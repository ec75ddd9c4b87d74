"""mamba2's d_inner kept split, and gradients laid out as autograd makes
them, on four gloo ranks, on the CPU.

Reduced mamba2 at d_model 48 on a (1, 4) ("data", "model") mesh: d_inner
(96) splits over 'model' in pieces of 24, and its 6 heads of 16 do not
divide 'model' while their head_dim does, so the scan runs on each rank's 4
columns of every head.  Held:
  * the head view (``mamba._heads``) moves each rank's 24 d_inner columns to
    its head_dim share by one all-to-all (8 or 4 columns to each rank, as
    the heads fall), and ``mamba._fold_heads`` moves them back: the result,
    its layout and the input's gradient are the same bits as the gather
    and view they replace, at the scan's (B, S, d_inner) and decode's
    (B, d_inner), and no all-gather runs;
  * serving (``Engine(plan=)`` and the model's prefill and decode, the
    harness of ``tests/test_torch_serve_plan.py``) and two train steps
    (remat ``dots``, the harness of ``tests/test_torch_parallel_train.py``)
    against the port's unsharded runs and the JAX package at those files'
    tolerances, while every call of the gated norm takes the RMSNorm
    kernels' split-row mode on each rank's 24 columns of rows 96 wide (no
    whole-row call sees a row 96 wide), and every head view and fold of
    the scan, of decode and of training moves by all-to-all;
  * decode's conv (``mamba._conv_own_columns``): each rank convolves its
    own 24 d_inner columns and b's and c's 32 channels whole, the conv
    cache's 128 channels (pieces of 32) moved to and from that layout by
    all-to-all, and no all-gather runs inside ``mamba_decode``: six greedy
    steps against the unsharded port and the JAX package (tokens equal,
    logits and conv cache leaves within 1e-6 of their scale, the first
    layer's leaves bit for bit); with 130 channels, which 'model' does not
    divide, every decode takes ``_conv_whole_rows``, as before.
ZeRO-2.  Reduced mamba2 on (2, 2) under a plan that keeps its mixer's
weights whole over 'model' (the dry run's ``mamba_dp`` rules), with every
state leaf in the default plan's layout (``opt_plan``), so the gradients of
the mixer's weights are reduce-scattered over 'model': the hooks of
``train_step.grads_laid_out`` give the same bits as ``torch.autograd.grad``
followed by the redistribution (the parent tree's ``shard_grads``), in the
optimizer's layout; under remat ``dots`` with two microbatches a leaf's hook
fires once a microbatch, not once a recompute; and two such steps match the
port's unsharded step (rtol 1e-4, atol 1e-6) and the JAX step (rtol 1e-3,
atol 1e-5; losses 1e-5 and 1e-4).
The first two tests' assertions hold only where ``_to_head_dim``,
``_from_head_dim``, ``rmsnorm_split`` and ``grads_laid_out`` run, the decode
tests' only where ``_conv_own_columns`` does.  The ranks import the port only; JAX runs in the test
process.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from test_torch_parallel_train import (JAX_TOL, OPT, PORT_TOL, _batches, _check as _check_train,
                                       _host, _references, _sharded_rank)
from test_torch_serve_plan import CASES, _check as _check_serve, _params, _serve_rank

from repro_torch.configs import ARCHS, reduced
from repro_torch.parallel import spawn

ARCH, KW = "mamba2-130m", {"d_model": 48}
TIMEOUT = 600  # seconds, per spawned call: each takes 30 to 90 s alone


class Collectives(TorchDispatchMode):
    """The collectives dispatched while it is on, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name().split("::")[-1].split(".")[0]
        if ("c10d_functional" in func.namespace or func.namespace == "_dtensor") and \
                name.startswith(("all_", "reduce_scatter", "shard_dim", "broadcast")):
            self.ops.append(name)
        return func(*args, **(kwargs or {}))


# -- the head view ----------------------------------------------------------------

def _heads_rank():
    """The head view and the fold, by all-to-all and by the gather they
    replace, on (1, 4); the collectives each ran."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import mamba
    from repro_torch.parallel.sharding import placements, plan_for_mesh

    spec = reduced(ARCHS[ARCH], **KW)
    nh, hd, din = spec.ssm_heads, spec.ssm_head_dim, spec.d_inner
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    plan = plan_for_mesh(mesh)
    gen = torch.Generator().manual_seed(0)
    out = {}
    for name, lead, axes in (("scan", (2, 8), ("batch", None)), ("decode", (2,), ("batch",))):
        x = torch.randn(*lead, din, generator=gen)
        w = torch.randn(*lead, nh, hd, generator=gen)
        shape = (*lead, nh, hd)
        place = lambda t, ax: distribute_tensor(t, mesh, placements(plan.spec(ax, t.shape), mesh),
                                                src_data_rank=None)
        xd = place(x, axes + ("d_inner",)).requires_grad_()
        with Collectives() as moved:
            h = mamba._heads(xd, shape, plan, axes)
            back = mamba._fold_heads(h, (*lead, din), plan, axes)
        gx, = torch.autograd.grad((h * place(w, axes + ("ssm_heads", "ssm_head_dim"))).sum(), xd)
        ref = plan.constrain(plan.constrain(xd, axes + (None,)).view(shape),
                             axes + ("ssm_heads", "ssm_head_dim"))
        rx, = torch.autograd.grad((ref * place(w, axes + ("ssm_heads", "ssm_head_dim"))).sum(),
                                  xd)
        out[name] = dict(
            same=torch.equal(h.full_tensor(), ref.full_tensor()),
            placements=(str(h.placements), str(ref.placements)),
            grad_same=torch.equal(gx.full_tensor(), rx.full_tensor()),
            back_same=torch.equal(back.full_tensor(), x),
            back_placements=(str(back.placements), str(xd.placements)),
            collectives=sorted(set(moved.ops)))
    return out if dist.get_rank() == 0 else None


def test_head_view_moves_by_all_to_all_bit_for_bit_with_the_gather():
    got = spawn.run(_heads_rank, 4, timeout=TIMEOUT)[0]
    for name, r in got.items():
        assert r["same"] and r["grad_same"] and r["back_same"], (name, r)
        assert r["placements"][0] == r["placements"][1], (name, r)
        assert r["back_placements"][0] == r["back_placements"][1], (name, r)
        assert r["collectives"] == ["all_to_all_single"], (name, r)


# -- the model: serving and training ------------------------------------------------

def _model_rank(serve_runs, train_cases, batches):
    """The serving harness's and the training harness's runs of reduced
    mamba2 on (1, 4), recording, in the plan's runs, each RMSNorm call's
    kind (whole-row or split), local width and row width, and whether each
    head view and fold moved by all-to-all."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels import ops
    from repro_torch.models import mamba

    seen = {"norm": set(), "to": [], "from": [], "plan": False}
    fused, whole, split = ops.fused_rmsnorm, ops.rmsnorm, ops.rmsnorm_split
    to_heads, from_heads = mamba._to_head_dim, mamba._from_head_dim

    def recording_fused(x, w, **kw):
        seen["plan"] = isinstance(x, DTensor)
        try:
            return fused(x, w, **kw)
        finally:
            seen["plan"] = False

    def recording_whole(x, w, **kw):
        if seen["plan"]:
            seen["norm"].add(("whole", x.shape[-1], x.shape[-1]))
        return whole(x, w, **kw)

    def recording_split(x, w, **kw):
        seen["norm"].add(("split", x.shape[-1], kw["d_full"]))
        return split(x, w, **kw)

    def recording(fn, key):
        def wrapped(t, *args):
            moved = fn(t, *args)
            if isinstance(t, DTensor):
                seen[key].append((t.ndim, moved is not None))
            return moved
        return wrapped

    ops.fused_rmsnorm, ops.rmsnorm, ops.rmsnorm_split = (recording_fused, recording_whole,
                                                          recording_split)
    mamba._to_head_dim = recording(to_heads, "to")
    mamba._from_head_dim = recording(from_heads, "from")
    serve = _serve_rank((1, 4), serve_runs, KW)
    served = {k: seen[k] for k in ("norm", "to", "from")}
    seen.update(norm=set(), to=[], **{"from": []})
    train = _sharded_rank(ARCH, KW, (1, 4), train_cases, batches)
    return serve, train, served, {k: seen[k] for k in ("norm", "to", "from")}


def test_mamba_keeps_d_inner_split_matches_unsharded_and_jax():
    spec = reduced(ARCHS[ARCH], **KW)
    din, piece = spec.d_inner, spec.d_inner // 4
    prompt, new, _ = cfg = CASES[ARCH]
    cases = [("dots", True, 1)]
    ranks = spawn.run(_model_rank, 4, [(ARCH, _params(ARCH, KW), cfg)], cases,
                      _batches(spec.vocab_size), timeout=TIMEOUT)
    _check_serve([r[0] for r in ranks], 0, ARCH, prompt, new, KW)
    _check_train([r[1] for r in ranks], _references(ARCH, KW, "dots", 1), 0)
    for _, _, served, trained in ranks:
        for seen in (served, trained):
            assert ("split", piece, din) in seen["norm"], seen["norm"]
            assert not any(kind == "whole" and w == din for kind, w, _ in seen["norm"])
            assert seen["from"] and all(moved for _, moved in seen["from"]), seen["from"]
        # the scan's head views (B, S, d_inner) and decode's (B, d_inner) move
        assert served["to"] and all(moved for _, moved in served["to"]), served["to"]
        assert {nd for nd, _ in served["to"]} == {2, 3}, served["to"]
        assert trained["to"] and all(moved for _, moved in trained["to"]), trained["to"]


# -- decode's conv on each rank's own d_inner columns ------------------------------

DECODE_PROMPT, DECODE_STEPS = 16, 6
# ssm_state 17: C = 96 + 2 * 17 = 130 channels, which 'model' (4) does not
# divide, so the conv cache is whole while xi's d_inner (96) is split
UNFIT_KW = {"d_model": 48, "ssm_state": 17}
DECODE_TOL = 1e-6  # logits: atol DECODE_TOL * the step's largest |logit|


def _decode_rank(runs):
    """For each (arch overrides, params, prompts): reduced mamba2's prefill
    and DECODE_STEPS greedy decode steps on (1, 4), unsharded and under the
    plan; each step's tokens, logits and conv cache leaves (rank 0), the
    decodes under the plan that took ``_conv_own_columns`` and
    ``_conv_whole_rows``, and the collectives dispatched inside
    ``mamba_decode`` under the plan."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import mamba
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import NULL_PLAN, distribute_tree, placements, plan_for_mesh

    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    plan = plan_for_mesh(mesh)
    seen = {"own": 0, "whole": 0, "ops": []}
    own, whole_rows, decode = mamba._conv_own_columns, mamba._conv_whole_rows, mamba.mamba_decode

    def counting(fn, key):
        def wrapped(p, conv, *args):
            out = fn(p, conv, *args)
            if isinstance(conv, DTensor) and out is not None:
                seen[key] += 1
            return out
        return wrapped

    def recording_decode(p, x, spec, pl, cache):
        if pl is NULL_PLAN:
            return decode(p, x, spec, pl, cache)
        with Collectives() as moved:
            out = decode(p, x, spec, pl, cache)
        seen["ops"] += moved.ops
        return out

    mamba._conv_own_columns = counting(own, "own")
    mamba._conv_whole_rows = counting(whole_rows, "whole_rows")
    mamba.mamba_decode = recording_decode
    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    out = []
    for kw, params, prompts in runs:
        spec = reduced(ARCHS[ARCH], **kw)
        (b, s), f32 = prompts.shape, torch.float32
        seen.update(own=0, whole_rows=0, ops=[])

        @torch.inference_mode()
        def run(p, pl):
            caches = M.init_caches(spec, b, s + DECODE_STEPS, dtype=f32, device="cpu")
            tok = torch.as_tensor(prompts)
            if pl is not NULL_PLAN:
                caches = distribute_tree(caches, M.cache_axes(spec, b, s + DECODE_STEPS), pl,
                                         mesh)
                tok = distribute_tensor(tok, mesh, placements(pl.spec(("batch", None), tok.shape),
                                                              mesh), src_data_rank=None)
            lg, caches = M.prefill(p, tok, caches, spec, pl, compute_dtype=f32)
            steps = []
            for i in range(DECODE_STEPS):
                tok = whole(lg).argmax(-1)
                lg, caches = M.decode_step(p, caches, tok, s + i, spec, pl, compute_dtype=f32)
                steps.append((tok.numpy().copy(), whole(lg).numpy().copy(),
                              [whole(c["conv"]).numpy().copy() for c in caches]))
            return steps

        base = run(params, NULL_PLAN)
        got = run(distribute_tree(params, M.param_axes(spec), plan, mesh), plan)
        first = dist.get_rank() == 0
        out.append(dict(base=base if first else None, got=got if first else None,
                        own=seen["own"], whole_rows=seen["whole_rows"],
                        ops=sorted(set(seen["ops"]))))
    return out


def _jax_decode(kw, params, prompts, tokens):
    """The JAX package's prefill and decode steps on ``tokens`` (a step's
    input each) from the same parameters, f32: each step's logits and conv
    cache leaves."""
    import jax.numpy as jnp
    from test_torch_models import _jax_decoder, _jax_layer

    from repro.configs import ARCHS as JARCHS, reduced as jreduced
    from repro.models import model as JM
    from repro_torch.convert import to_jax_params
    spec, jspec = reduced(ARCHS[ARCH], **kw), jreduced(JARCHS[ARCH], **kw)
    jp = to_jax_params(params, spec)
    b, s = prompts.shape
    caches = JM.init_caches(jspec, b, s + len(tokens), dtype=jnp.float32)
    _, caches = JM.prefill(jp, jnp.asarray(prompts), caches, jspec, compute_dtype=jnp.float32)
    step, out = _jax_decoder(jspec), []
    for i, tok in enumerate(tokens):
        lg, caches = step(jp, caches, tok, s + i)
        out.append((np.asarray(lg), [_jax_layer(caches, spec, j, "conv")
                                     for j in range(spec.n_layers)]))
    return out


_DECODE: dict = {}


def _decode_runs():
    if not _DECODE:
        runs = []
        for kw in (KW, UNFIT_KW):
            spec = reduced(ARCHS[ARCH], **kw)
            runs.append((kw, _params(ARCH, kw), np.random.default_rng(7).integers(
                0, spec.vocab_size, (2, DECODE_PROMPT)).astype(np.int32)))
        _DECODE["runs"] = runs
        _DECODE["ranks"] = spawn.run(_decode_rank, 4, runs, timeout=TIMEOUT)
    return _DECODE["runs"], _DECODE["ranks"]


def _check_decode(base, got):
    for step, ((bt, bl, bc), (gt, gl, gc)) in enumerate(zip(base, got)):
        np.testing.assert_array_equal(gt, bt, err_msg=f"tokens of step {step}")
        np.testing.assert_allclose(gl, bl, rtol=DECODE_TOL, atol=DECODE_TOL * np.abs(bl).max(),
                                   err_msg=f"logits of step {step}")
        # the first layer's conv rows are the embedding's products on either
        # side; deeper layers' inputs carry the plan's partial sums
        np.testing.assert_array_equal(gc[0], bc[0], err_msg="conv cache of layer 0")
        for layer, (g, w) in enumerate(zip(gc, bc)):
            np.testing.assert_allclose(g, w, rtol=DECODE_TOL, atol=DECODE_TOL * np.abs(w).max(),
                                       err_msg=f"conv cache of layer {layer}")


def test_decode_conv_keeps_d_inner_split_matches_unsharded_and_jax():
    """Reduced mamba2 (d_inner 96 in pieces of 24 over 'model', the conv
    cache's 128 channels in pieces of 32): every decode under the plan
    convolves each rank's own columns (``_conv_own_columns``), no all-gather
    runs inside ``mamba_decode`` (the cache and the head view move by
    all-to-all), and six greedy steps give the unsharded port's tokens and
    conv cache leaves bit for bit and its logits within DECODE_TOL of their
    scale, and the JAX package's logits and conv cache leaves within the
    same tolerance."""
    runs, ranks = _decode_runs()
    kw, params, prompts = runs[0]
    ranks = [r[0] for r in ranks]
    n_layers = reduced(ARCHS[ARCH], **kw).n_layers
    for r in ranks:
        assert (r["own"], r["whole_rows"]) == (DECODE_STEPS * n_layers, 0), r
        assert "all_to_all_single" in r["ops"], r["ops"]
        assert not [op for op in r["ops"] if op.startswith("all_gather")], r["ops"]
    base, got = ranks[0]["base"], ranks[0]["got"]
    _check_decode(base, got)
    jax_steps = _jax_decode(kw, params, prompts, [t for t, _, _ in base])
    for step, ((_, bl, bc), (jl, jc)) in enumerate(zip(base, jax_steps)):
        np.testing.assert_allclose(bl, jl, rtol=DECODE_TOL, atol=DECODE_TOL * np.abs(jl).max(),
                                   err_msg=f"logits of step {step} against JAX")
        for layer, (g, w) in enumerate(zip(bc, jc)):
            np.testing.assert_allclose(g, w, rtol=DECODE_TOL, atol=DECODE_TOL * np.abs(w).max(),
                                       err_msg=f"conv cache of layer {layer} against JAX")


def test_decode_conv_takes_whole_rows_where_the_split_does_not_fit():
    """With 130 conv channels (``UNFIT_KW``) the cache's channels stay whole
    while xi's d_inner is split: ``_conv_own_columns`` declines and every
    decode takes ``_conv_whole_rows``, with the unsharded port's tokens, conv
    cache leaves and logits."""
    ranks = [r[1] for r in _decode_runs()[1]]
    n_layers = reduced(ARCHS[ARCH], **UNFIT_KW).n_layers
    for r in ranks:
        assert (r["own"], r["whole_rows"]) == (0, DECODE_STEPS * n_layers), r
    _check_decode(ranks[0]["base"], ranks[0]["got"])


# -- ZeRO-2: gradients reduce-scattered as autograd makes them ---------------------

def _zero2_rank(batches, remat, micro):
    """On (2, 2) with the mixer's weights whole over 'model' and the state in
    the default plan's layout: the hooked gradients against autograd.grad
    then redistributed (bit equality, and each in the optimizer's layout),
    the count of leaves whose layouts differ, the hook calls a leaf over
    one two-microbatch step under remat ``dots``, and the losses, grad
    norms and final parameters of ``batches``' steps."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import (_default_rules, distribute_tree, placements,
                                               plan_for_mesh)
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (RunConfig, batch_axes, grads_laid_out,
                                              init_train_state, make_loss_fn, make_train_step)

    spec = reduced(ARCHS[ARCH])
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rules = _default_rules(True, True)
    rules["d_inner"] = rules["ssm_heads"] = []
    plan, opt_plan = plan_for_mesh(mesh, rules=rules), plan_for_mesh(mesh)
    axes = opt.leaves(M.param_axes(spec))
    fresh = lambda cfg: init_train_state(spec, cfg, seed=0, device="cpu", plan=opt_plan,
                                         mesh=mesh)
    cfg = RunConfig(remat="dots", opt=opt.OptConfig(**OPT))
    state = fresh(cfg)
    batch = distribute_tree({k: torch.as_tensor(v) for k, v in batches[0].items()},
                            batch_axes(spec), plan, mesh)
    ps = opt.leaves(state["params"])
    for p in ps:
        p.requires_grad_(True)
    loss_fn = make_loss_fn(spec, plan, cfg)
    hooked = grads_laid_out(loss_fn(state["params"], batch)[0], ps, axes, opt_plan)
    plain = torch.autograd.grad(loss_fn(state["params"], batch)[0], ps)
    wants = [placements(opt_plan.spec(ax, tuple(p.shape)), mesh) for p, ax in zip(ps, axes)]
    after = [g.redistribute(mesh, w) for g, w in zip(plain, wants)]
    out = dict(same_bits=all(torch.equal(h.to_local(), a.to_local())
                             for h, a in zip(hooked, after)),
               in_opt_layout=all(tuple(h.placements) == tuple(w) for h, w in zip(hooked, wants)),
               layouts_differ=sum(plan.spec(ax, tuple(p.shape)) != opt_plan.spec(ax, tuple(p.shape))
                                  for p, ax in zip(ps, axes)))

    cfg2 = cfg.with_(microbatches=2)
    state = fresh(cfg2)
    calls = [0] * len(axes)
    handles = [p.requires_grad_(True).register_hook(
        lambda g, i=i: calls.__setitem__(i, calls[i] + 1))
        for i, p in enumerate(opt.leaves(state["params"]))]
    make_train_step(spec, plan, cfg2, opt_plan=opt_plan)(state, batches[0])
    for h in handles:
        h.remove()
    out["calls"] = sorted(set(calls))

    cfg3 = RunConfig(remat=remat, microbatches=micro, opt=opt.OptConfig(**OPT))
    state, step = fresh(cfg3), make_train_step(spec, plan, cfg3, opt_plan=opt_plan)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    params = _host(state["params"])  # a collective: every rank gathers
    out.update(losses=losses, norms=norms, params=params if dist.get_rank() == 0 else None)
    return out


def test_zero2_gradients_are_reduce_scattered_by_hooks_as_they_are_made():
    remat, micro = "dots", 2
    spec = reduced(ARCHS[ARCH])
    ranks = spawn.run(_zero2_rank, 4, _batches(spec.vocab_size), remat, micro,
                      timeout=TIMEOUT)
    for r in ranks:
        assert r["same_bits"] and r["in_opt_layout"], r
        assert r["layouts_differ"] > 0  # the mixer's weights: whole in use, split for AdamW
        assert r["calls"] == [2]  # every leaf: once a microbatch
        assert r["losses"] == ranks[0]["losses"] and r["norms"] == ranks[0]["norms"]
    _, (jl, jparams), (pl, pparams) = _references(ARCH, {}, remat, micro)
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], pl, rtol=1e-5)
    np.testing.assert_allclose(got["losses"], jl, rtol=1e-4)
    assert sorted(got["params"]) == sorted(pparams) == sorted(jparams)
    for key, p in got["params"].items():
        np.testing.assert_allclose(p, pparams[key], err_msg=key, **PORT_TOL)
        np.testing.assert_allclose(p, jparams[key], err_msg=key, **JAX_TOL)
