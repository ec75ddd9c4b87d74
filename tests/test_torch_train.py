"""The port's training substrate vs the JAX package's, on the CPU.

Counterparts of ``tests/test_train.py`` (all 8 cases) and
``tests/test_perf_features.py:26-65`` (chunked CE, the train-step variants),
plus gradient parity of whole models and of every remat policy.  The same
numpy inputs and the same initial parameters (the JAX ``init_params``,
converted with ``from_jax_params``) go through both packages.

Tolerances, f32 throughout: losses rtol 1e-5 (the same f32 sums in another
order).  Gradients of whole models: rtol 1e-4, and atol 1e-4 of the leaf's
largest |g| (plus 1e-6).  An element of a weight's gradient sums products
over every position and layer that cancel, so f32 rounding in another order
shows against the leaf's scale, not the element's: elementwise rtol 1e-4
fails on many of a norm weight's elements, in either direction, where the
two packages sum the same terms in another order.  The global grad norm,
dominated by the largest such sums, agrees to rtol 2e-4.  Parameters after
an AdamW step are compared only where |g| > 1e-3 of the leaf's largest
|g|: the first update is about ``lr * sign(g)``, so an element whose
gradient is within the gradients' tolerance of 0 may move either way in
either package; there rtol 1e-4 / atol 1e-6.  The optimizer alone, fed the
same gradients, holds to rtol 1e-6.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import model as JM
from repro.parallel.sharding import NULL_PLAN
from repro.train import optimizer as jopt
from repro.train.loss import chunked_cross_entropy as j_chunked_ce, cross_entropy as j_ce
from repro.train.train_step import (RunConfig as JRunConfig, init_train_state as j_init_state,
                                    make_loss_fn as j_make_loss_fn,
                                    make_train_step as j_make_train_step)
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import from_jax_params, from_jax_state, to_jax_params
from repro_torch.kernels import ref
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt
from repro_torch.train.loss import chunked_cross_entropy, cross_entropy
from repro_torch.train.train_step import BF16_RUN, RunConfig, init_train_state, make_train_step

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)  # parameters after a step
MOVE_MASK = 1e-3  # |g| / max |g| of the leaf above which a step moves both alike


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _specs(arch, **kw):
    jspec, spec = jreduced(JARCHS[arch], **kw), reduced(ARCHS[arch], **kw)
    return jspec, spec


def _batch(spec, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, spec.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, spec.vocab_size, (b, s)).astype(np.int32)}


def _jax_state(jspec, cfg, seed=0):
    return j_init_state(jax.random.PRNGKey(seed), jspec, cfg)


def _port_state(jstate, spec):
    return from_jax_state(_np(jstate), spec, device="cpu")


# ---------------------------------------------------------------------------
# tests/test_train.py


def test_lr_schedule_shape():
    cfg = opt.OptConfig(lr=1e-3, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    lrs = [float(opt.lr_schedule(cfg, s)) for s in range(0, 120, 5)]
    assert lrs[0] == 0.0
    assert abs(max(lrs) - 1e-3) < 1e-9
    assert abs(lrs[-1] - 1e-4) < 1e-8  # floor at min_lr_ratio * lr
    peak = int(np.argmax(lrs))
    assert all(lrs[i] >= lrs[i + 1] for i in range(peak, len(lrs) - 1))
    jcfg = jopt.OptConfig(lr=1e-3, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    want = [float(jopt.lr_schedule(jcfg, jnp.asarray(s))) for s in range(0, 120, 5)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)


def test_adamw_moves_toward_minimum():
    state = opt.init_state({"w": torch.tensor([10.0, -10.0])})
    cfg = opt.OptConfig(lr=0.5, warmup_steps=0, decay_steps=10**9, weight_decay=0.0)
    for _ in range(60):
        grads = {"w": state["params"]["w"].clone()}  # grad of 0.5*w^2
        state, m = opt.apply_updates(state, grads, cfg)
    assert float(state["params"]["w"].abs().max()) < 1.0
    assert m["grad_norm"] > 0
    assert int(state["step"]) == 60 and state["step"].dtype == torch.int32


def test_grad_clip():
    state = opt.init_state({"w": torch.zeros(4)})
    cfg = opt.OptConfig(lr=1e-3, warmup_steps=0, grad_clip=1.0)
    _, m = opt.apply_updates(state, {"w": torch.full((4,), 1e6)}, cfg)
    assert float(m["grad_norm"]) > 1e6  # reported pre-clip


def test_cross_entropy_perfect_prediction():
    logits = torch.full((1, 3, 5), -20.0)
    logits[0, 0, 1] = logits[0, 1, 2] = logits[0, 2, 3] = 20.0
    assert float(cross_entropy(logits, torch.tensor([[1, 2, 3]], dtype=torch.int32))) < 1e-3


def test_cross_entropy_ignore_index():
    loss = cross_entropy(torch.zeros((1, 2, 4)), torch.tensor([[1, -1]], dtype=torch.int32))
    assert abs(float(loss) - float(np.log(4.0))) < 1e-5
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32)
    labels = rng.integers(-1, 11, (2, 6)).astype(np.int32)
    np.testing.assert_allclose(float(cross_entropy(torch.from_numpy(logits),
                                                   torch.from_numpy(labels))),
                               float(j_ce(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)


def test_microbatch_equivalence():
    """mb=1 vs mb=4 give the same update for mean CE, and mb=1 the JAX one."""
    jspec, spec = _specs("musicgen-medium")  # dense, embeddings frontend: no MoE aux noise
    b, s = 8, 16
    batch = {
        "inputs": np.random.default_rng(0).standard_normal((b, s, spec.d_model)).astype(np.float32),
        "labels": np.random.default_rng(1).integers(0, spec.vocab_size, (b, s)).astype(np.int32),
    }
    jcfg = JRunConfig(remat="none")
    j0 = _jax_state(jspec, jcfg)
    _, jm = jax.jit(j_make_train_step(jspec, cfg=jcfg))(j0, batch)
    out = {}
    for k in (1, 4):
        state = _port_state(j0, spec)
        out[k] = make_train_step(spec, cfg=RunConfig(remat="none", microbatches=k))(state, batch)
    (s1, m1), (s4, m4) = out[1], out[4]
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m1["loss"]), float(jm["loss"]), rtol=1e-5)
    for a, b_ in zip(opt.leaves(s1["params"]), opt.leaves(s4["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b_.detach().numpy(), rtol=1e-4, atol=1e-6)


def test_loss_decreases_over_steps():
    """SyntheticLM batches for 60 steps; the port's loss curve falls as the
    JAX test asks, and its first step's loss is the JAX one (the same init
    and the same batch)."""
    jspec, spec = _specs("qwen2-1.5b", n_layers=2)
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(spec, DataConfig(global_batch=8, seq_len=32, seed=0))
    cfg = RunConfig(remat="none", opt=opt.OptConfig(lr=6e-3, warmup_steps=5))
    jcfg = JRunConfig(remat="none", opt=jopt.OptConfig(lr=6e-3, warmup_steps=5))
    j0 = _jax_state(jspec, jcfg)
    _, jm = jax.jit(j_make_train_step(jspec, cfg=jcfg))(j0, data.batch_at(0))
    state = _port_state(j0, spec)
    step = make_train_step(spec, cfg=cfg)
    losses = []
    for i in range(60):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[0], float(jm["loss"]), rtol=1e-5)
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) - 0.08, losses


def test_mixed_precision_state_layout():
    jspec, spec = _specs("qwen2-1.5b", n_layers=1)
    state = init_train_state(spec, BF16_RUN, device="cpu")
    assert "master" in state
    assert opt.leaves(state["params"])[0].dtype == torch.bfloat16
    assert opt.leaves(state["master"])[0].dtype == torch.float32
    assert opt.leaves(state["m"])[0].dtype == torch.float32
    jstate = _jax_state(jspec, JRunConfig(compute_dtype=jnp.bfloat16, param_dtype=jnp.bfloat16))
    assert sorted(state) == sorted(jstate)
    assert [tuple(t.shape) for t in opt.leaves(state["params"])] == \
        [tuple(t.shape) for t in opt.leaves(from_jax_params(_np(jstate["params"]), spec, "cpu"))]


# ---------------------------------------------------------------------------
# the optimizer alone, and bf16 master weights


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_apply_updates_matches_jax(param_dtype):
    """Three AdamW steps from the same params and gradients (clip active on
    the first): m, v, the master, the params, grad_norm and lr agree."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": {"c": rng.standard_normal((11,)).astype(np.float32)}}
    grads = [{"a": rng.standard_normal((5, 7)).astype(np.float32) * scale,
              "b": {"c": rng.standard_normal((11,)).astype(np.float32) * scale}}
             for scale in (3.0, 0.1, 0.01)]
    jdt = jnp.bfloat16 if param_dtype == torch.bfloat16 else jnp.float32
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=2, decay_steps=10)
    jcfg = jopt.OptConfig(lr=1e-2, warmup_steps=2, decay_steps=10)
    js = jopt.init_state(jax.tree.map(jnp.asarray, params), jdt)
    ts = opt.init_state({"a": torch.from_numpy(params["a"]),
                         "b": {"c": torch.from_numpy(params["b"]["c"])}}, param_dtype)
    for g in grads:
        js, jm = jopt.apply_updates(js, jax.tree.map(jnp.asarray, g).copy(), jcfg)
        tg = {"a": torch.from_numpy(g["a"].copy()), "b": {"c": torch.from_numpy(g["b"]["c"].copy())}}
        ts, tm = opt.apply_updates(ts, tg, cfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        for key in ("m", "v", "master", "params"):
            if key not in js:
                assert key not in ts
                continue
            for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(js[key]),
                                         opt.leaves(ts[key])):
                np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                           rtol=1e-6, atol=1e-9, err_msg=f"{key} {path}")
        assert int(ts["step"]) == int(js["step"])


def test_bf16_train_step_matches_jax():
    """BF16_RUN: bf16 params and compute, f32 master and moments.  The loss
    agrees to 2e-2 (bf16 rounds in other places: the port's RMSNorm casts
    once after its (1 + w), the JAX layer before it); the params are the
    master rounded to bf16, exactly."""
    jspec, spec = _specs("qwen2-1.5b", n_layers=2)
    batch = _batch(spec, 4, 32)
    jcfg = JRunConfig(compute_dtype=jnp.bfloat16, param_dtype=jnp.bfloat16, remat="none")
    j0 = _jax_state(jspec, jcfg)
    _, jm = jax.jit(j_make_train_step(jspec, cfg=jcfg))(j0, batch)
    state = _port_state(j0, spec)
    assert opt.leaves(state["params"])[0].dtype == torch.bfloat16
    state, m = make_train_step(spec, cfg=BF16_RUN.with_(remat="none"))(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-2)
    for p, mp in zip(opt.leaves(state["params"]), opt.leaves(state["master"])):
        assert p.dtype == torch.bfloat16 and mp.dtype == torch.float32
        assert torch.equal(p, mp.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# tests/test_perf_features.py:26-65


def test_chunked_ce_matches_dense():
    b, s, d, v = 2, 32, 16, 64
    rng = np.random.default_rng(0)
    hidden = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((d, v)).astype(np.float32) * 0.2)
    labels = torch.from_numpy(rng.integers(0, v, (b, s)).astype(np.int32))
    dense = cross_entropy(hidden @ w, labels)
    jdense = j_ce(jnp.asarray(hidden.numpy()) @ jnp.asarray(w.numpy()), jnp.asarray(labels.numpy()))
    np.testing.assert_allclose(float(dense), float(jdense), rtol=1e-6)
    for chunk in (4, 8, 32, 12):  # 12 is halved to 6, 3, then 1, which divides 32
        ch = chunked_cross_entropy(hidden, lambda h: h @ w, labels, chunk=chunk)
        np.testing.assert_allclose(float(dense), float(ch), rtol=1e-6)


def test_chunked_ce_gradients_match():
    b, s, d, v = 2, 16, 8, 32
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    w0 = rng.standard_normal((d, v)).astype(np.float32) * 0.2
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    ht, lt = torch.from_numpy(hidden), torch.from_numpy(labels)
    w1 = torch.from_numpy(w0).requires_grad_()
    cross_entropy(ht @ w1, lt).backward()
    w2 = torch.from_numpy(w0).requires_grad_()
    chunked_cross_entropy(ht, lambda h: h @ w2, lt, chunk=4).backward()
    np.testing.assert_allclose(w1.grad.numpy(), w2.grad.numpy(), rtol=1e-5, atol=1e-7)
    jg = jax.grad(lambda w_: j_chunked_ce(jnp.asarray(hidden), lambda h: h @ w_,
                                          jnp.asarray(labels), chunk=4))(jnp.asarray(w0))
    np.testing.assert_allclose(w2.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("knobs", [
    dict(remat="save_kv"),
    dict(remat="full", loss_chunk=8),
    dict(remat="save_kv", loss_chunk=8, microbatches=2),
    dict(remat="dots", loss_chunk=8),
], ids=["save_kv", "full+chunk", "save_kv+chunk+mb2", "dots+chunk"])
def test_train_step_variants_match_plain(knobs):
    """Every perf knob is numerically the plain step (the JAX test), and the
    plain step is the JAX plain step."""
    jspec, spec = _specs("qwen2-1.5b", n_layers=2)
    batch = _batch(spec, 4, 32)
    j0 = _jax_state(jspec, JRunConfig(remat="none"))
    js, jm = jax.jit(j_make_train_step(jspec, cfg=JRunConfig(remat="none")))(j0, batch)
    s0, m0 = make_train_step(spec, cfg=RunConfig(remat="none"))(_port_state(j0, spec), batch)
    s1, m1 = make_train_step(spec, cfg=RunConfig(remat="none").with_(**knobs))(
        _port_state(j0, spec), batch)
    np.testing.assert_allclose(float(m0["loss"]), float(m1["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m0["loss"]), float(jm["loss"]), rtol=1e-5)
    for a, b in zip(opt.leaves(s0["params"]), opt.leaves(s1["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# gradients of whole models against jax.grad


def _assert_grads_close(got, want, path):
    """Per leaf: rtol 1e-4, atol 1e-4 of the leaf's largest |g| (see above)."""
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max() + 1e-6,
                               err_msg=str(path))


def _loss_grads_jax(jspec, jparams, batch, lb_weight):
    def loss(p):
        logits, aux = JM.forward(p, jnp.asarray(batch["inputs"]), jspec, remat="none")
        return j_ce(logits, jnp.asarray(batch["labels"])) + lb_weight * aux
    val, g = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, jparams))
    return float(val), g


def _loss_grads_port(spec, jparams, batch, lb_weight, remat):
    params = from_jax_params(jparams, spec, device="cpu")
    leaves = opt.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    logits, aux = M.forward(params, torch.from_numpy(batch["inputs"]), spec, remat=remat)
    loss = cross_entropy(logits, torch.from_numpy(batch["labels"])) + lb_weight * aux
    loss.backward()
    return loss.item(), params


@pytest.mark.parametrize("arch,n_layers", [
    ("qwen2-1.5b", 2),
    ("gemma3-1b", 4),            # sliding-window layers and a tail of the pattern
    ("granite-moe-3b-a800m", 2),  # MoE, with the load-balance loss
    ("mamba2-130m", 2),          # the SSD scan's plain version on the CPU
])
@pytest.mark.parametrize("remat", ["none", "dots", "full", "save_kv"])
def test_model_gradients_match_jax(arch, n_layers, remat):
    """loss.backward() of the port's forward vs jax.grad of the JAX forward,
    from the same parameters, under each remat policy (the JAX side without
    remat: a policy changes what is saved, not what is computed)."""
    jspec, spec = _specs(arch, n_layers=n_layers)
    jp = _np(JM.init_params(jax.random.PRNGKey(0), jspec))
    batch = _batch(spec, 2, 24, seed=3)
    lb = 0.01 if spec.n_experts else 0.0
    jloss, jg = _loss_grads_jax(jspec, jp, batch, lb)
    loss, params = _loss_grads_port(spec, jp, batch, lb, remat)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    grads = opt.leaves(params)
    assert all(p.grad is not None for p in grads)
    got = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_params(jax.tree.map(lambda p: p.grad, params,
                                   is_leaf=lambda x: isinstance(x, torch.Tensor)), spec)))
    for path, want in jax.tree_util.tree_leaves_with_path(_np(jg)):
        _assert_grads_close(got[path], want, jax.tree_util.keystr(path))


def test_train_step_matches_jax_step():
    """One plain step of both packages from the same state and batch: the
    loss, grad_norm and lr agree, and the params move alike wherever |g| is
    above the rounding noise (see the module docstring)."""
    jspec, spec = _specs("qwen2-1.5b", n_layers=2)
    batch = _batch(spec, 4, 32, seed=5)
    jcfg = JRunConfig(remat="none", opt=jopt.OptConfig(warmup_steps=0))
    j0 = _jax_state(jspec, jcfg)
    jg = jax.grad(lambda p: j_make_loss_fn(jspec, NULL_PLAN, jcfg)(p, batch)[0])(j0["params"])
    js, jm = jax.jit(j_make_train_step(jspec, cfg=jcfg))(j0, batch)
    state = _port_state(j0, spec)
    state, m = make_train_step(spec, cfg=RunConfig(remat="none", opt=opt.OptConfig(warmup_steps=0)))(
        state, batch)
    for key, rtol in (("loss", 1e-5), ("grad_norm", 2e-4), ("lr", 1e-6)):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=rtol, err_msg=key)
    got = dict(jax.tree_util.tree_leaves_with_path(to_jax_params(state["params"], spec)))
    g = dict(jax.tree_util.tree_leaves_with_path(_np(jg)))
    moved = 0
    for path, want in jax.tree_util.tree_leaves_with_path(_np(js["params"])):
        mask = np.abs(g[path]) > MOVE_MASK * np.abs(g[path]).max()
        moved += int(mask.sum())
        np.testing.assert_allclose(got[path][mask], want[mask], err_msg=jax.tree_util.keystr(path),
                                   **GRAD_TOL)
    assert moved > 0.9 * sum(np.size(x) for x in jax.tree.leaves(jg))


# ---------------------------------------------------------------------------
# the kernels' autograd Functions under every remat policy, on the CPU
#
# On the card, FlashAttentionFn and RMSNormFn launch kernels that write
# through ctypes into torch.empty buffers, which neither autograd nor the
# dispatch mode of selective checkpointing sees.  Here numpy stand-ins of
# the launches do the same (they write into the buffers' memory through
# .numpy()), so the Functions' wiring, their saved tensors and their
# recompute under checkpointing run on the CPU.


def _np_attention(q, k, v, causal, window, scale, q_offset=0):
    """numpy f64 attention in the kernel's layout, query row i at position
    q_offset + i -> (o, lse (B, H, S))."""
    b, s, h, hd = q.shape
    t, g = k.shape[1], k.shape[2]
    kk, vv = (np.repeat(x, h // g, axis=2) for x in (k, v))
    sc = np.einsum("bshd,bthd->bhst", q, kk) * scale
    qp, kp = q_offset + np.arange(s)[:, None], np.arange(t)[None]
    mask = np.ones((s, t), bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    sc = np.where(mask, sc, -np.inf)
    lse = np.log(np.exp(sc - sc.max(-1, keepdims=True)).sum(-1)) + sc.max(-1)
    p = np.exp(sc - lse[..., None])
    return np.einsum("bhst,bthd->bshd", p, vv), lse, p


def _fake_flash_launch(q, k, v, causal, window, scale, with_lse, q_offset):
    from repro_torch.kernels import flash_attention as fa
    o_ref, lse_ref, _ = _np_attention(*(x.detach().double().numpy() for x in (q, k, v)),
                                      causal, window, scale, q_offset)
    o = torch.empty(q.shape, dtype=q.dtype)
    o.detach().numpy()[...] = o_ref
    lse = None
    if with_lse:
        lse = torch.empty(lse_ref.shape, dtype=torch.float32)
        lse.detach().numpy()[...] = lse_ref
    fa.flash_attention.launches += 1
    return o, lse


def _fake_flash_bwd(q, k, v, o, lse, do, *, causal, window, scale, q_offset):
    qn, kn, vn, on, don = (x.detach().double().numpy() for x in (q, k, v, o, do))
    b, s, h, hd = qn.shape
    g = kn.shape[2]
    _, _, p = _np_attention(qn, kn, vn, causal, window, scale, q_offset)
    kk, vv = (np.repeat(x, h // g, axis=2) for x in (kn, vn))
    dv = np.einsum("bhst,bshd->bthd", p, don)
    dp = np.einsum("bshd,bthd->bhst", don, vv)
    ds = p * (dp - np.einsum("bshd,bshd->bhs", don, on)[..., None])
    dq = np.einsum("bhst,bthd->bshd", ds, kk) * scale
    dk = np.einsum("bhst,bshd->bthd", ds, qn) * scale
    grads = []
    for ref, like in ((dq, q), (dk.reshape(b, -1, g, h // g, hd).sum(3), k),
                      (dv.reshape(b, -1, g, h // g, hd).sum(3), v)):
        out = torch.empty(like.shape, dtype=like.dtype)
        out.detach().numpy()[...] = ref
        grads.append(out)
    _fake_flash_bwd.launches += 1
    return tuple(grads)


def _fake_rms_forward(x, w, eps):
    from repro_torch.kernels import rmsnorm as rn
    xn, wn = x.detach().double().numpy(), w.detach().double().numpy()
    o = torch.empty(x.shape, dtype=x.dtype)
    o.detach().numpy()[...] = xn / np.sqrt((xn * xn).mean(-1, keepdims=True) + eps) * (1 + wn)
    rn.rmsnorm.launches += 1
    return o


def _fake_rms_bwd(x, w, g, *, eps):
    xn, wn, gn = (t.detach().double().numpy() for t in (x, w, g))
    r = 1 / np.sqrt((xn * xn).mean(-1, keepdims=True) + eps)
    u = gn * (1 + wn)
    dx, dw = torch.empty(x.shape, dtype=x.dtype), torch.empty(w.shape, dtype=w.dtype)
    dx.detach().numpy()[...] = r * u - xn * r ** 3 * (u * xn).mean(-1, keepdims=True)
    dw.detach().numpy()[...] = (gn * xn * r).sum(0)
    _fake_rms_bwd.launches += 1
    return dx, dw


@pytest.fixture()
def kernel_functions(monkeypatch):
    """Route the models' flash attention and RMSNorm through the kernels'
    autograd Functions, with numpy stand-ins for the launches."""
    from repro_torch.kernels import flash_attention as fa, ops, rmsnorm as rn
    # the Functions' forward launches are the operators (kernels/_library.py)
    monkeypatch.setattr(fa, "_fwd_op", _fake_flash_launch)
    monkeypatch.setattr(fa, "flash_attention_bwd", _fake_flash_bwd)
    monkeypatch.setattr(rn, "_fwd_op", _fake_rms_forward)
    monkeypatch.setattr(rn, "rmsnorm_bwd", _fake_rms_bwd)
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, *, causal, window, scale,
                        q_offset: fa.FlashAttentionFn.apply(q, k, v, causal, window, scale,
                                                            q_offset))
    monkeypatch.setattr(ops, "rmsnorm", lambda x, w, *, eps: rn.RMSNormFn.apply(x, w, eps))
    for fn in (fa.flash_attention, _fake_flash_bwd, rn.rmsnorm, _fake_rms_bwd):
        monkeypatch.setattr(fn, "launches", 0, raising=False)
    return fa, rn


@pytest.mark.parametrize("arch,n_layers", [("qwen2-1.5b", 2), ("gemma3-1b", 4)])
@pytest.mark.parametrize("remat", ["none", "dots", "full", "save_kv"])
def test_kernel_functions_under_remat(kernel_functions, arch, n_layers, remat):
    """Gradients through FlashAttentionFn and RMSNormFn equal the plain
    path's (the gradients' tolerance: the stand-ins compute in f64), and
    checkpointing re-launches each layer's forward kernels in the backward:
    flash once per layer and twice under a remat policy, its backward once
    per layer; RMSNorm's forward 2 per layer + 1 (twice the 2 per layer
    under remat), its backward 2 per layer + 1."""
    fa, rn = kernel_functions
    jspec, spec = _specs(arch, n_layers=n_layers)
    jp = _np(JM.init_params(jax.random.PRNGKey(0), jspec))
    batch = _batch(spec, 2, 24, seed=3)
    with pytest.MonkeyPatch.context() as mp:  # the plain path first
        from repro_torch.kernels import ops
        mp.setattr(ops, "flash_attention", fa.flash_attention_plain)
        mp.setattr(ops, "rmsnorm", lambda x, w, *, eps: ref.rmsnorm_ref(x, w, eps=eps))
        want_loss, want = _loss_grads_port(spec, jp, batch, 0.0, "none")
    loss, got = _loss_grads_port(spec, jp, batch, 0.0, remat)
    counts = (fa.flash_attention.launches, _fake_flash_bwd.launches, rn.rmsnorm.launches,
              _fake_rms_bwd.launches)
    n = spec.n_layers
    again = 0 if remat == "none" else 1
    assert counts == (n * (1 + again), n, 2 * n * (1 + again) + 1, 2 * n + 1), counts
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    for i, (g, w) in enumerate(zip(opt.leaves(got), opt.leaves(want))):
        _assert_grads_close(g.grad.numpy(), w.grad.numpy(), f"leaf {i}")
