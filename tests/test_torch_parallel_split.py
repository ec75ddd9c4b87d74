"""The dims the sharded program keeps split, on four gloo ranks, on the CPU.

Each of the port's local-shard regions that the JAX plan leaves split,
under ``plan_for_mesh`` of a (2, 2) and a (1, 4) ("data", "model") mesh,
against the port's unsharded function and the JAX function on the same
seeded numpy inputs:
  * the loss over vocabulary-split logits (``cross_entropy``, and
    ``chunked_cross_entropy`` through a vocabulary-split head): the loss and
    the gradients of the logits (of the hidden states and the head);
  * the embedding of a vocabulary-split table (``take_embedding``, then the
    residual stream's constraint): the rows and the table's gradient;
  * flash attention with q split over its sequence (``ops.mha_flash``; 6
    heads do not divide a 'model' axis of 4, nor 3 one of 2): the output and
    q, k and v's gradients;
  * the MoE layer (``moe_apply``) with its experts split over 'model'
    (reduced granite's 4 experts: an all-to-all of the capacity rows where
    the sequence is split too, each rank's own experts where x is whole) and
    with their ff columns split (6 experts on a 4-way axis, 3 on a 2-way
    one), at routing groups of 8 tokens (several a rank) and in a decode
    step (S = 1): y, the balance loss, the dropped share and every
    gradient; and at batch 1 on (4, 1) and (2, 2), where 'data' splits no
    rows, with the experts on their FSDP shards of D;
  * the embedding lookup at batch 1 on the table's FSDP shards of D, and the
    tied head's product with a 250-word vocabulary over an idle 'model'
    (``head_product``): each rank's 63 columns, the last 61.
Each rank also records what its local ops saw (a dispatch mode below
``DTensor``): no local tensor holds a row's whole vocabulary, the table's
whole rows, the whole query sequence, or every expert's whole weights.

Tolerances: against the unsharded port rtol 1e-5 (the same f32 sums, some
of them split into partial sums added across ranks), gradients with an atol
of 1e-5 of the tensor's largest element; against JAX the same, 2e-5 (XLA's
own summation order).  The ranks import the port only; JAX runs in the test
process.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.parallel import spawn

AXES = ("data", "model")
MESHES = [(2, 2), (1, 4)]
TIMEOUT = 300  # seconds, per spawned call: each takes 10 to 30 s alone
B, S, V, D = 4, 16, 96, 32  # the loss and the embedding
GROUP = 8  # MoE routing group: S = 32 makes four groups a row


def _close(got, want, rtol=1e-5, err_msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


class _Widest:
    """A dispatch mode below ``DTensor``: the largest size each dim of the
    local tensors an op made had, by rank of the tensor, and under ``0`` the
    most elements of one (``DTensor``'s shape propagation on fake stand-ins
    left out)."""

    def __new__(cls):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.widest: dict[int, list[int]] = {}

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                for t in out if isinstance(out, (tuple, list)) else (out,):
                    if isinstance(t, torch.Tensor) and t.ndim and not isinstance(t, FakeTensor):
                        w = self.widest.setdefault(t.ndim, [0] * t.ndim)
                        self.widest[t.ndim] = [max(a, b) for a, b in zip(w, t.shape)]
                        self.widest[0] = max(self.widest.get(0, 0), t.numel())
                return out

        return Mode()


def _mesh(shape):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import plan_for_mesh
    mesh = make_mesh(shape, AXES, device="cpu")
    return mesh, plan_for_mesh(mesh)


def _place(t, axes, plan, mesh):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel.sharding import placements
    return distribute_tensor(t, mesh, placements(plan.spec(axes, tuple(t.shape)), mesh),
                             src_data_rank=None)


# -- the loss and the embedding -------------------------------------------------

def _vocab_inputs():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, V, (B, S)).astype(np.int64)
    labels[0, :3] = -1  # ignored positions
    return dict(logits=(3 * rng.standard_normal((B, S, V))).astype(np.float32), labels=labels,
                hidden=rng.standard_normal((B, S, D)).astype(np.float32),
                head=(rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32),
                table=rng.standard_normal((V, D)).astype(np.float32),
                tokens=rng.integers(0, V, (B, S)).astype(np.int64),
                weight=rng.standard_normal((B, S, D)).astype(np.float32))


def _vocab_rank(shape, x):
    import torch.distributed as dist

    from repro_torch.models.layers import linear, take_embedding
    from repro_torch.train.loss import chunked_cross_entropy, cross_entropy
    mesh, plan = _mesh(shape)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out = {}
    logits = _place(t["logits"], ("batch", "seq", "vocab"), plan, mesh).requires_grad_()
    labels = _place(t["labels"], ("batch", None), plan, mesh)
    with _Widest() as mode:
        loss = cross_entropy(logits, labels)
        loss.backward()
    out["loss"], out["loss_widest"] = loss.full_tensor().item(), mode.widest
    out["logits_grad"] = logits.grad.full_tensor().numpy()
    out["logits_placements"] = [str(p) for p in logits.placements]
    hidden = _place(t["hidden"], ("batch", "seq", "embed"), plan, mesh).requires_grad_()
    head = _place(t["head"], ("embed", "vocab"), plan, mesh).requires_grad_()
    head_fn = lambda h: plan.constrain(linear(h, head), ("batch", "seq", "vocab"))
    with _Widest() as mode:
        loss = chunked_cross_entropy(hidden, head_fn, labels, chunk=8)
        loss.backward()
    out["chunked"], out["chunked_widest"] = loss.full_tensor().item(), mode.widest
    out["hidden_grad"], out["head_grad"] = (x.grad.full_tensor().numpy() for x in (hidden, head))
    table = _place(t["table"], ("vocab", "embed"), plan, mesh).requires_grad_()
    tokens = _place(t["tokens"], ("batch", None), plan, mesh)
    with _Widest() as mode:
        rows = plan.constrain(take_embedding(table, tokens), ("batch", "seq", "embed"))
        (rows * _place(t["weight"], ("batch", "seq", "embed"), plan, mesh)).sum().backward()
    out["rows"], out["rows_widest"] = rows.full_tensor().detach().numpy(), mode.widest
    out["rows_placements"] = [str(p) for p in rows.placements]
    out["table_grad"] = table.grad.full_tensor().numpy()
    out["table_grad_placements"] = [str(p) for p in table.grad.placements]
    return out if dist.get_rank() == 0 else None


def _vocab_references(x):
    """(the port's unsharded results, the JAX package's), keyed as the ranks'."""
    import jax
    import jax.numpy as jnp

    from repro.models.layers import take_embedding as j_take
    from repro.train.loss import chunked_cross_entropy as j_chunked, cross_entropy as j_ce
    from repro_torch.models.layers import take_embedding
    from repro_torch.train.loss import chunked_cross_entropy, cross_entropy
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    port = {}
    logits = t["logits"].clone().requires_grad_()
    loss = cross_entropy(logits, t["labels"])
    loss.backward()
    port["loss"], port["logits_grad"] = loss.item(), logits.grad.numpy()
    hidden, head = (t[k].clone().requires_grad_() for k in ("hidden", "head"))
    loss = chunked_cross_entropy(hidden, lambda h: h @ head, t["labels"], chunk=8)
    loss.backward()
    port["chunked"], port["hidden_grad"], port["head_grad"] = (
        loss.item(), hidden.grad.numpy(), head.grad.numpy())
    table = t["table"].clone().requires_grad_()
    rows = take_embedding(table, t["tokens"])
    (rows * t["weight"]).sum().backward()
    port["rows"], port["table_grad"] = rows.detach().numpy(), table.grad.numpy()

    j = {k: jnp.asarray(v) for k, v in x.items()}
    lab = j["labels"].astype(jnp.int32)
    jl, jg = jax.value_and_grad(lambda lg: j_ce(lg, lab))(j["logits"])
    jc, (jh, jw) = jax.value_and_grad(
        lambda h, w: j_chunked(h, lambda c: c @ w, lab, chunk=8), argnums=(0, 1))(j["hidden"],
                                                                                   j["head"])
    jt = jax.grad(lambda tb: jnp.sum(j_take(tb, j["tokens"]) * j["weight"]))(j["table"])
    jax_out = dict(loss=float(jl), logits_grad=np.asarray(jg), chunked=float(jc),
                   hidden_grad=np.asarray(jh), head_grad=np.asarray(jw),
                   rows=np.asarray(j_take(j["table"], j["tokens"])), table_grad=np.asarray(jt))
    return port, jax_out


_VOCAB: dict = {}


def _vocab(shape):
    if shape not in _VOCAB:
        x = _vocab_inputs()
        _VOCAB[shape] = spawn.run(_vocab_rank, 4, shape, x, timeout=TIMEOUT)[0], \
            _vocab_references(x)
    return _VOCAB[shape]


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_vocab_split_loss_matches_unsharded_and_jax(shape):
    got, (port, jax_out) = _vocab(shape)
    assert got["logits_placements"][1] == "S(2)"  # 'model' splits the vocabulary
    for key in ("loss", "chunked"):
        _close(got[key], port[key], err_msg=key)
        _close(got[key], jax_out[key], 2e-5, err_msg=key)
    for key in ("logits_grad", "hidden_grad", "head_grad"):
        _close(got[key], port[key], err_msg=key)
        _close(got[key], jax_out[key], 2e-5, err_msg=key)
    n = shape[1]
    for key in ("loss_widest", "chunked_widest"):  # no local op held V columns
        assert got[key][3][-1] in (V // n, D) and got[key][2][-1] < V, (key, got[key])


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_vocab_split_embedding_matches_unsharded_and_jax(shape):
    got, (port, jax_out) = _vocab(shape)
    np.testing.assert_array_equal(got["rows"], port["rows"])  # one rank's row, zeros added
    _close(got["rows"], jax_out["rows"], 0)
    _close(got["table_grad"], port["table_grad"], err_msg="table")
    _close(got["table_grad"], jax_out["table_grad"], 2e-5, err_msg="table")
    assert got["rows_placements"][1] == "S(1)"  # reduce-scattered into ("batch", "seq", "embed")
    assert got["table_grad_placements"][1] == "S(0)"  # each rank's rows
    assert got["rows_widest"][0] < V * D  # no local op held the whole table


def _fsdp_rank(shape, x):
    """At batch 1 on ``shape``: the lookup of a table whose D columns 'data'
    splits, on those columns, and the tied head's product with a
    vocabulary of 250 that does not divide 'model', in decode's layout."""
    import torch.distributed as dist

    from repro_torch.models.layers import head_product, take_embedding
    mesh, plan = _mesh(shape)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    table = _place(t["table"], ("vocab", "embed"), plan, mesh).requires_grad_()
    tokens = _place(t["tokens"][:1], ("batch", None), plan, mesh)
    weight = _place(t["weight"][:1], ("batch", "seq", "embed"), plan, mesh)
    with _Widest() as mode:
        rows = plan.constrain(take_embedding(table, tokens), ("batch", "seq", "embed"))
    (rows * weight).sum().backward()
    out = dict(rows=rows.full_tensor().detach().numpy(), rows_widest=mode.widest,
               rows_placements=[str(p) for p in rows.placements],
               table_grad=table.grad.full_tensor().numpy(),
               table_grad_placements=[str(p) for p in table.grad.placements])
    head = _place(t["head250"], ("vocab", "embed"), plan, mesh)
    h = _place(t["hidden"][:, 0], ("batch", "embed"), plan, mesh)
    logits = head_product(h, head.T, plan)
    local = tuple(logits.to_local().shape)
    placed = [str(p) for p in logits.placements]
    logits = plan.constrain(logits, ("batch", "vocab"))
    out.update(logits=logits.full_tensor().numpy(), product_placements=placed)
    return out if dist.get_rank() == 0 else local


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=str)
def test_embedding_at_batch_1_looks_up_on_its_fsdp_shard(shape):
    """One row of tokens: each rank looks every token up in its own D
    columns of the table (and its own rows where 'model' splits the
    vocabulary), where gathering the table would move V x D; the rows and
    the table's gradient against the unsharded port and JAX."""
    import jax
    import jax.numpy as jnp

    from repro.models.layers import take_embedding as j_take
    from repro_torch.models.layers import take_embedding
    x = _vocab_inputs()
    x["head250"] = x["table"][:1]  # unused here
    got = spawn.run(_fsdp_rank, 4, shape, x, timeout=TIMEOUT)[0]
    table = torch.from_numpy(x["table"]).requires_grad_()
    tokens, weight = torch.from_numpy(x["tokens"][:1]), torch.from_numpy(x["weight"][:1])
    rows = take_embedding(table, tokens)
    (rows * weight).sum().backward()
    np.testing.assert_array_equal(got["rows"], rows.detach().numpy())
    jt = jnp.asarray(x["table"])
    _close(got["rows"], np.asarray(j_take(jt, jnp.asarray(x["tokens"][:1]))), 0)
    jg = jax.grad(lambda tb: jnp.sum(j_take(tb, jnp.asarray(x["tokens"][:1]))
                                     * jnp.asarray(x["weight"][:1])))(jt)
    _close(got["table_grad"], table.grad.numpy(), err_msg="table")
    _close(got["table_grad"], np.asarray(jg), 2e-5, err_msg="table")
    nd = shape[0]
    assert got["table_grad_placements"][0] == "S(1)"  # the gradient stays on D's shards
    assert got["rows_widest"][3][-1] == D // nd  # the lookup held no row's whole D


def test_tied_head_splits_an_undivided_vocabulary_over_an_idle_model():
    """Decode's rows leave 'model' idle and 250 words do not divide it: the
    head's vocabulary columns are split over it in pieces of 63 (the last
    61), each rank computing its own, and the logits laid out with the
    vocabulary whole, against the unsharded product and JAX."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    x = _vocab_inputs()
    x["head250"] = (rng.standard_normal((250, D)) / np.sqrt(D)).astype(np.float32)
    got, *locals_ = spawn.run(_fsdp_rank, 4, (1, 4), x, timeout=TIMEOUT)
    h, w = x["hidden"][:, 0], x["head250"]
    _close(got["logits"], (torch.from_numpy(h) @ torch.from_numpy(w).T).numpy())
    _close(got["logits"], np.asarray(jnp.asarray(h) @ jnp.asarray(w).T), 2e-5)
    assert got["logits"].shape == (B, 250)
    assert got["product_placements"] == ["R", "S(1)"]  # each rank's own columns
    assert locals_ == [(B, 63), (B, 63), (B, 61)]


# -- attention with q split over the sequence ------------------------------------

def _attention_inputs(t=64, h=6, g=2, hd=16):
    rng = np.random.default_rng(1)
    q, do = (rng.standard_normal((2, t, h, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, t, g, hd)).astype(np.float32) for _ in range(2))
    return dict(q=q, k=k, v=v, do=do)


def _attention_rank(shape, x, window):
    import torch.distributed as dist

    from repro_torch.kernels import ops
    mesh, plan = _mesh(shape)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    seen = []
    kernel = ops.flash_attention

    def recording(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), kw["q_offset"]))
        return kernel(q, k, v, **kw)

    ops.flash_attention = recording
    q = _place(t["q"], ("batch", "seq", None, None), plan, mesh).requires_grad_()
    k, v = (_place(t[n], ("batch", None, None, None), plan, mesh).requires_grad_()
            for n in ("k", "v"))
    o = ops.mha_flash(q, k, v, causal=True, window=window)
    o.backward(_place(t["do"], ("batch", "seq", None, None), plan, mesh))
    out = dict(seen=seen, o_placements=[str(p) for p in o.placements],
               o=o.full_tensor().detach().numpy(),
               grads=[x.grad.full_tensor().numpy() for x in (q, k, v)])
    return out if dist.get_rank() == 0 else {"seen": seen}


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_sequence_split_attention_matches_unsharded_and_jax(shape, window):
    import jax
    import jax.numpy as jnp

    from repro.models.attention import flash_attention_ref as jflash_ref
    from repro_torch.kernels import ops
    h = 3 if shape[1] == 2 else 6  # heads that do not divide 'model'
    x = _attention_inputs(h=h, g=1 if h == 3 else 2)
    ranks = spawn.run(_attention_rank, 4, shape, x, window, timeout=TIMEOUT)
    got = ranks[0]
    t = {k: torch.from_numpy(v).requires_grad_(k != "do") for k, v in x.items()}
    want = ops.mha_flash(t["q"], t["k"], t["v"], causal=True, window=window)
    want.backward(t["do"])
    g = x["k"].shape[2]
    rep = lambda a: jnp.repeat(a, h // g, 2)
    jo, jgrads = jax.vjp(lambda q, k, v: jflash_ref(q, rep(k), rep(v), jnp.arange(64),
                                                    window=window, kv_chunk=16),
                         *(jnp.asarray(x[n]) for n in ("q", "k", "v")))
    jgrads = jgrads(jnp.asarray(x["do"]))
    _close(got["o"], want.detach().numpy())
    _close(got["o"], np.asarray(jo), 2e-5)
    for name, a, b, c in zip("qkv", got["grads"], (t[n].grad for n in "qkv"), jgrads):
        _close(a, b.numpy(), err_msg=name)
        _close(a, np.asarray(c), 2e-5, err_msg=name)
    n = shape[1]
    assert got["o_placements"][1] == "S(1)"
    for rank, r in enumerate(ranks):  # each rank's own rows at its offset, all the keys
        (qs, ks, off), = r["seen"]
        assert qs[1] == 64 // n and ks[1] == 64 and off == (rank % n) * (64 // n)


# -- MoE --------------------------------------------------------------------------

MOE_CASES = [((2, 2), {}, 32), ((1, 4), {}, 32), ((1, 4), {"n_experts": 6}, 32),
             ((2, 2), {"n_experts": 3}, 32), ((1, 4), {}, 1), ((2, 2), {"n_experts": 3}, 1),
             ((1, 4), {"n_experts": 6, "d_ff": 32}, 64)]
# the cases whose ff columns are gathered for use (moe._ff_bytes: every row's
# capacity buffer and moving the rows cost more than gathering 32 columns)
FF_GATHERED = [((1, 4), {"n_experts": 6, "d_ff": 32}, 64)]


def _moe_inputs(spec, s, b=4):
    from repro_torch.models import moe
    from repro_torch.models.layers import init_tree
    params = init_tree(moe.moe_defs(spec), torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    return ({k: v.numpy() for k, v in params.items()},
            rng.standard_normal((b, s, spec.d_model)).astype(np.float32))


def _moe_rank(shape, kw, p, x):
    import torch.distributed as dist

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import moe
    from repro_torch.models.layers import axes_tree
    from repro_torch.parallel.sharding import distribute_tree
    moe.GROUP_SIZE = GROUP
    spec = reduced(ARCHS["granite-moe-3b-a800m"], **kw)
    mesh, plan = _mesh(shape)
    seen = []
    ffn = moe._expert_ffn

    def recording(xe, w_gate, w_up, w_down, contract=None):
        seen.append(tuple(w_gate.shape))
        return ffn(xe, w_gate, w_up, w_down, contract)

    moe._expert_ffn = recording
    params = distribute_tree({k: torch.from_numpy(v) for k, v in p.items()},
                             axes_tree(moe.moe_defs(spec)), plan, mesh)
    for t in params.values():
        t.requires_grad_()
    xd = _place(torch.from_numpy(x), ("batch", "seq", "embed"), plan, mesh).requires_grad_()
    y, aux = moe.moe_apply(params, xd, spec, plan)
    y = plan.constrain(y, ("batch", "seq", "embed"))
    (y.square().sum() + aux["lb_loss"]).backward()
    out = dict(seen=seen, y=y.full_tensor().detach().numpy(),
               aux={k: v.full_tensor().item() for k, v in aux.items()},
               grads={k: t.grad.full_tensor().numpy() for k, t in params.items()},
               x_grad=xd.grad.full_tensor().numpy(),
               w_placements=[str(p) for p in params["w_gate"].placements],
               w_grad_placements=[str(p) for p in params["w_gate"].grad.placements])
    return out if dist.get_rank() == 0 else None


def _moe_references(kw, p, x):
    import jax
    import jax.numpy as jnp

    import repro.models.moe as jmoe
    from repro.configs import ARCHS as JARCHS, reduced as jreduced
    from repro.parallel.sharding import NULL_PLAN as JNULL
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import moe
    spec, jspec = reduced(ARCHS["granite-moe-3b-a800m"], **kw), \
        jreduced(JARCHS["granite-moe-3b-a800m"], **kw)
    saved = moe.GROUP_SIZE, jmoe.GROUP_SIZE
    moe.GROUP_SIZE = jmoe.GROUP_SIZE = GROUP
    try:
        params = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
        xt = torch.from_numpy(x).requires_grad_()
        y, aux = moe.moe_apply(params, xt, spec)
        (y.square().sum() + aux["lb_loss"]).backward()
        port = dict(y=y.detach().numpy(), aux={k: v.item() for k, v in aux.items()},
                    grads={k: t.grad.numpy() for k, t in params.items()}, x_grad=xt.grad.numpy())

        def jloss(jp, jx):
            jy, jaux = jmoe.moe_apply(jp, jx, jspec, JNULL)
            return jnp.sum(jy * jy) + jaux["lb_loss"], (jy, jaux)

        (_, (jy, jaux)), (jg, jxg) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    finally:
        moe.GROUP_SIZE, jmoe.GROUP_SIZE = saved
    jax_out = dict(y=np.asarray(jy), aux={k: float(v) for k, v in jaux.items()},
                   grads={k: np.asarray(v) for k, v in jg.items()}, x_grad=np.asarray(jxg))
    return port, jax_out


@pytest.mark.parametrize("shape,kw,s", MOE_CASES, ids=lambda c: str(c).replace(" ", ""))
def test_moe_on_its_shards_matches_unsharded_and_jax(shape, kw, s):
    """In the decode step (S = 1, a row a 'data' rank) the experts also keep
    their FSDP split of D over 'data' (moving the rows costs less than
    gathering the experts); the prefill-sized cases gather it.  Ff columns
    stay split where every rank routing every row of its 'data' share costs
    less than gathering them (``FF_GATHERED`` the one case where not)."""
    from repro_torch.configs import ARCHS, reduced
    spec = reduced(ARCHS["granite-moe-3b-a800m"], **kw)
    p, x = _moe_inputs(spec, s)
    got = spawn.run(_moe_rank, 4, shape, kw, p, x, timeout=TIMEOUT)[0]
    port, jax_out = _moe_references(kw, p, x)
    for ref in (port, jax_out):
        tol = 1e-5 if ref is port else 2e-5
        _close(got["y"], ref["y"], tol)
        for k in ("lb_loss", "drop_frac"):
            _close(got["aux"][k], ref["aux"][k], tol, err_msg=k)
        _close(got["x_grad"], ref["x_grad"], tol, err_msg="x")
        for k, g in got["grads"].items():
            _close(g, ref["grads"][k], tol, err_msg=k)
    e, f, n = spec.n_experts, spec.d_ff, shape[1]
    split_experts = e % n == 0
    assert got["w_placements"][1] == ("S(0)" if split_experts else "S(2)")
    assert got["w_grad_placements"] == got["w_placements"]  # the gradient back on the split
    d = spec.d_model // shape[0] if s == 1 else spec.d_model
    want = (e // n, d, f) if split_experts else (e, d, f // n)
    if (shape, kw, s) in FF_GATHERED:  # whole experts on each rank's own groups
        want = (e, d, f)
    assert got["seen"] and set(got["seen"]) == {want}  # else no rank held every expert whole


# batch 1 ('data' splits no rows; x's D columns split over it instead) on
# (4, 1) and (2, 2), a prompt of 32 (four routing groups) and a decode step
MOE_BATCH1_CASES = [((4, 1), {}, 32), ((2, 2), {}, 32), ((4, 1), {}, 1),
                    ((2, 2), {"n_experts": 3}, 1)]


@pytest.mark.parametrize("shape,kw,s", MOE_BATCH1_CASES, ids=lambda c: str(c).replace(" ", ""))
def test_moe_at_batch_1_runs_on_its_fsdp_shards(shape, kw, s):
    """At batch 1 gathering the experts' D split over 'data' would move far
    more than x does (``moe._fsdp_bytes``), so the router and the experts
    run on each rank's D rows, their partial sums summed over 'data', and y
    is each rank's D columns: y, the balance loss, the dropped share and
    every gradient against the unsharded port and JAX; every expert call
    saw its D shard, and w_gate's gradient stays on it."""
    from repro_torch.configs import ARCHS, reduced
    spec = reduced(ARCHS["granite-moe-3b-a800m"], **kw)
    p, x = _moe_inputs(spec, s, b=1)
    got = spawn.run(_moe_rank, 4, shape, kw, p, x, timeout=TIMEOUT)[0]
    port, jax_out = _moe_references(kw, p, x)
    for ref in (port, jax_out):
        tol = 1e-5 if ref is port else 2e-5
        _close(got["y"], ref["y"], tol)
        for k in ("lb_loss", "drop_frac"):
            _close(got["aux"][k], ref["aux"][k], tol, err_msg=k)
        _close(got["x_grad"], ref["x_grad"], tol, err_msg="x")
        for k, g in got["grads"].items():
            _close(g, ref["grads"][k], tol, err_msg=k)
    e, f, (nd, nm) = spec.n_experts, spec.d_ff, shape
    el, fl = (e // nm, f) if e % nm == 0 else (e, f // nm)
    assert got["w_placements"][0] == got["w_grad_placements"][0] == "S(1)"  # D over 'data'
    assert got["seen"] and set(got["seen"]) == {(el, spec.d_model // nd, fl)}


def test_moe_train_step_gathers_ff_columns_matches_unsharded_and_jax():
    """Reduced granite with 6 experts of 32 ff columns on (1, 4), at routing
    groups of 8 tokens and a (8, 32) batch: gathering the columns costs less
    than every rank routing every row and holding its capacity buffer
    (``moe._ff_bytes``), so each rank runs its own groups through whole
    experts, forward and backward, and the weights' gradients go back to
    their ff split; two train steps against the unsharded step and the JAX
    step (``tests/test_torch_parallel_train.py``'s harness)."""
    from test_torch_parallel_train import MOE_GROUP, _check, _references, _sharded
    arch, kw = "granite-moe-3b-a800m", {"n_experts": 6, "d_ff": 32}
    ranks = _sharded(arch, kw, (1, 4), [("dots", True, 1)], MOE_GROUP)
    _check(ranks, _references(arch, kw, "dots", 1, MOE_GROUP), 0)
    assert all(r[0]["ffn_seen"] == [(6, 64, 32)] for r in ranks)


# -- the split softmax ------------------------------------------------------------

def _softmax_rank(s):
    import torch.distributed as dist

    from repro_torch.models.attention import split_softmax
    part = torch.from_numpy(s).chunk(dist.get_world_size(), dim=-1)[dist.get_rank()]
    return split_softmax(part, [dist.group.WORLD]).numpy()


def test_split_softmax_matches_the_whole_row():
    """Decode's softmax over a kv_seq split four ways (``split_softmax``):
    random scores in four shards of a row, the third all ``NEG_INF`` (slots
    past the position), against ``torch.softmax`` of the whole row; the
    masked shard comes out 0, nothing NaN."""
    from repro_torch.kernels.ref import NEG_INF
    s = np.random.default_rng(3).standard_normal((2, 3, 4, 32)).astype(np.float32) * 4
    s[..., 16:24] = NEG_INF
    got = np.concatenate(spawn.run(_softmax_rank, 4, s, timeout=TIMEOUT), axis=-1)
    _close(got, torch.softmax(torch.from_numpy(s), dim=-1).numpy())
    assert np.isfinite(got).all() and (got[..., 16:24] == 0).all()
