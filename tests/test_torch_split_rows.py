"""The split-row RMSNorm and the fused NLL on the CPU, against the JAX package.

Split rows.  A row whose columns several ranks hold (mamba2's gated norm on
its d_inner split over 'model') is normalised by the kernels' split-row mode:
each rank's partial sum of squares (``ref.rmsnorm_part_ref``), the sums
all-reduced, each rank's columns scaled (``ref.rmsnorm_apply_ref``); the
backward's sum of ``g * (1 + w) * x`` the same way, then
``ref.rmsnorm_split_bwd_ref``.  Here a row of 128 columns is cut into 4
ragged pieces (40, 24, 33 and 31 columns), their sums added as the
all-reduce adds them, and the pieces joined again are held against the JAX
``layers.rmsnorm`` (``src/repro/models/layers.py:81``) on the whole row and
its ``jax.vjp``: f32 at rtol 1e-5 (an atol of 1e-5 of the largest element
for the gradients, whose elements sum products that cancel); bf16 inputs
against the JAX layer run in f32 on the same (bf16-exact) values at 1e-2,
since the port multiplies by ``1 + w`` in f32 and casts once where the JAX
layer casts before that multiply (``kernels/rmsnorm.py``), and the port's
dx and dw are rounded to bf16 once.  ``rmsnorm_split`` (the autograd
Function the models take) runs the same pieces, its ``reduce`` adding the
other pieces' sums.

Fused NLL.  The unsplit vocabulary's loss (``loss._local_nll_sum``) goes
through ``VocabShardNLL`` with no group: the value is the same bits as the
plain version it replaces (``_plain_nll_sum`` below, copied from the parent
tree: ``logsumexp`` of the f32 logits, the gold logit gathered) in f32 and
bf16, and the gradient, written into one buffer of the logits' dtype (bf16
by blocks of rows in f32), is held against autograd of that plain version
(f32 at rtol 1e-6 with an atol of 1e-6 of the largest element; bf16 within
one bf16 rounding, 2 ** -8 relative) and against ``jax.vjp`` of the JAX
``cross_entropy`` (f32, 1e-5).  The backward makes one new storage as
large as the logits, where autograd of the plain version makes six (seven
for bf16 logits): that assertion fails on the parent tree.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models.layers import rmsnorm as j_rmsnorm
from repro.train.loss import cross_entropy as j_cross_entropy
from repro_torch.kernels import ref, rmsnorm as rn
from repro_torch.train import loss as L

D, ROWS = 128, 24
PIECES = (40, 24, 33, 31)  # a row's columns on 4 ranks, ragged
EPS = 1e-5


def _inputs(dtype):
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((ROWS, D))).astype(np.float32)
    w = (0.1 * rng.standard_normal(D)).astype(np.float32)
    g = rng.standard_normal((ROWS, D)).astype(np.float32)
    t = [torch.from_numpy(a).to(dtype) for a in (x, w, g)]
    return t, [a.float().numpy() for a in t]  # the torch inputs, their exact f32 values


def _jax(x, w, g):
    y, vjp = jax.vjp(lambda a, b: j_rmsnorm(a, b, EPS), jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    return [np.asarray(a) for a in (y, dx, dw)]


def _close(got, want, tol, err_msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max(),
                               err_msg=err_msg)


def _cuts():
    edges = np.cumsum((0,) + PIECES)
    return [slice(a, b) for a, b in zip(edges[:-1], edges[1:])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_split_row_plain_twins_match_jax_rmsnorm_and_its_vjp(dtype):
    (x, w, g), exact = _inputs(dtype)
    cuts = _cuts()
    ss = sum(ref.rmsnorm_part_ref(x[:, c]) for c in cuts)  # the all-reduce
    st = sum(ref.rmsnorm_part_ref(x[:, c], w[c], g[:, c]) for c in cuts)
    y = torch.cat([ref.rmsnorm_apply_ref(x[:, c], w[c], ss, d_full=D, eps=EPS) for c in cuts], 1)
    parts = [ref.rmsnorm_split_bwd_ref(x[:, c], w[c], g[:, c], ss, st, d_full=D, eps=EPS)
             for c in cuts]
    dx, dw = torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts])
    assert y.dtype == dx.dtype == dtype and dw.dtype == dtype
    jy, jdx, jdw = _jax(*exact)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, got, want in (("y", y, jy), ("dx", dx, jdx), ("dw", dw, jdw)):
        _close(got.float(), want, tol, name)
    # the pieces' forward is the whole-row plain version's to the f32 sum's rounding
    _close(y.float(), ref.rmsnorm_ref(x, w, eps=EPS).float(),
           1e-6 if dtype == torch.float32 else 2 ** -8, "whole row")


class _PieceSums:
    """A ``reduce`` for one piece: its partial sum plus the other pieces'
    (the forward's sum of squares, then the backward's sum of g (1 + w) x),
    as the all-reduce over the ranks that hold them gives it."""

    def __init__(self, x, w, g, cut, cuts):
        others = [c for c in cuts if c != cut]
        self.extra = [sum(ref.rmsnorm_part_ref(x[:, c]) for c in others),
                      sum(ref.rmsnorm_part_ref(x[:, c], w[c], g[:, c]) for c in others)]
        self.calls = 0

    def __call__(self, t):
        self.calls += 1
        return t + self.extra[self.calls - 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_rmsnorm_split_function_matches_jax_on_ragged_pieces(dtype):
    (x, w, g), exact = _inputs(dtype)
    cuts = _cuts()
    ys, dxs, dws = [], [], []
    for c in cuts:
        reduce = _PieceSums(x, w, g, c, cuts)
        xl, wl = x[:, c].clone().requires_grad_(), w[c].clone().requires_grad_()
        y = rn.rmsnorm_split(xl, wl, eps=EPS, d_full=D, reduce=reduce)
        dx, dw = torch.autograd.grad(y, (xl, wl), g[:, c])
        assert reduce.calls == 2  # once forward, once backward
        ys.append(y.detach())
        dxs.append(dx)
        dws.append(dw)
    jy, jdx, jdw = _jax(*exact)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    _close(torch.cat(ys, 1).float(), jy, tol, "y")
    _close(torch.cat(dxs, 1).float(), jdx, tol, "dx")
    _close(torch.cat(dws).float(), jdw, tol, "dw")


def test_rmsnorm_split_refuses_a_piece_wider_than_its_row():
    x, w = torch.ones(2, 8), torch.zeros(8)
    with pytest.raises(ValueError):
        rn.rmsnorm_split(x, w, d_full=4, reduce=lambda t: t)
    with pytest.raises(ValueError):
        rn.rmsnorm_split(x, torch.zeros(7), d_full=8, reduce=lambda t: t)


# -- the fused NLL --------------------------------------------------------------------

B, S, V = 3, 37, 1001


def _plain_nll_sum(logits, labels, ignore_index: int):
    """The parent tree's ``_local_nll_sum``: autograd of the plain version."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels != ignore_index).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def _nll_inputs(dtype):
    rng = np.random.default_rng(1)
    logits = torch.from_numpy((3 * rng.standard_normal((B, S, V))).astype(np.float32)).to(dtype)
    labels = torch.from_numpy(rng.integers(0, V, (B, S)))
    labels[0, :5] = -1  # ignored positions
    return logits, labels


class _Big(TorchDispatchMode):
    """Counts the new storages of at least ``n`` elements that ops make (a
    view's or an in-place op's output is its input's storage)."""

    def __init__(self, n):
        super().__init__()
        self.n, self.count = n, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        given = {a.untyped_storage().data_ptr() for a in [*args, *kwargs.values()]
                 if isinstance(a, torch.Tensor)}
        for t in out if isinstance(out, (tuple, list)) else (out,):
            self.count += (isinstance(t, torch.Tensor) and t.numel() >= self.n
                           and t.untyped_storage().data_ptr() not in given)
        return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_fused_nll_keeps_the_value_and_writes_one_gradient_buffer(dtype, monkeypatch):
    """The value bit for bit with the plain version; the gradient within one
    rounding of autograd's, from one logits-sized buffer (the parent tree's
    autograd made six, seven for bf16 logits)."""
    logits, labels = _nll_inputs(dtype)
    lp, lf = (logits.clone().requires_grad_() for _ in range(2))
    tot, cnt = _plain_nll_sum(lp, labels, -1)
    got_tot, got_cnt = L._local_nll_sum(lf, labels, -1)
    assert torch.equal(got_tot, tot) and torch.equal(got_cnt, cnt)
    want, = torch.autograd.grad(tot / cnt, lp)
    monkeypatch.setattr(L, "NLL_BLOCK", 10 * V + 7)  # several blocks of rows, the last short
    with _Big(logits.numel()) as big:
        got, = torch.autograd.grad(got_tot / got_cnt, lf)
    assert got.dtype == dtype and big.count == 1
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    _close(got.float(), want.float(), tol, "grad")
    monkeypatch.setattr(L, "NLL_BLOCK", 1 << 30)  # one block: the same bits
    lf2 = logits.clone().requires_grad_()
    t2, c2 = L._local_nll_sum(lf2, labels, -1)
    assert torch.equal(torch.autograd.grad(t2 / c2, lf2)[0], got)


def test_fused_nll_matches_jax_cross_entropy_and_its_vjp():
    logits, labels = _nll_inputs(torch.float32)
    lf = logits.clone().requires_grad_()
    loss = L.cross_entropy(lf, labels)
    got, = torch.autograd.grad(loss, lf)
    jl, vjp = jax.vjp(lambda a: j_cross_entropy(a, jnp.asarray(labels.numpy(), jnp.int32)),
                      jnp.asarray(logits.numpy()))
    _close(loss.item(), float(jl), 1e-6, "loss")
    _close(got, np.asarray(vjp(jnp.float32(1.0))[0]), 1e-5, "grad")
