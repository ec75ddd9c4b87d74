"""The SSD scan's backward on the CPU: ``ssd_scan_bwd_plain`` (the chunk
algebra of ``csrc/ssd_scan_bwd.cu`` in plain torch) and ``ops.ssd`` under
grad against autograd through the plain forward and against ``jax.vjp`` of
the JAX package's ``models/mamba.py`` ``ssd_chunked`` and ``kernels/ref.py``
``ssd_ref``; and the plain versions on head_dim slices of 1 and 4 columns
(what a head_dim split over a mesh axis leaves a rank), against the JAX
``ssd_chunked`` on the same slice, stitched back against the whole scan.

Inputs come from seeded numpy, and every case but those of an unused output
has a nonzero cotangent for the final state as well as for y.  Tolerance:
rtol 1e-5 and atol 1e-5 of each gradient's largest |g|, in f32: the chunked
backward and autodiff of the forward sum the same products in other orders
through exp, and an element of dt's or a's gradient sums many terms that
cancel, so rounding shows against the tensor's scale.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models.mamba import ssd_chunked as jssd_chunked
from repro_torch.kernels import ops, ssd_scan as ss

TOL = 1e-5
NAMES = ("dx", "ddt", "da", "db", "dc")


def _inputs(seed, b, s, h, g, p, n, ranges):
    """x, dt, a, b, c and the cotangents dy, dstate.  ``random``: dt =
    softplus(randn), a = -exp(randn), which forget within a few steps;
    ``model``: dt in [1e-3, 1e-1], a in [-16, -1], whose memory spans many
    chunks."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    if ranges == "random":
        dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
        a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    else:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h))).astype(np.float32)
        a = -rng.uniform(1.0, 16.0, h).astype(np.float32)
    bb = rng.standard_normal((b, s, g, n), dtype=np.float32)
    cc = rng.standard_normal((b, s, g, n), dtype=np.float32)
    dy = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dstate = rng.standard_normal((b, h, p, n), dtype=np.float32)
    return (x, dt, a, bb, cc), dy, dstate


def _assert_grads_close(got, want):
    for name, gv, wv in zip(NAMES, got, want):
        gv = gv.float().numpy() if isinstance(gv, torch.Tensor) else np.asarray(gv, np.float32)
        wv = wv.float().numpy() if isinstance(wv, torch.Tensor) else np.asarray(wv, np.float32)
        assert gv.shape == wv.shape, name
        np.testing.assert_allclose(gv, wv, rtol=TOL, atol=TOL * np.abs(wv).max(), err_msg=name)


def _autograd_plain(args, dy, dstate):
    leaves = [torch.from_numpy(t).requires_grad_() for t in args]
    y, state = ss.ssd_scan_plain(*leaves)
    return torch.autograd.grad((y, state), leaves, (torch.from_numpy(dy), torch.from_numpy(dstate)))


def _jax_chunked_vjp(args, dy, dstate, chunk):
    _, vjp = jax.vjp(lambda *t: jssd_chunked(*t, chunk=chunk), *map(jnp.asarray, args))
    return vjp((jnp.asarray(dy), jnp.asarray(dstate)))


def _jax_ref_vjp(args, dy, dstate):
    """jax.vjp of ``ref.ssd_ref`` on the folded layout, groups repeated over
    heads: the transposes sum them back, and a's over the batch."""
    b, s, h, _ = args[0].shape
    rep = h // args[3].shape[2]

    def f(x, dt, a, bb, cc):
        fold = lambda t: jnp.moveaxis(t, 2, 1).reshape(b * h, s, *t.shape[3:])
        y, hl = jref.ssd_ref(fold(x), fold(dt), jnp.tile(a, b), fold(jnp.repeat(bb, rep, 2)),
                             fold(jnp.repeat(cc, rep, 2)))
        return (jnp.moveaxis(y.reshape(b, h, s, -1), 1, 2),
                jnp.swapaxes(hl.reshape(b, h, *hl.shape[1:]), 2, 3))

    _, vjp = jax.vjp(f, *map(jnp.asarray, args))
    return vjp((jnp.asarray(dy), jnp.asarray(dstate)))


def _plain_bwd(args, dy, dstate):
    return ss.ssd_scan_bwd_plain(*map(torch.from_numpy, (*args, dy, dstate)))


CASES = [
    (2, 128, 4, 1, 16, 32),   # G = 1
    (2, 192, 4, 2, 16, 16),   # G = 2 with H = 4
    (1, 64, 2, 2, 32, 16),    # one chunk: no state carried in
]


@pytest.mark.parametrize("b,s,h,g,p,n", CASES)
@pytest.mark.parametrize("ranges", ["random", "model"])
def test_plain_backward_matches_autograd_through_the_plain_forward(b, s, h, g, p, n, ranges):
    args, dy, dstate = _inputs(20, b, s, h, g, p, n, ranges)
    _assert_grads_close(_plain_bwd(args, dy, dstate), _autograd_plain(args, dy, dstate))


@pytest.mark.parametrize("b,s,h,g,p,n", CASES)
@pytest.mark.parametrize("ranges", ["random", "model"])
def test_plain_backward_matches_jax_vjp_of_ssd_chunked(b, s, h, g, p, n, ranges):
    """The JAX trainer's gradient: autodiff of its jnp ``ssd_chunked``, at a
    chunk that divides S (its own 64, and 32)."""
    args, dy, dstate = _inputs(21, b, s, h, g, p, n, ranges)
    want = _jax_chunked_vjp(args, dy, dstate, chunk=64)
    _assert_grads_close(_plain_bwd(args, dy, dstate), want)
    _assert_grads_close(_plain_bwd(args, dy, dstate), _jax_chunked_vjp(args, dy, dstate, 32))


@pytest.mark.parametrize("h,g", [(4, 1), (4, 2)])
@pytest.mark.parametrize("ranges", ["random", "model"])
def test_plain_backward_ragged_length_matches_jax_vjp_of_ssd_ref(h, g, ranges):
    """S = 200 is no chunk multiple: the last chunk's rows past S are zero
    padding.  The JAX ``ssd_chunked`` asserts on such S, so the reference is
    the sequential ``ref.ssd_ref``."""
    args, dy, dstate = _inputs(22, 2, 200, h, g, 16, 16, ranges)
    _assert_grads_close(_plain_bwd(args, dy, dstate), _jax_ref_vjp(args, dy, dstate))


def test_plain_backward_without_a_state_gradient():
    """dstate None is a zero cotangent for the final state."""
    args, dy, dstate = _inputs(23, 1, 130, 4, 2, 16, 16, "model")
    got = ss.ssd_scan_bwd_plain(*map(torch.from_numpy, (*args, dy)), None)
    _assert_grads_close(got, _autograd_plain(args, dy, np.zeros_like(dstate)))


@pytest.mark.parametrize("g", [1, 2])
def test_plain_backward_keeps_the_input_dtypes(g):
    """bf16 x, b, c and dy: computed in f32, dx, db and dc come back in bf16
    and ddt and da in f32, as the kernels return them.  Against autograd
    through the plain forward on the same bf16 inputs: ddt and da at the f32
    tolerance; dx, db and dc at the card's bf16 tolerance, 2e-2 of each
    gradient's largest |g|, since autograd rounds each head's share to bf16
    before it sums a group's heads."""
    args, dy, dstate = _inputs(24, 1, 100, 4, g, 16, 16, "random")
    bf16 = torch.bfloat16
    x, dt, a, bb, cc = map(torch.from_numpy, args)
    x, bb, cc = (t.to(bf16) for t in (x, bb, cc))
    dy_t, dstate_t = torch.from_numpy(dy).to(bf16), torch.from_numpy(dstate)
    got = ss.ssd_scan_bwd_plain(x, dt, a, bb, cc, dy_t, dstate_t)
    assert [t.dtype for t in got] == [bf16, torch.float32, torch.float32, bf16, bf16]
    leaves = [t.detach().requires_grad_() for t in (x, dt, a, bb, cc)]
    y, state = ss.ssd_scan_plain(*leaves)
    want = torch.autograd.grad((y, state), leaves, (dy_t, dstate_t))
    for name, gv, wv in zip(NAMES, got, want):
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, name
        gv, wv = gv.float().numpy(), wv.float().numpy()
        tol = 2e-2 if name in ("dx", "db", "dc") else TOL
        np.testing.assert_allclose(gv, wv, rtol=tol, atol=tol * np.abs(wv).max(), err_msg=name)


@pytest.mark.parametrize("which", ["both", "y", "state"])
def test_ops_ssd_on_cpu_differentiates_the_plain_version(which):
    """``ops.ssd`` on CPU tensors under grad: autograd through the plain
    forward (the kernels' plain version in the PERF.md sense), never
    ``SSDScanFn``, no kernel launch counted, and an output not used takes
    no part in the gradient."""
    args, dy, dstate = _inputs(26, 2, 100, 4, 2, 16, 16, "model")
    if which == "y":
        dstate = np.zeros_like(dstate)
    elif which == "state":
        dy = np.zeros_like(dy)
    before = (ss.ssd_scan.launches, ss.ssd_scan_bwd.launches)
    leaves = [torch.from_numpy(t).requires_grad_() for t in args]
    y, state = ops.ssd(*leaves)
    assert "SSDScanFn" not in type(y.grad_fn).__name__
    outs = {"both": (y, state), "y": (y,), "state": (state,)}[which]
    cots = {"both": (dy, dstate), "y": (dy,), "state": (dstate,)}[which]
    got = torch.autograd.grad(outs, leaves, tuple(map(torch.from_numpy, cots)),
                              allow_unused=True)  # c takes no part in the final state
    got = [torch.zeros_like(t) if gv is None else gv for t, gv in zip(leaves, got)]
    assert (ss.ssd_scan.launches, ss.ssd_scan_bwd.launches) == before
    _assert_grads_close(got, _autograd_plain(args, dy, dstate))
    _assert_grads_close(got, _plain_bwd(args, dy, dstate))


def test_bwd_scratch_holds_state_gradients_and_each_heads_db_dc():
    """Per (batch, head) and chunk an (N, P) state gradient and a share of da;
    dB and dC once per head-block, whose heads the kernel sums in registers:
    at mamba2-130m's train shape 8 heads a block, 3 blocks a row."""
    assert ss.bwd_scratch_floats(4, 4096, 24, 1, 64, 128) == (
        4 * 24 * 64 * (128 * 64 + 1) + 2 * 4 * 4096 * 3 * 128)
    assert ss.bwd_scratch_floats(1, 1, 1, 1, 16, 16) == 16 * 16 + 1 + 2 * 16


def test_bwd_scratch_of_narrow_head_dims_takes_the_tiles_width():
    """Head dims below 16 pack 16 / P heads into a tile of 16 columns, and
    the state scratch keeps each head's own P columns: (N, P) a chunk, P / 16
    of a tile's width, in the forward's scratch and the backward's state
    gradients; the backward's own part beside them is W per head-block."""
    b, s, h, g, n = 4, 4096, 24, 1, 128
    nc = s // ss.CHUNK
    for p in (1, 2, 4, 8):
        assert ss.heads_per_tile(p) * p == 16
        assert ss.scratch_floats(b, s, h, p, n) * 16 == \
            ss.scratch_floats(b, s, h, 16, n) * p + b * h * nc * (16 - p)
        _, tiles, kt = ss.narrow_blocks(b, s, h, g, p)
        assert ss.bwd_scratch_floats(b, s, h, g, p, n) == \
            ss.scratch_floats(b, s, h, p, n) + b * nc * g * (tiles // kt) * ss.CHUNK ** 2
    assert ss.heads_per_tile(64) == 1 and ss.DIMS[:4] == (1, 2, 4, 8)


def _column_slices(p, width=16):
    return [slice(i, i + p) for i in range(0, width, p)]


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("g", [1, 2])
def test_plain_versions_on_a_head_dim_slice_match_jax_and_stitch_back(p, g):
    """A head_dim of 16 split into slices of ``p`` columns (the head_dim split
    over a mesh axis: 64 on 16 ranks is 4, reduced mamba2's 16 on 16 is 1):
    on each slice the plain forward and backward against the JAX
    ``ssd_chunked`` and ``jax.vjp`` of it on the same slice; the slices'
    y, final state and dx stitched back, and their dt, a, B and C gradients
    summed (each rank's share), against the whole scan's."""
    args, dy, dstate = _inputs(28, 2, 128, 4, g, 16, 16, "model")
    x, dt, a, bb, cc = args
    whole_y, whole_state = ss.ssd_scan_plain(*map(torch.from_numpy, args))
    whole = _plain_bwd(args, dy, dstate)
    ys, states, dxs, shared = [], [], [], None
    for sl in _column_slices(p):
        part = (np.ascontiguousarray(x[..., sl]), dt, a, bb, cc)
        dy_p, ds_p = np.ascontiguousarray(dy[..., sl]), np.ascontiguousarray(dstate[:, :, sl])
        y, state = ss.ssd_scan_plain(*map(torch.from_numpy, part))
        jy, jstate = jssd_chunked(*map(jnp.asarray, part), chunk=64)
        for got, want in ((y, jy), (state, jstate)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                       atol=TOL * np.abs(np.asarray(want)).max())
        grads = _plain_bwd(part, dy_p, ds_p)
        _assert_grads_close(grads, _jax_chunked_vjp(part, dy_p, ds_p, chunk=64))
        ys.append(y), states.append(state), dxs.append(grads[0])
        shared = list(grads[1:]) if shared is None else [u + v for u, v in zip(shared, grads[1:])]
    for got, want in ((torch.cat(ys, -1), whole_y), (torch.cat(states, 2), whole_state)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL * want.abs().max().item())
    _assert_grads_close([torch.cat(dxs, -1), *shared], whole)


@pytest.mark.parametrize("b,s,h,g,kh", [
    (4, 4096, 24, 1, 8),   # mamba2-130m's train shape: 768 blocks, 3 head-blocks a group
    (2, 4096, 12, 2, 3),   # 2 head-blocks a group of 6
    (2, 4096, 16, 2, 4),   # 2 head-blocks a group of 8
    (2, 1000, 8, 2, 1),    # too few chunks for 512 blocks of 2
    (4, 4096, 24, 24, 1),  # one head a group
])
def test_heads_per_block_rule(b, s, h, g, kh):
    """The wrapper's copy of the kernels' rule (csrc/ssd_scan.cuh): the most
    heads of one group, up to 8, that leave 512 blocks of B*H*nc."""
    assert ss.heads_per_block(h // g, b * h * -(-s // ss.CHUNK)) == kh


def test_ssd_backward_wrapper_refuses_cpu_tensors():
    """The kernels' entry takes CUDA tensors only (the CPU differentiates
    through the plain versions)."""
    args, dy, dstate = _inputs(27, 1, 64, 2, 1, 16, 16, "model")
    x, dt, a, bb, cc = map(torch.from_numpy, args)
    scratch = torch.zeros(ss.scratch_floats(1, 64, 2, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan_bwd(x, dt, a, bb, cc, scratch, torch.from_numpy(dy), torch.from_numpy(dstate))
