"""The port's kernel wrappers (plain path, CPU) vs the JAX package's kernels.

Inputs come from seeded numpy and go to both packages.  JAX runs its Pallas
kernels in interpret mode through ``repro.kernels.ops``, at the shapes of
``tests/test_kernels.py``; the port's ``ops`` take the kernels' plain
versions for CPU tensors.  Tolerances: 2e-5 in f32 (the same math in another
summation order), 2e-2 in bf16 (one bf16 rounding of the output).  The SSD
scan is held at 1e-4 of max |y| (and of max |state|), as the JAX test holds
its kernel: the chunked form and the sequential recurrence sum in other
orders through exp.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.mamba import ssd_chunked as jssd_chunked
from repro_torch.kernels import _build, flash_attention as fa
from repro_torch.kernels import ops, ref, rmsnorm as rn, ssd_scan as ss
from repro_torch.models import mamba as mb

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _pair(a, name):
    jd, td = DTYPES[name]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _qkv(seed, b, s, t, h, g, hd, name):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, t, g, hd), dtype=np.float32)
    v = rng.standard_normal((b, t, g, hd), dtype=np.float32)
    return _pair(q, name), _pair(k, name), _pair(v, name)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("b,s,h,g,hd", [
    (2, 256, 4, 2, 64),
    (1, 128, 2, 2, 32),
    (2, 128, 8, 1, 16),
    (1, 512, 4, 4, 64),
    (1, 128, 4, 1, 256),  # gemma3's head_dim and 4:1 grouping
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mha_flash_causal_matches_jax(b, s, h, g, hd, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(0, b, s, s, h, g, hd, dtype)
    expect = jops.mha_flash(jq, jk, jv, causal=True, block_q=64, block_k=64)
    got = ops.mha_flash(tq, tk, tv, causal=True)
    assert got.shape == (b, s, h, hd) and got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(expect), **_tol(dtype))


@pytest.mark.parametrize("window", [32, 64, 128])
@pytest.mark.parametrize("h,g", [(2, 2), (4, 2)])
def test_mha_flash_sliding_window_matches_jax(window, h, g):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 1, 256, 256, h, g, 32, "float32")
    expect = jops.mha_flash(jq, jk, jv, causal=True, window=window, block_q=64, block_k=64)
    got = ops.mha_flash(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(expect), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [16, 100])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mha_flash_sliding_window_at_head_dim_256_matches_jax(window, dtype):
    """gemma3's local layers: head_dim 256, 4 query heads on 1 KV group."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(4, 1, 256, 256, 4, 1, 256, dtype)
    expect = jops.mha_flash(jq, jk, jv, causal=True, window=window, block_q=64, block_k=64)
    got = ops.mha_flash(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(expect), **_tol(dtype))


@pytest.mark.parametrize("h,g,window", [(2, 2, 0), (4, 2, 0), (4, 1, 48)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mha_flash_ragged_length_matches_jax_ref(h, g, window, dtype):
    """S = T = 200 is no block multiple: the JAX wrapper asserts on it, so the
    reference is ``repro.kernels.ref.attention_ref`` on the repeated heads."""
    b, s, hd = 2, 200, 64
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, b, s, s, h, g, hd, dtype)
    fold = lambda x: jnp.repeat(x, h // x.shape[2], 2).transpose(0, 2, 1, 3).reshape(b * h, s, hd)
    expect = jref.attention_ref(fold(jq), fold(jk), fold(jv), causal=True, window=window)
    expect = np.asarray(expect, np.float32).reshape(b, h, s, hd).transpose(0, 2, 1, 3)
    got = ops.mha_flash(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_np(got), expect, **_tol(dtype))


def test_flash_plain_version_is_not_counted_as_a_launch():
    (_, tq), (_, tk), (_, tv) = _qkv(3, 1, 64, 64, 2, 1, 16, "float32")
    before = fa.flash_attention.launches
    ops.mha_flash(tq, tk, tv)
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("bad", ["device", "groups", "dtype"])
def test_flash_wrapper_rejects_what_the_kernel_cannot_take(bad):
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    if bad == "device":
        q, k = q.to("meta"), k.to("meta")
    elif bad == "groups":
        k = torch.zeros(1, 8, 3, 16)
    else:
        k = k.double()
    with pytest.raises(ValueError):
        ops.mha_flash(q, k, k.clone())


BASE = 0x7F00_0000_0000  # a 16-byte aligned device address


@pytest.mark.parametrize("shape,strides,elem_size,ptr,ok", [
    ((4, 1000, 12, 128), (1536000, 1536, 128, 1), 4, BASE, True),   # qwen2's q, f32
    ((4, 1000, 2, 128), (256000, 256, 128, 1), 2, BASE, True),       # its k, bf16
    ((2, 96, 2, 64), (49152, 512, 64, 1), 4, BASE + 1024, True),     # heads 4:6 of a packed qkv
    ((1, 1, 4, 16), (7, 7, 16, 1), 2, BASE, True),                   # extent-1 strides do not count
    ((1, 32, 4, 64), (9216, 288, 72, 1), 4, BASE + 4, False),        # base 4 bytes off
    ((1, 32, 4, 64), (8448, 264, 66, 1), 4, BASE, False),            # head stride 264 bytes
    ((1, 32, 4, 64), (8448, 264, 66, 1), 2, BASE, False),            # head stride 132 bytes
    ((2, 33, 1, 64), (2112, 65, 64, 1), 2, BASE, False),             # sequence stride 130 bytes
    ((2, 8, 4, 16), (1024, 128, 32, 2), 4, BASE, False),             # head_dim not contiguous
])
def test_flash_tma_layout_rule(shape, strides, elem_size, ptr, ok):
    problem = fa.tma_layout_problem(shape, strides, elem_size, ptr)
    assert (problem is None) is ok, problem


def test_flash_tma_layout_rule_accepts_the_models_tensors():
    """q, k and v as the attention layer hands them over: views of one
    projection's output, and fresh contiguous tensors."""
    x = torch.zeros(2, 50, 8 * 64)
    q = x.view(2, 50, 8, 64)
    for t in (q, q[:, :, :4], q[:, :, 4:6], torch.zeros(3, 7, 2, 16, dtype=torch.bfloat16)):
        assert fa.tma_layout_problem(t.shape, t.stride(), t.element_size(), t.data_ptr()) is None


@pytest.mark.parametrize("make,kept", [
    (lambda: torch.zeros(2, 50, 8, 64), True),                          # contiguous
    (lambda: torch.zeros(2, 50, 12 * 64).view(2, 50, 12, 64)[:, :, 4:], True),  # a head slice
    (lambda: torch.ones(()).expand(2, 50, 8, 64), False),               # o.sum()'s gradient
    (lambda: torch.zeros(2, 50, 8, 65)[..., :64], False),               # rows 260 bytes apart
    (lambda: torch.zeros(2 * 50 * 8 * 64 + 1)[1:].view(2, 50, 8, 64), False),  # base off 16 B
])
def test_flash_backward_hands_tma_readable_gradients(make, kept):
    """The backward reads dO through TMA and o with 16-byte loads: a view
    TMA can read is passed as it is, any other (stride 0, unaligned) as a
    contiguous copy of the same values."""
    x = make()
    got = fa._tma_ready(x)
    assert (got is x) is kept
    assert got.shape == x.shape and torch.equal(got, x)
    assert fa.tma_layout_problem(got.shape, got.stride(), got.element_size(),
                                 got.data_ptr()) is None
    assert 0 not in got.stride()


def test_build_compiles_every_kernel_source():
    assert _build.sources() == ["dse_sim", "flash_attention", "flash_attention_bwd", "rmsnorm",
                                "ssd_scan", "ssd_scan_bwd"]


def test_build_path_changes_with_a_header(tmp_path, monkeypatch):
    """An edited, added or removed ``csrc/*.cuh``, an edited source and an
    added include path each give another library; nothing else does."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    seen = [_build.library_path("k")]
    assert _build.library_path("k") == seen[0] and seen[0].name.startswith("k-")
    (csrc / "common.cuh").write_text("// two\n")
    seen.append(_build.library_path("k"))
    (csrc / "extra.cuh").write_text("// three\n")
    seen.append(_build.library_path("k"))
    (csrc / "extra.cuh").unlink()
    assert _build.library_path("k") == seen[1]
    (csrc / "k.cu").write_text("// edited\n")
    seen.append(_build.library_path("k"))
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, f"-I{tmp_path}"))
    seen.append(_build.library_path("k"))
    assert len(set(seen)) == len(seen)


@pytest.mark.parametrize("rows,d", [(128, 256), (64, 1024), (37 * 4, 512)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_rmsnorm_matches_jax(rows, d, dtype):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((rows, d), dtype=np.float32) * 3)
    w = rng.standard_normal(d, dtype=np.float32) * 0.1
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    expect = jops.fused_rmsnorm(jx, jw)
    got = ops.fused_rmsnorm(tx, tw)
    assert got.shape == (rows, d) and got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(expect), **_tol(dtype))


def test_fused_rmsnorm_any_leading_shape_and_row_stride():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 37, 64), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal(64, dtype=np.float32))
    got = ops.fused_rmsnorm(x, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.rmsnorm_ref(x.numpy(), w.numpy())),
                               rtol=2e-5, atol=2e-5)
    last = ops.fused_rmsnorm(x[:, -1, :], w)  # rows 37*64 elements apart
    np.testing.assert_allclose(last.numpy(), got[:, -1, :].numpy(), rtol=0, atol=0)


def test_rmsnorm_wrapper_rejects_other_devices_and_is_not_counted_on_cpu():
    before = rn.rmsnorm.launches
    rn.rmsnorm(torch.ones(4, 8), torch.zeros(8))
    assert rn.rmsnorm.launches == before
    with pytest.raises(ValueError):
        rn.rmsnorm(torch.ones(4, 8, device="meta"), torch.zeros(8, device="meta"))


def test_ref_oracles_match_jax_ref():
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((3, 40, 16), dtype=np.float32) for _ in range(3))
    for causal, window in [(True, 0), (True, 8), (False, 0)]:
        e = jref.attention_ref(q, k, v, causal=causal, window=window)
        g = ref.attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b, s, h, g, hd, ds, ranges):
    """``random``: the JAX tests' draws (dt = softplus(randn), a = -exp(randn)),
    which forget within a few steps.  ``model``: the init kinds' ranges,
    dt in [1e-3, 1e-1] and a in [-16, -1], whose memory spans many chunks."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    if ranges == "random":
        dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
        a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    else:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h))).astype(np.float32)
        a = -rng.uniform(1.0, 16.0, h).astype(np.float32)
    bb = rng.standard_normal((b, s, g, ds), dtype=np.float32)
    cc = rng.standard_normal((b, s, g, ds), dtype=np.float32)
    return x, dt, a, bb, cc


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def _jax_ssd_ref(x, dt, a, bb, cc):
    """JAX ``ref.ssd_ref`` on the folded layout, unfolded to (B,S,H,P) and (B,H,P,N)."""
    b, s, h, hd = x.shape
    ds, rep = bb.shape[3], h // bb.shape[2]
    fold = lambda t: np.moveaxis(t, 2, 1).reshape(b * h, s, *t.shape[3:])
    ye, he = jref.ssd_ref(fold(x), fold(dt), np.tile(a, b), fold(np.repeat(bb, rep, 2)),
                          fold(np.repeat(cc, rep, 2)))
    return (np.asarray(ye).reshape(b, h, s, hd).transpose(0, 2, 1, 3),
            np.asarray(he).reshape(b, h, ds, hd).transpose(0, 1, 3, 2))


@pytest.mark.parametrize("b,s,h,g,hd,ds,chunk", [
    (2, 128, 4, 1, 16, 32, 64),
    (1, 256, 2, 2, 32, 16, 64),
    (2, 64, 4, 4, 8, 8, 32),
    (1, 128, 2, 1, 64, 64, 128),
])
@pytest.mark.parametrize("ranges", ["random", "model"])
def test_ssd_matches_jax(b, s, h, g, hd, ds, chunk, ranges):
    """The JAX wrapper in interpret mode, at ``tests/test_kernels.py``'s shapes."""
    x, dt, a, bb, cc = _ssd_inputs(8, b, s, h, g, hd, ds, ranges)
    ye, he = jops.ssd(*map(jnp.asarray, (x, dt, a, bb, cc)), chunk=chunk)
    y, hl = ops.ssd(*map(torch.from_numpy, (x, dt, a, bb, cc)))
    assert y.shape == (b, s, h, hd) and y.dtype == torch.float32
    assert hl.shape == (b, h, hd, ds) and hl.dtype == torch.float32
    assert _rel(y, ye) < 1e-4 and _rel(hl, he) < 1e-4


@pytest.mark.parametrize("h,g", [(4, 1), (8, 2)])
@pytest.mark.parametrize("ranges", ["random", "model"])
def test_ssd_ragged_length_matches_jax_ref(h, g, ranges):
    """S = 200 is no chunk multiple: the JAX wrapper asserts on it, so the
    reference is ``repro.kernels.ref.ssd_ref`` on the repeated groups."""
    x, dt, a, bb, cc = _ssd_inputs(9, 2, 200, h, g, 16, 16, ranges)
    ye, he = _jax_ssd_ref(x, dt, a, bb, cc)
    y, hl = ops.ssd(*map(torch.from_numpy, (x, dt, a, bb, cc)))
    assert _rel(y, ye) < 1e-4 and _rel(hl, he) < 1e-4


def test_ssd_bf16_plain_path_rounds_once():
    x, dt, a, bb, cc = _ssd_inputs(10, 1, 96, 2, 1, 16, 16, "model")
    tx, tb, tc = (torch.from_numpy(t).to(torch.bfloat16) for t in (x, bb, cc))
    y, hl = ops.ssd(tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc)
    assert y.dtype == torch.bfloat16 and hl.dtype == torch.float32
    ye, he = _jax_ssd_ref(*(t.float().numpy() for t in (tx, torch.from_numpy(dt),
                                                        torch.from_numpy(a), tb, tc)))
    assert _rel(y, ye) < 2e-2 and _rel(hl, he) < 1e-4


def test_ssd_ref_matches_jax_ref():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 40, 8), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((3, 40)), 0).astype(np.float32)
    a = -np.exp(rng.standard_normal(3)).astype(np.float32)
    b, c = (rng.standard_normal((3, 40, 4), dtype=np.float32) for _ in range(2))
    ye, he = jref.ssd_ref(x, dt, a, b, c)
    y, hl = ref.ssd_ref(*map(torch.from_numpy, (x, dt, a, b, c)))
    np.testing.assert_allclose(y.numpy(), np.asarray(ye), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(hl.numpy(), np.asarray(he), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("ranges", ["random", "model"])
def test_ssd_chunked_matches_jax(ranges):
    x, dt, a, bb, cc = _ssd_inputs(12, 2, 192, 4, 2, 16, 32, ranges)
    ye, he = jssd_chunked(*map(jnp.asarray, (x, dt, a, bb, cc)), chunk=64)
    y, hl = mb.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bb, cc)), chunk=64)
    assert _rel(y, ye) < 1e-4 and _rel(hl, he) < 1e-4


def test_ssd_plain_version_is_not_counted_as_a_launch():
    x, dt, a, bb, cc = map(torch.from_numpy, _ssd_inputs(13, 1, 64, 2, 1, 16, 16, "model"))
    before = ss.ssd_scan.launches
    ops.ssd(x, dt, a, bb, cc)
    assert ss.ssd_scan.launches == before


def test_ssd_scratch_holds_each_chunk_state_and_decay():
    """The kernels' scratch: per (batch, head) and chunk of 64, an (N, P) f32
    state and one decay."""
    assert ss.scratch_floats(4, 4096, 24, 64, 128) == 4 * 24 * 64 * (128 * 64 + 1)
    assert ss.scratch_floats(2, 65, 3, 16, 32) == 2 * 3 * 2 * (32 * 16 + 1)
    assert ss.scratch_floats(1, 1, 1, 16, 16) == 16 * 16 + 1


@pytest.mark.parametrize("view,aligned", [
    (lambda t: t, True),
    (lambda t: t[..., 4:20], True),           # rows start 16 bytes in
    (lambda t: t[..., 1:17], False),          # rows start 4 bytes in
    (lambda t: t[:, ::3], True),              # strided rows, each on 16 bytes
    (lambda t: t.bfloat16()[..., 8:24], True),
    (lambda t: t.bfloat16()[..., 4:20], False),  # 8 bytes in: bf16 reads 16 at a time
])
def test_ssd_wrapper_finds_rows_off_16_bytes(view, aligned):
    assert ss._aligned(view(torch.zeros(2, 9, 3, 32))) is aligned


@pytest.mark.parametrize("bad", ["device", "groups", "dtype", "dt_dtype"])
def test_ssd_wrapper_rejects_what_the_kernel_cannot_take(bad):
    x, dt, a = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 4), torch.zeros(4)
    b = torch.zeros(1, 8, 2, 16)
    if bad == "device":
        x, dt, a, b = (t.to("meta") for t in (x, dt, a, b))
    elif bad == "groups":
        b = torch.zeros(1, 8, 3, 16)
    elif bad == "dtype":
        b = b.double()
    else:
        dt = dt.bfloat16()
    with pytest.raises(ValueError):
        ops.ssd(x, dt, a, b, b.clone())
