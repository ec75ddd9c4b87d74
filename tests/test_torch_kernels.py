"""The port's kernel wrappers (plain path, CPU) vs the JAX package's kernels.

Inputs come from seeded numpy and go to both packages.  JAX runs its Pallas
kernels in interpret mode through ``repro.kernels.ops``, at the shapes of
``tests/test_kernels.py``; the port's ``ops`` take the kernels' plain
versions for CPU tensors.  Tolerances: 2e-5 in f32 (the same math in another
summation order), 2e-2 in bf16 (one bf16 rounding of the output).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref, rmsnorm as rn

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
