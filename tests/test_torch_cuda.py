"""The port's Hopper kernels vs their plain versions, on the card.

Marked ``cuda``: each test skips on a host without a CUDA device (decided in
the fixture, never at import).  Run on the GPU host with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports torch and the port only, so it needs no JAX there.  Tolerances:
1e-4 in f32 (the same f32 math summed in another order), 2e-2 in bf16 (one
bf16 rounding of the output).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref, rmsnorm as rn
from repro_torch.models import model as M
from repro_torch.models.layers import map_with_path

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("b,s,t,h,g,hd,window", [
    (2, 256, 256, 4, 2, 64, 0),
    (1, 128, 128, 2, 2, 32, 0),
    (2, 128, 128, 8, 1, 16, 0),
    (1, 512, 512, 4, 4, 64, 64),
    (2, 200, 200, 12, 2, 128, 0),   # ragged: no multiple of the kernel's tiles
    (1, 77, 77, 4, 2, 128, 16),
    (1, 1, 1, 2, 1, 128, 0),
    (1, 100, 300, 2, 1, 64, 0),     # T > S: keys past S are masked by causality
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(dev, b, s, t, h, g, hd, window, dtype):
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, g, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, g, hd), generator=gen, device=dev).to(dtype)
    before = fa.flash_attention.launches
    got = ops.mha_flash(q, k, v, causal=True, window=window)
    assert fa.flash_attention.launches == before + 1
    _close(got, fa.flash_attention_plain(q, k, v, causal=True, window=window), dtype)


def test_flash_kernel_reads_strided_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn((2, 96, 4 + 2 + 2, 64), generator=gen, device=dev)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    _close(ops.mha_flash(q, k, v), fa.flash_attention_plain(q, k, v), torch.float32)


def test_flash_kernel_rejects_unsupported_head_dim(dev):
    q = torch.zeros((1, 8, 2, 96), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        ops.mha_flash(q, q, q)


@pytest.mark.parametrize("rows,d", [(4000, 1536), (4, 1536), (148, 512), (3, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(dev, rows, d, dtype):
    gen = torch.Generator(device=dev).manual_seed(2)
    x = (torch.randn((rows, d), generator=gen, device=dev) * 3).to(dtype)
    w = (torch.randn((d,), generator=gen, device=dev) * 0.1).to(dtype)
    before = rn.rmsnorm.launches
    got = ops.fused_rmsnorm(x, w)
    assert rn.rmsnorm.launches == before + 1
    _close(got, ref.rmsnorm_ref(x, w), dtype)


def test_reduced_model_on_card_matches_cpu(dev):
    spec = reduced(ARCHS["qwen2-1.5b"])
    cpu = M.init_params(spec, 0, device="cpu")
    gpu = map_with_path(lambda _, t: t.to(dev), cpu)
    tok = torch.as_tensor(np.random.default_rng(3).integers(0, spec.vocab_size, (2, 70)))
    _close(M.forward(gpu, tok.to(dev), spec).cpu(), M.forward(cpu, tok, spec), torch.float32)
    caches = M.init_caches(spec, 2, 80, dtype=torch.float32, device=dev)
    lp, caches = M.prefill(gpu, tok.to(dev), caches, spec, compute_dtype=torch.float32)
    ld, _ = M.decode_step(gpu, caches, tok[:, -1].to(dev), 70, spec, compute_dtype=torch.float32)
    ccache = M.init_caches(spec, 2, 80, dtype=torch.float32, device="cpu")
    clp, ccache = M.prefill(cpu, tok, ccache, spec, compute_dtype=torch.float32)
    cld, _ = M.decode_step(cpu, ccache, tok[:, -1], 70, spec, compute_dtype=torch.float32)
    _close(lp.cpu(), clp, torch.float32)
    _close(ld.cpu(), cld, torch.float32)
