"""The port's Hopper kernels vs their plain versions, on the card.

Marked ``cuda``: each test skips on a host without a CUDA device (decided in
the fixture, never at import).  Run on the GPU host with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports torch and the port only, so it needs no JAX there.  Tolerances:
1e-4 in f32 (the same f32 math summed in another order; flash attention's
3xTF32 products keep f32 accuracy, which one TF32 pass would not: see the
large-score case), 2e-2 in bf16 (bf16 operands and one bf16 rounding of the
output).  The SSD scan is held at those bounds relative
to max |y| and max |state|: its chunked form and the sequential recurrence
sum through exp in other orders.  Gradients (flash attention's and RMSNorm's
backward kernels, whole models) are held at those bounds relative to the
largest |gradient| of each tensor (plus rtol at the same bound): an element
of a gradient sums many products that cancel, so rounding in another order
shows against the tensor's scale.
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref, rmsnorm as rn, ssd_scan as ss
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
    # head_dim 256 (gemma3: 4 query heads on 1 KV group), its own tile shape
    (2, 2040, 2040, 4, 1, 256, 512),  # gemma3's prefill, local layers (B=2)
    (1, 2040, 2040, 4, 1, 256, 0),    # and its global layers
    (2, 256, 256, 4, 1, 256, 0),
    (1, 600, 600, 4, 1, 256, 512),
    (1, 300, 300, 4, 1, 256, 100),  # the window's edge inside a key tile
    (2, 300, 300, 4, 1, 256, 37),
    (2, 200, 200, 4, 1, 256, 0),    # ragged
    (1, 1, 1, 4, 1, 256, 0),
    (1, 100, 300, 4, 1, 256, 0),    # T > S
    (1, 130, 700, 4, 2, 256, 50),   # T > S with a window, 2 groups
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


# The kernels' seams: 128-row query tiles in two 64-row halves, key tiles of
# 128 (bf16) and 64 (f32) up to head_dim 128 and 64 (bf16) and fewer (f32)
# at 256, TMA boxes of up to 128 bytes per row.
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 1000])
@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_tile_seams(dev, s, hd, dtype):
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((1, s, 4, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((1, s, 2, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((1, s, 2, hd), generator=gen, device=dev).to(dtype)
    _close(ops.mha_flash(q, k, v), fa.flash_attention_plain(q, k, v), dtype)


@pytest.mark.parametrize("s,t,window", [
    (300, 300, 100),    # the window's edge inside a key tile
    (300, 300, 1),      # each row sees itself only
    (256, 256, 192),
    (200, 200, 129),
    (130, 700, 50),     # T > S with a window
    (64, 1000, 0),      # T > S: keys past S are masked by causality
    (129, 513, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_window_and_long_keys(dev, s, t, window, dtype):
    gen = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((2, s, 4, 64), generator=gen, device=dev).to(dtype)
    k = torch.randn((2, t, 1, 64), generator=gen, device=dev).to(dtype)
    v = torch.randn((2, t, 1, 64), generator=gen, device=dev).to(dtype)
    _close(ops.mha_flash(q, k, v, window=window),
           fa.flash_attention_plain(q, k, v, window=window), dtype)


@pytest.mark.parametrize("hd", [128, 256])
def test_flash_f32_keeps_f32_accuracy_at_large_scores(dev, hd):
    """Scores of magnitude 10 and more: one TF32 pass misses 1e-4 here (PERF.md
    gives its error), the kernel's 3xTF32 must not."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((1, 256, 4, hd), generator=gen, device=dev) * 4
    k = torch.randn((1, 256, 2, hd), generator=gen, device=dev) * 4
    v = torch.randn((1, 256, 2, hd), generator=gen, device=dev)
    scores = torch.einsum("bshd,btgd->bsht", q[:, :, :2], k) / hd ** 0.5
    assert scores.abs().amax(-1).min() >= 10
    _close(ops.mha_flash(q, k, v), fa.flash_attention_plain(q, k, v), torch.float32)


@pytest.mark.parametrize("hd,width,start", [
    (64, 72, 1),     # the base address off 16 bytes
    (64, 66, 0),     # the head stride (66 elements) no multiple of 16 bytes
    (256, 264, 1),
    (256, 258, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_rejects_views_tma_cannot_read(dev, hd, width, start, dtype):
    q = torch.zeros((1, 32, 4, width), device=dev, dtype=dtype)[..., start:start + hd]
    k = torch.zeros((1, 32, 2, hd), device=dev, dtype=dtype)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="16"):
        ops.mha_flash(q, k, k)
    assert fa.flash_attention.launches == before


def test_flash_kernel_reads_strided_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn((2, 96, 4 + 2 + 2, 64), generator=gen, device=dev)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    _close(ops.mha_flash(q, k, v), fa.flash_attention_plain(q, k, v), torch.float32)


def test_flash_kernel_rejects_unsupported_head_dim(dev):
    q = torch.zeros((1, 8, 2, 80), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        ops.mha_flash(q, q, q)


@pytest.mark.parametrize("rows,d", [(148, 512)] + [
    (r, d) for r in (1, 3, 4, 4000) for d in (100, 512, 768, 1536, 8960)] + [
    (16384, 768), (16384, 1536)])  # mamba2-130m prefill and training
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(dev, rows, d, dtype):
    gen = torch.Generator(device=dev).manual_seed(2)
    x = (torch.randn((rows, d), generator=gen, device=dev) * 3).to(dtype)
    w = (torch.randn((d,), generator=gen, device=dev) * 0.1).to(dtype)
    before = rn.rmsnorm.launches
    got = ops.fused_rmsnorm(x, w)
    assert rn.rmsnorm.launches == before + 1
    _close(got, ref.rmsnorm_ref(x, w), dtype)


@pytest.mark.parametrize("d", [768, 1536, 8960])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_row_stride_off_16_bytes(dev, d, dtype):
    """Rows that start off 16 bytes take the element-by-element loads."""
    gen = torch.Generator(device=dev).manual_seed(6)
    x = (torch.randn((37, d + 1), generator=gen, device=dev) * 3).to(dtype)[:, 1:]
    w = (torch.randn((d,), generator=gen, device=dev) * 0.1).to(dtype)
    _close(ops.fused_rmsnorm(x, w), ref.rmsnorm_ref(x, w), dtype)


@pytest.mark.parametrize("d", [1536, 8960])
def test_rmsnorm_kernel_f32_weight_under_bf16(dev, d):
    """The models keep f32 weights under a bf16 compute dtype."""
    gen = torch.Generator(device=dev).manual_seed(7)
    x = (torch.randn((40, d), generator=gen, device=dev) * 3).bfloat16()
    w = torch.randn((d,), generator=gen, device=dev) * 0.1
    _close(ops.fused_rmsnorm(x, w), ref.rmsnorm_ref(x, w), torch.bfloat16)


def _ssd_inputs(dev, b, s, h, g, p, n, dtype, ranges, seed=4):
    """``random``: dt = softplus(randn), a = -exp(randn), which forget within a
    few steps.  ``model``: dt in [1e-3, 1e-1] and a in [-16, -1], the init
    kinds' ranges, whose memory spans many chunks."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    if ranges == "random":
        dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev))
        a = -torch.exp(torch.randn((h,), generator=gen, device=dev))
    else:
        u = torch.rand((b, s, h), generator=gen, device=dev)
        dt = torch.exp(u * (np.log(1e-1) - np.log(1e-3)) + np.log(1e-3))
        a = -(1.0 + 15.0 * torch.rand((h,), generator=gen, device=dev))
    bb = torch.randn((b, s, g, n), generator=gen, device=dev).to(dtype)
    cc = torch.randn((b, s, g, n), generator=gen, device=dev).to(dtype)
    return x, dt, a, bb, cc


def _close_rel(got, want, tol):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


SSD_SHAPES = [
    (4, 4096, 24, 1, 64, 128),   # mamba2-130m prefill
    (4, 1000, 24, 1, 64, 128),   # ragged: no multiple of the kernel's chunk
    (2, 512, 8, 2, 64, 16),      # grouped, jamba's widths
    (2, 200, 8, 1, 16, 16),      # reduced mamba2
    (2, 128, 4, 1, 16, 32),      # tests/test_kernels.py shapes
    (1, 256, 2, 2, 32, 16),
    (1, 128, 2, 1, 64, 64),
    (1, 300, 4, 1, 128, 128),    # P = 128
    # the chunk-parallel kernels' seams: the state pass over 1 to 3 chunks,
    # the ragged last chunk's padded rows, 128 chunks of carried state
    (2, 1, 4, 1, 64, 128),       # one row: the chunk is all padding but one
    (2, 63, 4, 1, 64, 128),
    (2, 64, 4, 1, 64, 128),      # exactly one chunk: no state carried in
    (2, 65, 4, 1, 64, 128),      # a second chunk of one row
    (2, 129, 4, 1, 64, 128),
    (1, 8192, 4, 1, 64, 128),
    (2, 300, 4, 2, 128, 16),     # P = 128 with N = 16
    # several heads of a group a block (ssd_scan.heads_per_block), and a group
    # over more than one block: kh = 3 and 4, two head-blocks a group
    (2, 4096, 12, 2, 64, 64),
    (2, 4096, 16, 2, 32, 32),
    # a next head at kh = 2 and 4 through the branches that share buffers:
    # one x/dY stage and M^T, W^T in one buffer (f32, P = N = 128); N = 16
    (2, 4096, 8, 1, 128, 128),
    (2, 4096, 16, 2, 64, 16),
    # head dims below 16 (a head_dim split over a mesh axis): the tiles of 16
    # columns, x and dY read an element at a time; G 1 and 2, ragged S
    (2, 1000, 24, 1, 4, 128),    # mamba2-130m's heads on one of 16 'model' ranks
    (2, 300, 8, 1, 1, 16),       # reduced mamba2's on one of 16
    (2, 200, 8, 2, 2, 16),
    (2, 130, 4, 2, 8, 64),
    (1, 65, 4, 1, 4, 32),
]


@pytest.mark.parametrize("b,s,h,g,p,n", SSD_SHAPES)
@pytest.mark.parametrize("ranges", ["random", "model"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(dev, b, s, h, g, p, n, ranges, dtype):
    x, dt, a, bb, cc = _ssd_inputs(dev, b, s, h, g, p, n, dtype, ranges)
    before = ss.ssd_scan.launches
    y, hl = ops.ssd(x, dt, a, bb, cc)
    assert ss.ssd_scan.launches == before + 1
    ye, he = ss.ssd_scan_plain(x, dt, a, bb, cc)
    _close_rel(y, ye, TOL[dtype])
    _close_rel(hl, he, TOL[torch.float32])  # f32 state from the same inputs


def test_ssd_kernel_copies_unaligned_rows(dev):
    """x, B and C whose rows start off 16 bytes are copied before the launch."""
    gen = torch.Generator(device=dev).manual_seed(8)
    b, s, h, p, g, n = 2, 100, 2, 16, 1, 16
    packed = torch.randn((b, s, 1 + h * p + 2 * g * n), generator=gen, device=dev)
    x = packed[..., 1 : 1 + h * p].view(b, s, h, p)
    bb = packed[..., 1 + h * p : 1 + h * p + g * n].unflatten(-1, (g, n))
    cc = packed[..., 1 + h * p + g * n :].unflatten(-1, (g, n))
    dt = torch.rand((b, s, h), generator=gen, device=dev) * 0.1
    a = -torch.rand((h,), generator=gen, device=dev) * 4
    y, hl = ops.ssd(x, dt, a, bb, cc)
    ye, he = ss.ssd_scan_plain(x, dt, a, bb, cc)
    _close_rel(y, ye, 1e-4)
    _close_rel(hl, he, 1e-4)


def test_ssd_kernel_reads_strided_inputs(dev):
    """x, B and C as views into one packed projection, dt a column slice."""
    gen = torch.Generator(device=dev).manual_seed(5)
    b, s, h, p, g, n = 2, 150, 4, 32, 2, 16
    packed = torch.randn((b, s, h * p + 2 * g * n), generator=gen, device=dev)
    x = packed[..., : h * p].view(b, s, h, p)
    bb = packed[..., h * p : h * p + g * n].unflatten(-1, (g, n))
    cc = packed[..., h * p + g * n :].unflatten(-1, (g, n))
    dt = torch.rand((b, s, 2 * h), generator=gen, device=dev)[..., ::2] * 0.1
    a = -torch.rand((h,), generator=gen, device=dev) * 4
    y, hl = ops.ssd(x, dt, a, bb, cc)
    ye, he = ss.ssd_scan_plain(x, dt, a, bb, cc)
    _close_rel(y, ye, 1e-4)
    _close_rel(hl, he, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cols", [(0, 1), (4, 8), (12, 16), (2, 4)])
def test_ssd_narrow_head_dims_read_column_slices(dev, dtype, cols):
    """A head_dim below 16 as a column slice of a wider x and dy (rows off
    16 bytes, read an element at a time, not copied): y, the final state and
    every gradient against the plain version on the same slice."""
    lo, hi = cols
    x, dt, a, bb, cc = _ssd_inputs(dev, 2, 150, 4, 2, 16, 32, dtype, "model")
    gen = torch.Generator(device=dev).manual_seed(11)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)[..., lo:hi]
    dstate = torch.randn((2, 4, hi - lo, 32), generator=gen, device=dev)
    leaves = [t.detach().requires_grad_() for t in (x[..., lo:hi], dt, a, bb, cc)]
    assert leaves[0].stride(-1) == 1 and leaves[0].stride(2) == 16
    y, hl = ops.ssd(*leaves)
    got = torch.autograd.grad((y, hl), leaves, (dy, dstate))
    ye, he = ss.ssd_scan_plain(*leaves)
    _close_rel(y, ye, TOL[dtype])
    _close_rel(hl, he, TOL[torch.float32])
    for leaf, gv, wv in zip(leaves, got, _ssd_bwd_reference(leaves, dy, dstate)):
        assert gv.shape == leaf.shape
        _close_grad(gv, wv, dtype)


def _ssd_narrow_twice(args, dy, dstate):
    """Forward and backward of the kernels on the same inputs, twice."""
    runs = []
    for _ in range(2):
        y, hl, scratch = ss._launch(*args)
        runs.append((y, hl, *ss.ssd_scan_bwd(*args, scratch, dy, dstate)))
    return runs


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_narrow_packed_tiles(dev, dtype, p, g):
    """Head dims below 16 pack 16 / P heads of a group into one tile: a
    group's heads that 16 / P does not divide (6, or 3 at P = 8) leave a
    ragged last tile; ragged S, N = 16.  y, the final state and every
    gradient against the plain version, and two calls bit for bit."""
    hg = 3 if p == 8 else 6
    args, _, dy, dstate = _ssd_bwd_case(dev, 2, 200, hg * g, g, p, 16, dtype, "model")
    assert ss.narrow_blocks(2, 200, hg * g, g, p)[1] * ss.heads_per_tile(p) > hg
    first, second = _ssd_narrow_twice(args, dy, dstate)
    assert all(torch.equal(u, v) for u, v in zip(first, second))
    ye, he = ss.ssd_scan_plain(*args)
    _close_rel(first[0], ye, TOL[dtype])
    _close_rel(first[1], he, TOL[torch.float32])
    for gv, wv in zip(first[2:], _ssd_bwd_reference(args, dy, dstate)):
        _close_grad(gv, wv, dtype)


@pytest.mark.parametrize("p", [4, 8])
def test_ssd_narrow_blocks_of_several_tiles(dev, p):
    """Enough chunks for blocks of several tiles (``tiles_per_block``: 2 of
    6 heads at P = 4, the second ragged; 3 at P = 8): the raw scores once for
    them, W summed over their heads; against the plain version."""
    args, _, dy, dstate = _ssd_bwd_case(dev, 2, 8190, 6, 1, p, 16, torch.float32, "model")
    _, tiles, kt = ss.narrow_blocks(2, 8190, 6, 1, p)
    assert kt == tiles > 1
    y, hl, scratch = ss._launch(*args)
    ye, he = ss.ssd_scan_plain(*args)
    _close_rel(y, ye, TOL[torch.float32])
    _close_rel(hl, he, TOL[torch.float32])
    got = ss.ssd_scan_bwd(*args, scratch, dy, dstate)
    for gv, wv in zip(got, _ssd_bwd_reference(args, dy, dstate)):
        _close_grad(gv, wv, torch.float32)


def test_ssd_kernel_rejects_unsupported_sizes(dev):
    x, dt, a, bb, cc = _ssd_inputs(dev, 1, 16, 2, 1, 8, 8, torch.float32, "model")
    with pytest.raises(ValueError, match="head_dim"):
        ops.ssd(x, dt, a, bb, cc)


def test_reduced_mamba_on_card_matches_cpu(dev):
    spec = reduced(ARCHS["mamba2-130m"])
    cpu = M.init_params(spec, 0, device="cpu")
    gpu = map_with_path(lambda _, t: t.to(dev), cpu)
    tok = torch.as_tensor(np.random.default_rng(3).integers(0, spec.vocab_size, (2, 70)))
    _close(M.forward(gpu, tok.to(dev), spec)[0].cpu(), M.forward(cpu, tok, spec)[0],
           torch.float32)
    caches = M.init_caches(spec, 2, 80, dtype=torch.float32, device=dev)
    lp, caches = M.prefill(gpu, tok.to(dev), caches, spec, compute_dtype=torch.float32)
    ld, caches = M.decode_step(gpu, caches, tok[:, -1].to(dev), 70, spec,
                               compute_dtype=torch.float32)
    ccache = M.init_caches(spec, 2, 80, dtype=torch.float32, device="cpu")
    clp, ccache = M.prefill(cpu, tok, ccache, spec, compute_dtype=torch.float32)
    cld, ccache = M.decode_step(cpu, ccache, tok[:, -1], 70, spec, compute_dtype=torch.float32)
    _close(lp.cpu(), clp, torch.float32)
    _close(ld.cpu(), cld, torch.float32)
    for got, want in zip(caches, ccache):
        for name in ("conv", "ssm"):
            _close(got[name].cpu(), want[name], torch.float32)


def test_reduced_model_on_card_matches_cpu(dev):
    spec = reduced(ARCHS["qwen2-1.5b"])
    cpu = M.init_params(spec, 0, device="cpu")
    gpu = map_with_path(lambda _, t: t.to(dev), cpu)
    tok = torch.as_tensor(np.random.default_rng(3).integers(0, spec.vocab_size, (2, 70)))
    _close(M.forward(gpu, tok.to(dev), spec)[0].cpu(), M.forward(cpu, tok, spec)[0],
           torch.float32)
    caches = M.init_caches(spec, 2, 80, dtype=torch.float32, device=dev)
    lp, caches = M.prefill(gpu, tok.to(dev), caches, spec, compute_dtype=torch.float32)
    ld, _ = M.decode_step(gpu, caches, tok[:, -1].to(dev), 70, spec, compute_dtype=torch.float32)
    ccache = M.init_caches(spec, 2, 80, dtype=torch.float32, device="cpu")
    clp, ccache = M.prefill(cpu, tok, ccache, spec, compute_dtype=torch.float32)
    cld, _ = M.decode_step(cpu, ccache, tok[:, -1], 70, spec, compute_dtype=torch.float32)
    _close(lp.cpu(), clp, torch.float32)
    _close(ld.cpu(), cld, torch.float32)


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-moe-3b-a800m", "jamba-v0.1-52b"])
def test_reduced_ring_and_moe_models_on_card_match_cpu(dev, arch):
    """Ring caches (window 16, a 70-token prompt, then decode across the
    wrap), MoE FFNs and the hybrid: forward with its aux, prefill, six decode
    steps and every cache leaf on the card against the CPU's plain path,
    within 1e-4 of each one's scale: the same code on both devices."""
    tol = 1e-4
    spec = reduced(ARCHS[arch])
    cpu = M.init_params(spec, 0, device="cpu")
    gpu = map_with_path(lambda _, t: t.to(dev), cpu)
    tok = torch.as_tensor(np.random.default_rng(3).integers(0, spec.vocab_size, (2, 76)))

    def close(got, want):
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        scale = want.float().abs().max().item()
        torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol, atol=tol * scale)

    gl, ga = M.forward(gpu, tok[:, :70].to(dev), spec)
    cl, ca = M.forward(cpu, tok[:, :70], spec)
    close(gl, cl)
    close(ga, ca)
    f32 = torch.float32
    caches = M.init_caches(spec, 2, 80, dtype=f32, device=dev)
    ccache = M.init_caches(spec, 2, 80, dtype=f32, device="cpu")
    lp, caches = M.prefill(gpu, tok[:, :70].to(dev), caches, spec, compute_dtype=f32)
    clp, ccache = M.prefill(cpu, tok[:, :70], ccache, spec, compute_dtype=f32)
    close(lp, clp)
    for pos in range(70, 76):
        ld, caches = M.decode_step(gpu, caches, tok[:, pos].to(dev), pos, spec, compute_dtype=f32)
        cld, ccache = M.decode_step(cpu, ccache, tok[:, pos], pos, spec, compute_dtype=f32)
        close(ld, cld)
    for got, want in zip(caches, ccache):
        assert got.keys() == want.keys()
        for name in got:
            if name == "kpos":
                assert got[name].dtype == torch.int32 and torch.equal(got[name].cpu(), want[name])
            else:
                close(got[name], want[name])


# ---------------------------------------------------------------------------
# head_dim 96 (phi-3-vision-4.2b), the forward's log-sum-exp, and backward


@pytest.mark.parametrize("b,s,t,h,g,window", [
    (4, 1024, 1024, 32, 32, 0),   # phi-3-vision-4.2b's prefill
    (2, 200, 200, 4, 2, 0),
    (1, 77, 77, 4, 4, 16),
    (2, 129, 300, 4, 1, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_head_dim_96(dev, b, s, t, h, g, window, dtype):
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((b, s, h, 96), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, g, 96), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, g, 96), generator=gen, device=dev).to(dtype)
    _close(ops.mha_flash(q, k, v, window=window),
           fa.flash_attention_plain(q, k, v, window=window), dtype)


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_log_sum_exp(dev, hd, dtype):
    """The training forward's per-row log-sum-exp of the scaled scores."""
    gen = torch.Generator(device=dev).manual_seed(10)
    b, s, h, g, window = 2, 150, 4, 2, 37
    q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, g, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, g, hd), generator=gen, device=dev).to(dtype)
    o, lse = fa._launch(q, k, v, True, window, hd ** -0.5, with_lse=True)
    sc = torch.einsum("bshd,bthd->bhst", q.float(), k.float().repeat_interleave(h // g, 2))
    pos = torch.arange(s, device=dev)
    mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - window)
    want = torch.logsumexp((sc * hd ** -0.5).masked_fill(~mask, float("-inf")), -1)
    _close(lse, want, torch.float32)
    _close(o, fa.flash_attention_plain(q, k, v, window=window), dtype)


def _close_grad(got, want, dtype, scale=None):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = want.float().abs().max().item() if scale is None else scale
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype] * scale + 1e-6)


def _flash_grads(q, k, v, do, window, plain):
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    fn = fa.flash_attention_plain if plain else ops.mha_flash
    fn(q, k, v, causal=True, window=window).backward(do)
    return q.grad, k.grad, v.grad


@pytest.mark.parametrize("b,s,t,h,g,window", [
    (2, 200, 200, 4, 2, 0),      # ragged, GQA
    (1, 77, 77, 4, 4, 16),       # window, no grouping
    (2, 130, 130, 8, 1, 0),      # one KV group for 8 heads
    (2, 300, 300, 4, 1, 100),    # the window's edge inside a tile
    (1, 100, 300, 2, 1, 0),      # T > S
    (1, 1, 1, 2, 1, 0),
    (1, 65, 65, 2, 2, 1),        # each row sees itself only
    (2, 333, 333, 6, 6, 0),      # H == G (dk, dv written by the dK/dV blocks), ragged S and T
    (1, 190, 250, 4, 2, 70),     # T > S, the window's edge inside a 128-key tile
    (8, 256, 256, 16, 4, 0),     # B * H = 128: more than one wave of blocks
])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_matches_plain(dev, b, s, t, h, g, window, hd, dtype):
    """dq, dk, dv of the backward kernels (through FlashAttentionFn) vs
    autograd through the plain version, in the inputs' dtype, each held
    against the largest of the three: where a row sees a single key (window
    1), dq and dk are 0 by cancellation (dP - D), which the kernel reaches
    to rounding of the dO V products that dv's scale measures."""
    gen = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, g, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, g, hd), generator=gen, device=dev).to(dtype)
    do = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    got = _flash_grads(q, k, v, do, window, plain=False)
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want = _flash_grads(q, k, v, do, window, plain=True)
    scale = max(w.float().abs().max().item() for w in want)
    for x, y in zip(got, want):
        _close_grad(x, y, dtype, scale)


def test_flash_backward_reads_strided_inputs(dev):
    """q, k, v as views into one packed projection and an expanded (stride
    0) output gradient, as ``o.sum().backward()`` gives."""
    gen = torch.Generator(device=dev).manual_seed(12)
    qkv = torch.randn((2, 96, 4 + 2 + 2, 64), generator=gen, device=dev, requires_grad=True)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    ops.mha_flash(q, k, v).sum().backward()
    got = qkv.grad.clone()
    qkv.grad = None
    fa.flash_attention_plain(q, k, v).sum().backward()
    _close_grad(got, qkv.grad, torch.float32)


@pytest.mark.parametrize("rows,d", [(4000, 1536), (8160, 1152), (3, 100), (37, 8960), (1, 768),
                                    (300, 3072),
                                    # mamba2-130m training: norm1 and the final norm at
                                    # d_model, the mixer's gated norm at d_inner
                                    (16384, 768), (16384, 1536),
                                    # rows held in registers: several rows per block, rows
                                    # no multiple of them; the widest such row
                                    (37, 1152), (4097, 1536), (1001, 2048),
                                    (3, rn.BWD_MAX_D)])  # the widest row the kernel takes
@pytest.mark.parametrize("dtype,wdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.float32),
                                          (torch.bfloat16, torch.bfloat16)])
def test_rmsnorm_backward_matches_plain(dev, rows, d, dtype, wdtype):
    """dx and dw of the backward kernels (through RMSNormFn) vs autograd
    through the plain version."""
    gen = torch.Generator(device=dev).manual_seed(13)
    x = (torch.randn((rows, d), generator=gen, device=dev) * 3).to(dtype)
    w = (torch.randn((d,), generator=gen, device=dev) * 0.1).to(wdtype)
    g = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
    grads = []
    before = rn.rmsnorm_bwd.launches
    for fn in (ops.fused_rmsnorm, ref.rmsnorm_ref):
        xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
        fn(xg, wg).backward(g)
        grads.append((xg.grad, wg.grad))
    assert rn.rmsnorm_bwd.launches == before + 1
    (dx, dw), (dx_want, dw_want) = grads
    _close_grad(dx, dx_want, dtype)
    _close_grad(dw, dw_want, wdtype if wdtype == torch.bfloat16 else dtype)


def test_rmsnorm_backward_refuses_wider_rows(dev):
    x = torch.ones((2, rn.BWD_MAX_D + 1), device=dev)
    w = torch.zeros((rn.BWD_MAX_D + 1,), device=dev)
    with pytest.raises(ValueError, match="d <="):
        rn.rmsnorm_bwd(x, w, x)


@pytest.mark.parametrize("rows,d,stride", [
    (300, 1536, 1537),   # a row stride that rules out 16-byte loads: element by element, wide
    (64, 255, 256),      # d no multiple of the vector: element by element, rows in registers
    (50, 1536, 1540),    # 16-byte aligned rows with padding between them
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_reads_strided_rows(dev, rows, d, stride, dtype):
    """x as a view with a row stride other than d, through RMSNormFn."""
    gen = torch.Generator(device=dev).manual_seed(14)
    base = (torch.randn((rows, stride), generator=gen, device=dev) * 3).to(dtype)
    x = base[:, :d]
    w = (torch.randn((d,), generator=gen, device=dev) * 0.1).to(dtype)
    g = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
    grads = []
    for fn in (ops.fused_rmsnorm, ref.rmsnorm_ref):
        xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
        assert xg.stride() == (stride, 1)
        fn(xg, wg).backward(g)
        grads.append((xg.grad, wg.grad))
    (dx, dw), (dx_want, dw_want) = grads
    _close_grad(dx, dx_want, dtype)
    _close_grad(dw, dw_want, dtype)


@pytest.mark.parametrize("h,g,hd,window", [(12, 2, 128, 0), (4, 1, 256, 512), (6, 6, 64, 37)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_deterministic(dev, h, g, hd, window, dtype):
    """Two backward calls on the same inputs give the same dq, dk and dv bit
    for bit: every output element is summed by one block in a fixed order,
    the GQA heads of a group in head order."""
    gen = torch.Generator(device=dev).manual_seed(15)
    b, s = 2, 700
    q, do = (torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, s, g, hd), generator=gen, device=dev).to(dtype) for _ in range(2))
    o, lse = fa._launch(q, k, v, True, window, hd ** -0.5, with_lse=True)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    torch.cuda.synchronize()
    for x, y in zip(first, again):
        assert torch.equal(x, y)


# The query offset: q holds rows q_offset .. q_offset + S - 1 of a sequence
# whose keys run from 0 (one rank of a sequence-split attention).
OFFSET_CASES = [
    (1, 1024, 4096, 12, 2, 128, 3072, 0),  # qwen2 as the last of 4 'model' ranks sees it
    (1, 1024, 4096, 12, 2, 128, 3072, 512),
    (2, 200, 333, 4, 2, 64, 133, 0),        # ragged, T = q_offset + S
    (2, 200, 700, 4, 2, 64, 37, 0),         # T > q_offset + S, an offset inside a tile
    (1, 130, 700, 4, 1, 256, 500, 512),     # head_dim 256 at gemma3's window
    (2, 77, 300, 6, 6, 96, 200, 16),        # a window's edge inside a key tile
    (1, 1, 64, 2, 1, 32, 63, 0),            # one row, the last position
]


def _offset_inputs(dev, b, s, t, h, g, hd, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, t, g, hd), generator=gen, device=dev).to(dtype) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("b,s,t,h,g,hd,off,window", OFFSET_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_with_query_offset_matches_plain(dev, b, s, t, h, g, hd, off, window, dtype):
    """Forward and backward kernels at a query offset against the plain
    version at the same offset (autograd through it for the gradients)."""
    q, k, v, do = _offset_inputs(dev, b, s, t, h, g, hd, dtype, 16)
    got = fa.flash_attention(q, k, v, window=window, q_offset=off)
    _close(got, fa.flash_attention_plain(q, k, v, window=window, q_offset=off), dtype)
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_plain):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        fn(*leaves, window=window, q_offset=off).backward(do)
        grads.append([x.grad for x in leaves])
    scale = max(w.float().abs().max().item() for w in grads[1])
    for x, y in zip(*grads):
        _close_grad(x, y, dtype, scale)


@pytest.mark.parametrize("window", [0, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_query_offset_rows_are_the_full_attentions_bits(dev, window, dtype):
    """At an offset that is a multiple of the 128-row query tile, each tile
    meets the same key tiles under the same masks as in the whole-sequence
    launch: the rows (and their dq) come out bit for bit, and offset 0 is
    the launch without an offset."""
    b, t, h, g, hd = 1, 2048, 12, 2, 128
    q, k, v, do = _offset_inputs(dev, b, t, t, h, g, hd, dtype, 17)
    whole = fa.flash_attention(q, k, v, window=window)
    assert torch.equal(fa.flash_attention(q, k, v, window=window, q_offset=0), whole)
    o, lse = fa._launch(q, k, v, True, window, hd ** -0.5, with_lse=True)
    dq = fa.flash_attention_bwd(q, k, v, o, lse, do, window=window)[0]
    for off, s in ((1536, 512), (1024, 768), (128, 1)):
        rows = slice(off, off + s)
        part = fa.flash_attention(q[:, rows], k, v, window=window, q_offset=off)
        assert torch.equal(part, whole[:, rows]), off
        o_p, lse_p = fa._launch(q[:, rows].contiguous(), k, v, True, window, hd ** -0.5,
                                with_lse=True, q_offset=off)
        dq_p = fa.flash_attention_bwd(q[:, rows].contiguous(), k, v, o_p, lse_p,
                                      do[:, rows].contiguous(), window=window, q_offset=off)[0]
        assert torch.equal(dq_p, dq[:, rows]), off


def test_flash_kernel_refuses_keys_short_of_the_offset(dev):
    q = torch.randn((1, 64, 2, 64), device=dev)
    k = torch.randn((1, 100, 2, 64), device=dev)
    with pytest.raises(ValueError, match="offset"):
        fa.flash_attention(q, k, k, q_offset=37)
    with pytest.raises(ValueError, match="offset"):
        fa.flash_attention(q, k, k, q_offset=-1)


@pytest.mark.parametrize("rows,d", [(4096, 1536), (37, 8960), (16384, 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_is_deterministic(dev, rows, d, dtype):
    """Two backward calls on the same inputs give the same dx and dw bit for
    bit: dw adds the blocks' column sums in block order."""
    gen = torch.Generator(device=dev).manual_seed(16)
    x, g = (torch.randn((rows, d), generator=gen, device=dev).to(dtype) for _ in range(2))
    w = torch.randn((d,), generator=gen, device=dev).to(dtype)
    first, again = rn.rmsnorm_bwd(x, w, g), rn.rmsnorm_bwd(x, w, g)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_ssd_backward_under_grad_launches_the_backward_kernels_once(dev):
    """ops.ssd on CUDA tensors that require grad goes through SSDScanFn: one
    forward call, and one backward call whose gradients match autograd
    through the plain version; under no_grad no backward is recorded."""
    args = [t.requires_grad_() for t in _ssd_inputs(dev, 2, 130, 4, 2, 16, 32, torch.float32,
                                                     "model")]
    before = (ss.ssd_scan.launches, ss.ssd_scan_bwd.launches)
    y, hl = ops.ssd(*args)
    grads = torch.autograd.grad(y.square().sum() + hl.sum(), args)
    assert (ss.ssd_scan.launches, ss.ssd_scan_bwd.launches) == (before[0] + 1, before[1] + 1)
    ye, he = ss.ssd_scan_plain(*args)
    want = torch.autograd.grad(ye.square().sum() + he.sum(), args)
    for got, w in zip(grads, want):
        _close_grad(got, w, torch.float32)
    with torch.no_grad():
        y, _ = ops.ssd(*args)
    assert y.grad_fn is None and ss.ssd_scan_bwd.launches == before[1] + 1


def _ssd_bwd_case(dev, b, s, h, g, p, n, dtype, ranges, seed=9):
    """Inputs, the forward's scratch, dy and a nonzero dstate."""
    x, dt, a, bb, cc = _ssd_inputs(dev, b, s, h, g, p, n, dtype, ranges)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dy = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    dstate = torch.randn((b, h, p, n), generator=gen, device=dev)
    _, _, scratch = ss._launch(x, dt, a, bb, cc)
    return (x, dt, a, bb, cc), scratch, dy, dstate


def _ssd_bwd_reference(args, dy, dstate):
    """Autograd through the plain version on the same inputs (dstate None
    is a zero cotangent)."""
    leaves = [t.detach().requires_grad_() for t in args]
    y, hl = ss.ssd_scan_plain(*leaves)
    return torch.autograd.grad((y, hl), leaves, (dy, torch.zeros_like(hl) if dstate is None
                                                 else dstate))


@pytest.mark.parametrize("b,s,h,g,p,n", SSD_SHAPES)
@pytest.mark.parametrize("ranges", ["random", "model"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_matches_plain(dev, b, s, h, g, p, n, ranges, dtype):
    """dx, ddt, da, db, dc of the backward kernels vs autograd through the
    plain version, at the forward tests' shapes (among them blocks of one
    head, of several heads of a group, and groups over several blocks)."""
    args, scratch, dy, dstate = _ssd_bwd_case(dev, b, s, h, g, p, n, dtype, ranges)
    before = ss.ssd_scan_bwd.launches
    got = ss.ssd_scan_bwd(*args, scratch, dy, dstate)
    assert ss.ssd_scan_bwd.launches == before + 1
    for gv, wv in zip(got, _ssd_bwd_reference(args, dy, dstate)):
        _close_grad(gv, wv, dtype)


@pytest.mark.parametrize("b,s,h,g,p,n", SSD_SHAPES + [(4, 4096, 24, 1, 64, 128),
                                                      (2, 1000, 8, 2, 64, 16)] + [
    # head dims below 16: H/G of 6, 24 and 128, ragged S
    (4, 4096, 24, 1, p, 128) for p in (1, 2, 4, 8)] + [
    (2, 1000, 24, 1, 4, 128), (8, 8190, 6, 1, 4, 128), (1, 4097, 6, 1, 4, 128),
    (2, 300, 12, 2, 1, 16), (2, 1000, 128, 1, 4, 128), (2, 3000, 256, 2, 8, 16)])
def test_ssd_backward_scratch_size_is_the_kernels(dev, b, s, h, g, p, n):
    """The wrapper's scratch size (its copies of heads_per_block, and below
    head dim 16 of the packed tiles' layout) is the C library's own."""
    assert ss.bwd_scratch_floats(b, s, h, g, p, n) == ss._bwd_scratch_entry()(b, s, h, g, p, n)


def test_ssd_backward_refuses_a_short_scratch(dev, monkeypatch):
    """A scratch one float short of the C library's count is refused before
    any launch."""
    args, scratch, dy, dstate = _ssd_bwd_case(dev, 2, 4096, 12, 2, 64, 64, torch.float32,
                                              "model")
    short = ss.bwd_scratch_floats
    monkeypatch.setattr(ss, "bwd_scratch_floats", lambda *shape: short(*shape) - 1)
    before = ss.ssd_scan_bwd.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        ss.ssd_scan_bwd(*args, scratch, dy, dstate)
    assert ss.ssd_scan_bwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_without_a_state_gradient(dev, dtype):
    args, scratch, dy, _ = _ssd_bwd_case(dev, 2, 300, 4, 2, 64, 32, dtype, "model")
    got = ss.ssd_scan_bwd(*args, scratch, dy, None)
    for gv, wv in zip(got, _ssd_bwd_reference(args, dy, None)):
        _close_grad(gv, wv, dtype)


@pytest.mark.parametrize("which", ["y", "state"])
def test_ssd_backward_with_an_output_unused(dev, which):
    """Through ops.ssd, an output that takes no part in the loss reaches
    SSDScanFn's backward as a None gradient, taken as zero."""
    args = [t.requires_grad_() for t in _ssd_inputs(dev, 2, 200, 4, 2, 32, 16, torch.float32,
                                                     "model")]
    y, hl = ops.ssd(*args)
    loss = y.square().sum() if which == "y" else hl.square().sum()
    grads = torch.autograd.grad(loss, args)
    ye, he = ss.ssd_scan_plain(*args)
    want = torch.autograd.grad(ye.square().sum() if which == "y" else he.square().sum(), args,
                               allow_unused=True)
    for got, w, leaf in zip(grads, want, args):
        _close_grad(got, torch.zeros_like(leaf) if w is None else w, torch.float32)


def test_ssd_backward_reads_strided_and_unaligned_inputs(dev):
    """x, B and C as views into one packed projection whose rows start off
    16 bytes, dt a column slice and dy a strided view: the wrapper copies
    what the kernels cannot read, and the gradients keep the inputs' shapes."""
    gen = torch.Generator(device=dev).manual_seed(10)
    b, s, h, p, g, n = 2, 150, 4, 32, 2, 16
    packed = torch.randn((b, s, 1 + h * p + 2 * g * n), generator=gen, device=dev)
    x = packed[..., 1 : 1 + h * p].view(b, s, h, p)
    bb = packed[..., 1 + h * p : 1 + h * p + g * n].unflatten(-1, (g, n))
    cc = packed[..., 1 + h * p + g * n :].unflatten(-1, (g, n))
    dt = torch.rand((b, s, 2 * h), generator=gen, device=dev)[..., ::2] * 0.1
    a = -torch.rand((h,), generator=gen, device=dev) * 4
    dy = torch.randn((b, s, 2 * h, p), generator=gen, device=dev)[:, :, ::2]
    dstate = torch.randn((b, h, n, p), generator=gen, device=dev).transpose(2, 3)
    leaves = [t.detach().requires_grad_() for t in (x, dt, a, bb, cc)]
    y, hl = ops.ssd(*leaves)
    got = torch.autograd.grad((y, hl), leaves, (dy, dstate))
    want = _ssd_bwd_reference((x, dt, a, bb, cc), dy, dstate)
    for leaf, gv, wv in zip(leaves, got, want):
        assert gv.shape == leaf.shape
        _close_grad(gv, wv, torch.float32)


@pytest.mark.parametrize("b,s,h,g,p,n", [(4, 4096, 24, 1, 64, 128), (2, 1000, 8, 2, 64, 16),
                                         (1, 300, 4, 1, 128, 128), (2, 4096, 12, 2, 64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_is_deterministic(dev, b, s, h, g, p, n, dtype):
    """No atomics: dB and dC summed over a block's heads in head order and
    over a group's head-blocks in order, da over the chunks in a fixed order;
    two calls give the same bits."""
    args, scratch, dy, dstate = _ssd_bwd_case(dev, b, s, h, g, p, n, dtype, "model")
    first = ss.ssd_scan_bwd(*args, scratch, dy, dstate)
    again = ss.ssd_scan_bwd(*args, scratch, dy, dstate)
    torch.cuda.synchronize()
    for u, v in zip(first, again):
        assert torch.equal(u, v)


def _card_and_cpu_grads(arch, n_layers, remat, dev):
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loss import cross_entropy
    spec = reduced(ARCHS[arch], n_layers=n_layers)
    cpu = M.init_params(spec, 0, device="cpu")
    rng = np.random.default_rng(3)
    tok = torch.as_tensor(rng.integers(0, spec.vocab_size, (2, 150)))
    lab = torch.as_tensor(rng.integers(0, spec.vocab_size, (2, 150)))
    out = []
    for device, r in (("cpu", "none"), (dev, remat)):
        params = map_with_path(lambda _, t: t.detach().to(device).requires_grad_(), cpu)
        logits, _ = M.forward(params, tok.to(device), spec, remat=r)
        loss = cross_entropy(logits, lab.to(device))
        loss.backward()
        out.append((loss.item(), [p.grad.cpu() for p in opt.leaves(params)]))
    return out


@pytest.mark.parametrize("arch,n_layers", [("qwen2-1.5b", 2), ("gemma3-1b", 4),
                                           ("mamba2-130m", 2),
                                           ("jamba-v0.1-52b", 8)])  # 1 attention, 7 Mamba, MoE
@pytest.mark.parametrize("remat", ["none", "dots", "full", "save_kv"])
def test_reduced_model_gradients_on_card_match_cpu(dev, arch, n_layers, remat):
    """Every parameter's gradient on the card (the kernels forward and
    backward, under each remat policy) vs the CPU's plain path.  One
    backward call per forward call: flash per attention layer, the SSD scan
    per Mamba layer, RMSNorm per norm1, norm2 (with an FFN), the Mamba
    mixer's gated norm, and the final norm."""
    lds = reduced(ARCHS[arch], n_layers=n_layers).layer_defs()
    n_mamba = sum(ld.mixer == "mamba" for ld in lds)
    norms = sum(1 + (ld.ffn != "none") + (ld.mixer == "mamba") for ld in lds) + 1
    counters = (fa.flash_attention_bwd, ss.ssd_scan_bwd, rn.rmsnorm_bwd)
    before = [c.launches for c in counters]
    (cpu_loss, cpu_grads), (loss, grads) = _card_and_cpu_grads(arch, n_layers, remat, dev)
    assert [c.launches - b for c, b in zip(counters, before)] == [len(lds) - n_mamba, n_mamba,
                                                                  norms]
    np.testing.assert_allclose(loss, cpu_loss, rtol=1e-5)
    for got, want in zip(grads, cpu_grads):
        assert bool(got.abs().max() > 0)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item() + 1e-6)


def test_serving_under_inference_mode_keeps_its_launch_counts(dev):
    """Parameters that require grad (a train state's) still serve through
    the lean forward path: the same launch counts, no backward launches."""
    from repro_torch.serve.engine import Engine
    spec = reduced(ARCHS["qwen2-1.5b"])
    params = map_with_path(lambda _, t: t.requires_grad_(), M.init_params(spec, 0, device=dev))
    eng = Engine(spec, params, max_len=40, device=dev)
    prompts = np.random.default_rng(0).integers(0, spec.vocab_size, (2, 24)).astype(np.int32)
    counters = (fa.flash_attention, fa.flash_attention_bwd, rn.rmsnorm, rn.rmsnorm_bwd)
    before = [c.launches for c in counters]
    out, _ = eng.generate(prompts, max_new=8)
    got = [c.launches - b for c, b in zip(counters, before)]
    assert got == [spec.n_layers, 0, (2 * spec.n_layers + 1) * (1 + 8), 0]
    assert out.shape == (2, 8)


# ---------------------------------------------------------------------------
# the DSE simulation kernels (csrc/dse_sim.cu) and the torch backend on the
# card: float64 kernels held bit for bit against their plain twins and the
# JAX package's numpy durations, the backend against the JAX package's
# reference event loop at RTOL 1e-9 (``repro.core`` is numpy and imports no
# jax)
# ---------------------------------------------------------------------------

DSE_RTOL = 1e-9  # the issue-order sweep vs the event loop (tests/test_backends.py:182)
DSE_BASE = dict(dp=8, sp=1, pp=1, weight_sharded=0, sched_policy="fifo",
                coll_algo=("ring", "direct", "ring", "rhd"), chunks=2,
                multidim_coll="baseline", topology=("ring", "fc", "ring", "switch"),
                npus_per_dim=(4, 8, 4, 8), bw_per_dim=(400, 200, 150, 100))


def _dse_env(kind, backend="reference", device=None, pkg="repro_torch"):
    """An env of ``pkg``: the port, or the JAX package (``repro``, whose
    ``system_env`` takes no device) for the expected side."""
    import importlib
    scenario = importlib.import_module(f"{pkg}.core.scenario")
    system_env = importlib.import_module(f"{pkg}.core.systems").system_env
    sc, obj, extra = {
        "train": (None, "perf_per_bw", {}),
        "disagg": (scenario.DisaggServeScenario(64, 2048, 16), "perf_per_bw",
                   dict(prefill_frac=0.5, decode_batch=4)),
        "request-stream": (scenario.RequestStreamScenario(n_requests=24, seq=1024,
                                                          decode_tokens=16, rate_rps=16.0,
                                                          seed=3), "goodput",
                           dict(prefill_frac=0.5, decode_batch=4, batch_window_ms=50.0,
                                max_inflight=2)),
    }[kind]
    kw = dict(scenario=sc) if sc is not None else dict(batch=64)
    if pkg == "repro_torch":
        kw.update(backend=backend, sim_device=device)
    env = system_env("qwen2-1.5b", "system2", objective=obj, **kw)
    return env, extra


def _dse_population(kind, size):
    """``size`` seeded design points differing in every knob that prices a
    duration (algorithms, chunks, mode, bandwidths, policy), sharing one trace."""
    rng = np.random.default_rng(size)
    algos = ("ring", "direct", "rhd", "dbt")
    _, extra = _dse_env(kind)
    return [dict(DSE_BASE, **extra, coll_algo=tuple(rng.choice(algos) for _ in range(4)),
                 chunks=int(rng.choice((1, 2, 4, 8, 16))),
                 sched_policy=str(rng.choice(("fifo", "lifo"))),
                 multidim_coll=str(rng.choice(("baseline", "blueconnect"))),
                 bw_per_dim=tuple(int(b) for b in rng.choice(range(50, 501, 50), size=4)))
            for _ in range(size)]


def _dse_calls(kind, size, pkg="repro_torch"):
    env, _ = _dse_env(kind, pkg=pkg)
    jobs = [env.scenario.sim_job(env.context(c)) for c in _dse_population(kind, size)]
    calls = [c for j in jobs for c in j.calls]
    tr = calls[0].trace
    return tr, [c for c in calls if c.trace is tr]


def _dse_inputs(backend, tr, calls):
    from repro_torch.core.simulator import plan_duration_tables
    plan, tables = plan_duration_tables(tr, calls)
    return plan, tables, backend._static(tr, plan), backend._class_tables(tables)


def _dse_kernels(st, tab):
    from repro_torch.kernels import dse_sim
    class_t = dse_sim.dse_class_times(
        st["kind"], st["size"], st["is_xfer"], tab["npus"], tab["bw"], tab["lat"], tab["scale"],
        tab["topo"], tab["algo"], tab["chunks"], tab["blue"], tab["xfer_bw"], tab["xfer_lat"])
    dur, finish = dse_sim.dse_sweep(st["parents"], sources=st["sources"], class_t=class_t,
                                    peak=tab["peak"], membw=tab["membw"])
    torch.cuda.synchronize()
    return class_t, dur, finish


@pytest.mark.parametrize("size", [1, 7, 32, 256])
@pytest.mark.parametrize("kind", ["train", "disagg", "request-stream"])
def test_dse_kernels_match_their_plain_twins_bit_for_bit(dev, kind, size):
    from repro.core.simulator import plan_durations_batch
    from repro_torch.core.backends.torch_backend import TorchBackend
    from repro_torch.kernels import dse_sim
    tr, calls = _dse_calls(kind, size)
    plan, _, st, tab = _dse_inputs(TorchBackend(device=dev), tr, calls)
    before = (dse_sim.dse_class_times.launches, dse_sim.dse_sweep.launches)
    class_t, dur, finish = _dse_kernels(st, tab)
    assert (dse_sim.dse_class_times.launches - before[0],
            dse_sim.dse_sweep.launches - before[1]) == (1, 1)
    assert class_t.shape == (len(calls), len(plan.coll_shapes))
    assert dur.shape == (plan.n_ops, len(calls)) and finish.shape == (plan.n_ops + 1, len(calls))
    args = [st["kind"], st["size"], st["is_xfer"]] + [tab[k] for k in (
        "npus", "bw", "lat", "scale", "topo", "algo", "chunks", "blue", "xfer_bw", "xfer_lat")]
    assert torch.equal(class_t, dse_sim.class_times_plain(*args))
    want_dur = dse_sim.op_durations_plain(st["sources"], class_t, tab["peak"], tab["membw"])
    assert torch.equal(dur, want_dur)
    assert torch.equal(finish, dse_sim.sweep_plain(st["parents"], dur))
    # the JAX package's numpy duration pass on the same population, on the host
    _, want = plan_durations_batch(*_dse_calls(kind, size, pkg="repro"))
    assert np.array_equal(dur.cpu().numpy(), want.T)
    # the given-durations mode (the unfused path) sweeps the same bits
    same, fin2 = dse_sim.dse_sweep(st["parents"], dur=dur.clone())
    assert torch.equal(fin2, finish) and torch.equal(same, dur)


@pytest.mark.parametrize("kind", ["train", "disagg", "request-stream"])
@pytest.mark.parametrize("backend", ["torch", "torch-unfused"])
def test_dse_torch_backend_on_the_card_matches_reference(dev, kind, backend):
    from repro.core import cache as j_cache
    from repro_torch.core import cache
    from repro_torch.kernels import dse_sim
    cache.clear_all_caches()
    j_cache.clear_all_caches()
    cfgs = _dse_population(kind, 16)
    env_ref, _ = _dse_env(kind, pkg="repro")
    env_t, _ = _dse_env(kind, backend=backend)  # the default device: the card
    before = (dse_sim.dse_class_times.launches, dse_sim.dse_sweep.launches)
    got = env_t.step_batch(cfgs)
    launched = (dse_sim.dse_class_times.launches - before[0],
                dse_sim.dse_sweep.launches - before[1])
    assert launched[0] == (launched[1] if backend == "torch" else 0) and launched[1] >= 1
    want = [env_ref.evaluate_config(c) for c in cfgs]
    assert sum(w.valid for w in want) >= 8
    for g, w in zip(got, want):
        assert g.valid == w.valid
        if w.valid:
            assert abs(g.reward - w.reward) <= DSE_RTOL * abs(w.reward)
            assert abs(g.latency_ms - w.latency_ms) <= DSE_RTOL * abs(w.latency_ms)


def test_dse_forward_dependency_raises_on_the_card(dev):
    from repro_torch.core.backends import get_backend
    from repro_torch.core.compute import SYSTEM_2_DEVICE
    from repro_torch.core.simulator import SystemConfig
    from repro_torch.core.topology import system_2
    from repro_torch.core.workload import Op, Parallelism, Trace
    ops = [Op(uid=0, name="a", kind="comp", deps=[1], flops=1e9, bytes=1e6),
           Op(uid=1, name="b", kind="comp", deps=[], flops=1e9, bytes=1e6)]
    cfg = SystemConfig(network=system_2(), device=SYSTEM_2_DEVICE,
                       coll_algo=("ring", "direct", "ring", "rhd"))
    with pytest.raises(ValueError, match="depends on a later op"):
        get_backend("torch").simulate(Trace(ops=ops), cfg, Parallelism(1024, 64, 4, 1))


@pytest.mark.parametrize("kind", ["train", "request-stream"])
def test_dse_kernels_give_the_same_bits_twice(dev, kind):
    from repro_torch.core.backends.torch_backend import TorchBackend
    tr, calls = _dse_calls(kind, 32)
    _, _, st, tab = _dse_inputs(TorchBackend(device=dev), tr, calls)
    first, second = _dse_kernels(st, tab), _dse_kernels(st, tab)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# the sweep kernel's window: synthetic parent tables (dse_sim.synthetic_sweep_case)
# whose parents sit in registers (1 or 2 ops back), in the ring (up to
# dse_sim.RING back) and in the finish table (up to 5,000 back), with ops
# whose parents are all padded and ops naming a parent twice; op counts no
# multiple of the kernel's 256-op tile, and lanes left over in the last block

def _numpy_max_plus(parents, dur):
    """finish[i] = dur[i] + max(finish[parents[i]]) in uid order, numpy."""
    n_ops, P = dur.shape
    fin = np.zeros((n_ops + 1, P))
    for i in range(n_ops):
        fin[i] = dur[i] + fin[parents[i]].max(axis=0)
    return fin


def _synthetic_sources(seed, n_ops, P, dev):
    """Duration sources of every kind (zero, compute, collective, delay) and a
    class table for P members, from a seeded numpy generator."""
    from repro_torch.kernels import dse_sim
    rng = np.random.default_rng(seed)
    n_comp, n_coll, n_delay, C = 5, 4, 3, 3

    def put(a, dtype=torch.float64):
        return torch.as_tensor(a, dtype=dtype, device=dev).contiguous()
    src = dse_sim.Sources(
        put(rng.integers(0, 1 + n_comp + n_coll + n_delay, n_ops), torch.int32),
        put(rng.uniform(1e9, 1e13, n_comp)), put(rng.uniform(1e6, 1e10, n_comp)),
        put(rng.integers(0, C, n_coll), torch.int32), put(rng.integers(1, 5, n_coll)),
        put(rng.uniform(0.0, 50.0, n_delay)))
    return (src, put(rng.uniform(1.0, 500.0, (P, C))), put(rng.uniform(1e14, 1e15, P)),
            put(rng.uniform(1e12, 3e12, P)))


def _check_window(dev, parents_np, dur, finish):
    from repro_torch.kernels import dse_sim
    torch.cuda.synchronize()
    parents = torch.from_numpy(parents_np).to(dev)
    assert finish.shape == (parents.shape[0] + 1, dur.shape[1])
    assert torch.equal(finish, dse_sim.sweep_plain(parents, dur))
    assert np.array_equal(finish.cpu().numpy(), _numpy_max_plus(parents_np, dur.cpu().numpy()))


@pytest.mark.parametrize("mode", ["dur", "sources"])
@pytest.mark.parametrize("n_ops,W", [(6001, 8), (2003, 4), (1037, 3)])
@pytest.mark.parametrize("P", [1, 31, 33, 257])
def test_dse_sweep_window_matches_plain_bit_for_bit(dev, mode, n_ops, W, P):
    from repro_torch.kernels import dse_sim
    parents_np, dur_np = dse_sim.synthetic_sweep_case(n_ops + P, n_ops, W, P)
    parents = torch.from_numpy(parents_np).to(dev)
    served = dse_sim.sweep_served_from(parents)
    assert min(served.values()) > 0, served
    before = dse_sim.dse_sweep.launches
    if mode == "dur":
        dur = torch.from_numpy(dur_np).to(dev)
        same, finish = dse_sim.dse_sweep(parents, dur=dur)
        assert same is dur
    else:
        src, class_t, peak, membw = _synthetic_sources(P, n_ops, P, dev)
        dur, finish = dse_sim.dse_sweep(parents, sources=src, class_t=class_t, peak=peak,
                                        membw=membw)
        assert torch.equal(dur, dse_sim.op_durations_plain(src, class_t, peak, membw))
    assert dse_sim.dse_sweep.launches == before + 1
    _check_window(dev, parents_np, dur, finish)


@pytest.mark.parametrize("n_ops,W,P", [(1, 1, 33), (5, 2, 1), (256, 4, 2), (257, 5, 32),
                                       (65, 9, 40), (700, 300, 33), (530, 1, 3), (771, 2, 5),
                                       (1025, 3, 2), (600, 4, 3)])
def test_dse_sweep_window_edges(dev, n_ops, W, P):
    """One op; a tile cut short; exactly one tile; wider rows than the
    branch-free walk takes; a table so wide that the kernel halves its tile;
    the branch-free walk at each W over several tiles, the last one cut to
    each remainder of its unrolled loop."""
    from repro_torch.kernels import dse_sim
    parents_np, dur_np = dse_sim.synthetic_sweep_case(W, n_ops, W, P)
    dur = torch.from_numpy(dur_np).to(dev)
    _, finish = dse_sim.dse_sweep(torch.from_numpy(parents_np).to(dev), dur=dur)
    _check_window(dev, parents_np, dur, finish)


def _near_walk_case(W, last_rows):
    """Five tiles of ops with W parents each: every parent within the ring
    but in the third tile, which holds one parent further back; the last
    tile cut to ``last_rows`` ops."""
    from repro_torch.kernels import dse_sim
    T = dse_sim.TILE
    n_ops = 4 * T + last_rows
    parents, dur = dse_sim.synthetic_sweep_case(10 * W + last_rows, n_ops, W, 33)
    i = np.arange(n_ops)[:, None]
    parents[(parents < n_ops) & (i - parents > dse_sim.RING)] = n_ops
    far = 2 * T + 7
    parents[far, 0] = far - dse_sim.RING - 50
    back = np.where(parents < n_ops, i - parents, 0)
    near = [int(back[t:t + T].max()) <= dse_sim.RING for t in range(0, n_ops, T)]
    assert near == [True, True, False, True, True]
    return parents, dur


@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("last_rows", [1, 2, 3, 4, 253, 254, 255, 256])
def test_dse_sweep_near_walk_every_remainder(dev, W, last_rows):
    """The branch-free walk at every W it takes, over four tiles of all-near
    parents and one tile of the general walk between them, the last tile
    cut to every remainder 0 to 3 of the walk's four ops a trip."""
    from repro_torch.kernels import dse_sim
    parents_np, dur_np = _near_walk_case(W, last_rows)
    dur = torch.from_numpy(dur_np).to(dev)
    _, finish = dse_sim.dse_sweep(torch.from_numpy(parents_np).to(dev), dur=dur)
    _check_window(dev, parents_np, dur, finish)


def test_dse_sweep_refuses_a_table_too_wide_for_shared_memory(dev):
    from repro_torch.kernels import dse_sim
    parents = torch.full((8, 6000), 8, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="dse_sweep kernel launch failed"):
        dse_sim.dse_sweep(parents, dur=torch.zeros((8, 4), dtype=torch.float64, device=dev))


def test_dse_sweep_refuses_an_unaligned_parents_table(dev):
    from repro_torch.kernels import dse_sim
    parents = torch.full((8 * 3 + 1,), 8, dtype=torch.int32, device=dev)[1:].view(8, 3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        dse_sim.dse_sweep(parents, dur=torch.zeros((8, 4), dtype=torch.float64, device=dev))


def test_fp64_chain_probe_counts_the_chain(dev):
    from repro_torch.kernels import dse_sim
    short, long_ = dse_sim.fp64_chain_probe(1 << 10, dev), dse_sim.fp64_chain_probe(1 << 14, dev)
    assert 2 * (1 << 10) <= short < long_ and long_ >= 2 * (1 << 14)


def test_operators_launch_on_the_card_and_stand_ins_do_not(dev):
    """A real CUDA tensor reaches each kernel through its operator and counts
    a launch; a fake stand-in labelled cuda takes the fake implementation,
    with the same shapes, and counts none."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    q = torch.randn((1, 64, 4, 64), device=dev)
    x, w = torch.randn((8, 128), device=dev), torch.randn((128,), device=dev)
    xs, dt = torch.randn((1, 64, 4, 16), device=dev), torch.rand((1, 64, 4), device=dev)
    a, bc = -torch.rand((4,), device=dev), torch.randn((1, 64, 1, 16), device=dev)
    counted = (fa.flash_attention, rn.rmsnorm, ss.ssd_scan)
    before = [f.launches for f in counted]
    real = (fa.flash_attention(q, q, q), rn.rmsnorm(x, w), ss.ssd_scan(xs, dt, a, bc, bc)[0])
    assert [f.launches - b for f, b in zip(counted, before)] == [1, 1, 1]
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fq, fx, fw = (mode.from_tensor(t) for t in (q, x, w))
        fxs, fdt, fa_, fbc = (mode.from_tensor(t) for t in (xs, dt, a, bc))
        fake = (fa.flash_attention(fq, fq, fq), rn.rmsnorm(fx, fw),
                ss.ssd_scan(fxs, fdt, fa_, fbc, fbc)[0])
    assert [f.launches - b for f, b in zip(counted, before)] == [1, 1, 1]
    for r, f in zip(real, fake):
        assert f.shape == r.shape and f.dtype == r.dtype and f.device.type == "cuda"


class _PieceSums:
    """The split-row mode's ``reduce`` on one card: this piece's partial sums
    plus the other pieces' (fixed tensors): the sum of squares, then the sum
    of g (1 + w) x."""

    def __init__(self, others):
        self.others, self.calls = others, 0

    def __call__(self, t):
        self.calls += 1
        return t + self.others[self.calls - 1]


@pytest.mark.parametrize("rows,d,d_full", [
    (16384, 96, 1536),   # mamba2-130m's gated norm on one of 16 'model' ranks: train rows
    (4, 96, 1536),       # and a decode step's
    (1000, 40, 1536),    # a ragged piece
    (37, 37, 1000),      # d no multiple of the vector: element by element
    (64, 2048, 4096),    # 256 threads a row
    (5, 8192, 16384),    # a row wider than a block's vectors: the loop over them
])
@pytest.mark.parametrize("dtype,wdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.float32),
                                          (torch.bfloat16, torch.bfloat16)])
def test_rmsnorm_split_matches_plain(dev, rows, d, d_full, dtype, wdtype):
    """The split-row mode on one piece of rows ``d_full`` wide, the other
    pieces' sums fixed: each launch (the partial sums, the apply, the
    backward) against its plain twin on the same inputs, and forward and
    backward through ``rmsnorm_split`` (two forward launches, two backward
    calls) against the plain chain; the backward twice for the same bits."""
    gen = torch.Generator(device=dev).manual_seed(21)
    x = (torch.randn((rows, d), generator=gen, device=dev) * 3).to(dtype)
    w = (torch.randn((d,), generator=gen, device=dev) * 0.1).to(wdtype)
    g = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
    others = [(torch.randn((rows, d_full - d), generator=gen, device=dev) * 3).square().sum(-1),
              torch.randn((rows,), generator=gen, device=dev) * (d_full - d) ** 0.5]
    ss = ref.rmsnorm_part_ref(x) + others[0]
    st = ref.rmsnorm_part_ref(x, w, g) + others[1]
    _close_grad(rn.rmsnorm_part(x) + others[0], ss, torch.float32)
    _close_grad(rn.rmsnorm_part(x, w, g) + others[1], st, torch.float32)
    _close(rn.rmsnorm_apply(x, w, ss, d_full=d_full),
           ref.rmsnorm_apply_ref(x, w, ss, d_full=d_full), dtype)
    got = rn.rmsnorm_split_bwd(x, w, g, ss, st, d_full=d_full)
    want = ref.rmsnorm_split_bwd_ref(x, w, g, ss, st, d_full=d_full)
    assert all(torch.equal(a, b) for a, b in zip(got, rn.rmsnorm_split_bwd(x, w, g, ss, st,
                                                                            d_full=d_full)))
    _close_grad(got[0], want[0], dtype)
    _close_grad(got[1], want[1], wdtype if wdtype == torch.bfloat16 else dtype)
    before = rn.rmsnorm_split.launches, rn.rmsnorm_split_bwd.launches
    xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = rn.rmsnorm_split(xg, wg, d_full=d_full, reduce=_PieceSums(others))
    dx, dw = torch.autograd.grad(y, (xg, wg), g)
    assert (rn.rmsnorm_split.launches, rn.rmsnorm_split_bwd.launches) == (before[0] + 2,
                                                                          before[1] + 2)
    _close(y, ref.rmsnorm_apply_ref(x, w, ss, d_full=d_full), dtype)
    _close_grad(dx, want[0], dtype)
    _close_grad(dw, want[1], wdtype if wdtype == torch.bfloat16 else dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_split_reads_strided_rows(dev, dtype):
    """A piece as a view with a row stride other than its width (a column
    slice of wider rows), forward and backward."""
    gen = torch.Generator(device=dev).manual_seed(22)
    base = (torch.randn((300, 100), generator=gen, device=dev) * 3).to(dtype)
    x, g = base[:, :96], torch.randn((300, 96), generator=gen, device=dev).to(dtype)
    w = (torch.randn((96,), generator=gen, device=dev) * 0.1).to(dtype)
    ss = ref.rmsnorm_part_ref(x) + 7.0
    st = ref.rmsnorm_part_ref(x, w, g) - 3.0
    _close_grad(rn.rmsnorm_part(x), ref.rmsnorm_part_ref(x), torch.float32)
    _close(rn.rmsnorm_apply(x, w, ss, d_full=192), ref.rmsnorm_apply_ref(x, w, ss, d_full=192),
           dtype)
    for a, b in zip(rn.rmsnorm_split_bwd(x, w, g, ss, st, d_full=192),
                    ref.rmsnorm_split_bwd_ref(x, w, g, ss, st, d_full=192)):
        _close_grad(a, b, dtype)
