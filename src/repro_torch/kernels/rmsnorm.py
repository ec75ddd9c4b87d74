"""Fused RMSNorm on Hopper: the port of the JAX package's Pallas kernel
``kernels/rmsnorm.py`` (``rmsnorm``, :23).

The kernel is Triton: one program per row reads the row once, reduces the
f32 mean of squares, scales by ``rsqrt(var + eps) * (1 + w)`` in f32 and
casts once on the write.  It does a handful of flops per byte, so it is
bound by device-memory bytes (one read of x, one write of the output, w
from L2); the design keeps the whole row in registers so each byte moves
once, and uses no tensor cores.  Rows = B*S in prefill and B in decode.

``rmsnorm`` takes the kernel for a CUDA tensor and the plain version
``ref.rmsnorm_ref`` for a CPU tensor; any other device raises.
``rmsnorm.launches`` counts kernel launches.  ``triton`` is imported on the
first launch, so CPU-only hosts can import this module.

The JAX model's ``layers.rmsnorm`` (:81-85) casts to the working dtype
*before* the ``(1 + w)`` multiply, while the kernel (and ``rmsnorm_ref``)
multiply in f32 and cast once.  The two agree exactly in fp32, the serving
Engine's dtype, and differ by one bf16 rounding in bf16.  The port follows
the kernel.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref

tl = None  # triton.language, bound on the first launch


@functools.cache
def _kernel():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, w_ptr, o_ptr, x_row_stride, o_row_stride, d, eps,
                       BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        x = tl.load(x_ptr + row * x_row_stride + cols, mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / d
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = x * tl.rsqrt(var + eps) * (1.0 + w)
        tl.store(o_ptr + row * o_row_stride + cols, y.to(o_ptr.dtype.element_ty), mask=mask)

    return rmsnorm_kernel


def rmsnorm(x, w, *, eps: float = 1e-5):
    """x: (rows, d); w: (d,).  Returns (rows, d) of x.dtype."""
    if x.ndim != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"want x (rows, d) and w (d,); got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError("x and w must share one device")
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on CUDA or CPU tensors, not {x.device}")
    rows, d = x.shape
    block = 1 << max(d - 1, 1).bit_length()
    if x.stride(1) != 1 or w.stride(0) != 1 or block > 65536 or rows == 0:
        raise ValueError(f"the kernel takes 0 < d <= 65536 with contiguous rows; "
                         f"got x {tuple(x.shape)} strides {x.stride()}")
    o = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        _kernel()[(rows,)](x, w, o, x.stride(0), o.stride(0), d, eps, BLOCK=block,
                           num_warps=min(max(block // 256, 1), 16))
    rmsnorm.launches += 1
    return o


rmsnorm.launches = 0
