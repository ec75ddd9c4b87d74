"""Flash attention on Hopper: the port of the JAX package's Pallas kernel
``kernels/flash_attention.py`` (``flash_attention``, :76).

The kernel is CUDA C++ (``repro_torch/csrc/flash_attention.cu``, whose
header says what bounds it on the H100 and what its design does about it),
built for ``sm_90a`` and called through ``ctypes``: bf16 on ``wgmma`` and
f32 in 3xTF32 on ``mma.sync``, both fed by TMA.  It reads the model layout
directly: q (B, S, H, hd) and k/v (B, T, G, hd), head ``h`` reading KV group
``h // (H/G)`` through 4-D tensor maps, so nothing is folded, repeated or
padded in memory.  Any S and T: TMA fills rows past S and T with zeros and
the kernel masks keys by the true T.  TMA needs a 16-byte aligned base and
byte strides that are multiples of 16 (``tma_layout_problem``); the wrapper
raises ``ValueError`` on a view that breaks this, and never copies it.

``flash_attention`` takes the kernel for a CUDA tensor and its plain version
(``flash_attention_plain``, built on ``ref.attention_ref``) for a CPU tensor;
any other device raises.  ``flash_attention.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i,
                   ctypes.POINTER(ctypes.c_longlong), i, i, ctypes.c_float, vp]
    fn.restype = i
    return fn


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None):
    """The kernel's plain version, in its layout: q (B,S,H,hd), k/v (B,T,G,hd)."""
    b, s, h, hd = q.shape
    t, g = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // g, dim=2)
    v = v.repeat_interleave(h // g, dim=2)

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, x.shape[1], hd)

    o = ref.attention_ref(fold(q), fold(k), fold(v), causal=causal, window=window,
                          scale=scale)
    return o.reshape(b, h, s, hd).transpose(1, 2)


def tma_layout_problem(shape, strides, elem_size: int, ptr: int) -> str | None:
    """Why TMA cannot read a (batch, sequence, heads, hd) tensor of this
    layout (element ``strides``, ``elem_size`` bytes, base address ``ptr``),
    or None if it can.  A dimension of extent 1 is never stepped, so its
    stride does not count."""
    if strides[-1] != 1:
        return "the head_dim axis must be contiguous"
    if ptr % 16:
        return f"the base address {ptr:#x} is not 16-byte aligned"
    for name, n, st in zip(("batch", "sequence", "head"), shape[:3], strides[:3]):
        if n > 1 and st * elem_size % 16:
            return (f"the {name} stride ({st} elements of {elem_size} bytes) is no multiple "
                    f"of 16 bytes")
    return None


def _check(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,hd) and k/v (B,T,G,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share one dtype and one device")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q: (B, S, H, hd); k/v: (B, T, G, hd).  Returns (B, S, H, hd) of q.dtype."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    b, s, h, hd = q.shape
    t, g = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, not {hd}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes {sorted(map(str, _DTYPES))}, not {q.dtype}")
    if b * s * h == 0 or t == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        problem = tma_layout_problem(x.shape, x.stride(), x.element_size(), x.data_ptr())
        if problem:
            raise ValueError(f"{name} {tuple(x.shape)} strides {x.stride()}: {problem}")
    o = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    scale = scale or 1.0 / math.sqrt(hd)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *o.stride()[:3])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype], b, s, t,
            h, g, hd, strides, int(causal), int(window), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        err = _entry()(*args)
    if err:
        raise RuntimeError("flash_attention: a TMA descriptor could not be encoded" if err == -1
                           else f"flash_attention kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
