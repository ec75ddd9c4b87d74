"""Flash attention on Hopper: the port of the JAX package's Pallas kernel
``kernels/flash_attention.py`` (``flash_attention``, :76).

The kernel is CUDA C++ (``repro_torch/csrc/flash_attention.cu``, whose
header says what bounds it on the H100 and what its design does about it),
built for ``sm_90a`` and called through ``ctypes``: bf16 on ``wgmma`` and
f32 in 3xTF32 on ``mma.sync``, both fed by TMA.  It reads the model layout
directly: q (B, S, H, hd) and k/v (B, T, G, hd), head ``h`` reading KV group
``h // (H/G)`` through 4-D tensor maps, so nothing is folded, repeated or
padded in memory.  Any S and T: TMA fills rows past S and T with zeros and
the kernel masks keys by the true T.  ``q_offset`` places query row ``i`` at
position ``q_offset + i`` of the key sequence (keys from 0): the causal mask
keeps ``j <= q_offset + i`` and a window ``j > q_offset + i - window``, so a
rank of a sequence-split attention runs its own rows against the whole K/V;
a causal call needs ``T >= q_offset + S``.  TMA needs a 16-byte aligned base and
byte strides that are multiples of 16 (``tma_layout_problem``); the wrapper
raises ``ValueError`` on a view that breaks this, and never copies it.

``flash_attention`` takes the kernel for a CUDA tensor and its plain version
(``flash_attention_plain``, built on ``ref.attention_ref``) for a CPU tensor;
any other device raises.  ``flash_attention.launches`` counts kernel
launches.

Each launch is an operator (``kernels/_library.py``):
``torch.ops.repro_torch.flash_fwd`` and ``flash_bwd``.  A ``FakeTensor``
(the dry run's stand-ins, labelled ``cpu`` or ``cuda``) takes the operator
before any device branch, so its fake implementation gives the shapes,
nothing is launched and no launch is counted; the dense plain version is
never reached either.  The FLOP formulas count what the kernels do per
(batch, head) and unmasked (query, key) pair (``pairs``): 4 hd forward (Q
K^T and P V), 10 hd backward (Q K^T again, dO V^T, P^T dO, dS^T Q, dS K),
the counts behind ``chip_smoke.py``'s bounds.

Gradients.  When grad mode is on and an input requires grad, a CUDA call
goes through ``FlashAttentionFn``: its forward launches the same kernel and
also keeps each row's log-sum-exp, and its backward is
``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``, also on the tensor
cores: D = rowsum(dO o O), a dK/dV pass with keys as rows, a dQ pass, and
under GQA a sum of each group's heads, deterministic throughout;
``flash_attention_bwd.launches`` counts calls).  Otherwise (serving,
``inference_mode``) the call launches the forward alone, as lean as before.
A CPU call differentiates through the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build, _library, ref

HEAD_DIMS = (16, 32, 64, 96, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LSE_ROWS = 128  # the backward's (B, H, S) row statistics are padded to a multiple of this


@functools.cache
def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i,
                   ctypes.POINTER(ctypes.c_longlong), i, i, i, ctypes.c_float, vp]
    fn.restype = i
    return fn


@functools.cache
def _bwd_entry():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    i, pll = ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [pll, pll, i, i, i, i, i, i, i, i, i, i, ctypes.c_float, ctypes.c_void_p]
    fn.restype = i
    return fn


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None, q_offset: int = 0):
    """The kernel's plain version, in its layout: q (B,S,H,hd), k/v (B,T,G,hd),
    query row i at position ``q_offset + i``."""
    b, s, h, hd = q.shape
    t, g = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // g, dim=2)
    v = v.repeat_interleave(h // g, dim=2)

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, x.shape[1], hd)

    o = ref.attention_ref(fold(q), fold(k), fold(v), causal=causal, window=window,
                          scale=scale, q_offset=q_offset)
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


def _check(q, k, v, window, causal=True, q_offset=0):
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
    if q_offset < 0 or (causal and k.shape[1] < q_offset + s):
        raise ValueError(f"query offset {q_offset}: want 0 <= q_offset and, causal, "
                         f"T >= q_offset + S; got S {s}, T {k.shape[1]}")


def _check_card(q, k, v):
    b, s, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, not {hd}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes {sorted(map(str, _DTYPES))}, not {q.dtype}")
    if b * s * h == 0 or k.shape[1] == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if _library.is_fake(q):
        return  # no storage: the layout is checked where the kernel launches
    for name, x in (("q", q), ("k", k), ("v", v)):
        problem = tma_layout_problem(x.shape, x.stride(), x.element_size(), x.data_ptr())
        if problem:
            raise ValueError(f"{name} {tuple(x.shape)} strides {x.stride()}: {problem}")


def _launch(q, k, v, causal, window, scale, with_lse: bool, q_offset: int = 0):
    """One forward launch on checked CUDA tensors: o, and each row's f32
    log-sum-exp (B, H, S) if ``with_lse`` (else None).  The CUDA
    implementation of ``repro_torch::flash_fwd``."""
    b, s, h, hd = q.shape
    t, g = k.shape[1], k.shape[2]
    o = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *o.stride()[:3])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None, _DTYPES[q.dtype], b, s, t, h, g, hd, strides,
            int(causal), int(window), int(q_offset), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        err = _entry()(*args)
    if err:
        raise RuntimeError("flash_attention: a TMA descriptor could not be encoded" if err == -1
                           else f"flash_attention kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return o, lse


def _tma_ready(x):
    """x itself if TMA can read it (a stride of 0, as an expanded gradient
    has, is never handed to a tensor map), else a copy in a fresh, hence
    aligned, contiguous buffer (``contiguous()`` would keep an unaligned
    view that is contiguous already)."""
    shape, strides = x.shape, x.stride()
    if any(n > 1 and st == 0 for n, st in zip(shape, strides)) or tma_layout_problem(
            shape, strides, x.element_size(), x.data_ptr()):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, window: int = 0,
                        scale: float | None = None, q_offset: int = 0):
    """The backward kernels on CUDA tensors (or fake ones): q/o/do (B,S,H,hd),
    k/v (B,T,G,hd), lse the forward's f32 (B,H,S), the forward's
    ``q_offset``.  Returns dq, dk, dv in the layouts and dtype of q, k and v."""
    _check(q, k, v, window, causal, q_offset)
    _check_card(q, k, v)
    b, s, h, hd = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, s):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} or lse {tuple(lse.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError("o and do take q's dtype, lse float32")
    return _bwd_op(q, k, v, o, lse, do, causal, window, float(scale or 1.0 / math.sqrt(hd)),
                   int(q_offset))


def _launch_bwd(q, k, v, o, lse, do, causal, window, scale, q_offset):
    """One backward call on checked CUDA tensors: the CUDA implementation of
    ``repro_torch::flash_bwd``."""
    b, s, h, hd = q.shape
    t, g = k.shape[1], k.shape[2]
    # dO goes through TMA and o through 16-byte loads: an autograd gradient
    # may come expanded (stride 0) or unaligned, and is then copied
    o, do = _tma_ready(o), _tma_ready(do)
    lse = lse.contiguous()
    dev, f32 = q.device, torch.float32
    rows = -(-s // _LSE_ROWS) * _LSE_ROWS  # lse2 and D, padded for the kernels' query tiles
    lse2, delta = (torch.empty((b, h, rows), dtype=f32, device=dev) for _ in range(2))
    dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=dev) for x in (q, k, v))
    # GQA: each query head's dK and dV in f32, summed per group by the last launch
    sk, sv = ((torch.empty((b, t, h, hd), dtype=f32, device=dev) for _ in range(2)) if h > g
              else (None, None))
    ts = (q, k, v, o, do, lse, lse2, delta, dq, dk, dv, sk, sv)
    ptrs = (ctypes.c_longlong * 13)(*(0 if x is None else x.data_ptr() for x in ts))
    strides = (ctypes.c_longlong * 15)(*(st for x in (q, k, v, o, do) for st in x.stride()[:3]))
    with torch.cuda.device(dev):
        err = _bwd_entry()(ptrs, strides, _DTYPES[q.dtype], b, s, t, h, g, hd, int(causal),
                           int(window), int(q_offset), float(scale),
                           torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("flash_attention_bwd: a TMA descriptor could not be encoded"
                           if err == -1 else
                           f"flash_attention_bwd kernel launch failed with CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def pairs(s: int, t: int, causal: bool, window: int, q_offset: int = 0) -> int:
    """The (query, key) pairs the kernel's mask keeps: key j of T for query
    row i of S, at position i + q_offset, when j <= i + q_offset (causal) and
    j > i + q_offset - window (a window)."""
    i = np.arange(s, dtype=np.int64) + q_offset
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _fwd_fake(q, k, v, causal, window, scale, with_lse, q_offset):
    b, s, h, hd = q.shape
    return (q.new_empty((b, s, h, hd)),
            q.new_empty((b, h, s) if with_lse else (0,), dtype=torch.float32))


def _fwd_flops(q, k, v, causal, window, scale, with_lse, q_offset, *, out_shape=None, **_):
    b, s, h, hd = q
    return 4 * hd * b * h * pairs(s, k[1], causal, window, q_offset)


def _fwd_cuda(q, k, v, causal, window, scale, with_lse, q_offset):
    o, lse = _launch(q, k, v, causal, window, scale, with_lse, q_offset)
    return o, (lse if with_lse else q.new_empty((0,), dtype=torch.float32))


def _bwd_fake(q, k, v, o, lse, do, causal, window, scale, q_offset):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _bwd_flops(q, k, v, o, lse, do, causal, window, scale, q_offset, *, out_shape=None, **_):
    b, s, h, hd = q
    return 10 * hd * b * h * pairs(s, k[1], causal, window, q_offset)


_fwd_op = _library.define(
    "flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, int window, float scale, "
    "bool with_lse, int q_offset) -> (Tensor, Tensor)", _fwd_cuda, _fwd_fake, _fwd_flops)
_bwd_op = _library.define(
    "flash_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do, bool causal, "
    "int window, float scale, int q_offset) -> (Tensor, Tensor, Tensor)", _launch_bwd, _bwd_fake,
    _bwd_flops)


class FlashAttentionFn(torch.autograd.Function):
    """The kernel with its gradient: the forward keeps q, k, v, o and each
    row's log-sum-exp; the backward is ``flash_attention_bwd`` at the same
    mask and query offset."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        o, lse = _fwd_op(q, k, v, causal, window, scale, True, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, scale, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale, q_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                                         scale=scale, q_offset=q_offset)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, q_offset: int = 0):
    """q: (B, S, H, hd); k/v: (B, T, G, hd); query row i at position
    ``q_offset + i``.  Returns (B, S, H, hd) of q.dtype."""
    q_offset = int(q_offset)
    _check(q, k, v, window, causal, q_offset)
    if not _library.is_fake(q):
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale,
                                         q_offset=q_offset)
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    _check_card(q, k, v)
    scale = scale or 1.0 / math.sqrt(q.shape[3])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale, q_offset)
    return _fwd_op(q, k, v, causal, window, scale, False, q_offset)[0]


flash_attention.launches = 0
flash_attention_bwd.launches = 0
