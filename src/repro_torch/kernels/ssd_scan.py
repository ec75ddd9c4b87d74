"""Mamba2 SSD chunked scan on Hopper: the port of the JAX package's Pallas
kernel ``kernels/ssd_scan.py`` (``ssd_scan``, :71).

The kernels are CUDA C++ (``repro_torch/csrc/ssd_scan.cu``, whose header says
what bounds each phase on the H100 and what the design does about it), built
for ``sm_90a`` and called through ``ctypes``.  One call runs the chunk-parallel
SSD decomposition in three launches on PyTorch's current stream:

1. ``ssd_scan_chunk_state``: per (chunk, batch*head), the chunk's cumsum of
   dt*a, its state contribution B^T (x*dt*decay-to-end) and its decay, into a
   scratch buffer this wrapper allocates (``scratch_floats``);
2. ``ssd_scan_state_pass``: per state element, the chain over chunks, which
   leaves the state entering each chunk in the scratch and writes the final
   state;
3. ``ssd_scan_output_f32`` / ``ssd_scan_output_bf16``: per (chunk,
   batch*head), y from the chunk's scores and its entering state (bf16 on
   the tensor cores).

The kernels read the model layout directly: x (B, S, H, P), dt (B, S, H),
b/c (B, S, G, N), head ``h`` reading group ``h // (H/G)`` through strides,
and write the final state directly as (B, H, P, N).  Their chunk length (64)
is their own choice; any S, the ragged last chunk masked.  Rows of x, b and c
are read 16 bytes at a time, so a view whose rows are not 16-byte aligned is
copied first.

``ssd_scan`` takes the kernels for a CUDA tensor and its plain version
(``ssd_scan_plain``, built on ``ref.ssd_ref``) for a CPU tensor; any other
device raises.  ``ssd_scan.launches`` counts calls that launched the kernels:
one per call, whatever the three launches inside it.

The kernels have no backward yet (ROADMAP.md Queue 1: the SSD scan backward
kernel, with mamba2-130m training).  So that no gradient is ever dropped
silently, a CUDA call raises ``NotImplementedError`` when grad mode is on and
an input requires grad.  A CPU call differentiates through the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

DIMS = (16, 32, 64, 128)  # the head dims P and state sizes N the kernel takes
CHUNK = 64  # the kernels' chunk length, L in csrc/ssd_scan.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _entry():
    fn = _build.load("ssd_scan").ssd_scan_fwd
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, i, i, i, i, i, i, i,
                   ctypes.POINTER(ctypes.c_longlong), vp]
    fn.restype = i
    return fn


def scratch_floats(bsz: int, s: int, h: int, p: int, n: int) -> int:
    """f32 scratch of one call: each chunk's (N, P) state and its decay, per
    (batch, head)."""
    return bsz * h * -(-s // CHUNK) * (n * p + 1)


def _aligned(t) -> bool:
    """Rows of ``t`` (all but its last, contiguous dim) start on 16 bytes."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(st % per == 0 for st in t.stride()[:-1])


def ssd_scan_plain(x, dt, a, b, c):
    """The kernel's plain version, in its layout: x (B,S,H,P), dt (B,S,H),
    a (H,), b/c (B,S,G,N) -> y (B,S,H,P) of x.dtype, state (B,H,P,N) f32."""
    bsz, s, h, p = x.shape
    n = b.shape[3]
    rep = h // b.shape[2]

    def fold(t):  # (B,S,H,...) -> (B*H,S,...)
        return t.transpose(1, 2).reshape(bsz * h, s, *t.shape[3:])

    y, hl = ref.ssd_ref(fold(x), fold(dt), a.repeat(bsz), fold(b.repeat_interleave(rep, dim=2)),
                        fold(c.repeat_interleave(rep, dim=2)))
    return (y.reshape(bsz, h, s, p).transpose(1, 2),
            hl.reshape(bsz, h, n, p).transpose(2, 3))


def _check(x, dt, a, b, c):
    if x.ndim != 4 or dt.ndim != 3 or a.ndim != 1 or b.ndim != 4 or b.shape != c.shape:
        raise ValueError(f"want x (B,S,H,P), dt (B,S,H), a (H,), b/c (B,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    bsz, s, h, _ = x.shape
    g = b.shape[2]
    if dt.shape != (bsz, s, h) or a.shape != (h,) or b.shape[:2] != (bsz, s):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)} or b/c {tuple(b.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if g == 0 or h % g:
        raise ValueError(f"{g} groups do not divide {h} heads")
    if not (x.dtype == b.dtype == c.dtype) or dt.dtype != torch.float32 \
            or a.dtype != torch.float32:
        raise ValueError(f"want x, b, c of one dtype and dt, a in float32; got x {x.dtype}, "
                         f"b {b.dtype}, c {c.dtype}, dt {dt.dtype}, a {a.dtype}")
    if len({t.device for t in (x, dt, a, b, c)}) != 1:
        raise ValueError("x, dt, a, b and c must share one device")


def ssd_scan(x, dt, a, b, c):
    """x: (B, S, H, P); dt: (B, S, H) f32; a: (H,) f32; b/c: (B, S, G, N).
    Returns y (B, S, H, P) of x.dtype and the final state (B, H, P, N) f32."""
    _check(x, dt, a, b, c)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, not {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, b, c)):
        raise NotImplementedError(
            "ssd_scan has no backward kernel on the card yet (ROADMAP.md Queue 1: the SSD scan "
            "backward kernel, with mamba2-130m training); run the forward under torch.no_grad() "
            "or inference_mode, or differentiate on the CPU")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if p not in DIMS or n not in DIMS:
        raise ValueError(f"the kernel takes head_dim and state size in {DIMS}, not {p} and {n}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes {sorted(map(str, _DTYPES))}, not {x.dtype}")
    if any(t.stride(-1) != 1 for t in (x, b, c)) or not a.is_contiguous():
        raise ValueError("the last axis of x, b and c, and a, must be contiguous")
    if bsz * s == 0:
        raise ValueError(f"empty scan: x {tuple(x.shape)}")
    if bsz * h > 65535:
        raise ValueError(f"the kernels take at most 65535 batch*heads, not {bsz * h}")
    x, b, c = (t if _aligned(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (x, b, c))
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty(scratch_floats(bsz, s, h, p, n), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 15)(*x.stride()[:3], *dt.stride(), *b.stride()[:3],
                                       *c.stride()[:3], *y.stride()[:3])
    with torch.cuda.device(x.device):
        err = _entry()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                       y.data_ptr(), state.data_ptr(), scratch.data_ptr(), scratch.numel(),
                       _DTYPES[x.dtype], bsz, s, h, g, p, n, strides,
                       torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed with CUDA error {err}")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
