"""Fused RMSNorm on Hopper: the port of the JAX package's Pallas kernel
``kernels/rmsnorm.py`` (``rmsnorm``, :23).

The kernel is CUDA C++ (``repro_torch/csrc/rmsnorm.cu``, whose header
says what bounds it on the H100 and what its design does about it), built
for ``sm_90a`` and called through ``ctypes``: 32 to 256 threads per row, each
holding its part of the row in registers, reduce the f32 mean of squares,
scale by ``rsqrt(var + eps) * (1 + w)`` in f32 and cast once on the write; a
block per row for rows wider than that holds.  It is bound by device-memory
bytes.  Rows = B*S in prefill and B in decode, where the host's launch path
is the cost: the wrapper checks, allocates the output and calls the C entry
with one argument block, and enters ``torch.cuda.device`` only for a tensor
off the current device.

``rmsnorm`` takes the kernel for a CUDA tensor and the plain version
``ref.rmsnorm_ref`` for a CPU tensor; any other device raises.
``rmsnorm.launches`` counts kernel launches.

The JAX model's ``layers.rmsnorm`` (:81-85) casts to the working dtype
*before* the ``(1 + w)`` multiply, while the kernel (and ``rmsnorm_ref``)
multiply in f32 and cast once.  The two agree exactly in fp32, the serving
Engine's dtype, and differ by one bf16 rounding in bf16.  The port follows
the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The C entry's code for an (x dtype, w dtype) pair: x code + 2 * w code.
_CODES = {(x, w): cx + 2 * cw for x, cx in _CODE.items() for w, cw in _CODE.items()}
# The C entry's arguments, filled per call and passed as they are (no
# argtypes: ctypes converts nothing).  The library is loaded as a PyDLL,
# which keeps the GIL through the call, so no other thread can refill them
# while the launch reads them.
_ARGS = (ctypes.c_longlong * 8)()
_EPS = ctypes.c_float()
_launch = None  # (C entry, raw current stream, current device), bound on first use


def _bind():
    """The C entry, and PyTorch's raw current-stream and current-device
    lookups (the C calls Triton's launcher uses: no Python object per call)."""
    global _launch
    _build.build(["rmsnorm"])
    fn = ctypes.PyDLL(str(_build.library_path("rmsnorm"))).rmsnorm_fwd
    fn.restype = ctypes.c_int
    _launch = fn, torch._C._cuda_getCurrentRawStream, torch._C._cuda_getDevice
    return _launch


def _off_card(x, w, eps):
    if x.ndim != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"want x (rows, d) and w (d,); got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError("x and w must share one device")
    if x.device.type != "cpu":
        raise ValueError(f"rmsnorm runs on CUDA or CPU tensors, not {x.device}")
    return ref.rmsnorm_ref(x, w, eps=eps)


def rmsnorm(x, w, *, eps: float = 1e-5):
    """x: (rows, d); w: (d,).  Returns (rows, d) of x.dtype.

    Every normalisation of the models comes here, a decode step's too, so
    the CUDA path does as little in Python as it can."""
    if not x.is_cuda:
        return _off_card(x, w, eps)
    if x.ndim != 2 or w.ndim != 1:
        raise ValueError(f"want x (rows, d) and w (d,); got {tuple(x.shape)}, {tuple(w.shape)}")
    rows, d = x.shape
    xs, unit = x.stride()
    code = _CODES.get((x.dtype, w.dtype))
    dev = x.get_device()
    if w.shape[0] != d or w.get_device() != dev:
        raise ValueError(f"w {tuple(w.shape)} on {w.device} does not fit x {tuple(x.shape)} "
                         f"on {x.device}")
    if code is None or unit != 1 or not w.is_contiguous() or not rows or not d:
        raise ValueError(f"the kernel takes float32 or bfloat16, rows > 0, d > 0 and "
                         f"contiguous rows; got x {x.dtype} {tuple(x.shape)} strides "
                         f"{x.stride()}, w {w.dtype}")
    o = torch.empty_like(x) if xs == d else x.new_empty((rows, d))
    fn, stream, current = _launch or _bind()
    _ARGS[:] = (x.data_ptr(), w.data_ptr(), o.data_ptr(), code, rows, d, xs, stream(dev))
    _EPS.value = eps
    if dev == current():
        err = fn(_ARGS, _EPS)
    else:
        with torch.cuda.device(dev):
            err = fn(_ARGS, _EPS)
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed with CUDA error {err}")
    rmsnorm.launches += 1
    return o


rmsnorm.launches = 0
