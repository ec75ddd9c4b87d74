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

Each launch is an operator (``kernels/_library.py``):
``torch.ops.repro_torch.rmsnorm_fwd`` and ``rmsnorm_bwd``.  A ``FakeTensor``
(the dry run's stand-ins, labelled ``cpu`` or ``cuda``) takes the operator
before any device branch: its fake implementation gives the shapes and
nothing is launched or counted.  The FLOP formulas count 4 operations an
element forward (square, sum, scale, times ``1 + w``) and 8 backward, the
counts behind ``chip_smoke.py``'s bounds.

Gradients.  When grad mode is on and x or w requires grad, a CUDA call goes
through ``RMSNormFn``, whose backward is ``rmsnorm_bwd`` (two launches in
``csrc/rmsnorm.cu``: dx from rows held in registers, as the forward holds
them, with each block's dw column sums; then dw summed over the blocks in a
fixed order; ``rmsnorm_bwd.launches`` counts calls).
Otherwise the call takes the lean path below, as serving always does.  A
CPU call differentiates through the plain version.

Split rows.  ``rmsnorm_split`` normalises a rank's columns of rows whose
other columns other ranks hold (a plan that splits the normalised dim:
mamba2's gated norm on its d_inner split over 'model'): the row's sum of
squares is a partial-sum launch, the caller's all-reduce, then an apply
launch; the backward the same for the sum of g * (1 + w) * x, then a
launch for dx and the blocks' dw column sums, added in a fixed order
(``RMSNormSplitFn``; counters ``rmsnorm_split.launches`` and
``rmsnorm_split_bwd.launches``, one a launch or call).  Whole rows never
take it.

The JAX model's ``layers.rmsnorm`` (:81-85) casts to the working dtype
*before* the ``(1 + w)`` multiply, while the kernel (and ``rmsnorm_ref``)
multiply in f32 and cast once.  The two agree exactly in fp32, the serving
Engine's dtype, and differ by one bf16 rounding in bf16.  The port follows
the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _library, ref

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
    if not x.is_cuda and not _library.is_fake(x):
        return _off_card(x, w, eps)
    if (x.requires_grad or w.requires_grad) and torch.is_grad_enabled():
        return RMSNormFn.apply(x, w, eps)
    return _fwd_op(x, w, eps)


def _forward(x, w, eps):
    """One launch on CUDA tensors, checked here: the CUDA implementation of
    ``repro_torch::rmsnorm_fwd``."""
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


# The backward's first launch takes one wave of blocks at its occupancy
# (SMs x blocks per SM), each summing d columns of dw: at most this many,
# eight blocks of 256 threads on each of the H100's 132 SMs.
BWD_BLOCKS = 1056
BWD_MAX_D = 58096  # wider rows' column sums (and 16 row sums) would not fit a block's shared memory


def rmsnorm_bwd(x, w, g, *, eps: float = 1e-5):
    """The backward kernels on CUDA tensors (or fake ones): x (rows, d), w
    (d,), g the output's gradient (rows, d).  Returns dx (rows, d) of x.dtype
    and dw (d,) of w.dtype."""
    if x.ndim != 2 or w.shape != (x.shape[1],) or g.shape != x.shape:
        raise ValueError(f"want x and g (rows, d), w (d,); got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}, {tuple(w.shape)}")
    rows, d = x.shape
    code = _CODES.get((x.dtype, w.dtype))
    on_card = x.is_cuda or _library.is_fake(x)
    if code is None or g.dtype != x.dtype or not on_card or {w.device, g.device} != {x.device}:
        raise ValueError(f"the kernel takes CUDA float32 or bfloat16 x and g of one dtype on one "
                         f"device; got x {x.dtype}, g {g.dtype}, w {w.dtype}")
    if not rows or not d or d > BWD_MAX_D:
        raise ValueError(f"the kernel takes rows > 0 and 0 < d <= {BWD_MAX_D}, not "
                         f"{tuple(x.shape)}")
    return _bwd_op(x, w, g, eps)


def _launch_bwd(x, w, g, eps):
    """One backward call on checked CUDA tensors: the CUDA implementation of
    ``repro_torch::rmsnorm_bwd``."""
    rows, d = x.shape
    code = _CODES[x.dtype, w.dtype]
    x, g = (t if t.stride(1) == 1 else t.contiguous() for t in (x, g))
    w = w.contiguous()
    dx = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    dw = torch.empty((d,), dtype=w.dtype, device=x.device)
    parts = min(rows, BWD_BLOCKS)
    scratch = torch.empty((parts, d), dtype=torch.float32, device=x.device)
    args = (ctypes.c_longlong * 13)(x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
                                    dw.data_ptr(), scratch.data_ptr(), code, rows, d,
                                    x.stride(0), g.stride(0),
                                    torch.cuda.current_stream(x.device).cuda_stream, parts)
    with torch.cuda.device(x.device):
        err = _bwd_entry()(args, ctypes.c_float(eps))
    if err:
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed with CUDA error {err}")
    rmsnorm_bwd.launches += 1
    return dx, dw


def _fwd_fake(x, w, eps):
    if x.ndim != 2 or w.shape != (x.shape[1],) or (x.dtype, w.dtype) not in _CODES:
        raise ValueError(f"the kernel takes x (rows, d) and w (d,) in float32 or bfloat16; got "
                         f"{x.dtype} {tuple(x.shape)}, {w.dtype} {tuple(w.shape)}")
    return x.new_empty(x.shape)


def _bwd_fake(x, w, g, eps):
    return x.new_empty(x.shape), w.new_empty(w.shape)


_fwd_op = _library.define("rmsnorm_fwd(Tensor x, Tensor w, float eps) -> Tensor", _forward,
                          _fwd_fake, lambda x, w, eps, **_: 4 * x[0] * x[1])
_bwd_op = _library.define("rmsnorm_bwd(Tensor x, Tensor w, Tensor g, float eps) "
                          "-> (Tensor, Tensor)",
                          _launch_bwd, _bwd_fake, lambda x, w, g, eps, **_: 8 * x[0] * x[1])


@functools.cache
def _bwd_entry():
    fn = _build.load("rmsnorm").rmsnorm_bwd
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
    fn.restype = ctypes.c_int
    return fn


class RMSNormFn(torch.autograd.Function):
    """The kernel with its gradient: the forward keeps x and w, the backward
    is ``rmsnorm_bwd``."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _fwd_op(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, g, eps=ctx.eps)
        return dx, dw, None


rmsnorm_bwd.launches = 0


# ---------------------------------------------------------------------------
# Split rows: the columns of each row spread over several ranks (mamba2's
# gated norm on its d_inner split over 'model', ``ops.fused_rmsnorm``).  The
# row's sum of squares, and in the backward its sum of g * (1 + w) * x,
# cross ranks, so each direction is a partial-sum launch, an all-reduce of
# one f32 a row (the caller's ``reduce``), and a launch that reads the
# reduced sum (``csrc/rmsnorm.cu``'s split-row kernels).  Each launch is an
# operator: ``torch.ops.repro_torch.rmsnorm_part``, ``rmsnorm_apply`` and
# ``rmsnorm_split_bwd``; a CPU tensor takes the plain twins in ``ref``.

def _plain(x, *others) -> bool:
    """Does this call take the plain twins (a CPU tensor)?  A CUDA or fake
    one takes the operators; any other device raises."""
    if x.is_cuda or _library.is_fake(x):
        return False
    if x.device.type != "cpu" or any(t.device != x.device for t in others):
        raise ValueError(f"the split-row RMSNorm runs on CUDA or CPU tensors on one device, "
                         f"not {[str(t.device) for t in (x, *others)]}")
    return True


def _split_check(x, w, d_full):
    if x.ndim != 2 or w.shape != (x.shape[1],) or (x.dtype, w.dtype) not in _CODES:
        raise ValueError(f"want x (rows, d) and w (d,) in float32 or bfloat16; got {x.dtype} "
                         f"{tuple(x.shape)}, {w.dtype} {tuple(w.shape)}")
    if not 0 < x.shape[1] <= min(d_full, BWD_MAX_D) or not x.shape[0]:
        raise ValueError(f"the split-row kernels take rows > 0 and 0 < d <= d_full and "
                         f"d <= {BWD_MAX_D}, not {tuple(x.shape)} of rows {d_full} wide")


def rmsnorm_split(x, w, *, eps: float = 1e-5, d_full: int, reduce):
    """x: (rows, d), this rank's d columns of rows ``d_full`` wide; w: (d,),
    its columns of the weight; ``reduce(t)`` sums a (rows,) f32 tensor over
    the ranks that hold the rows' other columns.  Returns (rows, d) of
    x.dtype: those columns of the whole rows' ``rmsnorm``.  Differentiable
    (``RMSNormSplitFn``): dw is this rank's columns, summed over its rows."""
    _split_check(x, w, d_full)
    return RMSNormSplitFn.apply(x, w, eps, d_full, reduce)


rmsnorm_split.launches = 0


def rmsnorm_part(x, w=None, g=None):
    """Each row's sum over x's columns (f32, (rows,)): of x^2, or with w and
    g of g * (1 + w) * x."""
    if _plain(x, *(t for t in (w, g) if t is not None)):
        return ref.rmsnorm_part_ref(x, w, g)
    return _part_op(x, w, g)


def rmsnorm_apply(x, w, ss, *, d_full: int, eps: float = 1e-5):
    """x's columns normalised by the rows' sums of squares ``ss`` over
    ``d_full`` columns, times (1 + w)."""
    if _plain(x, w, ss):
        return ref.rmsnorm_apply_ref(x, w, ss, d_full=d_full, eps=eps)
    return _apply_op(x, w, ss, d_full, eps)


def rmsnorm_split_bwd(x, w, g, ss, st, *, d_full: int, eps: float = 1e-5):
    """dx (rows, d) of x.dtype and dw (d,) of w.dtype from the whole rows'
    sums ``ss`` (of x^2) and ``st`` (of g * (1 + w) * x)."""
    if _plain(x, w, g, ss, st):
        return ref.rmsnorm_split_bwd_ref(x, w, g, ss, st, d_full=d_full, eps=eps)
    return _split_bwd_op(x, w, g, ss, st, d_full, eps)


rmsnorm_split_bwd.launches = 0


def _split_call(entry: str, x, w, g, ss, st, o, dw, out_sum, parts, *extra):
    """One split-row C call on checked CUDA tensors (0 for an absent one)."""
    rows, d = x.shape
    code = _CODES.get((x.dtype, w.dtype if w is not None else x.dtype))
    ts = [t for t in (x, w, g, ss, st, o, dw, out_sum) if t is not None]
    if code is None or any(t.device != x.device for t in ts) or x.stride(1) != 1 or (
            g is not None and (g.dtype != x.dtype or g.shape != x.shape or g.stride(1) != 1)):
        raise ValueError(f"the split-row kernels take CUDA float32 or bfloat16 x (and g, of x's "
                         f"dtype and shape) with contiguous rows on one device; got x {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    for t in (w, ss, st):
        if t is not None and not t.is_contiguous():
            raise ValueError("w and the row sums must be contiguous")
    if (ss is not None and ss.shape != (rows,)) or (st is not None and st.shape != (rows,)) or \
            any(t is not None and t.dtype != torch.float32 for t in (ss, st)):
        raise ValueError(f"the row sums must be float32 ({rows},)")
    ptr = lambda t: 0 if t is None else t.data_ptr()
    scratch = None
    if parts:
        scratch = torch.empty((parts, d), dtype=torch.float32, device=x.device)
    args = (ctypes.c_longlong * 16)(
        ptr(x), ptr(w), ptr(g), ptr(ss), ptr(st), ptr(o), ptr(dw), ptr(out_sum), ptr(scratch),
        code, rows, d, x.stride(0), g.stride(0) if g is not None else 0,
        torch.cuda.current_stream(x.device).cuda_stream, parts or 1)
    with torch.cuda.device(x.device):
        err = _split_entry(entry)(args, *extra)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed with CUDA error {err}")


@functools.cache
def _split_entry(name: str):
    fn = getattr(_build.load("rmsnorm"), name)
    tail = [ctypes.c_int] if name == "rmsnorm_split_sum" else [ctypes.c_float, ctypes.c_float]
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), *tail]
    fn.restype = ctypes.c_int
    return fn


def _launch_part(x, w, g):
    out = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    w = None if g is None else w
    _split_call("rmsnorm_split_sum", x, w, g, None, None, None, None, out, 0,
                ctypes.c_int(g is not None))
    (rmsnorm_split if g is None else rmsnorm_split_bwd).launches += 1
    return out


def _launch_apply(x, w, ss, d_full, eps):
    o = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _split_call("rmsnorm_split_fwd", x, w, None, ss, None, o, None, None, 0,
                ctypes.c_float(d_full), ctypes.c_float(eps))
    rmsnorm_split.launches += 1
    return o


def _launch_split_bwd(x, w, g, ss, st, d_full, eps):
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dw = torch.empty(w.shape, dtype=w.dtype, device=x.device)
    _split_call("rmsnorm_split_bwd", x, w, g, ss, st, dx, dw, None, min(x.shape[0], BWD_BLOCKS),
                ctypes.c_float(d_full), ctypes.c_float(eps))
    rmsnorm_split_bwd.launches += 1
    return dx, dw


_part_op = _library.define(
    "rmsnorm_part(Tensor x, Tensor? w, Tensor? g) -> Tensor", _launch_part,
    lambda x, w, g: x.new_empty((x.shape[0],), dtype=torch.float32),
    lambda x, w, g, **_: (2 if g is None else 3) * x[0] * x[1])
_apply_op = _library.define(
    "rmsnorm_apply(Tensor x, Tensor w, Tensor ss, int d_full, float eps) -> Tensor", _launch_apply,
    lambda x, w, ss, d_full, eps: x.new_empty(x.shape),
    lambda x, w, ss, d_full, eps, **_: 2 * x[0] * x[1])
_split_bwd_op = _library.define(
    "rmsnorm_split_bwd(Tensor x, Tensor w, Tensor g, Tensor ss, Tensor st, int d_full, "
    "float eps) -> (Tensor, Tensor)", _launch_split_bwd,
    lambda x, w, g, ss, st, d_full, eps: (x.new_empty(x.shape), w.new_empty(w.shape)),
    lambda x, w, g, ss, st, d_full, eps, **_: 5 * x[0] * x[1])


class RMSNormSplitFn(torch.autograd.Function):
    """The split-row mode with its gradient: the forward keeps x, w and the
    rows' reduced sum of squares; the backward reduces T the same way and
    launches ``rmsnorm_split_bwd``.  ``reduce`` takes no gradient: the
    backward does its own reduction."""

    @staticmethod
    def forward(ctx, x, w, eps, d_full, reduce):
        ss = reduce(rmsnorm_part(x))
        ctx.save_for_backward(x, w, ss)
        ctx.eps, ctx.d_full, ctx.reduce = eps, d_full, reduce
        return rmsnorm_apply(x, w, ss, d_full=d_full, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, w, ss = ctx.saved_tensors
        g = g.contiguous()
        st = ctx.reduce(rmsnorm_part(x, w, g))
        dx, dw = rmsnorm_split_bwd(x, w, g, ss, st, d_full=ctx.d_full, eps=ctx.eps)
        return dx, dw, None, None, None
