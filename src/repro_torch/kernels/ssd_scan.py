"""Mamba2 SSD chunked scan on Hopper: the port of the JAX package's Pallas
kernel ``kernels/ssd_scan.py`` (``ssd_scan``, :71), and its gradient.

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

At head dims below 16 the first and last are ``ssd_scan_chunk_state_narrow``
and ``ssd_scan_output_narrow``, per (chunk, batch, tiles of a group).

The kernels read the model layout directly: x (B, S, H, P), dt (B, S, H),
b/c (B, S, G, N), head ``h`` reading group ``h // (H/G)`` through strides,
and write the final state directly as (B, H, P, N).  Their chunk length (64)
is their own choice; any S, the ragged last chunk masked.  Rows of x, b and c
are read 16 bytes at a time, so a view whose rows are not 16-byte aligned is
copied first.  Head dims below 16 (``DIMS``: 1, 2, 4 and 8, what a head_dim
split over a mesh axis leaves a rank) pack a group's heads side by side into
tiles of 16 columns (``heads_per_tile``), several tiles of a group a block
(``tiles_per_block``); x and dy are read 16 bytes at a time where a packed
row lies whole and aligned, else an element at a time, so a column slice is
never copied.  The scratch holds each head's chunk states at its own head
dim, (N, P) a chunk, for every P.

``ssd_scan`` takes the kernels for a CUDA tensor and its plain version
(``ssd_scan_plain``, built on ``ref.ssd_ref``) for a CPU tensor; any other
device raises.  ``ssd_scan.launches`` counts calls that launched the kernels:
one per call, whatever the three launches inside it.

Gradients.  When grad mode is on and an input requires grad, a CUDA call
goes through ``SSDScanFn``: its forward launches the same kernels and keeps
their scratch (the state entering each chunk, and each chunk's decay), and
its backward is ``ssd_scan_bwd`` (``csrc/ssd_scan_bwd.cu``, five launches:
each chunk's share of the state gradient, the chain over chunks in reverse,
dx/ddt/da per chunk with ``heads_per_block`` heads of a group a block (below
head dim 16 ``tiles_per_block`` packed tiles) and dB/dC (from head dim 16 on
per head-block, then their group sum; below it per group, from the score
gradients summed over its heads), and da over the chunks, deterministic
throughout; ``ssd_scan_bwd.launches`` counts calls).
Otherwise (serving, ``inference_mode``) the call launches the forward alone,
as lean as before.  A CPU call differentiates through the plain version,
which is also the card's reference for the gradient.
``ssd_scan_bwd_plain`` is the backward's chunk algebra in plain torch: the
derivation's check on the CPU.

Each call is an operator (``kernels/_library.py``):
``torch.ops.repro_torch.ssd_fwd`` (y, the final state and the scratch) and
``ssd_bwd``.  A ``FakeTensor`` (the dry run's stand-ins, labelled ``cpu`` or
``cuda``) takes the operator before any device branch: its fake
implementation gives the shapes (the scratch's too) and nothing is launched
or counted; the plain version's loop over S is never reached.  The FLOP
formulas count the chunked decomposition's products, the algorithm of the
kernels and of the JAX ``ssd_chunked`` whose work XLA counts: per (batch,
head) 4 S N P (the chunk states and C h_in) and 2 P L S (the masked
scores times x, chunks of L = 64), per (batch, group) 2 N L S (the scores
C B^T, shared by the group's heads), and twice that backward.  Neither the
score tiles the kernels skip above the diagonal nor the tiles of 16
columns a head dim below 16 is packed into are counted.  ``chip_smoke.py``'s
bounds take the sequential recurrence's work, 4 S N P forward and 8 S N P
backward, the least any form of the scan does.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, _library, ref

DIMS = (1, 2, 4, 8, 16, 32, 64, 128)  # the head dims P the kernels take
STATE_DIMS = (16, 32, 64, 128)  # and the state sizes N
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


@functools.cache
def _bwd_entry():
    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd
    i, pll = ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [pll, pll, ctypes.c_longlong, i, i, i, i, i, i, i, ctypes.c_void_p]
    fn.restype = i
    return fn


@functools.cache
def _bwd_scratch_entry():
    """The C library's size of a backward call's scratch (0 for sizes it
    refuses): what ``bwd_scratch_floats`` mirrors."""
    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd_scratch_floats
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    return fn


def heads_per_tile(p: int) -> int:
    """Heads of one group side by side in a tile of 16 columns at head dim
    ``p`` below 16 (``Packed`` in ``csrc/ssd_scan.cuh``); 1 from 16 on, where
    a head fills its own tiles."""
    return 16 // p if p < 16 else 1


def scratch_floats(bsz: int, s: int, h: int, p: int, n: int) -> int:
    """f32 scratch of one call: each chunk's (N, P) state and its decay, per
    (batch, head)."""
    return bsz * h * -(-s // CHUNK) * (n * p + 1)


def heads_per_block(heads_per_group: int, chunk_heads: int) -> int:
    """Heads of one group that a block of the per-chunk kernels walks, forward
    and backward, at head dims from 16 on: the most, up to 8, that leave at
    least 512 blocks of ``chunk_heads`` = B*H*nc.  A copy of
    ``heads_per_block`` in ``csrc/ssd_scan.cuh``, whose backward entry
    refuses a scratch shorter than its own count (``_bwd_scratch_entry``)."""
    for kh in (8, 6, 4, 3, 2):
        if heads_per_group % kh == 0 and chunk_heads // kh >= 512:
            return kh
    return 1


def tiles_per_block(tiles_per_group: int, chunk_tiles: int) -> int:
    """Packed tiles of one group that a block walks at head dims below 16:
    the most that divide the group's tiles and leave at least 256 blocks of
    ``chunk_tiles`` = B*G*tiles*nc, so C B^T is formed once per (chunk,
    batch, group) where the card stays full.  A copy of ``tiles_per_block``
    in ``csrc/ssd_scan.cuh``."""
    for kt in range(tiles_per_group, 1, -1):
        if tiles_per_group % kt == 0 and chunk_tiles // kt >= 256:
            return kt
    return 1


def narrow_blocks(bsz: int, s: int, h: int, g: int, p: int) -> tuple[int, int, int]:
    """At head dim ``p`` below 16: (heads a tile, tiles of a group, tiles a
    block), the layout of the forward's and backward's per-chunk blocks."""
    k = heads_per_tile(p)
    tiles = -(-(h // g) // k)
    return k, tiles, tiles_per_block(tiles, bsz * g * tiles * -(-s // CHUNK))


def bwd_scratch_floats(bsz: int, s: int, h: int, g: int, p: int, n: int) -> int:
    """f32 scratch of one backward call: per (batch, head) and chunk an (N, P)
    state gradient and a share of da; from head dim 16 on dB and dC of each
    head-block (the ``heads_per_block`` heads of a group that one block
    sums), below it the (L, L) sum W of each head-block's score gradients
    (``narrow_blocks``), per (batch, chunk, group)."""
    nc = -(-s // CHUNK)
    states = bsz * h * nc * (n * p + 1)
    if p < 16:
        _, tiles, kt = narrow_blocks(bsz, s, h, g, p)
        return states + bsz * nc * g * (tiles // kt) * CHUNK * CHUNK
    blocks = h // heads_per_block(h // g, bsz * h * nc)
    return states + 2 * bsz * s * blocks * n


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


def ssd_scan_bwd_plain(x, dt, a, b, c, dy, dstate=None):
    """The backward's chunk algebra in plain torch (``csrc/ssd_scan_bwd.cu``
    header), chunks of 64 with the ragged last one padded by zero rows:
    the gradients of ``ssd_scan``'s y and final state given dy (B,S,H,P)
    and dstate (B,H,P,N) or None (zero).  Returns dx, ddt, da, db, dc: dx,
    db, dc in the dtypes of x, b, c; ddt and da in f32, which it computes in."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep, ln = h // g, CHUNK
    nc = -(-s // ln)
    f = torch.float32

    def chunks(t, heads=False):  # (B,S,...) -> (B,nc,L,...), groups repeated over heads
        t = F.pad(t.to(f), (0, 0) * (t.ndim - 2) + (0, nc * ln - s))
        t = t.reshape(bsz, nc, ln, *t.shape[2:])
        return t.repeat_interleave(rep, dim=3) if heads else t

    xs, dts, dys = chunks(x), chunks(dt), chunks(dy)
    bs, cs = chunks(b, True), chunks(c, True)
    af = a.to(f)
    cum = torch.cumsum(dts * af, dim=2)                                     # (B,nc,L,H)
    last = cum[:, :, -1]
    tri = torch.tril(torch.ones((ln, ln), dtype=torch.bool, device=x.device))[..., None]
    decay = torch.exp(torch.where(tri, cum[:, :, :, None] - cum[:, :, None], -torch.inf))
    e_in, e_end = torch.exp(cum), torch.exp(last[:, :, None] - cum)
    # the states entering each chunk, and the gradients of those leaving it
    s_c = torch.einsum("bcmhn,bcmhp->bchnp", bs * (dts * e_end)[..., None], xs)
    z_c = torch.einsum("bclhn,bclhp->bchnp", cs * e_in[..., None], dys)
    h_in, g_out = torch.empty_like(s_c), torch.empty_like(z_c)
    hc = torch.zeros_like(s_c[:, 0])
    gc = torch.zeros_like(hc) if dstate is None else dstate.to(f).transpose(-1, -2)
    for i in range(nc):
        h_in[:, i] = hc
        hc = torch.exp(last[:, i])[..., None, None] * hc + s_c[:, i]
    for i in reversed(range(nc)):
        g_out[:, i] = gc
        gc = torch.exp(last[:, i])[..., None, None] * gc + z_c[:, i]
    r = torch.einsum("bclhn,bcmhn->bclmh", cs, bs)                         # C_l . B_m
    q = torch.einsum("bclhp,bcmhp->bclmh", dys, xs)                        # dY_l . x_m
    m = r * decay
    w = decay * dts[:, :, None] * q
    t = r * w
    bg = torch.einsum("bcmhn,bchnp->bcmhp", bs, g_out)
    dxt = torch.einsum("bclmh,bclhp->bcmhp", m, dys) + e_end[..., None] * bg
    y_off = e_in[..., None] * torch.einsum("bclhn,bchnp->bclhp", cs, h_in)
    u = e_end * dts * (xs * bg).sum(-1)
    dcum = t.sum(3) - t.sum(2) + (dys * y_off).sum(-1) - u
    dcum[:, :, -1] += u.sum(2) + torch.exp(last) * (g_out * h_in).sum((-2, -1))
    rc = dcum.flip(2).cumsum(2).flip(2)
    ddt = (xs * dxt).sum(-1) + af * rc
    dc = torch.einsum("bclmh,bcmhn->bclhn", w, bs) \
        + e_in[..., None] * torch.einsum("bclhp,bchnp->bclhn", dys, h_in)
    db = torch.einsum("bclmh,bclhn->bcmhn", w, cs) \
        + (dts * e_end)[..., None] * torch.einsum("bcmhp,bchnp->bcmhn", xs, g_out)

    def rows(t, dtype, groups=False):  # (B,nc,L,...) -> (B,S,...), heads summed per group
        t = t.reshape(bsz, nc * ln, *t.shape[3:])[:, :s]
        return (t.reshape(bsz, s, g, rep, n).sum(3) if groups else t).to(dtype)

    return (rows(dts[..., None] * dxt, x.dtype), rows(ddt, f), (dts * rc).sum((0, 1, 2)),
            rows(db, b.dtype, True), rows(dc, c.dtype, True))


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


def _check_card(x, b):
    bsz, s, h, p = x.shape
    n = b.shape[3]
    if p not in DIMS or n not in STATE_DIMS:
        raise ValueError(f"the kernel takes head_dim in {DIMS} and state size in {STATE_DIMS}, "
                         f"not {p} and {n}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes {sorted(map(str, _DTYPES))}, not {x.dtype}")
    if bsz * s == 0:
        raise ValueError(f"empty scan: x {tuple(x.shape)}")
    if bsz * h > 65535:
        raise ValueError(f"the kernels take at most 65535 batch*heads, not {bsz * h}")


def _rows_ready(t, by_element: bool = False):
    """t itself if the kernels can read its rows (last axis contiguous, rows
    on 16 bytes unless they are read ``by_element``: x and dy below 16
    columns), else a copy in a fresh contiguous buffer."""
    if (t.stride(-1) == 1 or t.shape[-1] == 1) and (by_element or _aligned(t)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(x, dt, a, b, c):
    """One forward call on checked CUDA tensors: y, the final state, and the
    scratch that holds the state entering each chunk and each chunk's decay.
    The CUDA implementation of ``repro_torch::ssd_fwd``."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
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
    return y, state, scratch


def ssd_scan_bwd(x, dt, a, b, c, scratch, dy, dstate=None):
    """The backward kernels on CUDA tensors (or fake ones): the forward's
    inputs and its ``scratch`` (``_launch``), dy (B,S,H,P) and dstate
    (B,H,P,N) f32 or None (zero).  Returns dx, ddt, da, db, dc: dx, db, dc in
    x's dtype, ddt and da in f32."""
    _check(x, dt, a, b, c)
    if x.device.type != "cuda" and not _library.is_fake(x):
        raise ValueError(f"ssd_scan_bwd launches kernels on CUDA tensors, not {x.device}: the "
                         "CPU differentiates through the plain version")
    _check_card(x, b)
    bsz, s, h, p = x.shape
    n = b.shape[3]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not fit x {tuple(x.shape)} "
                         f"{x.dtype}")
    if dstate is not None and (dstate.shape != (bsz, h, p, n) or dstate.dtype != torch.float32
                               or dstate.device != x.device):
        raise ValueError(f"dstate {tuple(dstate.shape)} {dstate.dtype} on {dstate.device}: want "
                         f"{(bsz, h, p, n)} float32 on {x.device}")
    if scratch.numel() != scratch_floats(bsz, s, h, p, n) or not scratch.is_contiguous():
        raise ValueError("scratch is not the forward's")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    return _bwd_op(x, dt, a, b, c, scratch, dy, dstate)


def _launch_bwd(x, dt, a, b, c, scratch, dy, dstate):
    """One backward call on checked CUDA tensors, dstate possibly None: the
    CUDA implementation of ``repro_torch::ssd_bwd``."""
    narrow = x.shape[-1] < 16  # x and dy: an element at a time where a packed row is not aligned
    x, dy = (_rows_ready(t, narrow) for t in (x, dy))
    b, c = _rows_ready(b), _rows_ready(c)
    dstate = None if dstate is None else dstate.contiguous()
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    dev, f32 = x.device, torch.float32
    work = torch.empty(bwd_scratch_floats(bsz, s, h, g, p, n), dtype=f32, device=dev)
    dx = torch.empty((bsz, s, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((bsz, s, h), dtype=f32, device=dev)
    da = torch.empty((h,), dtype=f32, device=dev)
    db, dc = (torch.empty((bsz, s, g, n), dtype=x.dtype, device=dev) for _ in range(2))
    ts = (x, dt, a, b, c, dy, dstate, scratch, work, dx, ddt, da, db, dc)
    ptrs = (ctypes.c_longlong * 14)(*(0 if t is None else t.data_ptr() for t in ts))
    strides = (ctypes.c_longlong * 15)(*x.stride()[:3], *dt.stride(), *b.stride()[:3],
                                       *c.stride()[:3], *dy.stride()[:3])
    with torch.cuda.device(dev):
        err = _bwd_entry()(ptrs, strides, work.numel(), _DTYPES[x.dtype], bsz, s, h, g, p, n,
                           torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed with CUDA error {err}")
    ssd_scan_bwd.launches += 1
    return dx, ddt, da, db, dc


def _fwd_fake(x, dt, a, b, c):
    bsz, s, h, p = x.shape
    n = b.shape[3]
    return (x.new_empty((bsz, s, h, p)), x.new_empty((bsz, h, p, n), dtype=torch.float32),
            x.new_empty((scratch_floats(bsz, s, h, p, n),), dtype=torch.float32))


def _bwd_fake(x, dt, a, b, c, scratch, dy, dstate):
    return (x.new_empty(x.shape), dt.new_empty(dt.shape), a.new_empty(a.shape),
            b.new_empty(b.shape), c.new_empty(c.shape))


def _fwd_flops(x, dt, a, b, c, **_):
    """The chunked decomposition's products at the kernels' chunk length L:
    per (batch, head) 4 S N P (the chunk states B^T x and C h_in) and
    2 P sum(L_c^2) (the masked scores times x), and per (batch, group)
    2 N sum(L_c^2) (the scores C B^T, which a group's heads share)."""
    bsz, s, h, p = x
    g, n = b[2], b[3]
    squares = (s // CHUNK) * CHUNK ** 2 + (s % CHUNK) ** 2  # sum over chunks of L_c^2
    return bsz * (h * (4 * s * n * p + 2 * squares * p) + g * 2 * squares * n)


def _bwd_flops(x, dt, a, b, c, scratch, dy, dstate, **_):
    """Twice the forward's: each product's two gradient products."""
    return 2 * _fwd_flops(x, dt, a, b, c)


_fwd_op = _library.define(
    "ssd_fwd(Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c) -> (Tensor, Tensor, Tensor)",
    _launch, _fwd_fake, _fwd_flops)
_bwd_op = _library.define(
    "ssd_bwd(Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c, Tensor scratch, Tensor dy, "
    "Tensor? dstate) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    _launch_bwd, _bwd_fake, _bwd_flops)


class SSDScanFn(torch.autograd.Function):
    """The kernels with their gradient, on checked CUDA tensors whose rows
    the kernels can read: the forward keeps its inputs and the scratch of
    entering states; the backward is ``ssd_scan_bwd``.  A gradient of None
    (y or the final state not used) counts as zero."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c):
        ctx.set_materialize_grads(False)
        y, state, scratch = _fwd_op(x, dt, a, b, c)
        ctx.save_for_backward(x, dt, a, b, c, scratch)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, b, c, scratch = ctx.saved_tensors
        return _bwd_op(x, dt, a, b, c, scratch, torch.zeros_like(x) if dy is None else dy,
                       dstate)


def ssd_scan(x, dt, a, b, c):
    """x: (B, S, H, P); dt: (B, S, H) f32; a: (H,) f32; b/c: (B, S, G, N).
    Returns y (B, S, H, P) of x.dtype and the final state (B, H, P, N) f32."""
    _check(x, dt, a, b, c)
    fake = _library.is_fake(x)
    if x.device.type == "cpu" and not fake:
        return ssd_scan_plain(x, dt, a, b, c)
    if x.device.type != "cuda" and not fake:
        raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, not {x.device}")
    _check_card(x, b)
    if any(t.stride(-1) != 1 and t.shape[-1] != 1 for t in (x, b, c)) or not a.is_contiguous():
        raise ValueError("the last axis of x, b and c, and a, must be contiguous")
    if not fake:
        x, b, c = _rows_ready(x, x.shape[-1] < 16), _rows_ready(b), _rows_ready(c)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, b, c)):
        return SSDScanFn.apply(x, dt, a, b, c)
    y, state, _ = _fwd_op(x, dt, a, b, c)
    return y, state


ssd_scan.launches = 0
ssd_scan_bwd.launches = 0
