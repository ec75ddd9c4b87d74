"""The design-space explorer's simulation kernels on Hopper: the port of the
JAX package's ``jax`` simulation backend (``core/backends/jax_backend.py``),
whose hot loop is XLA-jitted jnp, not Pallas: ``_fused_eval`` (:129-146)
and ``_sweep_population`` (:66-89).

The kernels are CUDA C++ (``repro_torch/csrc/dse_sim.cu``, whose header says
what bounds each on the H100 and what the design does about it), float64
throughout, built for ``sm_90a`` and called through ``ctypes``:

``dse_class_times``
    the ``(P, C)`` class-time table: ``collectives.multidim_collective_time_vec``
    over the packed ``(P, C, D)`` dim tables of
    ``simulator.plan_duration_tables`` (one thread per member and class), or
    the transfer lane for transfer classes.
``dse_sweep``
    the per-op durations, gathered through ``src_of_op`` as
    ``simulator.batch_op_durations`` gathers them in a launch of their own
    (one thread per op and member; given instead on the unfused path), then
    the max-plus sweep ``finish[i, p] = dur[i, p] + max(finish[parents[i, :],
    p])`` with one thread per member walking the ops in uid order, blocks of
    one warp.  Each thread keeps the last two finish times in registers and
    the last ``RING`` in a ring in shared memory; only a parent further back
    is read from the finish table in device memory (``sweep_served_from``
    counts where a table's parent reads are served).  Parent indices and
    durations are staged ahead of the walk by ``cp.async`` in tiles of 256
    ops.  A tile whose rows hold at most four parents, all within the ring,
    takes a walk without branches; any other tile one that branches on each
    parent's distance.  Durations and finish times come back op-major,
    ``(n_ops, P)`` and ``(n_ops + 1, P)``, the last finish row the padded
    parent slot (0).

Each wrapper takes its kernel for CUDA tensors and its plain-PyTorch twin
(``class_times_plain``, ``op_durations_plain`` + ``sweep_plain``) for CPU
tensors; any other device raises, and a CUDA call never falls back to the
twin.  The twins repeat numpy's arithmetic operation by operation, so on
the CPU they are bit-identical to ``plan_durations_batch`` and to a numpy
max-plus, and the kernels are bit-identical to them.  ``<wrapper>.launches``
counts the calls that launched kernels: one per call, whatever its launches
(``dse_sweep`` two when it gathers the durations).

``fp64_chain_probe`` is on no main path: it times a chain of dependent fp64
max and add on one thread of the card, the latency the sweep's chain is
made of.  ``synthetic_sweep_case`` makes parent tables that reach every
source of the sweep's parent reads, for the checks.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

F64, I32 = torch.float64, torch.int32
RING = 256  # the sweep's ring of recent finish times a member, kRing in csrc/dse_sim.cu
TILE = 256  # ops a staged tile of the sweep (halved only for wide tables), kTile there

# collectives.py's coefficient tables (the kernel's copies are in dse_sim.cu):
# per-NPU links [topo kind (ring, switch, fc)][algo (ring, direct, rhd, dbt)]
# with -1 for the n-dependent fc/direct entry; rounds and wire multipliers
# per kind (all_reduce, all_gather, reduce_scatter, all_to_all)
_LINKS = ((1.0, 1.0, 1.0, 2.0), (1.0, 1.0, 1.0, 1.0), (1.0, -1.0, 1.0, 2.0))
_STEP_MULT = (2.0, 1.0, 1.0, 1.0)
_WIRE_MULT = (2.0, 1.0, 1.0, 1.0)
_RING_A, _DIRECT_A, _RHD_A, _DBT_A = 0, 1, 2, 3
_RING_T = 0


class Sources(NamedTuple):
    """A plan's duration sources, design-point independent (see
    ``simulator._class_static``): each op's slot in the concatenated
    ``[zero | comp | coll | delay]`` axis, the compute ops' roofline inputs,
    the comm ops' class and repeat count, and the delays."""
    src_of_op: torch.Tensor    # (n_ops,) int32
    comp_flops: torch.Tensor   # (n_comp,) float64
    comp_bytes: torch.Tensor   # (n_comp,) float64
    coll_class: torch.Tensor   # (n_coll,) int32
    coll_repeat: torch.Tensor  # (n_coll,) float64
    delay_us: torch.Tensor     # (n_delay,) float64


@functools.cache
def _entry(name: str):
    fn = getattr(_build.load("dse_sim"), name)
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def _want(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} {tuple(shape)} on {device}; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


# ---------------------------------------------------------------------------
# The class-time table
# ---------------------------------------------------------------------------

def class_times_plain(kind, size, is_xfer, npus, bw, lat, scale, topo, algo, chunks, blue,
                      xfer_bw, xfer_lat):
    """The kernel's plain twin: ``multidim_collective_time_vec`` (with the
    host-exact ``scale``) and the transfer lane, operation by operation as
    numpy evaluates them in ``batch_op_durations``.  Shapes as
    ``dse_class_times``; returns ``(P, C)`` float64."""
    dev = npus.device
    links_t = torch.tensor(_LINKS, dtype=F64, device=dev)
    step_t = torch.tensor(_STEP_MULT, dtype=F64, device=dev)
    wire_t = torch.tensor(_WIRE_MULT, dtype=F64, device=dev)
    kind, algo, topo = kind.long(), algo.long(), topo.long()
    n = npus
    c = torch.clamp_min(chunks, 1.0)[:, None]                   # (P, 1)
    kd = kind[None, :, None]                                    # (1, C, 1)
    sz = size[None, :, None] * scale                            # (P, C, D)
    cc = torch.clamp_min(c[..., None], 1.0)                     # (P, 1, 1)
    # collective_time_vec, elementwise over the dims
    _, e = torch.frexp(torch.clamp_min(n - 1.0, 1.0))
    lg = torch.clamp_min(e.to(F64), 1.0)
    per_pass = torch.where(algo == _RING_A, n - 1.0,
                           torch.where(algo == _DIRECT_A, torch.ones_like(n), lg))
    steps = per_pass * step_t[kd] * cc
    frac = (n - 1.0) / n
    wire = wire_t[kd] * sz * frac
    links = links_t[topo, algo]
    links = torch.where(links < 0, n - 1.0, links)
    on_ring = topo == _RING_T
    cong = torch.ones_like(n)
    cong = torch.where(on_ring & (algo == _DIRECT_A), n / 4.0, cong)
    cong = torch.where(on_ring & (algo == _RHD_A), torch.clamp_min((n / 2.0) / lg, 1.0), cong)
    cong = torch.where(on_ring & (algo == _DBT_A), torch.clamp_min(n / (2.0 * lg), 1.0), cong)
    cong = torch.where(n <= 2.0, torch.ones_like(n), cong)
    eff_bw = bw * links / cong
    t = steps * lat + (wire / eff_bw) * 1e-3
    phases = torch.where((n > 1.0) & (sz > 0.0), t, torch.zeros_like(t))
    # the unrolled reductions over the dims, in order
    sum_p = phases[..., 0]
    max_p = phases[..., 0]
    base_sum = phases[..., 0] / c
    for d in range(1, phases.shape[-1]):
        p = phases[..., d]
        sum_p = sum_p + p
        max_p = torch.maximum(max_p, p)
        base_sum = base_sum + p / c
    active = (n > 1.0).sum(-1)
    blue_t = max_p + (sum_p - max_p) / c
    base = base_sum + (c - 1.0) / c * max_p
    coll_t = torch.where(active <= 1, sum_p, torch.where(blue[:, None], blue_t, base))
    xfer_t = xfer_lat[:, None] + (size[None, :] / xfer_bw[:, None]) * 1e-3
    return torch.where(is_xfer[None, :], xfer_t, coll_t)


def dse_class_times(kind, size, is_xfer, npus, bw, lat, scale, topo, algo, chunks, blue,
                    xfer_bw, xfer_lat):
    """The ``(P, C)`` float64 class-time table.

    kind (C,) int32 collective kind ids; size (C,) float64 payloads; is_xfer
    (C,) bool; npus, bw, lat, scale (P, C, D) float64 and topo, algo (P, C,
    D) int32, the padded dim tables; chunks, xfer_bw, xfer_lat (P,) float64;
    blue (P,) bool.  All on one device, contiguous."""
    if not npus.is_cuda:
        if npus.device.type != "cpu":
            raise ValueError(f"dse_class_times runs on CUDA or CPU tensors, not {npus.device}")
        return class_times_plain(kind, size, is_xfer, npus, bw, lat, scale, topo, algo, chunks,
                                 blue, xfer_bw, xfer_lat)
    if npus.ndim != 3:
        raise ValueError(f"npus: want (P, C, D); got {tuple(npus.shape)}")
    P, C, D = npus.shape
    dev = npus.device
    for name, t, dtype, shape in (
            ("kind", kind, I32, (C,)), ("size", size, F64, (C,)),
            ("is_xfer", is_xfer, torch.bool, (C,)), ("npus", npus, F64, (P, C, D)),
            ("bw", bw, F64, (P, C, D)), ("lat", lat, F64, (P, C, D)),
            ("scale", scale, F64, (P, C, D)), ("topo", topo, I32, (P, C, D)),
            ("algo", algo, I32, (P, C, D)), ("chunks", chunks, F64, (P,)),
            ("blue", blue, torch.bool, (P,)), ("xfer_bw", xfer_bw, F64, (P,)),
            ("xfer_lat", xfer_lat, F64, (P,))):
        _want(name, t, dtype, shape, dev)
    out = torch.empty((P, C), dtype=F64, device=dev)
    if not P * C:
        return out
    args = (ctypes.c_longlong * 18)(
        *(t.data_ptr() for t in (kind, size, is_xfer, npus, bw, lat, scale, topo, algo, chunks,
                                 blue, xfer_bw, xfer_lat, out)),
        P, C, D, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        err = _entry("dse_class_times")(args)
    if err:
        raise RuntimeError(f"dse_class_times kernel launch failed with CUDA error {err}")
    dse_class_times.launches += 1
    return out


dse_class_times.launches = 0


# ---------------------------------------------------------------------------
# The durations and the sweep
# ---------------------------------------------------------------------------

def op_durations_plain(sources: Sources, class_t, peak, membw):
    """The gather's plain twin: ``batch_op_durations(op_major=True)`` from a
    class table.  Returns ``(n_ops, P)`` float64."""
    P = peak.shape[0]
    parts = [torch.zeros((1, P), dtype=F64, device=peak.device)]
    if sources.comp_flops.numel():
        t_c = sources.comp_flops[:, None] / peak[None, :]
        t_m = sources.comp_bytes[:, None] / membw[None, :]
        parts.append(torch.maximum(t_c, t_m) * 1e6)
    if sources.coll_class.numel():
        parts.append(class_t.T[sources.coll_class.long()] * sources.coll_repeat[:, None])
    if sources.delay_us.numel():
        parts.append(sources.delay_us[:, None].expand(-1, P))
    return torch.cat(parts)[sources.src_of_op.long()]


def sweep_levels(parents: torch.Tensor) -> list[torch.Tensor]:
    """The ops grouped by dependency level (an op's level is one more than
    its highest parent's), each group as an index tensor: the plain sweep
    walks them in order.  Depends on the plan only."""
    n_ops = parents.shape[0]
    par = parents.tolist()
    level = [0] * (n_ops + 1)  # the padded slot n_ops sits at level 0
    for i, row in enumerate(par):
        level[i] = 1 + max(level[j] for j in row)
    groups: dict[int, list[int]] = {}
    for i in range(n_ops):
        groups.setdefault(level[i], []).append(i)
    return [torch.tensor(groups[k], dtype=torch.long, device=parents.device)
            for k in sorted(groups)]


def sweep_plain(parents, dur, levels: list[torch.Tensor] | None = None):
    """The sweep's plain twin: ``finish[i] = dur[i] + max(finish[parents[i]])``
    level by level (each level's ops depend only on earlier levels, and max
    and one add per op are exact whatever the grouping).  ``dur`` (n_ops, P);
    returns (n_ops + 1, P) float64, the last row 0."""
    n_ops, P = dur.shape
    finish = torch.zeros((n_ops + 1, P), dtype=F64, device=dur.device)
    par = parents.long()
    for ops in (sweep_levels(parents) if levels is None else levels):
        finish[ops] = finish[par[ops]].amax(dim=1) + dur[ops]
    return finish


def dse_sweep(parents, *, dur=None, sources: Sources | None = None, class_t=None, peak=None,
              membw=None, levels: list[torch.Tensor] | None = None):
    """The per-op durations and the finish times: ``(dur, finish)``, op-major,
    ``(n_ops, P)`` and ``(n_ops + 1, P)`` float64.

    parents (n_ops, W) int32, each op's augmented parents (its deps and the
    previous op on its resource, each before the op) padded with n_ops; on
    the card its base must be 16-byte aligned (the kernel stages it in
    16-byte chunks), and W at most 2,540 on an H100 (a tile of its rows
    must fit in shared memory beside the ring).  Either ``dur`` (n_ops, P) float64,
    the durations (returned as they are), or ``sources`` with ``class_t``
    (P, C) from ``dse_class_times`` and ``peak``, ``membw`` (P,) float64,
    from which the durations are gathered.  ``levels`` (CPU only) is
    ``sweep_levels(parents)``, if the caller keeps it."""
    if (dur is None) == (sources is None):
        raise ValueError("dse_sweep takes either dur or sources, class_t, peak and membw")
    if not parents.is_cuda:
        if parents.device.type != "cpu":
            raise ValueError(f"dse_sweep runs on CUDA or CPU tensors, not {parents.device}")
        if dur is None:
            dur = op_durations_plain(sources, class_t, peak, membw)
        return dur, sweep_plain(parents, dur, levels)
    dev = parents.device
    if parents.ndim != 2:
        raise ValueError(f"parents: want (n_ops, W); got {tuple(parents.shape)}")
    n_ops, W = parents.shape
    if dur is not None:
        P = dur.shape[1] if dur.ndim == 2 else -1
        _want("dur", dur, F64, (n_ops, P), dev)
        n_comp = n_coll = n_delay = C = 0
    else:
        P, C = peak.shape[0], class_t.shape[1]
        n_comp, n_coll, n_delay = (sources.comp_flops.shape[0], sources.coll_class.shape[0],
                                   sources.delay_us.shape[0])
        for name, t, dtype, shape in (
                ("src_of_op", sources.src_of_op, I32, (n_ops,)),
                ("comp_flops", sources.comp_flops, F64, (n_comp,)),
                ("comp_bytes", sources.comp_bytes, F64, (n_comp,)),
                ("coll_class", sources.coll_class, I32, (n_coll,)),
                ("coll_repeat", sources.coll_repeat, F64, (n_coll,)),
                ("delay_us", sources.delay_us, F64, (n_delay,)),
                ("class_t", class_t, F64, (P, C)), ("peak", peak, F64, (P,)),
                ("membw", membw, F64, (P,))):
            _want(name, t, dtype, shape, dev)
    _want("parents", parents, I32, (n_ops, W), dev)
    if parents.data_ptr() % 16:
        raise ValueError("parents: the sweep kernel stages the table in 16-byte chunks; its "
                         "base must be 16-byte aligned")
    finish = torch.empty((n_ops + 1, P), dtype=F64, device=dev)
    if not n_ops or not P:
        if finish.numel():
            finish.zero_()
        return (torch.empty((n_ops, P), dtype=F64, device=dev) if dur is None else dur), finish
    out = None
    if dur is None:
        out = torch.empty((n_ops, P), dtype=F64, device=dev)
        src = (sources.src_of_op, sources.comp_flops, sources.comp_bytes, peak, membw, class_t,
               sources.coll_class, sources.coll_repeat, sources.delay_us)
    else:
        src = (None,) * 9
    args = (ctypes.c_longlong * 21)(
        parents.data_ptr(), *(_ptr(t) for t in src), _ptr(dur), _ptr(out), finish.data_ptr(),
        n_ops, P, W, n_comp, n_coll, n_delay, C, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        err = _entry("dse_sweep")(args)
    if err:
        raise RuntimeError(f"dse_sweep kernel launch failed with CUDA error {err}")
    dse_sweep.launches += 1
    return (out if dur is None else dur), finish


dse_sweep.launches = 0


# ---------------------------------------------------------------------------
# What the checks of the sweep use
# ---------------------------------------------------------------------------

def sweep_served_from(parents: torch.Tensor) -> dict[str, int]:
    """Where the sweep kernel takes a table's real parent reads (those of
    an index in [0, i) for op i): ``registers`` (one or two ops back),
    ``ring`` (up to ``RING`` back) and ``table`` (further back, from the
    finish table in device memory)."""
    par = parents.long()
    i = torch.arange(par.shape[0], device=par.device)[:, None]
    back = i - par
    real = (par >= 0) & (back > 0)
    return {"registers": int((real & (back <= 2)).sum()),
            "ring": int((real & (back > 2) & (back <= RING)).sum()),
            "table": int((real & (back > RING)).sum())}


def synthetic_sweep_case(seed: int, n_ops: int, W: int, P: int,
                         max_back: int = 5000) -> tuple[np.ndarray, np.ndarray]:
    """A parents table (n_ops, W) int32 and durations (n_ops, P) float64
    from a seeded numpy generator, reaching every source of the sweep's
    parent reads: each slot one or two ops back, 3 to ``RING`` back,
    ``RING + 1`` to ``max_back`` back, or the padded slot n_ops (as is any
    slot that would reach before op 0).  About 5% of the ops have only
    padded parents, and about 10% name their first parent twice.  Durations
    are non-negative over six decades, about 5% of them 0."""
    rng = np.random.default_rng(seed)
    i = np.arange(n_ops)[:, None]
    kind = rng.choice(4, size=(n_ops, W), p=(0.4, 0.2, 0.2, 0.2))
    back = np.select([kind == 0, kind == 1, kind == 2],
                     [rng.integers(1, 3, (n_ops, W)), rng.integers(3, RING + 1, (n_ops, W)),
                      rng.integers(RING + 1, max(max_back, RING + 1) + 1, (n_ops, W))], 0)
    parents = np.where((kind < 3) & (back <= i), i - back, n_ops)
    parents[rng.random(n_ops) < 0.05] = n_ops
    if W > 1:
        twice = rng.random(n_ops) < 0.1
        parents[twice, 1] = parents[twice, 0]
    dur = rng.exponential(1.0, (n_ops, P)) * 10.0 ** rng.integers(-3, 4, (n_ops, 1))
    dur[rng.random((n_ops, P)) < 0.05] = 0.0
    return parents.astype(np.int32), dur


def fp64_chain_probe(n: int, device: torch.device | str = "cuda") -> int:
    """Clock cycles of ``n`` dependent (fmax, add) pairs in float64 on one
    thread of the card (``clock64()``), the link of the sweep's chain.
    Synchronises.  A measurement of the card: there is no plain twin, and a
    CPU device raises."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"fp64_chain_probe measures a CUDA device, not {device}")
    buf = torch.tensor([0.0, -1.0, 1e-300, 0.0], dtype=F64, device=device)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    args = (ctypes.c_longlong * 4)(buf.data_ptr(), cycles.data_ptr(), n,
                                   torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        err = _entry("dse_fp64_probe")(args)
    if err:
        raise RuntimeError(f"dse_fp64_probe kernel launch failed with CUDA error {err}")
    return int(cycles.item())
