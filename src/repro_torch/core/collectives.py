"""Collective communication cost models: {Ring, Direct, RHD, DBT} x
{ring, switch, fc} x {reduce-scatter, all-gather, all-reduce, all-to-all},
with chunked pipelining and BlueConnect multi-dimensional decomposition.

alpha-beta form: T = steps * alpha + wire_bytes / effective_bw, where
effective_bw folds in (i) how many of the NPU's links the algorithm can
drive concurrently on the given topology and (ii) congestion when the
algorithm's traffic pattern doesn't match the physical links (e.g. Direct
on a ring incurs multi-hop forwarding).

Two evaluation paths share one set of coefficient tables:

  * the SCALAR path (``collective_time_us`` / ``multidim_collective_time_us``)
    — the memoized per-design-point oracle the reference backend prices
    with, bit-identical to the original branchy implementation;
  * the VECTORIZED path (``collective_time_vec`` /
    ``multidim_collective_time_vec``) — the same model over arrays of
    integer ids (kind/algo/topo_kind) and float dims, evaluating whole
    populations x duration-classes in one shot, in numpy (the ``torch``
    backend prices on the device with the ``dse_class_times`` kernel,
    ``repro_torch.kernels.dse_sim``).  With a host-exact ``scale`` table
    the numpy path reproduces the scalar path bit for bit; without one it matches to the last couple of
    ulps (cumprod vs sequential division).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from repro_torch.core.cache import switchable_lru_cache
from repro_torch.core.topology import TOPO_KINDS, Network, TopoDim

ALGOS = ("ring", "direct", "rhd", "dbt")
COLL_KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")

# -- integer ids: the gather keys of the vectorized evaluator ---------------
ALGO_IDS = {a: i for i, a in enumerate(ALGOS)}
COLL_KIND_IDS = {k: i for i, k in enumerate(COLL_KINDS)}
TOPO_KIND_IDS = {t: i for i, t in enumerate(TOPO_KINDS)}  # ring/switch/fc

_AR = COLL_KIND_IDS["all_reduce"]
_A2A = COLL_KIND_IDS["all_to_all"]
_RING_A, _DIRECT_A, _RHD_A, _DBT_A = (ALGO_IDS[a] for a in ALGOS)
_RING_T, _SWITCH_T, _FC_T = (TOPO_KIND_IDS[t] for t in TOPO_KINDS)

# -- coefficient tables ------------------------------------------------------
# Plain-float tuples feed the scalar path (no numpy scalars on the memoized
# hot path); the numpy arrays the vectorized evaluator gathers from are
# built FROM them so the two paths cannot diverge.
# per-NPU concurrently-driven links, [topo_kind_id][algo_id];
# -1 marks the n-dependent entry (Direct on fully-connected drives n-1)
_LINKS = (
    # ring   direct  rhd   dbt
    (1.0,    1.0,    1.0,  2.0),   # ring topology
    (1.0,    1.0,    1.0,  1.0),   # switch (NIC-bound for every algorithm)
    (1.0,   -1.0,    1.0,  2.0),   # fully connected
)
# serialized-rounds multiplier per collective kind (all-reduce pays a
# reduce-scatter pass plus an all-gather pass); the per-pass round count is
# the algo selector: ring -> n-1, direct -> 1, rhd/dbt -> ceil(log2 n)
_KIND_STEP_MULT = (2.0, 1.0, 1.0, 1.0)
# injection-port bytes multiplier per kind: AR = 2M(n-1)/n, rest = M(n-1)/n
_KIND_WIRE_MULT = (2.0, 1.0, 1.0, 1.0)

_LINKS_TABLE = np.array(_LINKS)
_KIND_STEP_MULT_ARR = np.array(_KIND_STEP_MULT)
_KIND_WIRE_MULT_ARR = np.array(_KIND_WIRE_MULT)


def _ceil_log2(n: int) -> int:
    """ceil(log2(n)) for n >= 1, exactly (bit tricks, no libm)."""
    return max(n - 1, 0).bit_length() if n > 1 else 0


def _steps(algo: str, kind: str, n: int) -> float:
    """Latency term: serialized communication rounds."""
    if n <= 1:
        return 0.0
    lg = math.ceil(math.log2(n))
    if algo == "ring":
        per_pass = n - 1
    elif algo == "direct":
        per_pass = 1.0
    else:  # rhd, dbt
        per_pass = lg
    if kind == "all_reduce":
        return 2.0 * per_pass   # reduce-scatter pass + all-gather pass
    if kind == "all_to_all":
        return 1.0 if algo == "direct" else per_pass
    return float(per_pass)      # AG / RS: one pass


def _wire_bytes(kind: str, n: int, size: float) -> float:
    """Bytes each NPU must move through its injection port (bandwidth-optimal
    lower bound): AR = 2M(n-1)/n, AG/RS/A2A = M(n-1)/n."""
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    return _KIND_WIRE_MULT[COLL_KIND_IDS[kind]] * size * frac


def _parallel_links(algo: str, topo_kind: str, n: int) -> float:
    """How many links per NPU the algorithm drives concurrently (the
    ``_LINKS_TABLE`` coefficient; -1 marks the n-dependent fc/direct entry)."""
    v = _LINKS_TABLE[TOPO_KIND_IDS[topo_kind], ALGO_IDS[algo]]
    return float(n - 1) if v < 0 else float(v)


def _congestion(algo: str, topo_kind: str, n: int) -> float:
    """Multiplier >= 1 when traffic must be forwarded over links it doesn't
    own (pattern/topology mismatch)."""
    if n <= 2:
        return 1.0
    if topo_kind == "ring":
        if algo == "direct":
            return n / 4.0            # mean hop distance on a bidirectional ring
        if algo == "rhd":
            # exchange at distance 2^i: sum of hops / passes
            return max(1.0, (n / 2.0) / math.ceil(math.log2(n)))
        if algo == "dbt":
            return max(1.0, n / (2.0 * math.ceil(math.log2(n))))
    if topo_kind == "switch":
        return 1.0                    # non-blocking
    return 1.0                        # fc: every pair has a wire


def collective_time_us(kind: str, size_bytes: float, dim: TopoDim, algo: str,
                       chunks: int = 1) -> float:
    """Time for one collective of `size_bytes` within one network dim.

    Chunking trades bandwidth efficiency for latency/pipelinability: the
    latency term pays per chunk; the bandwidth term is unchanged (chunks are
    serialized within a single dim — the pipelining win shows up across dims
    in `multidim_collective_time_us`)."""
    n = dim.npus
    if n <= 1 or size_bytes <= 0:
        return 0.0
    steps = _steps(algo, kind, n) * max(chunks, 1)
    wire = _wire_bytes(kind, n, size_bytes)
    eff_bw = dim.bw * _parallel_links(algo, dim.kind, n) / _congestion(algo, dim.kind, n)
    return steps * dim.latency_us + (wire / eff_bw) * 1e-3  # bytes/(GB/s) -> us
    # (1 byte / 1 GB/s = 1e-9 s = 1e-3 us)


def multidim_collective_time_us(kind: str, size_bytes: float, net: Network,
                                algos: Sequence[str], chunks: int = 1,
                                mode: str = "baseline",
                                dims: Sequence[int] | None = None) -> float:
    """A collective spanning several mesh dimensions.

    Memoized on ``(kind, size, net, algos, chunks, mode, dims)`` — traces
    repeat the same per-layer collective shapes, and searches revisit design
    points, so the hit rate on the DSE hot path is very high.  ``Network``
    and ``TopoDim`` are frozen dataclasses, making the whole key hashable;
    a hit is bit-identical to the uncached computation.

    baseline:    hierarchical reduce-scatter up the dims then all-gather back
                 down (sizes shrink by the group size at each hop); chunks
                 pipeline across the per-dim phases.
    blueconnect: decompose the collective into per-dim schedules running
                 concurrently on disjoint chunks (Cho et al., MLSys'19) —
                 total time approaches the slowest dim instead of the sum.
    """
    return _multidim_collective_time_cached(
        kind, float(size_bytes), net, tuple(algos), chunks, mode,
        None if dims is None else tuple(dims))


def _multidim_collective_time_impl(kind: str, size_bytes: float, net: Network,
                                   algos: Sequence[str], chunks: int,
                                   mode: str,
                                   dims: Sequence[int] | None) -> float:
    idx = list(range(len(net.dims))) if dims is None else list(dims)
    idx = [i for i in idx if net.dims[i].npus > 1]
    if not idx or size_bytes <= 0:
        return 0.0
    if len(idx) == 1:
        return collective_time_us(kind, size_bytes, net.dims[idx[0]], algos[idx[0]], chunks)

    if kind == "all_to_all":
        # dimension-ordered routing: each dim moves the full payload once
        phases = [collective_time_us(kind, size_bytes, net.dims[i], algos[i], chunks)
                  for i in idx]
    else:
        # RS up / AG down with shrinking payloads
        phases = []
        scale = 1.0
        for i in idx:
            d = net.dims[i]
            if kind == "all_reduce":
                phases.append(
                    collective_time_us("reduce_scatter", size_bytes * scale, d, algos[i], chunks)
                    + collective_time_us("all_gather", size_bytes * scale, d, algos[i], chunks))
            else:
                phases.append(collective_time_us(kind, size_bytes * scale, d, algos[i], chunks))
            scale /= d.npus

    c = max(chunks, 1)
    if mode == "blueconnect":
        # concurrent per-dim schedules on disjoint chunk shards
        return max(phases) + (sum(phases) - max(phases)) / c
    # hierarchical with chunk pipelining between consecutive phases
    return sum(p / c for p in phases) + (c - 1) / c * max(phases)


_multidim_collective_time_cached = \
    switchable_lru_cache(maxsize=131072)(_multidim_collective_time_impl)


# ---------------------------------------------------------------------------
# Vectorized evaluator: the same model over arrays of integer ids
# ---------------------------------------------------------------------------

def _vec_ceil_log2(n):
    """ceil(log2(n)) for float arrays of integers, exactly: the exponent of
    frexp(n - 1) is bit_length(n - 1), with no libm rounding to worry about.
    Returns 1 where n <= 2 (callers only consume lg through congestion /
    rhd-dbt step counts, which are guarded there)."""
    _, e = np.frexp(np.maximum(n - 1.0, 1.0))
    return np.maximum(e.astype(np.float64), 1.0)


def collective_time_vec(kind_id, size_bytes, npus, bw, latency_us, topo_id,
                        algo_id, chunks):
    """Elementwise ``collective_time_us`` over arrays.

    All arguments broadcast together; ids are integer arrays indexing the
    coefficient tables (``COLL_KIND_IDS`` / ``ALGO_IDS`` / ``TOPO_KIND_IDS``),
    the rest are float64 arrays.  Entries with ``npus <= 1`` or
    ``size_bytes <= 0`` evaluate to 0, so padded dim slots are free."""
    n = np.asarray(npus, dtype=np.float64)
    size = np.asarray(size_bytes, dtype=np.float64)
    c = np.maximum(np.asarray(chunks, dtype=np.float64), 1.0)
    lat = np.asarray(latency_us, dtype=np.float64)
    kind_id = np.asarray(kind_id)
    algo_id = np.asarray(algo_id)
    topo_id = np.asarray(topo_id)

    lg = _vec_ceil_log2(n)
    # latency term: per-pass rounds selected by algo, doubled for all-reduce
    per_pass = np.where(algo_id == _RING_A, n - 1.0,
                        np.where(algo_id == _DIRECT_A, 1.0, lg))
    steps = per_pass * np.asarray(_KIND_STEP_MULT)[kind_id] * c
    # bandwidth term: injection-port bytes over effective bandwidth
    frac = (n - 1.0) / n
    wire = np.asarray(_KIND_WIRE_MULT)[kind_id] * size * frac
    links = np.asarray(_LINKS_TABLE)[topo_id, algo_id]
    links = np.where(links < 0, n - 1.0, links)
    on_ring = topo_id == _RING_T
    cong = np.ones_like(n)
    cong = np.where(on_ring & (algo_id == _DIRECT_A), n / 4.0, cong)
    cong = np.where(on_ring & (algo_id == _RHD_A),
                    np.maximum(1.0, (n / 2.0) / lg), cong)
    cong = np.where(on_ring & (algo_id == _DBT_A),
                    np.maximum(1.0, n / (2.0 * lg)), cong)
    cong = np.where(n <= 2.0, 1.0, cong)
    eff_bw = bw * links / cong
    t = steps * lat + (wire / eff_bw) * 1e-3
    return np.where((n > 1.0) & (size > 0.0), t, 0.0)


def multidim_collective_time_vec(kind_id, size_bytes, npus, bw, latency_us,
                                 topo_id, algo_id, chunks, blueconnect, *,
                                 scale=None):
    """Vectorized ``multidim_collective_time_us`` over padded dim tables.

    The trailing axis is the (padded) dim axis: ``npus``/``bw``/
    ``latency_us``/``topo_id``/``algo_id`` are ``(..., D)``; ``kind_id``,
    ``size_bytes``, ``chunks`` and the boolean ``blueconnect`` (mode) are
    ``(...)`` and broadcast.  Pad unused slots with ``npus = 1`` (carved
    dims always have >= 2 NPUs, so real and padded slots can't collide).

    ``scale`` optionally provides the hierarchical payload-shrinking table
    ``(..., D)`` host-exactly (sequential division, as the scalar path
    computes it) — the packed-table fast path passes it; when ``None`` it is
    derived here via cumprod (equal to the last ulp).  All-to-all rows must
    pass scale 1 (dimension-ordered routing moves the full payload per dim);
    the internal derivation handles that, host-built tables must too.

    Reductions over the dim axis are unrolled so the accumulation order
    matches the scalar path's active-dims-in-order ``sum()``/``max()`` —
    with a host-exact ``scale`` the numpy evaluation is bit-identical to
    the (uncached) scalar model."""
    n = np.asarray(npus, dtype=np.float64)
    size = np.asarray(size_bytes, dtype=np.float64)[..., None]
    kind = np.asarray(kind_id)[..., None]
    c = np.maximum(np.asarray(chunks, dtype=np.float64), 1.0)
    if scale is None:
        inv = 1.0 / n
        shifted = np.cumprod(inv[..., :-1], axis=-1)
        scale = np.concatenate(
            [np.ones_like(inv[..., :1]), shifted], axis=-1)
        scale = np.where(kind == _A2A, 1.0, scale)
    else:
        scale = np.asarray(scale, dtype=np.float64)
    phases = collective_time_vec(kind, size * scale, n, bw, latency_us,
                                 topo_id, algo_id, c[..., None])
    ndim = phases.shape[-1]
    # unrolled reductions: padded slots contribute exact 0.0 terms
    sum_p = phases[..., 0]
    max_p = phases[..., 0]
    base_sum = phases[..., 0] / c
    for d in range(1, ndim):
        p = phases[..., d]
        sum_p = sum_p + p
        max_p = np.maximum(max_p, p)
        base_sum = base_sum + p / c
    active = np.sum(n > 1.0, axis=-1)
    blue = max_p + (sum_p - max_p) / c
    base = base_sum + (c - 1.0) / c * max_p
    multi = np.where(np.asarray(blueconnect, dtype=bool), blue, base)
    # 0 or 1 active dims: no cross-dim pipelining — the bare phase (or 0)
    return np.where(active <= 1, sum_p, multi)
