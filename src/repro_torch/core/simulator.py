"""Simulation front door + the design-point-independent scheduling plan.

Resources: one compute stream (roofline device model) + one communication
engine per parallelism group (tp/dp/ep/pp), each mapped onto the network
dims it spans.  Ready ops queue on their resource; the queue discipline is
the paper's Collective 'Scheduling Policy' knob (LIFO favours the freshest
— critical-path — collectives, FIFO drains in issue order).  Compute/comm
overlap falls out of the scheduler, so exposed communication is measured,
not assumed.

HOW a trace is scheduled is a swappable backend (``repro_torch.core.backends``):
``simulate()`` below is a thin delegate onto the selected ``SimBackend``
(default: the reference discrete-event heapq loop, bit-identical to the
original in-module implementation).  This module keeps what every backend
shares — the ``SystemConfig``/``SimResult`` value objects, the per-trace
``_SimPlan`` (dependency counts, children lists, per-op resource ids,
compute-op shape arrays, built once per ``Trace`` and reused across every
design point that shares it), and the per-design-point duration pass
(numpy-vectorized roofline for compute ops, the memoized collective cost
model for comm ops with each group's sub-network resolved once per call
rather than once per op).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

from repro_torch.core.cache import switchable_lru_cache
from repro_torch.core.collectives import (ALGO_IDS, COLL_KIND_IDS, TOPO_KIND_IDS,
                                    multidim_collective_time_us,
                                    multidim_collective_time_vec)
from repro_torch.core.compute import Device
from repro_torch.core.topology import Network, TopoDim, carve_dims
from repro_torch.core.workload import Op, Parallelism, Trace


SCHED_POLICIES = ("fifo", "lifo")


@dataclass(frozen=True)
class SystemConfig:
    """The Collective + Network + Compute stacks of one design point."""
    network: Network
    device: Device
    coll_algo: tuple[str, ...]          # per network dim
    chunks: int = 1
    sched_policy: str = "fifo"          # lifo | fifo
    multidim_coll: str = "baseline"     # baseline | blueconnect
    # cross-partition transfer engine (multi-pool scenarios: KV-cache
    # handoff between disaggregated pools).  None rides the outermost —
    # scale-out — network dim's link speed.
    xfer_bw: float | None = None        # GB/s per transfer lane
    xfer_latency_us: float = 5.0

    def __post_init__(self) -> None:
        # a typo'd policy used to silently schedule as FIFO (the duration
        # pass only checked == "lifo"); fail at construction instead
        if self.sched_policy not in SCHED_POLICIES:
            raise ValueError(f"unknown sched_policy "
                             f"{self.sched_policy!r}; "
                             f"known: {SCHED_POLICIES}")


@switchable_lru_cache(maxsize=4096)
def group_dims(net: Network, par: Parallelism) -> dict[str, tuple[tuple[int, TopoDim], ...]]:
    """Map parallelism groups onto network dimensions, innermost first:
    TP gets the inner (fastest) dims, then EP(=TP group), SP, DP, PP.

    Each carved dim is returned with the physical dim index it came from
    (``carve_dims`` contract), so DP/PP collectives riding outer dims are
    priced with the collective algorithms the agent configured for THOSE
    dims — not the inner dims' algorithms.  When a group covers part of a
    dim, a virtual TopoDim with the residual group size (same kind/bw)
    approximates the sub-ring/sub-switch.  A group factor sharing no
    divisor with any dim (non-power-of-two pools from disaggregated/
    partitioned scenarios) becomes a virtual dim at the outermost —
    slowest — tier so its collectives are never free.

    Memoized on ``(net, par)`` (both frozen): populations revisit the same
    mapping thousands of times per generation.  The returned dict is shared
    across hits — treat it (and its tuple values) as immutable."""
    sizes = {"tp": par.tp, "sp": par.sp, "dp": par.dp, "pp": par.pp}
    cap = [d.npus for d in net.dims]  # consumed across groups, in order
    out: dict[str, tuple[tuple[int, TopoDim], ...]] = {
        grp: tuple(carve_dims(net.dims, cap, sizes[grp]))
        for grp in ("tp", "sp", "dp", "pp")
    }
    out["ep"] = out["tp"]  # expert-parallel collectives ride the TP group
    return out


@dataclass
class SimResult:
    makespan_us: float
    compute_busy_us: float              # pool-0 compute stream (back-compat)
    comm_busy_us: dict[str, float]
    exposed_comm_us: float
    per_op_us: dict[int, float] = field(default_factory=dict)
    pool_compute_us: dict[int, float] = field(default_factory=dict)
    # op completion times (same opt-in as per_op_us): the request-stream
    # scenario reads per-wave first-token / last-token finish times off this
    op_finish_us: dict[int, float] = field(default_factory=dict)
    # opt-in (``simulate(..., analyze=True)``): critical-path bottleneck
    # attribution over the dependency DAG — see
    # ``repro_torch.core.analysis.CriticalPath.summary`` for the keys
    analysis: dict[str, Any] | None = None

    @property
    def latency_ms(self) -> float:
        return self.makespan_us / 1e3


@switchable_lru_cache(maxsize=16384)
def _group_net_cached(coll_algo: tuple[str, ...],
                      carved: tuple[tuple[int, TopoDim], ...],
                      ) -> tuple[Network, tuple[str, ...]] | None:
    if not carved:
        return None
    n_alg = len(coll_algo)
    algos = tuple(coll_algo[min(i, n_alg - 1)] if n_alg else "ring"
                  for i, _ in carved)
    return Network(tuple(d for _, d in carved)), algos


def _group_net(cfg: SystemConfig,
               carved: Sequence[tuple[int, TopoDim]]) -> tuple[Network, tuple[str, ...]] | None:
    """Resolve one parallelism group's sub-network + per-dim algorithms.

    ``carved`` pairs each dim with its source physical dim index, so the
    group's collectives use ``cfg.coll_algo[src_idx]`` — the algorithm the
    agent chose for that physical dim — instead of slicing from position 0
    (which handed DP/PP groups the inner dims' algorithms).  Residual
    virtual dims carry the outermost dim's index and therefore inherit its
    algorithm; indices beyond the configured tuple clamp to its last entry.

    Memoized on ``(cfg.coll_algo, carved)`` — everything else on the config
    is irrelevant to the resolution, so design points differing only in
    chunks/policy/device hit the same entry."""
    return _group_net_cached(cfg.coll_algo, tuple(carved))


@dataclass
class _SimPlan:
    """Design-point-independent scheduling structure of one trace.

    Ops carry dense uids (0..n-1 in issue order), so dependency bookkeeping
    lives in flat lists instead of dicts.  Resources are small integer ids;
    id 0 is always pool 0's compute stream.  Every pool gets its own compute
    stream and comm engines; cross-partition ``xfer`` collectives share one
    transfer resource; ``delay`` ops (arrival releases in request-stream
    traces) each get a private timer resource so they never serialize.

    Comm ops are condensed into duration CLASSES — the distinct
    ``(pool, group, coll, size)`` shapes (layers repeat shapes, so a trace
    with thousands of collectives typically has a few dozen classes): the
    per-design-point duration pass prices each class once and scatters,
    instead of walking every op through a memo dict."""
    n_ops: int
    res_names: list[str]                # per resource id: "compute" | group
    res_pool: list[int]                 # per resource id: owning pool
    res_of: list[int]                   # per op: resource id
    ndeps0: list[int]
    children: list[list[int]]
    roots: list[int]
    # every op's deps concatenated in uid order (CSR values; ``ndeps0`` is
    # the row-length vector) — the static verifier / critical-path pass
    # (``repro_torch.core.analysis``) runs vectorized over this instead of
    # re-walking the op list
    deps_flat: np.ndarray
    comp_uids: np.ndarray
    comp_flops: np.ndarray
    comp_bytes: np.ndarray
    coll_shapes: list[tuple[int, str, str, float]]  # per class: (pool, group, coll, size)
    coll_uids: np.ndarray               # comm-op uids
    coll_class: np.ndarray              # per comm op: coll_shapes index
    coll_repeat: np.ndarray             # per comm op: back-to-back repeats
    delay_ops: list[tuple[int, float]]  # (uid, delay_us)
    pools: tuple[int, ...]
    # per-design-point packed duration tables, memoized on the plan keyed by
    # (network, coll_algo, pool entries) — see _pack_class_tables
    pack_memo: dict = field(default_factory=dict, repr=False)


def _sim_plan(trace: Trace) -> _SimPlan:
    plan = getattr(trace, "_sim_plan", None)
    if plan is not None:
        return plan
    n = len(trace.ops)
    if any(op.uid != i for i, op in enumerate(trace.ops)):
        raise ValueError("simulate() requires dense op uids (0..n-1 in list "
                         "order) — build traces with TraceBuilder")
    res_names = ["compute"]
    res_pool = [0]
    res_index: dict[tuple[int, str], int] = {(0, "compute"): 0}
    res_of = [0] * n
    ndeps0 = [0] * n
    children: list[list[int]] = [[] for _ in range(n)]
    roots: list[int] = []
    comp_idx: list[int] = []
    comp_flops: list[float] = []
    comp_bytes: list[float] = []
    class_index: dict[tuple[int, str, str, float], int] = {}
    coll_shapes: list[tuple[int, str, str, float]] = []
    coll_uids: list[int] = []
    coll_class: list[int] = []
    coll_repeat: list[int] = []
    delay_ops: list[tuple[int, float]] = []
    pools: set[int] = {0}
    deps_flat: list[int] = []

    def resource(pool: int, name: str) -> int:
        rid = res_index.get((pool, name))
        if rid is None:
            rid = len(res_names)
            res_index[(pool, name)] = rid
            res_names.append(name)
            res_pool.append(pool)
        return rid

    for op in trace.ops:
        pools.add(op.pool)
        if op.kind == "comp":
            res_of[op.uid] = resource(op.pool, "compute")
            comp_idx.append(op.uid)
            # the roofline is linear in (flops, bytes), so an op repeated
            # back-to-back k times is exactly one op scaled by k
            comp_flops.append(op.flops * op.repeat)
            comp_bytes.append(op.bytes * op.repeat)
        elif op.kind == "delay":
            # a pure time offset (request release): private resource so
            # concurrent delays never queue on each other
            res_of[op.uid] = resource(op.pool, f"_delay{op.uid}")
            delay_ops.append((op.uid, op.delay_us))
        else:
            # the transfer engine bridges partitions: one shared resource
            pool = 0 if op.group == "xfer" else op.pool
            res_of[op.uid] = resource(pool, op.group)
            key = (op.pool, op.group, op.coll, op.size_bytes)
            cls = class_index.get(key)
            if cls is None:
                cls = class_index[key] = len(coll_shapes)
                coll_shapes.append(key)
            coll_uids.append(op.uid)
            coll_class.append(cls)
            coll_repeat.append(op.repeat)
        ndeps0[op.uid] = len(op.deps)
        if not op.deps:
            roots.append(op.uid)
        deps_flat.extend(op.deps)
        for d in op.deps:
            children[d].append(op.uid)
    plan = _SimPlan(n_ops=n, res_names=res_names, res_pool=res_pool,
                    res_of=res_of, ndeps0=ndeps0, children=children,
                    roots=roots,
                    deps_flat=np.array(deps_flat, dtype=np.intp),
                    comp_uids=np.array(comp_idx, dtype=np.intp),
                    comp_flops=np.array(comp_flops, dtype=np.float64),
                    comp_bytes=np.array(comp_bytes, dtype=np.float64),
                    coll_shapes=coll_shapes,
                    coll_uids=np.array(coll_uids, dtype=np.intp),
                    coll_class=np.array(coll_class, dtype=np.intp),
                    coll_repeat=np.array(coll_repeat, dtype=np.float64),
                    delay_ops=delay_ops,
                    pools=tuple(sorted(pools)))
    trace._sim_plan = plan  # traces are cached + immutable; piggyback the plan
    return plan


def _xfer_time_us(cfg: SystemConfig, size_bytes: float) -> float:
    """Cross-partition transfer: latency + bytes over the transfer lane
    (callers pre-divide the payload by the number of parallel lanes)."""
    bw = cfg.xfer_bw if cfg.xfer_bw is not None else cfg.network.dims[-1].bw
    return cfg.xfer_latency_us + (size_bytes / bw) * 1e-3


def _op_durations(plan: _SimPlan, cfg: SystemConfig,
                  gdims_by_pool: dict[int, dict[str, list[tuple[int, TopoDim]]]]) -> np.ndarray:
    """Duration of every op: vectorized roofline for the compute ops, the
    memoized collective model priced once per duration CLASS and scattered
    to the comm ops (a repeat of k back-to-back identical collectives pays
    k full latency+bandwidth terms)."""
    arr = np.zeros(plan.n_ops, dtype=np.float64)
    if len(plan.comp_uids):
        arr[plan.comp_uids] = cfg.device.op_times_us(plan.comp_flops,
                                                     plan.comp_bytes)
    if plan.coll_shapes:
        group_nets = {(pool, g): _group_net(cfg, carved)
                      for pool, gdims in gdims_by_pool.items()
                      for g, carved in gdims.items()}
        chunks, mode = cfg.chunks, cfg.multidim_coll
        class_t = np.empty(len(plan.coll_shapes), dtype=np.float64)
        for cls, (pool, group, coll, size) in enumerate(plan.coll_shapes):
            if group == "xfer":
                t = _xfer_time_us(cfg, size)
            else:
                resolved = group_nets.get((pool, group))
                if resolved is None:
                    t = 0.0
                else:
                    sub, algos = resolved
                    t = multidim_collective_time_us(coll, size, sub, algos,
                                                    chunks=chunks, mode=mode)
            class_t[cls] = t
        arr[plan.coll_uids] = class_t[plan.coll_class] * plan.coll_repeat
    for uid, delay_us in plan.delay_ops:
        arr[uid] = delay_us
    return arr


def _pool_entries(plan: _SimPlan, par: Parallelism,
                  pools: dict[int, Any] | None) -> tuple[tuple[int, Any], ...]:
    """Canonical, hashable form of the ``pools`` argument: one resolved
    entry per pool the plan actually uses (pool values are Parallelism /
    (Par, Net) / (Par, Net, dim_map) — all frozen/hashable)."""
    if pools is None:
        return tuple((p, par) for p in plan.pools)
    return tuple((p, pools.get(p, par)) for p in plan.pools)


@switchable_lru_cache(maxsize=4096)
def _pool_group_dims_cached(network: Network,
                            entries: tuple[tuple[int, Any], ...],
                            ) -> dict[int, dict[str, tuple[tuple[int, TopoDim], ...]]]:
    gdims_by_pool = {}
    for p, entry in entries:
        dim_map: tuple[int, ...] | None = None
        if isinstance(entry, tuple):
            if len(entry) == 3:
                par_p, net_p, dim_map = entry
            else:
                par_p, net_p = entry
        else:
            par_p, net_p = entry, network
        gd = group_dims(net_p, par_p)
        if dim_map:
            # carve indices are relative to the pool's sub-fabric; translate
            # them to the parent fabric's physical dims for algo resolution
            last = len(dim_map) - 1
            gd = {g: tuple((dim_map[min(i, last)], d) for i, d in v)
                  for g, v in gd.items()}
        gdims_by_pool[p] = gd
    return gdims_by_pool


def pool_group_dims(plan: _SimPlan, cfg: SystemConfig, par: Parallelism,
                    pools: dict[int, Any] | None) -> dict[int, dict[str, tuple[tuple[int, TopoDim], ...]]]:
    """Resolve every pool's parallelism-group -> carved-dims mapping.

    ``pools`` maps pool id -> that partition's Parallelism (default: every
    pool is parallelized by ``par`` on ``cfg.network``).  A ``(Parallelism,
    Network)`` value prices the pool's collectives on the sub-fabric its NPU
    slice actually spans instead of the whole cluster; a ``(Parallelism,
    Network, dim_map)`` value (``topology.sub_network_indexed``)
    additionally maps each sub-fabric dim back to its source physical dim so
    ``cfg.coll_algo`` is resolved against the dims the pool's traffic
    actually rides.

    Memoized on ``(cfg.network, resolved pool entries)`` — populations reuse
    a handful of carvings across thousands of calls.  The returned mapping
    is shared across hits; treat it as immutable."""
    return _pool_group_dims_cached(cfg.network, _pool_entries(plan, par, pools))


def plan_durations(trace: Trace, cfg: SystemConfig, par: Parallelism,
                   pools: dict[int, Any] | None = None) -> tuple[_SimPlan, np.ndarray]:
    """The shared per-design-point half of every backend: the (cached)
    scheduling plan plus this config's per-op durations (float64)."""
    plan = _sim_plan(trace)
    return plan, _op_durations(plan, cfg, pool_group_dims(plan, cfg, par,
                                                          pools))


# ---------------------------------------------------------------------------
# Batched duration pass: price a whole population in one vectorized shot
# ---------------------------------------------------------------------------

def _class_static(plan: _SimPlan) -> dict[str, np.ndarray]:
    """Design-point-independent per-class arrays (collective kind ids, class
    payload sizes, the xfer mask) plus the delay-op scatter arrays — built
    once per plan and reused by every batch."""
    st = plan.pack_memo.get("static")
    if st is None:
        C = len(plan.coll_shapes)
        kind_id = np.zeros(C, dtype=np.int32)
        size = np.zeros(C, dtype=np.float64)
        is_xfer = np.zeros(C, dtype=bool)
        for i, (_pool, group, coll, sz) in enumerate(plan.coll_shapes):
            # xfer classes price on the transfer lane, not the collective
            # model; kind id 0 is a dead gather behind the is_xfer mask
            kind_id[i] = 0 if group == "xfer" else COLL_KIND_IDS[coll]
            size[i] = sz
            is_xfer[i] = group == "xfer"
        delay_uids = np.array([u for u, _ in plan.delay_ops], dtype=np.intp)
        # permutation mapping op uid -> slot in the concatenated
        # [zero | comp | coll | delay] duration-source axis: the batched
        # pass GATHERS per-op durations through it instead of scattering
        # three uid groups (one contiguous-row gather, in numpy and in the
        # ``dse_sweep`` kernel alike); slot 0 stays 0.0 for ops with no
        # duration source
        src = np.zeros(plan.n_ops, dtype=np.int32)
        base = 1
        for uids in (plan.comp_uids, plan.coll_uids, delay_uids):
            src[np.asarray(uids, dtype=np.intp)] = \
                base + np.arange(len(uids), dtype=np.int32)
            base += len(uids)
        st = {
            "kind_id": kind_id, "size": size, "is_xfer": is_xfer,
            "delay_uids": delay_uids,
            "delay_us": np.array([d for _, d in plan.delay_ops],
                                 dtype=np.float64),
            "src_of_op": src,
        }
        plan.pack_memo["static"] = st
    return st


def _pack_class_tables(plan: _SimPlan, cfg: SystemConfig, par: Parallelism,
                       pools: dict[int, Any] | None) -> dict[str, np.ndarray]:
    """One design point's per-class dim tables, padded to this key's max
    dim count: ``(C, D)`` arrays of npus / bw / latency_us / hierarchical
    payload scale (float64) and topo-kind / algo ids (int32).

    The carving is resolved once per ``(network, coll_algo, pool entries)``
    and memoized on the plan — population members differing only in
    chunks / mode / device / policy hit the same entry, and generations
    revisit the same few entries.  Padded slots hold ``npus = 1`` (carved
    dims always span >= 2 NPUs), which the vectorized collective evaluator
    prices to an exact 0.  The ``scale`` column is the scalar path's
    sequential-division payload shrinking, so pricing from these tables is
    bit-identical to the memoized scalar model."""
    entries = _pool_entries(plan, par, pools)
    key = (cfg.network, cfg.coll_algo, entries)
    cached = plan.pack_memo.get(key)
    if cached is not None:
        return cached
    gdims = _pool_group_dims_cached(cfg.network, entries)
    C = len(plan.coll_shapes)
    rows: list[tuple[tuple[TopoDim, str], ...]] = []
    D = 1
    for pool, group, _coll, _sz in plan.coll_shapes:
        resolved = None
        if group != "xfer":
            carved = gdims.get(pool, {}).get(group)
            if carved:
                resolved = _group_net(cfg, carved)
        if resolved is None:
            rows.append(())
            continue
        sub, algos = resolved
        row = tuple(zip(sub.dims, algos))
        rows.append(row)
        D = max(D, len(row))
    npus = np.ones((C, D), dtype=np.float64)
    bw = np.ones((C, D), dtype=np.float64)
    lat = np.zeros((C, D), dtype=np.float64)
    scale = np.ones((C, D), dtype=np.float64)
    topo = np.zeros((C, D), dtype=np.int32)
    algo = np.zeros((C, D), dtype=np.int32)
    for i, row in enumerate(rows):
        a2a = plan.coll_shapes[i][2] == "all_to_all"
        s = 1.0
        for j, (d, a) in enumerate(row):
            npus[i, j] = d.npus
            bw[i, j] = d.bw
            lat[i, j] = d.latency_us
            topo[i, j] = TOPO_KIND_IDS[d.kind]
            algo[i, j] = ALGO_IDS[a]
            scale[i, j] = 1.0 if a2a else s
            s /= d.npus
    tab = {"npus": npus, "bw": bw, "lat": lat, "scale": scale,
           "topo": topo, "algo": algo}
    plan.pack_memo[key] = tab
    return tab


def plan_duration_tables(trace: Trace,
                         calls: Sequence[Any]) -> tuple[_SimPlan, dict[str, np.ndarray]]:
    """The batched analogue of ``plan_durations``'s inputs: the (cached)
    plan plus one dict of packed numpy tables covering the whole population
    — ``(P, C, D)`` per-class dim tables and ``(P,)`` per-call scalars
    (roofline coefficients, chunks, mode, transfer-lane parameters).  The
    tables are everything ``batch_op_durations`` needs, and the ``torch``
    backend uploads them to the device as they are."""
    plan = _sim_plan(trace)
    tables = dict(_class_static(plan))
    per = [_pack_class_tables(plan, c.cfg, c.par, c.pools) for c in calls]
    P = len(calls)
    C = len(plan.coll_shapes)
    # pad the dim axis to a stable width, 6, which covers every carve of a
    # <=5-dim network (5 plus a residual virtual dim), so the packed
    # tables keep one shape from batch to batch
    D = max(max((t["npus"].shape[1] for t in per), default=1), 6)
    for name, fill, dtype in (("npus", 1.0, np.float64),
                              ("bw", 1.0, np.float64),
                              ("lat", 0.0, np.float64),
                              ("scale", 1.0, np.float64),
                              ("topo", 0, np.int32),
                              ("algo", 0, np.int32)):
        out = np.full((P, C, D), fill, dtype=dtype)
        for k, t in enumerate(per):
            a = t[name]
            out[k, :, :a.shape[1]] = a
        tables[name] = out
    # per-call scalars, computed with the exact scalar-path expressions
    tables["peak"] = np.array([c.cfg.device.peak_tflops * 1e12
                               for c in calls], dtype=np.float64)
    tables["membw"] = np.array([c.cfg.device.mem_bw_gbps * 1e9
                                for c in calls], dtype=np.float64)
    tables["chunks"] = np.array([float(c.cfg.chunks) for c in calls],
                                dtype=np.float64)
    tables["blue"] = np.array([c.cfg.multidim_coll == "blueconnect"
                               for c in calls], dtype=bool)
    tables["xfer_bw"] = np.array(
        [c.cfg.xfer_bw if c.cfg.xfer_bw is not None
         else (c.cfg.network.dims[-1].bw if c.cfg.network.dims else 1.0)
         for c in calls], dtype=np.float64)
    tables["xfer_lat"] = np.array([c.cfg.xfer_latency_us for c in calls],
                                  dtype=np.float64)
    return plan, tables


def batch_op_durations(plan: _SimPlan, tables: dict[str, Any], *,
                       op_major: bool = False):
    """Duration of every op for every population member: ``(P, n_ops)``
    (or ``(n_ops, P)`` with ``op_major=True``).

    The whole-population duration pass over ``plan_duration_tables`` output:
    the roofline prices all compute ops x calls in one broadcast, the
    vectorized collective evaluator prices all duration classes x calls in
    one shot (transfer classes switch to the xfer lane model), and the
    results route to op uids through one permutation gather (see
    ``src_of_op`` in ``_class_static``: a contiguous-row gather, and
    op-major rows come out contiguous for the scheduling sweep).  Each row is bit-identical to the scalar
    ``plan_durations`` row for that call.  It runs in numpy: the ``torch``
    backend prices on the device with the ``dse_sim`` kernels, whose plain
    twins (``repro_torch.kernels.dse_sim``) repeat this arithmetic."""
    P = int(tables["peak"].shape[0])
    parts = [np.zeros((1, P), dtype=np.float64)]
    if len(plan.comp_uids):
        t_c = np.asarray(plan.comp_flops)[:, None] / tables["peak"][None, :]
        t_m = np.asarray(plan.comp_bytes)[:, None] / tables["membw"][None, :]
        parts.append(np.maximum(t_c, t_m) * 1e6)           # (n_comp, P)
    if plan.coll_shapes:
        kind = np.asarray(tables["kind_id"])[None, :]
        size = np.asarray(tables["size"])[None, :]
        coll_t = multidim_collective_time_vec(
            kind, size, tables["npus"], tables["bw"], tables["lat"],
            tables["topo"], tables["algo"], tables["chunks"][:, None],
            tables["blue"][:, None], scale=tables["scale"])
        xfer_t = tables["xfer_lat"][:, None] \
            + (size / tables["xfer_bw"][:, None]) * 1e-3
        class_t = np.where(np.asarray(tables["is_xfer"])[None, :],
                           xfer_t, coll_t)                 # (P, C)
        parts.append(class_t.T[np.asarray(plan.coll_class)]
                     * np.asarray(plan.coll_repeat)[:, None])  # (n_coll, P)
    if plan.delay_ops:
        parts.append(np.broadcast_to(
            np.asarray(tables["delay_us"])[:, None],
            (len(plan.delay_ops), P)))                     # (n_delay, P)
    src = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    dur_t = src[np.asarray(tables["src_of_op"])]           # (n_ops, P)
    return dur_t if op_major else dur_t.T


def plan_durations_batch(trace: Trace,
                         calls: Sequence[Any]) -> tuple[_SimPlan, np.ndarray]:
    """Batched ``plan_durations``: the plan plus a ``(P, n_ops)`` float64
    duration matrix, row ``k`` bit-identical to
    ``plan_durations(trace, calls[k].cfg, calls[k].par, calls[k].pools)``."""
    plan, tables = plan_duration_tables(trace, calls)
    return plan, batch_op_durations(plan, tables)


def build_sim_result(plan: _SimPlan, *, makespan: float,
                     busy: Sequence[float], dur: Sequence[float],
                     finish: dict[int, float],
                     record_per_op: bool = False) -> SimResult:
    """Assemble a ``SimResult`` from a backend's schedule: per-resource busy
    times, the makespan, and (opt-in) op finish times."""
    n_res = len(plan.res_names)
    pool_compute = {plan.res_pool[r]: busy[r]
                    for r in range(n_res) if plan.res_names[r] == "compute"}
    comm_busy: dict[str, float] = {}
    for r in range(n_res):
        name = plan.res_names[r]
        if name == "compute" or name.startswith("_delay"):
            continue  # delay timers are releases, not communication
        key = name if plan.res_pool[r] == 0 else f"{name}@p{plan.res_pool[r]}"
        comm_busy[key] = comm_busy.get(key, 0.0) + busy[r]
    if record_per_op:
        per_op = dict(enumerate(dur.tolist() if isinstance(dur, np.ndarray)
                                else dur))
    else:
        per_op = {}
    return SimResult(
        makespan_us=makespan,
        compute_busy_us=pool_compute.get(0, 0.0),
        comm_busy_us=comm_busy,
        # time covered by no compute stream; pools chain/overlap, so the
        # aggregate compute across pools is the honest subtrahend (for a
        # single pool this is exactly the old makespan - compute_busy)
        exposed_comm_us=max(0.0, makespan - sum(pool_compute.values())),
        per_op_us=per_op,
        pool_compute_us=pool_compute,
        op_finish_us=finish,
    )


def simulate(trace: Trace, cfg: SystemConfig, par: Parallelism, *,
             pools: dict[int, Parallelism | tuple[Parallelism, Network]] | None = None,
             record_per_op: bool = False,
             record_finish: bool = False,
             backend: "str | Any | None" = None,
             verify: bool = False,
             analyze: bool = False) -> SimResult:
    """Schedule ``trace`` on the device + network of ``cfg``.

    A thin delegate onto the selected simulation backend
    (``repro_torch.core.backends``); the default ``"reference"`` backend is the
    original discrete-event heapq loop, bit-identical to the pre-backend
    in-module implementation — no caller breaks.

    ``pools`` maps pool id -> that partition's Parallelism for multi-pool
    traces (see ``pool_group_dims`` for the accepted value shapes).
    ``record_per_op`` opts into materializing ``SimResult.per_op_us`` (plus
    ``op_finish_us``); ``record_finish`` materializes only
    ``SimResult.op_finish_us`` — the cheaper flag streaming scenarios use
    per design point to read wave TTFT/TPOT without allocating the per-op
    duration dict.  Both are off on the batched DSE hot path.

    ``verify=True`` statically checks the trace's scheduling plan first
    (dependency-DAG acyclicity, dangling dep/resource references, pool
    feasibility against ``cfg``/``pools``, repeat/delay sanity) and raises
    ``repro_torch.core.analysis.PlanVerificationError`` with a structured report
    instead of letting a defective trace deadlock the event loop mid-run.
    ``analyze=True`` additionally attaches critical-path bottleneck
    attribution (compute vs collective vs gate time on the longest
    dependency chain) as ``SimResult.analysis``."""
    from repro_torch.core.backends import get_backend

    if verify:
        from repro_torch.core.analysis import verify_trace
        verify_trace(trace, cfg, par, pools).raise_if_issues()
    res = get_backend(backend).simulate(trace, cfg, par, pools=pools,
                                        record_per_op=record_per_op,
                                        record_finish=record_finish)
    if analyze:
        from repro_torch.core.analysis import critical_path
        plan, dur = plan_durations(trace, cfg, par, pools)
        res.analysis = critical_path(plan, dur).summary(
            makespan_us=res.makespan_us)
    return res
