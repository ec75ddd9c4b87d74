"""TorchBackend: the levelized sweep over the dependency DAG, fused with the
batched duration pass, on the card's ``dse_sim`` CUDA kernels.

The counterpart of the JAX package's ``jax`` backend: the same lowering,
with hand-written kernels where that backend has XLA.  The reference event
loop is inherently sequential per design point.  This backend lowers the
shared ``_SimPlan`` into a fixed-structure longest-path sweep evaluated for
a whole agent population in one call.

The lowering: under an issue-order schedule, each resource runs its ops in
uid order (a topological order by the ``TraceBuilder``/
``compose_request_waves`` contract), so ``free[resource]`` at op *i* is
exactly the finish time of the previous op on *i*'s resource.  That turns
the whole schedule into a max-plus longest-path recurrence over the DAG
augmented with per-resource chain edges::

    finish[i] = dur[i] + max(finish[j] for j in deps[i] + {prev_on_res[i]})

The augmented-parent table is static per trace (built once, piggybacked on
the plan, and kept on the device in ``plan.pack_memo``).  The per-design-
point durations are the ONLY population-varying input, and they come in two
flavours:

  * FUSED (default, registered as ``torch``):
    ``simulator.plan_duration_tables`` packs the whole population's
    collective dim tables + roofline coefficients host-side (memoized per
    design-point key); ``dse_class_times`` prices every duration class x
    population member on the card and ``dse_sweep`` gathers the per-op
    durations and runs the sweep — two launches, no host round-trip between
    pricing and scheduling.
  * UNFUSED (``TorchBackend(fused=False)``, registered as ``torch-unfused``):
    the scalar per-call duration pass (``simulator.plan_durations``) feeding
    ``dse_sweep`` — the pre-fusion baseline, kept as the measurable
    baseline for the duration-pass-vs-sweep time split.

``last_timings`` records the split after every ``simulate_batch``:
``durations_s`` (host-side duration pass: the scalar loop when unfused, the
memoized table packing when fused) and ``sweep_s`` (the device evaluation —
pricing + sweep together when fused — with the uploads and the copies of
durations and finish times back to the host).

Device: the card unless ``device`` asks for another (``resolve_device``);
without CUDA the default raises.  On the CPU the kernels' plain twins run
(``repro_torch.kernels.dse_sim``); a CUDA call never falls back to them.

Fidelity: each resource serializes its ops in issue order instead of the
reference loop's arrival-order (FIFO) / freshest-first (LIFO) queue
discipline, so makespans can deviate where a resource's queue reorders —
parity tests pin the tolerance (exact on every trace family shipped:
per-resource ready order follows issue order there).  Use the reference
backend when bit-exact schedules matter; use this one to sweep large
populations over large traces.
"""
from __future__ import annotations

import time
from collections.abc import Mapping
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.simulator import (SimResult, SystemConfig, _SimPlan,
                                        _class_static, build_sim_result,
                                        plan_duration_tables, plan_durations)
from repro_torch.core.workload import Parallelism, Trace
from repro_torch.kernels import dse_sim


def _plan_parents(trace: Trace, plan: _SimPlan) -> np.ndarray:
    """The plan's augmented-parent table, built once and piggybacked on the
    plan (plans are piggybacked on cached immutable traces)."""
    cached = getattr(plan, "_torch_parents", None)
    if cached is not None:
        return cached
    n = plan.n_ops
    last_on_res: dict[int, int] = {}
    rows: list[list[int]] = []
    for op in trace.ops:
        if any(d >= op.uid for d in op.deps):
            # the sweep reads parents' finish times in uid order; a forward
            # dep would silently read 0 where the reference loop deadlocks
            raise ValueError(f"op {op.uid} depends on a later op — the torch "
                             f"backend needs topologically-ordered uids "
                             f"(TraceBuilder/compose_request_waves traces)")
        r = plan.res_of[op.uid]
        row = list(op.deps)
        prev = last_on_res.get(r)
        if prev is not None:
            row.append(prev)
        last_on_res[r] = op.uid
        rows.append(row)
    width = max((len(row) for row in rows), default=0)
    parents = np.full((n, max(width, 1)), n, dtype=np.int32)
    for i, row in enumerate(rows):
        parents[i, :len(row)] = row
    plan._torch_parents = parents
    return parents


class FinishTimes(Mapping):
    """``SimResult.op_finish_us`` backed by the sweep's finish row — dict
    semantics (uid -> finish time) without materializing tens of thousands
    of boxed floats per design point; scenarios only read the wave-mark
    uids off it."""

    __slots__ = ("_row",)

    def __init__(self, row: np.ndarray) -> None:
        self._row = row

    def __getitem__(self, uid: int) -> float:
        # dict semantics, not array semantics: unknown uids must raise
        # KeyError (so `in`/`.get()` work) and never wrap negatively
        if not 0 <= uid < len(self._row):
            raise KeyError(uid)
        return float(self._row[uid])

    def __len__(self) -> int:
        return len(self._row)

    def __iter__(self):
        return iter(range(len(self._row)))


# the packed tables' float64 and integer columns, in the order they are
# uploaded as one buffer each (see ``TorchBackend._class_tables``)
_F64_COLS = ("npus", "bw", "lat", "scale", "peak", "membw", "chunks",
             "xfer_bw", "xfer_lat")
_I32_COLS = ("topo", "algo")


class TorchBackend:
    """Population-vectorized scheduling on the ``dse_sim`` CUDA kernels.

    ``fused=True`` (the default, registered as ``torch``) prices durations
    on the card beside the sweep; ``fused=False`` (registered as
    ``torch-unfused``) keeps the scalar per-call duration pass feeding the
    sweep kernel — the measurable pre-fusion baseline."""

    vectorized = True

    def __init__(self, fused: bool = True,
                 device: "str | torch.device | None" = None) -> None:
        self.fused = fused
        self.name = "torch" if fused else "torch-unfused"
        self.device = resolve_device(device)
        # duration-pass vs device-evaluation wall-time split of the most
        # recent simulate_batch (see module docstring)
        self.last_timings: dict[str, float] = {}

    def simulate(self, trace: Trace, cfg: SystemConfig, par: Parallelism, *,
                 pools: dict[int, Any] | None = None,
                 record_per_op: bool = False,
                 record_finish: bool = False) -> SimResult:
        from repro_torch.core.backends.base import SimCall

        return self.simulate_batch(
            trace, [SimCall(trace, cfg, par, pools=pools,
                            record_per_op=record_per_op,
                            record_finish=record_finish)])[0]

    def _static(self, trace: Trace, plan: _SimPlan) -> dict[str, Any]:
        """The plan's design-point-independent tensors on this backend's
        device, uploaded once: the parent table (and, on the CPU, its
        dependency levels), the duration sources and the class statics.
        The parent table is the same every batch, and re-uploading it
        would cost more than the entire class-table pack."""
        key = ("_torch_static", str(self.device))
        st = plan.pack_memo.get(key)
        if st is None:
            cs = _class_static(plan)
            dev = self.device

            def put(a, dtype):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                       device=dev)
            parents = put(_plan_parents(trace, plan), torch.int32)
            st = {
                "parents": parents,
                "levels": (dse_sim.sweep_levels(parents)
                           if dev.type == "cpu" else None),
                "sources": dse_sim.Sources(
                    put(cs["src_of_op"], torch.int32),
                    put(plan.comp_flops, torch.float64),
                    put(plan.comp_bytes, torch.float64),
                    put(plan.coll_class, torch.int32),
                    put(plan.coll_repeat, torch.float64),
                    put(cs["delay_us"], torch.float64)),
                "kind": put(cs["kind_id"], torch.int32),
                "size": put(cs["size"], torch.float64),
                "is_xfer": put(cs["is_xfer"], torch.bool),
            }
            plan.pack_memo[key] = st
        return st

    def _class_tables(self, tables: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """The population's packed tables on the device: the float64 and
        the int32 columns in one upload each, the bool masks in a third,
        each column a view of its buffer."""
        f64 = np.concatenate([tables[k].ravel() for k in _F64_COLS])
        i32 = np.concatenate([tables[k].ravel() for k in _I32_COLS])
        dev = self.device
        bufs = (torch.from_numpy(f64).to(dev), torch.from_numpy(i32).to(dev),
                torch.from_numpy(tables["blue"]).to(dev))
        out: dict[str, torch.Tensor] = {"blue": bufs[2]}
        for cols, buf in ((_F64_COLS, bufs[0]), (_I32_COLS, bufs[1])):
            at = 0
            for k in cols:
                shape = tables[k].shape
                size = int(np.prod(shape))
                out[k] = buf[at:at + size].view(shape)
                at += size
        return out

    def simulate_batch(self, trace: Trace,
                       calls: Sequence[Any]) -> list[SimResult]:
        if not calls:
            return []
        t0 = time.perf_counter()
        if self.fused:
            plan, tables = plan_duration_tables(trace, calls)
            st = self._static(trace, plan)
            t1 = time.perf_counter()
            tab = self._class_tables(tables)
            class_t = dse_sim.dse_class_times(
                st["kind"], st["size"], st["is_xfer"], tab["npus"],
                tab["bw"], tab["lat"], tab["scale"], tab["topo"],
                tab["algo"], tab["chunks"], tab["blue"], tab["xfer_bw"],
                tab["xfer_lat"])
            dur_d, finish_d = dse_sim.dse_sweep(
                st["parents"], sources=st["sources"], class_t=class_t,
                peak=tab["peak"], membw=tab["membw"], levels=st["levels"])
            dur = dur_d.cpu().numpy().T    # (P, n_ops) view, op-major data
            finish = finish_d[:plan.n_ops].cpu().numpy().T
        else:
            plans_durs = [plan_durations(trace, c.cfg, c.par, c.pools)
                          for c in calls]
            plan = plans_durs[0][0]
            st = self._static(trace, plan)
            dur = np.asarray([d for _, d in plans_durs], dtype=np.float64)
            t1 = time.perf_counter()
            dur_d = torch.from_numpy(np.ascontiguousarray(dur.T)).to(
                self.device)
            _, finish_d = dse_sim.dse_sweep(st["parents"], dur=dur_d,
                                            levels=st["levels"])
            finish = finish_d[:plan.n_ops].cpu().numpy().T
        t2 = time.perf_counter()
        self.last_timings = {"durations_s": t1 - t0, "sweep_s": t2 - t1}
        makespan = finish.max(axis=1) if plan.n_ops else np.zeros(len(calls))
        res_of = np.asarray(plan.res_of, dtype=np.intp)
        n_res = len(plan.res_names)
        # whole-population busy accounting in one 2D scatter over
        # (population, resource).  Either broadcast orientation accumulates
        # each (member, resource) cell in increasing-uid order — the same
        # order as the per-call np.bincount it replaces — so every row is
        # bit-identical; iterate the orientation matching the duration
        # matrix's memory layout (op-major from the fused kernel)
        busy2d = np.zeros((len(calls), n_res), dtype=np.float64)
        if self.fused:
            np.add.at(busy2d.T,
                      (res_of[:, None],
                       np.arange(len(calls))[None, :]), dur.T)
        else:
            np.add.at(busy2d,
                      (np.arange(len(calls))[:, None], res_of[None, :]), dur)
        out: list[SimResult] = []
        for k, call in enumerate(calls):
            fin: Mapping = {}
            if call.record_per_op or call.record_finish:
                fin = FinishTimes(finish[k])
            out.append(build_sim_result(
                plan, makespan=float(makespan[k]), busy=busy2d[k].tolist(),
                dur=dur[k], finish=fin,
                record_per_op=call.record_per_op))
        return out
