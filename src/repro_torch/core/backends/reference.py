"""ReferenceBackend: the original discrete-event heapq scheduler.

This IS the pre-backend ``core.simulator.simulate`` event loop, moved here
verbatim — bit-identical results are pinned by golden tests.  Ready ops
queue on their resource; the queue discipline is the paper's Collective
'Scheduling Policy' knob (LIFO favours the freshest — critical-path —
collectives, FIFO drains in issue order).  Compute/comm overlap falls out
of the event loop, so exposed communication is measured, not assumed.

``simulate_batch`` is the honest loop over ``simulate`` — the reference
backend is the semantics oracle, not the fast path; vectorized backends
(``torch_backend``) exploit the shared-plan seam instead.
"""
from __future__ import annotations

import heapq
from typing import Any, Sequence

from repro_torch.core.simulator import (SimResult, SystemConfig, build_sim_result,
                                  plan_durations)
from repro_torch.core.workload import Parallelism, Trace


class ReferenceBackend:
    """The heapq discrete-event loop (the engine's original scheduler)."""

    name = "reference"
    vectorized = False

    def simulate(self, trace: Trace, cfg: SystemConfig, par: Parallelism, *,
                 pools: dict[int, Any] | None = None,
                 record_per_op: bool = False,
                 record_finish: bool = False) -> SimResult:
        plan, dur_arr = plan_durations(trace, cfg, par, pools)
        dur = dur_arr.tolist()  # python floats: fastest for the event loop

        n_res = len(plan.res_names)
        ndeps = list(plan.ndeps0)
        children = plan.children
        res_of = plan.res_of
        queues: list[list[tuple[int, int]]] = [[] for _ in range(n_res)]
        free_at = [0.0] * n_res
        busy = [0.0] * n_res
        sign = -1 if cfg.sched_policy == "lifo" else 1
        seq = 0  # enqueue order tiebreaker
        hpush, hpop = heapq.heappush, heapq.heappop

        events: list[tuple[float, int, int]] = []  # (time, eseq, uid)
        eseq = 0
        n_finished = 0
        finish: dict[int, float] = {}
        track_finish = record_per_op or record_finish

        for uid in plan.roots:
            seq += 1
            hpush(queues[res_of[uid]], (sign * seq, uid))
        for r in range(n_res):
            if queues[r]:
                _, uid = hpop(queues[r])
                d = dur[uid]
                free_at[r] = d
                busy[r] += d
                eseq += 1
                hpush(events, (d, eseq, uid))

        makespan = 0.0
        while events:
            now, _, uid = hpop(events)
            n_finished += 1
            if track_finish:
                finish[uid] = now
            if now > makespan:
                makespan = now
            # only the freed resource and resources receiving new work can
            # start an op here: any other free resource with queued work
            # would already have been started when it last freed (the
            # loop's invariant)
            cand = [res_of[uid]]
            for ch in children[uid]:
                ndeps[ch] -= 1
                if ndeps[ch] == 0:
                    seq += 1
                    r = res_of[ch]
                    hpush(queues[r], (sign * seq, ch))
                    if r not in cand:
                        cand.append(r)
            for r in cand:
                if free_at[r] <= now and queues[r]:
                    _, nxt = hpop(queues[r])
                    d = dur[nxt]
                    free_at[r] = now + d
                    busy[r] += d
                    eseq += 1
                    hpush(events, (now + d, eseq, nxt))

        if n_finished != plan.n_ops:
            raise RuntimeError(
                f"deadlock: {n_finished}/{plan.n_ops} ops finished")

        return build_sim_result(plan, makespan=makespan, busy=busy, dur=dur,
                                finish=finish, record_per_op=record_per_op)

    def simulate_batch(self, trace: Trace,
                       calls: Sequence[Any]) -> list[SimResult]:
        return [self.simulate(trace, c.cfg, c.par, pools=c.pools,
                              record_per_op=c.record_per_op,
                              record_finish=c.record_finish)
                for c in calls]
