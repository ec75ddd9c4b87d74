#!/usr/bin/env python3
"""Time the DSE sweep kernel on every scenario family's traces on one NVIDIA GPU.

    python3 chip_dse_traces.py

For each scenario family the port's DSE tests run (tests/
test_torch_dse_backend.py ``_scenarios``: train, disagg, request stream,
multi-tenant, fleet; qwen2-1.5b on system2), and for the backend
benchmark's request stream (chip_smoke.py ``dse_env``), it draws POINTS
seeded design points that share the trace-shaping knobs; for the
paper's design space (gpt3-13b on system2, ``paper_psa(1024, max_pp=4)``)
it samples SPACE_POINTS points, each its own trace.  It groups the
simulation calls by trace as ``CosmicEnv.step_batch`` does, and for each
trace runs ``dse_sweep`` as the ``torch`` backend calls it (the gather,
then the sweep).  Per trace it prints one JSON line: ops, parents a row (W), the farthest parent, the
share of parent reads one or two ops back, the share of 256-op tiles (and
of ops) that csrc/dse_sim.cu's ``tile_is_near`` sends to the branch-free
walk (W <= 4, every parent within 256 ops), the sweep's CUDA-events ms and
torch.profiler device ms by kernel, and whether the finish times equal the
plain twin's bit for bit.

It uses only what every checkout since the DSE port carries
(``repro_torch.core``, ``TorchBackend``, ``kernels.dse_sim``), so a copy of
it placed in an older checkout times that checkout's kernel on the same
traces.  Needs CUDA; imports no JAX.
"""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NEAR_TILE, NEAR_RING, NEAR_COLS = 256, 256, 4  # kTile, kRing, kRegCols of the redesigned sweep
POINTS = 32  # design points a family's population
ITERS, TRACE_TRIES = 10, 3  # calls timed; profiler traces taken before device ms counts as lost
SPACE_POINTS, SPACE_SEED = 12, 7  # the paper's design space: points drawn, and their seed


def families(sc, fleet, archs):
    """(name, scenario or None for training at batch 64, objective, the
    knobs every member shares)."""
    stream = dict(prefill_frac=0.5, decode_batch=4, batch_window_ms=50.0, max_inflight=2)
    return [
        ("train", None, "perf_per_bw", {}),
        ("disagg", sc.DisaggServeScenario(64, 2048, 16), "perf_per_bw",
         dict(prefill_frac=0.5, decode_batch=4)),
        ("stream", sc.RequestStreamScenario(n_requests=24, seq=1024, decode_tokens=16,
                                            rate_rps=16.0, seed=3), "goodput", stream),
        ("tenants", sc.MultiTenantScenario(tenants=(
            sc.Tenant("a", archs["gpt3-13b"], 512, 2048, "train", slo_ms=5e5),
            sc.Tenant("b", archs["qwen2-1.5b"], 64, 2048, "serve", slo_ms=5e4))),
         "perf_per_bw", dict(tenant_npus=(512, 256))),
        ("fleet", fleet.FleetScenario(
            n_requests=16, seq=2048, decode_tokens=8, rate_rps=16.0, max_batch=8, seed=3,
            replicas=2, arrival="diurnal", period_s=10.0), "goodput_per_dollar",
         dict(prefill_frac=0.875, decode_batch=4, batch_window_ms=200.0, max_inflight=2,
              router="round-robin", autoscale_target=0.0, autoscale_cooldown_s=10.0)),
        ("bench-stream", sc.RequestStreamScenario(n_requests=256, seq=2048, decode_tokens=64,
                                                  rate_rps=32.0, seed=0), "goodput",
         dict(stream, decode_batch=8)),
    ]


def population(np, shared: dict, points: int, seed: int) -> list[dict]:
    """Design points differing in every knob that prices a duration, the
    trace-shaping ones pinned (tests/test_torch_cuda.py ``_dse_population``)."""
    rng = np.random.default_rng(seed)
    algos = ("ring", "direct", "rhd", "dbt")
    base = dict(dp=8, sp=1, pp=1, weight_sharded=0, topology=("ring", "fc", "ring", "switch"),
                npus_per_dim=(4, 8, 4, 8))
    return [dict(base, **shared, coll_algo=tuple(rng.choice(algos) for _ in range(4)),
                 chunks=int(rng.choice((1, 2, 4, 8, 16))),
                 sched_policy=str(rng.choice(("fifo", "lifo"))),
                 multidim_coll=str(rng.choice(("baseline", "blueconnect"))),
                 bw_per_dim=tuple(int(b) for b in rng.choice(range(50, 501, 50), size=4)))
            for _ in range(points)]


def shape_stats(np, parents) -> dict:
    """How far back a parents table (n_ops, W) reaches, and which of its
    tiles the redesigned sweep walks without branches."""
    n_ops, W = parents.shape
    i = np.arange(n_ops)[:, None]
    real = (parents >= 0) & (parents < i)
    back = np.where(real, i - parents, 0)
    tiles = [back[t:t + NEAR_TILE] for t in range(0, n_ops, NEAR_TILE)]
    near = [W <= NEAR_COLS and int(b.max(initial=0)) <= NEAR_RING for b in tiles]
    return dict(n_ops=n_ops, W=W, real_reads=int(real.sum()), farthest=int(back.max(initial=0)),
                within_2=float((real & (back <= 2)).sum() / max(int(real.sum()), 1)),
                tiles=len(tiles), near_tiles=sum(near),
                near_op_share=sum(len(b) for b, ok in zip(tiles, near) if ok) / n_ops)


def timed(torch, fn) -> tuple[float, dict]:
    """CUDA-events ms a call (after warm-up) and torch.profiler device ms a
    call by kernel (the identifier after ``dse_``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    dev: dict[str, float] = {}
    for _ in range(TRACE_TRIES):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and e.device_time_total:
                m = re.search(r"dse_\w*", e.name)
                key = m.group(0) if m else e.name
                dev[key] = dev.get(key, 0.0) + e.device_time_total / 1e3 / ITERS
        if dev:
            break
    return start.elapsed_time(end) / ITERS, dev


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_dse_traces: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ARCHS
    from repro_torch.core import fleet, scenario
    from repro_torch.core.backends.torch_backend import TorchBackend
    from repro_torch.core.psa import paper_psa
    from repro_torch.core.simulator import plan_duration_tables
    from repro_torch.core.space import DesignSpace
    from repro_torch.core.systems import system_env
    from repro_torch.kernels import dse_sim
    be = TorchBackend(device="cuda")
    rows = []

    def run(name, env, cfgs):
        groups: dict[int, list] = {}
        for cfg in cfgs:
            for c in getattr(env.scenario.sim_job(env.context(cfg)), "calls", ()):  # valid only
                groups.setdefault(id(c.trace), []).append(c)
        for g, group in enumerate(groups.values()):
            tr = group[0].trace
            plan, tables = plan_duration_tables(tr, group)
            st, tab = be._static(tr, plan), be._class_tables(tables)
            class_t = dse_sim.dse_class_times(st["kind"], st["size"], st["is_xfer"], *[
                tab[k] for k in ("npus", "bw", "lat", "scale", "topo", "algo", "chunks", "blue",
                                 "xfer_bw", "xfer_lat")])

            def sweep():
                return dse_sim.dse_sweep(st["parents"], sources=st["sources"], class_t=class_t,
                                         peak=tab["peak"], membw=tab["membw"])
            dur, finish = sweep()
            exact = torch.equal(finish, dse_sim.sweep_plain(st["parents"], dur))
            ms, dev = timed(torch, sweep)
            row = dict(family=name, trace=g, P=len(group),
                       **shape_stats(np, st["parents"].cpu().numpy()), ms=ms,
                       device_ms=sum(dev.values()) or None, device_ms_by_kernel=dev,
                       bit_identical=bool(exact))
            print(json.dumps(row), flush=True)
            rows.append(row)

    for k, (name, sc, obj, shared) in enumerate(families(scenario, fleet, ARCHS)):
        kw = dict(scenario=sc) if sc is not None else dict(batch=64)
        run(name, system_env("qwen2-1.5b", "system2", objective=obj, backend="torch", **kw),
            population(np, shared, POINTS, k))
    space, rng = DesignSpace(paper_psa(1024, max_pp=4)), np.random.default_rng(SPACE_SEED)
    run("space", system_env("gpt3-13b", "system2", backend="torch"),
        [space.sample(rng) for _ in range(SPACE_POINTS)])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "traces": rows}))
    return 0 if all(r["bit_identical"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
