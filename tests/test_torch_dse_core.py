"""The port's own copy of the DSE core (``repro_torch.core``, ``repro_torch.dse``)
against the JAX package's (``repro.core``, ``repro.dse``), on the
``reference`` simulation backend in both: traces, the collective models,
every scenario family, the golden values, seeded sampling, whole searches
with each agent and the study CLI give equal results (``==``) unless a test
says otherwise."""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro.configs import ARCHS as J_ARCHS
from repro.core import cache as j_cache
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.core import cache as t_cache

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("repro", "repro_torch")
RTOL = 1e-9  # the scalar oracle vs the vectorized evaluator (as test_collectives_vec)


@pytest.fixture(autouse=True)
def cold_caches():
    """Each test starts, and leaves, both packages' DSE caches cold."""
    j_cache.clear_all_caches()
    t_cache.clear_all_caches()
    yield
    j_cache.clear_all_caches()
    t_cache.clear_all_caches()


def _pkg(name: str) -> SimpleNamespace:
    """One package's DSE modules, by their short names."""
    mods = ("collectives", "compute", "dse", "env", "fleet", "psa", "scenario",
            "simulator", "space", "study", "systems", "topology", "workload")
    ns = SimpleNamespace(**{m: importlib.import_module(f"{name}.core.{m}") for m in mods})
    ns.ARCHS = J_ARCHS if name == "repro" else T_ARCHS
    return ns


J, T = _pkg("repro"), _pkg("repro_torch")


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-12)


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gpt3-13b", "gpt3-175b"])
def test_generate_trace_gives_the_same_ops(arch):
    traces = [p.workload.generate_trace(p.ARCHS[arch], p.workload.Parallelism(1024, 64, 4, 1, True),
                                        batch=1024, seq=2048) for p in (J, T)]
    ops = [[dataclasses.astuple(op) for op in tr.ops] for tr in traces]
    assert len(ops[0]) > 100 and ops[0] == ops[1]


# ---------------------------------------------------------------------------
# the collective models: scalar oracle vs vectorized evaluator, in each
# package, and the two packages against each other
# (tests/test_collectives_vec.py:41-174)
# ---------------------------------------------------------------------------

def _single_dim_grid(p):
    c = p.collectives
    rng = np.random.default_rng(0)
    scalar, cols = [], [[] for _ in range(8)]
    for kind in c.COLL_KINDS:
        for algo in c.ALGOS:
            for topo in p.topology.TOPO_KINDS:
                for chunks in (1, 2, 7, 16):
                    for _ in range(3):
                        npus = int(rng.choice((2, 3, 4, 5, 7, 8, 16, 27, 64)))
                        b = float(rng.uniform(10.0, 900.0))
                        lat = float(rng.uniform(0.05, 2.0))
                        sz = float(rng.uniform(1.0, 1e9))
                        dim = p.topology.TopoDim(topo, npus, b, lat)
                        scalar.append(c.collective_time_us(kind, sz, dim, algo, chunks))
                        for col, v in zip(cols, (c.COLL_KIND_IDS[kind], sz, npus, b, lat,
                                                 c.TOPO_KIND_IDS[topo], c.ALGO_IDS[algo],
                                                 chunks)):
                            col.append(v)
    got = c.collective_time_vec(*(np.array(col) for col in cols))
    return np.array(scalar), got


@pytest.mark.parametrize("pkg", PACKAGES)
def test_collective_time_vec_full_grid_parity(pkg):
    scalar, got = _single_dim_grid(_pkg(pkg))
    assert got.shape == scalar.shape
    assert np.all(_rel(got, scalar) < RTOL)


def test_collective_models_equal_across_packages():
    j_scalar, j_got = _single_dim_grid(J)
    t_scalar, t_got = _single_dim_grid(T)
    assert np.array_equal(j_scalar, t_scalar) and np.array_equal(j_got, t_got)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_collective_time_vec_degenerate_entries_are_exact_zero(pkg):
    got = _pkg(pkg).collectives.collective_time_vec(
        np.array([0, 1, 2]), np.array([1e6, 0.0, 1e6]), np.array([1.0, 8.0, 1.0]),
        np.array([100.0] * 3), np.array([0.5] * 3), np.array([0, 1, 2]),
        np.array([0, 1, 2]), np.array([2, 2, 2]))
    assert np.array_equal(got, np.zeros(3))


def _pack_dims(p, carved, coll_algo):
    """One carved-dims row padded as ``_pack_class_tables`` pads it."""
    c = p.collectives
    D = max(len(carved), 1)
    npus, bw, lat = np.ones(D), np.ones(D), np.zeros(D)
    topo, algo = np.zeros(D, dtype=np.int32), np.zeros(D, dtype=np.int32)
    for j, (src, d) in enumerate(carved):
        npus[j], bw[j], lat[j] = d.npus, d.bw, d.latency_us
        topo[j] = c.TOPO_KIND_IDS[d.kind]
        algo[j] = c.ALGO_IDS[coll_algo[src]]
    return npus, bw, lat, topo, algo


def multidim_sweep(p):
    """200 random fabrics and carvings (partial dims and residual virtual
    dims), every kind, both modes: the scalar oracle's times, the packed
    tables and the vectorized evaluator's times."""
    c, tp = p.collectives, p.topology
    rng = np.random.default_rng(7)
    rows, scalars = [], []
    n_residual = n_partial = 0
    for _ in range(200):
        ndim = int(rng.integers(2, 5))
        kinds = [str(rng.choice(tp.TOPO_KINDS)) for _ in range(ndim)]
        npus = [int(rng.choice((2, 4, 8))) for _ in range(ndim)]
        bws = [float(rng.uniform(25.0, 900.0)) for _ in range(ndim)]
        lats = [float(rng.uniform(0.1, 1.5)) for _ in range(ndim)]
        net = tp.Network(tuple(tp.TopoDim(k, n, b, lat)
                               for k, n, b, lat in zip(kinds, npus, bws, lats)))
        coll_algo = tuple(str(rng.choice(c.ALGOS)) for _ in range(ndim))
        need = int(rng.choice((2, 3, 4, 6, 8, 12, 24, 48, 96)))
        carved = tp.carve_dims(net.dims, [d.npus for d in net.dims], need)
        if not carved:
            continue
        rem = need
        for i in range(ndim):
            if rem <= 1:
                break
            rem //= math.gcd(rem, npus[i])
        n_residual += rem > 1
        n_partial += any(d.npus < net.dims[src].npus for src, d in carved)
        kind = str(rng.choice(c.COLL_KINDS))
        chunks = int(rng.choice((1, 2, 4, 16)))
        mode = str(rng.choice(("baseline", "blueconnect")))
        size = float(rng.uniform(1e3, 1e9))
        sub = tp.Network(tuple(d for _, d in carved))
        algos = tuple(coll_algo[src] for src, _ in carved)
        scalars.append(c.multidim_collective_time_us(kind, size, sub, algos, chunks=chunks,
                                                     mode=mode))
        rows.append((_pack_dims(p, carved, coll_algo), kind, size, chunks, mode))
    D, P = max(len(r[0][0]) for r in rows), len(rows)
    tab = dict(npus=np.ones((P, D)), bw=np.ones((P, D)), lat=np.zeros((P, D)),
               topo=np.zeros((P, D), dtype=np.int32), algo=np.zeros((P, D), dtype=np.int32),
               kind=np.zeros(P, dtype=np.int32), size=np.zeros(P), chunks=np.zeros(P),
               blue=np.zeros(P, dtype=bool))
    for i, ((n_, b_, l_, t_, a_), kind, sz, ch, mode) in enumerate(rows):
        w = len(n_)
        tab["npus"][i, :w], tab["bw"][i, :w], tab["lat"][i, :w] = n_, b_, l_
        tab["topo"][i, :w], tab["algo"][i, :w] = t_, a_
        tab["kind"][i], tab["size"][i], tab["chunks"][i] = c.COLL_KIND_IDS[kind], sz, ch
        tab["blue"][i] = mode == "blueconnect"
    got = c.multidim_collective_time_vec(tab["kind"], tab["size"], tab["npus"], tab["bw"],
                                         tab["lat"], tab["topo"], tab["algo"], tab["chunks"],
                                         tab["blue"])
    return np.array(scalars), tab, got, (n_residual, n_partial)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_multidim_vec_parity_random_sweep(pkg):
    scalars, _, got, (n_residual, n_partial) = multidim_sweep(_pkg(pkg))
    assert len(scalars) >= 150 and n_residual >= 10 and n_partial >= 10
    assert np.all(_rel(got, scalars) < RTOL)


def test_multidim_models_equal_across_packages():
    j_scalars, _, j_got, _ = multidim_sweep(J)
    t_scalars, _, t_got, _ = multidim_sweep(T)
    assert np.array_equal(j_scalars, t_scalars) and np.array_equal(j_got, t_got)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_multidim_vec_residual_virtual_dim_and_single_dim(pkg):
    p = _pkg(pkg)
    c, tp = p.collectives, p.topology
    net = tp.Network((tp.TopoDim("ring", 4, 200.0, 0.5), tp.TopoDim("switch", 8, 50.0, 1.0)))
    carved = tp.carve_dims(net.dims, [4, 8], 96)  # 96 = 4*8*3 -> residual 3
    assert [d.npus for _, d in carved] == [4, 8, 3]
    assert carved[-1] == (1, tp.TopoDim("switch", 3, 50.0, 1.0))
    coll_algo = ("ring", "rhd")
    for kind in c.COLL_KINDS:
        for mode in ("baseline", "blueconnect"):
            sub = tp.Network(tuple(d for _, d in carved))
            algos = tuple(coll_algo[src] for src, _ in carved)
            want = c.multidim_collective_time_us(kind, 1e7, sub, algos, chunks=4, mode=mode)
            n_, b_, l_, t_, a_ = _pack_dims(p, carved, coll_algo)
            got = c.multidim_collective_time_vec(
                np.array([c.COLL_KIND_IDS[kind]]), np.array([1e7]), n_[None], b_[None],
                l_[None], t_[None], a_[None], np.array([4.0]), np.array([mode == "blueconnect"]))
            assert float(_rel(got[0], want)) < RTOL, (kind, mode)
            assert want > 0.0
    one = _pack_dims(p, carved[:1], coll_algo)
    pad = [np.concatenate([x, np.ones(2) if x.dtype == np.float64 and i < 2
                           else np.zeros(2, x.dtype)]) for i, x in enumerate(one)]
    got = c.multidim_collective_time_vec(
        np.array([c.COLL_KIND_IDS["all_gather"]]), np.array([1e7]), pad[0][None], pad[1][None],
        pad[2][None], pad[3][None].astype(np.int32), pad[4][None].astype(np.int32),
        np.array([4.0]), np.array([False]))
    want = c.collective_time_us("all_gather", 1e7, carved[0][1], "ring", 4)
    assert float(_rel(got[0], want)) < RTOL


# ---------------------------------------------------------------------------
# every scenario family through evaluate_config, both policies
# (tests/test_backends.py:200-230 and tests/test_fleet.py)
# ---------------------------------------------------------------------------

BASE_CFG = dict(dp=8, sp=1, pp=1, weight_sharded=0, sched_policy="fifo",
                coll_algo=("ring", "direct", "ring", "rhd"), chunks=2,
                multidim_coll="baseline", topology=("ring", "fc", "ring", "switch"),
                npus_per_dim=(4, 8, 4, 8), bw_per_dim=(400, 200, 150, 100))
FLEET_CFG = dict(BASE_CFG, prefill_frac=0.875, decode_batch=4, batch_window_ms=200.0,
                 max_inflight=2, router="round-robin", autoscale_target=0.0,
                 autoscale_cooldown_s=10.0)


def scenario_cases(p):
    """(name, env keywords, config) for each of the five families."""
    sc, fl = p.scenario, p.fleet
    stream = dict(prefill_frac=0.5, decode_batch=4, batch_window_ms=50.0, max_inflight=2)
    return [
        ("train", dict(batch=64), {}, "perf_per_bw"),
        ("disagg", dict(scenario=sc.DisaggServeScenario(64, 2048, 16)),
         dict(prefill_frac=0.5, decode_batch=4), "perf_per_bw"),
        ("request-stream", dict(scenario=sc.RequestStreamScenario(
            n_requests=24, seq=1024, decode_tokens=16, rate_rps=16.0, seed=3)),
         stream, "goodput"),
        ("multi-tenant", dict(scenario=sc.MultiTenantScenario(tenants=(
            sc.Tenant("a", p.ARCHS["gpt3-13b"], 512, 2048, "train", slo_ms=5e5),
            sc.Tenant("b", p.ARCHS["qwen2-1.5b"], 64, 2048, "serve", slo_ms=5e4)))),
         dict(tenant_npus=(512, 256)), "perf_per_bw"),
        ("fleet", dict(scenario=fl.FleetScenario(
            n_requests=16, seq=2048, decode_tokens=8, rate_rps=16.0, max_batch=8, seed=3,
            replicas=2, arrival="diurnal", period_s=10.0)),
         {k: v for k, v in FLEET_CFG.items() if k not in BASE_CFG}, "goodput_per_dollar"),
    ]


@pytest.mark.parametrize("policy", ["fifo", "lifo"])
def test_every_scenario_family_evaluates_equal(policy):
    for (name, kw, extra, obj), (_, t_kw, _, _) in zip(scenario_cases(J), scenario_cases(T)):
        cfg = dict(BASE_CFG, sched_policy=policy, **extra)
        want = J.systems.system_env("qwen2-1.5b", "system2", objective=obj,
                                    **kw).evaluate_config(cfg)
        got = T.systems.system_env("qwen2-1.5b", "system2", objective=obj,
                                   **t_kw).evaluate_config(cfg)
        assert want.valid, name
        assert (got.reward, got.latency_ms, got.valid) == \
            (want.reward, want.latency_ms, want.valid), name


@pytest.mark.parametrize("router", ["round-robin", "least-outstanding", "prefix-hash"])
def test_fleet_routers_and_autoscaler_evaluate_equal(router):
    evs = []
    for p in (J, T):
        sc = p.fleet.FleetScenario(n_requests=32, seq=2048, decode_tokens=8, rate_rps=32.0,
                                   max_batch=8, seed=3, replicas=2, arrival="bursty",
                                   epoch_s=1.0, autoscale_targets=(0.0, 0.8),
                                   n_sessions=4, prefix_hit_frac=0.9)
        env = p.env.CosmicEnv(spec=p.ARCHS["gpt3-13b"], n_npus=1024,
                              device=p.compute.SYSTEM_2_DEVICE, scenario=sc,
                              objective="goodput_per_dollar")
        evs.append([env.evaluate_config(dict(FLEET_CFG, router=router, autoscale_target=t,
                                             autoscale_cooldown_s=1.0))
                    for t in (0.0, 0.8)])
    assert [(e.reward, e.latency_ms, e.valid) for e in evs[0]] == \
        [(e.reward, e.latency_ms, e.valid) for e in evs[1]]
    assert any(e.valid for e in evs[0])


# ---------------------------------------------------------------------------
# the pre-refactor golden values hold for the copy
# (tests/test_backends.py:87-132)
# ---------------------------------------------------------------------------

def _sys(policy: str = "fifo"):
    return T.simulator.SystemConfig(network=T.topology.system_2(),
                                    device=T.compute.SYSTEM_2_DEVICE,
                                    coll_algo=("ring", "direct", "ring", "rhd"),
                                    chunks=2, sched_policy=policy)


def test_reference_backend_matches_pre_refactor_golden_values():
    Par = T.workload.Parallelism
    cases = [
        ("gpt3-13b", Par(1024, 64, 4, 1, True), 1024, "train",
         16271035.786701888, 16185591.472128013, 85444.3145738747),
        ("gpt3-175b", Par(1024, 32, 8, 1, True), 1024, "train",
         217819100.03438663, 216970720.1298433, 848379.9045433402),
        ("gpt3-13b", Par(1024, 64, 4, 1), 64, "decode",
         137863.06259999986, 137621.4177999999, 241.64479999995092),
        ("gpt3-175b", Par(1024, 64, 1, 1, True), 1024, "train",
         218434834.8352596, None, 1452035.1098963022),
    ]
    for arch, par, batch, mode, makespan, compute, exposed in cases:
        tr = T.workload.generate_trace(T.ARCHS[arch], par, batch=batch, seq=2048, mode=mode)
        for policy in ("fifo", "lifo"):
            res = T.simulator.simulate(tr, _sys(policy), par)
            assert res.makespan_us == makespan, (arch, mode, policy)
            assert res.exposed_comm_us == exposed, (arch, mode, policy)
            if compute is not None:
                assert res.compute_busy_us == compute, (arch, mode, policy)


def test_scenario_golden_values_via_reference_backend():
    disagg = T.systems.system_env("qwen2-1.5b", "system2",
                                  scenario=T.scenario.DisaggServeScenario(64, 2048, 16),
                                  objective="latency")
    ev = disagg.evaluate_config(dict(BASE_CFG, prefill_frac=0.5, decode_batch=4))
    assert ev.latency_ms == 235.54705323946763
    assert ev.reward == 0.004245436256777772
    stream = T.systems.system_env(
        "qwen2-1.5b", "system2",
        scenario=T.scenario.RequestStreamScenario(n_requests=32, seq=1024, decode_tokens=16,
                                                  rate_rps=16.0, seed=3),
        objective="goodput")
    ev = stream.evaluate_config(dict(BASE_CFG, prefill_frac=0.5, decode_batch=4,
                                     batch_window_ms=50.0, max_inflight=2))
    assert ev.latency_ms == 74.93265646512177
    assert ev.reward == 18.606955522152628


# ---------------------------------------------------------------------------
# seeded sampling, whole searches, the study CLI
# ---------------------------------------------------------------------------

def test_seeded_design_space_samples_the_same_configs():
    samples = []
    for p in (J, T):
        space = p.space.DesignSpace(p.psa.paper_psa(1024, max_pp=4))
        rng = np.random.default_rng(11)
        samples.append([space.sample(rng) for _ in range(64)])
    assert samples[0] == samples[1]


@pytest.mark.parametrize("agent", ["rw", "ga", "aco", "bo", "surrogate"])
def test_run_search_gives_the_same_curve_in_both_packages(agent):
    """The slice as a whole: agent -> space -> env.step_batch -> scenario ->
    simulator, 48 steps in batches of 8 on gpt3-13b/system2."""
    res = [p.dse.run_search(p.systems.system_pset("system2"),
                            p.systems.system_env("gpt3-13b", "system2"), agent,
                            steps=48, seed=0, batch_size=8) for p in (J, T)]
    assert res[0].reward_curve == res[1].reward_curve
    assert len(res[1].reward_curve) == 48
    assert res[0].best_config == res[1].best_config
    assert (res[0].best_reward, res[0].best_latency_ms, res[0].steps_to_peak) == \
        (res[1].best_reward, res[1].best_latency_ms, res[1].steps_to_peak)


WALL_CLOCK = {"wall_s", "points_per_s", "finished_unix", "created_unix"}


def _records(path: Path) -> list[dict]:
    """The results file's records without their wall-clock fields and the
    provenance of the checkout (both packages run from the same one)."""
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        rec = {k: v for k, v in rec.items() if k not in WALL_CLOCK | {"git"}}
        if isinstance(rec.get("result"), dict):
            rec["result"] = {k: v for k, v in rec["result"].items() if k not in WALL_CLOCK}
        out.append(rec)
    return out


@pytest.mark.parametrize("study", ["smoke.json", "fleet_smoke.json"])
def test_study_cli_writes_the_same_cell_records(study, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    recs = []
    for pkg in PACKAGES:
        out = tmp_path / f"{pkg}.jsonl"
        r = subprocess.run([sys.executable, "-m", f"{pkg}.dse", "run",
                            str(ROOT / "examples" / "studies" / study), "--out", str(out),
                            "--backend", "reference", "--quiet"],
                           capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
        assert r.returncode == 0, r.stderr
        assert "campaign done: cells_run=2" in r.stdout
        recs.append(_records(out))
    assert [r["record"] for r in recs[1]] == ["study", "cell", "cell"]
    assert recs[0] == recs[1]


def test_cli_commands_exist():
    from repro_torch.dse import main

    for argv in (["list-scenarios"], ["list-systems"], ["list-objectives"],
                 ["list-backends"]):
        assert main(argv) == 0
    with pytest.raises(SystemExit):
        main(["run", "--help"])
    for cmd in ("lint", "analyze", "compare", "store"):
        with pytest.raises(SystemExit) as e:
            main([cmd, "--help"])
        assert e.value.code == 0


def test_cli_lint_and_analyze_agree_with_the_jax_package(tmp_path, capsys):
    from repro.dse import main as j_main
    from repro_torch.dse import main as t_main

    spec = str(ROOT / "examples" / "studies" / "smoke.json")
    outs = []
    for main, name in ((j_main, "repro"), (t_main, "repro_torch")):
        assert main(["lint", spec]) == 0
        (tmp_path / name).mkdir()
        res = tmp_path / name / "results.jsonl"
        assert main(["run", spec, "--out", str(res), "--quiet"]) == 0
        capsys.readouterr()
        assert main(["analyze", str(res)]) == 0
        assert main(["compare", str(res), str(res)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1].replace(str(tmp_path / "repro_torch"), str(tmp_path / "repro"))
