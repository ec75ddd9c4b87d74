"""The ``torch`` simulation backend of the port (``repro_torch.core.backends
.torch_backend``) on the CPU, asked for explicitly, where it runs the plain
twins of the ``dse_sim`` kernels.  The expected side comes from the JAX
package (``repro.core``) on the same traces: its ``reference`` backend at
RTOL 1e-9 (its ``jax`` backend cannot run on a host whose jax lacks
``enable_x64``, so the oracle is the event loop), and its numpy
``plan_durations_batch`` and ``_plan_parents`` bit for bit.  Also the
registry, and the card as the default device: without CUDA the backend and
the CLI raise."""
from __future__ import annotations

import dataclasses
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.core import cache as j_cache
from repro_torch.configs import ARCHS
from repro_torch.core import cache
from repro_torch.core.backends import (SimCall, backend_available, get_backend,
                                       list_backends)
from repro_torch.core.backends.torch_backend import FinishTimes, _plan_parents
from repro_torch.core.compute import SYSTEM_2_DEVICE
from repro_torch.core.env import CosmicEnv
from repro_torch.core.psa import paper_psa
from repro_torch.core.scenario import RequestStreamScenario
from repro_torch.core.simulator import SystemConfig, _sim_plan, plan_duration_tables
from repro_torch.core.space import DesignSpace
from repro_torch.core.study import StudySpec, run_study
from repro_torch.core.systems import system_env
from repro_torch.core.topology import system_2
from repro_torch.core.workload import Op, Parallelism, Trace, generate_trace
from repro_torch.kernels import dse_sim

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-9  # the issue-order sweep vs the event loop (tests/test_backends.py:182)
CPU = "cpu"


def _pkg(name: str) -> SimpleNamespace:
    """One package's DSE modules, by their short names."""
    mods = ("backends", "collectives", "compute", "fleet", "scenario", "simulator", "study",
            "systems", "topology", "workload")
    ns = SimpleNamespace(**{m: importlib.import_module(f"{name}.core.{m}") for m in mods})
    ns.ARCHS = J_ARCHS if name == "repro" else ARCHS
    return ns


J, T = _pkg("repro"), _pkg("repro_torch")  # J: the expected side


@pytest.fixture(autouse=True)
def cold_caches():
    """Each test starts, and leaves, both packages' DSE caches cold."""
    j_cache.clear_all_caches()
    cache.clear_all_caches()
    yield
    j_cache.clear_all_caches()
    cache.clear_all_caches()


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _sys(policy: str = "fifo", p: SimpleNamespace = T):
    return p.simulator.SystemConfig(network=p.topology.system_2(),
                                    device=p.compute.SYSTEM_2_DEVICE,
                                    coll_algo=("ring", "direct", "ring", "rhd"), chunks=2,
                                    sched_policy=policy)


BASE_CFG = dict(dp=8, sp=1, pp=1, weight_sharded=0, sched_policy="fifo",
                coll_algo=("ring", "direct", "ring", "rhd"), chunks=2,
                multidim_coll="baseline", topology=("ring", "fc", "ring", "switch"),
                npus_per_dim=(4, 8, 4, 8), bw_per_dim=(400, 200, 150, 100))
STREAM_CFG = dict(BASE_CFG, prefill_frac=0.5, decode_batch=4, batch_window_ms=50.0,
                  max_inflight=2)


def _tb(fused: bool = True):
    return get_backend("torch" if fused else "torch-unfused", device=CPU)


# ---------------------------------------------------------------------------
# registry and device
# ---------------------------------------------------------------------------

def test_registry_lists_reference_torch_and_torch_unfused():
    assert set(list_backends()) == {"reference", "torch", "torch-unfused"}
    tb, ub = _tb(True), _tb(False)
    assert tb.fused and tb.name == "torch" and tb.device == torch.device(CPU)
    assert not ub.fused and ub.name == "torch-unfused"
    assert tb is _tb(True) and tb is not ub
    assert get_backend("reference", device=CPU).name == "reference"
    for name in ("jax", "jax-unfused"):
        with pytest.raises(ValueError, match="unknown simulation backend"):
            get_backend(name)
        with pytest.raises(ValueError, match="unknown simulation backend"):
            CosmicEnv(spec=ARCHS["qwen2-1.5b"], n_npus=1024, device=SYSTEM_2_DEVICE,
                      batch=64, seq=2048, backend=name)
        with pytest.raises(ValueError, match="unknown simulation backend"):
            dataclasses.replace(StudySpec.from_json(ROOT / "examples" / "studies" /
                                                    "smoke.json"), backend=name)


def test_torch_backend_defaults_to_the_card_and_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    for name in ("torch", "torch-unfused"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_backend(name)
        assert not backend_available(name)
    env = system_env("qwen2-1.5b", "system2", batch=64, backend="torch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        env.step_batch([dict(BASE_CFG), dict(BASE_CFG, chunks=4)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        env.evaluate_config(dict(BASE_CFG))


def test_cli_torch_backend_fails_without_cuda_and_runs_on_the_cpu_when_asked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    spec = str(ROOT / "examples" / "studies" / "smoke.json")

    def run(*extra, pkg="repro_torch"):
        return subprocess.run([sys.executable, "-m", f"{pkg}.dse", "run", spec, *extra],
                              capture_output=True, text=True, env=env, timeout=300,
                              cwd=tmp_path)
    if not torch.cuda.is_available():
        r = run("--backend", "torch", "--out", str(tmp_path / "card.jsonl"))
        assert r.returncode != 0 and "CUDA is not available" in r.stderr
        assert "campaign done" not in r.stdout and '"ok"' not in r.stdout
        assert not (tmp_path / "card.jsonl").exists()
    best = {}
    for name, extra, pkg in (("reference", (), "repro"),  # the JAX package's CLI
                             ("torch", ("--backend", "torch", "--device", CPU), "repro_torch")):
        r = run(*extra, "--out", str(tmp_path / f"{name}.jsonl"), pkg=pkg)
        assert r.returncode == 0, r.stderr
        best[name] = [line for line in r.stdout.splitlines() if line.startswith("best cell")]
    assert best["torch"] and best["torch"] == best["reference"]


def test_run_study_and_system_env_pass_the_device_through(tmp_path):
    spec = StudySpec.from_json(ROOT / "examples" / "studies" / "smoke.json")
    want = J.study.run_study(J.study.StudySpec.from_json(ROOT / "examples" / "studies" /
                                                         "smoke.json"))
    got = run_study(dataclasses.replace(spec, backend="torch"), sim_device=CPU)
    for w, g in zip(want.outcomes, got.outcomes):
        assert _rel(g.result.best_reward, w.result.best_reward) < RTOL
    env = system_env("qwen2-1.5b", "system2", batch=64, backend="torch", sim_device=CPU)
    assert env.sim_device == CPU
    assert env.context(dict(BASE_CFG)).backend is _tb(True)


# ---------------------------------------------------------------------------
# parity with the JAX package's reference event loop
# (tests/test_backends.py:186-298)
# ---------------------------------------------------------------------------

def test_torch_parity_train_trace_both_policies():
    tb = _tb()
    for arch, dims in (("gpt3-13b", (1024, 64, 4, 1, True)),
                       ("gpt3-175b", (1024, 64, 1, 1, True))):
        (j_tr, j_par), (tr, par) = [
            (p.workload.generate_trace(p.ARCHS[arch], p.workload.Parallelism(*dims),
                                       batch=1024, seq=2048), p.workload.Parallelism(*dims))
            for p in (J, T)]
        for policy in ("fifo", "lifo"):
            ref = J.simulator.simulate(j_tr, _sys(policy, J), j_par)
            got = tb.simulate(tr, _sys(policy), par)
            assert _rel(got.makespan_us, ref.makespan_us) < RTOL
            assert _rel(got.compute_busy_us, ref.compute_busy_us) < RTOL
            for k, v in ref.comm_busy_us.items():
                assert _rel(got.comm_busy_us[k], v) < RTOL


def _scenarios(p: SimpleNamespace = T):
    sc = p.scenario
    return [
        ("train", None, {}),
        ("disagg", sc.DisaggServeScenario(64, 2048, 16), dict(prefill_frac=0.5, decode_batch=4)),
        ("stream", sc.RequestStreamScenario(n_requests=24, seq=1024, decode_tokens=16,
                                            rate_rps=16.0, seed=3),
         dict(prefill_frac=0.5, decode_batch=4, batch_window_ms=50.0, max_inflight=2)),
        ("tenants", sc.MultiTenantScenario(tenants=(
            sc.Tenant("a", p.ARCHS["gpt3-13b"], 512, 2048, "train", slo_ms=5e5),
            sc.Tenant("b", p.ARCHS["qwen2-1.5b"], 64, 2048, "serve", slo_ms=5e4))),
         dict(tenant_npus=(512, 256))),
        ("fleet", p.fleet.FleetScenario(
            n_requests=16, seq=2048, decode_tokens=8, rate_rps=16.0, max_batch=8, seed=3,
            replicas=2, arrival="diurnal", period_s=10.0),
         dict(prefill_frac=0.875, decode_batch=4, batch_window_ms=200.0, max_inflight=2,
              router="round-robin", autoscale_target=0.0, autoscale_cooldown_s=10.0)),
    ]


@pytest.mark.parametrize("policy", ["fifo", "lifo"])
def test_torch_parity_all_scenarios(policy):
    """Env-level parity on every scenario family: rewards and latencies of
    the torch sweep agree with the JAX package's reference event loop."""
    for (name, j_sc, extra), (_, sc, _) in zip(_scenarios(J), _scenarios(T)):
        j_kw = dict(scenario=j_sc) if j_sc is not None else dict(batch=64)
        kw = dict(scenario=sc) if sc is not None else dict(batch=64)
        obj = {"stream": "goodput", "fleet": "goodput_per_dollar"}.get(name, "perf_per_bw")
        env_ref = J.systems.system_env("qwen2-1.5b", "system2", objective=obj, **j_kw)
        env_t = system_env("qwen2-1.5b", "system2", objective=obj, backend="torch",
                           sim_device=CPU, **kw)
        cfg = dict(BASE_CFG, sched_policy=policy, **extra)
        ref = env_ref.evaluate_config(cfg)
        got = env_t.evaluate_config(cfg)
        assert ref.valid and got.valid, name
        assert _rel(got.latency_ms, ref.latency_ms) < RTOL, name
        assert _rel(got.reward, ref.reward) < RTOL, name


def test_torch_parity_seeded_design_space_sweep():
    env_ref = J.systems.system_env("gpt3-13b", "system2")
    env_t = system_env("gpt3-13b", "system2", backend="torch", sim_device=CPU)
    space = DesignSpace(paper_psa(1024, max_pp=4))
    rng = np.random.default_rng(7)
    checked = 0
    for _ in range(12):
        cfg = space.sample(rng)
        ref = env_ref.evaluate_config(cfg)
        got = env_t.evaluate_config(cfg)
        assert got.valid == ref.valid
        if ref.valid:
            checked += 1
            assert _rel(got.latency_ms, ref.latency_ms) < RTOL
    assert checked >= 3


def test_torch_batch_is_bit_identical_to_torch_single():
    tb = _tb()
    par = Parallelism(1024, 64, 4, 1, True)
    tr = generate_trace(ARCHS["qwen2-1.5b"], par, batch=1024, seq=2048)
    cfgs = [SystemConfig(network=system_2(), device=SYSTEM_2_DEVICE,
                         coll_algo=("ring", "direct", "ring", "rhd"), chunks=c,
                         sched_policy=p)
            for c, p in ((2, "fifo"), (8, "lifo"), (16, "fifo"))]
    batch = tb.simulate_batch(tr, [SimCall(tr, c, par) for c in cfgs])
    for cfg, got in zip(cfgs, batch):
        one = tb.simulate(tr, cfg, par)
        assert got.makespan_us == one.makespan_us
        assert got.comm_busy_us == one.comm_busy_us


def test_torch_step_batch_routes_through_simulate_batch():
    sc = RequestStreamScenario(n_requests=24, seq=1024, decode_tokens=16, rate_rps=16.0,
                               seed=3)
    env = system_env("qwen2-1.5b", "system2", scenario=sc, objective="goodput",
                     backend="torch", sim_device=CPU)
    cfgs = [dict(STREAM_CFG, chunks=c) for c in (2, 4, 8, 4)]  # one duplicate
    tb = _tb()
    tb.last_timings = {}
    out = env.step_batch(cfgs)
    assert set(tb.last_timings) == {"durations_s", "sweep_s"}  # went through simulate_batch
    assert len(out) == 4 and len(env.history) == 4
    assert out[1].reward == out[3].reward
    serial = [env.evaluate_config(c) for c in cfgs]
    assert [o.reward for o in out] == [s.reward for s in serial]
    env_ref = J.systems.system_env(
        "qwen2-1.5b", "system2", objective="goodput",
        scenario=J.scenario.RequestStreamScenario(n_requests=24, seq=1024, decode_tokens=16,
                                                  rate_rps=16.0, seed=3))
    for o, c in zip(out, cfgs):
        assert _rel(o.reward, env_ref.evaluate_config(c).reward) < RTOL


def test_backends_do_not_cross_hit_a_shared_eval_store():
    store: dict = {}
    kw = dict(batch=64, seq=2048, eval_store=store)
    env_ref = system_env("qwen2-1.5b", "system2", **kw)
    env_t = system_env("qwen2-1.5b", "system2", backend="torch", sim_device=CPU, **kw)
    env_ref.step(dict(BASE_CFG))
    env_t.step(dict(BASE_CFG))
    assert env_ref.store_misses == 1 and env_ref.store_hits == 0
    assert env_t.store_misses == 1 and env_t.store_hits == 0
    assert len(store) == 2


def test_forward_dependency_raises():
    ops = [Op(uid=0, name="a", kind="comp", deps=[1], flops=1e9, bytes=1e6),
           Op(uid=1, name="b", kind="comp", deps=[], flops=1e9, bytes=1e6)]
    tr = Trace(ops=ops)
    with pytest.raises(ValueError, match="depends on a later op"):
        _tb().simulate(tr, _sys(), Parallelism(1024, 64, 4, 1))


def test_finish_times_have_dict_semantics():
    fin = FinishTimes(np.array([1.0, 2.5, 4.0]))
    assert fin[1] == 2.5 and len(fin) == 3 and list(fin) == [0, 1, 2]
    assert 3 not in fin and -1 not in fin and fin.get(7) is None


# ---------------------------------------------------------------------------
# the kernels' plain twins, bit for bit against the JAX package's numpy
# (tests/test_collectives_vec.py:230-270 and :353-381)
# ---------------------------------------------------------------------------

def _cfgs_population(p: SimpleNamespace = T):
    out = []
    for algos, chunks, mode, policy in (
            (("ring", "direct", "ring", "rhd"), 2, "baseline", "fifo"),
            (("dbt", "rhd", "direct", "ring"), 8, "blueconnect", "lifo"),
            (("direct", "direct", "dbt", "dbt"), 1, "baseline", "lifo"),
            (("rhd", "ring", "rhd", "ring"), 16, "blueconnect", "fifo")):
        out.append(p.simulator.SystemConfig(
            network=p.topology.system_2(), device=p.compute.SYSTEM_2_DEVICE, coll_algo=algos,
            chunks=chunks, multidim_coll=mode, sched_policy=policy))
    return out


def _train_calls(p: SimpleNamespace = T):
    par = p.workload.Parallelism(1024, 64, 4, 1, True)
    tr = p.workload.generate_trace(p.ARCHS["qwen2-1.5b"], par, batch=256, seq=1024)
    return tr, [p.backends.SimCall(tr, cfg, par) for cfg in _cfgs_population(p)]


def _stream_calls(p: SimpleNamespace = T):
    sc = p.scenario.RequestStreamScenario(n_requests=16, seq=512, decode_tokens=8,
                                          rate_rps=16.0, seed=3)
    env = p.systems.system_env("qwen2-1.5b", "system2", scenario=sc, objective="goodput")
    base = dict(STREAM_CFG, coll_algo=("ring", "direct", "ring", "rhd"))
    jobs = [env.scenario.sim_job(env.context(dict(base, chunks=c, multidim_coll=m)))
            for c, m in ((2, "baseline"), (8, "blueconnect"), (16, "baseline"))]
    calls = [c for j in jobs for c in j.calls]
    tr = calls[0].trace
    assert all(c.trace is tr for c in calls) and any(c.pools for c in calls)
    return tr, calls


def _plain_durations(tr, calls):
    """The fused backend's CPU path: the class table and the gathered
    durations, op-major, from the plain twins of both kernels."""
    plan, tables = plan_duration_tables(tr, calls)
    st = _tb()._static(tr, plan)
    tab = _tb()._class_tables(tables)
    class_t = dse_sim.dse_class_times(
        st["kind"], st["size"], st["is_xfer"], tab["npus"], tab["bw"], tab["lat"],
        tab["scale"], tab["topo"], tab["algo"], tab["chunks"], tab["blue"], tab["xfer_bw"],
        tab["xfer_lat"])
    dur, finish = dse_sim.dse_sweep(st["parents"], sources=st["sources"], class_t=class_t,
                                    peak=tab["peak"], membw=tab["membw"])
    return plan, tables, class_t.numpy(), dur.numpy(), finish.numpy()


@pytest.mark.parametrize("calls_of", [_train_calls, _stream_calls], ids=["train", "stream"])
def test_plain_durations_are_bit_identical_to_numpy(calls_of):
    tr, calls = calls_of()
    before = (dse_sim.dse_class_times.launches, dse_sim.dse_sweep.launches)
    plan, tables, class_t, dur, _ = _plain_durations(tr, calls)
    assert (dse_sim.dse_class_times.launches, dse_sim.dse_sweep.launches) == before
    j_tr, j_calls = calls_of(J)
    _, want = J.simulator.plan_durations_batch(j_tr, j_calls)
    assert dur.shape == (plan.n_ops, len(calls))
    assert np.array_equal(dur.T, want)  # bit-identical, not approx
    if calls_of is _stream_calls:
        assert any(group == "xfer" for _p, group, _c, _s in plan.coll_shapes)
        assert plan.delay_ops
    # the scalar per-call pass is the oracle's; numpy's batched pass agrees
    # with it to the last ulp or so (a reference caveat, ROADMAP Queue 3)
    for k, call in enumerate(j_calls):
        _, scalar = J.simulator.plan_durations(j_tr, call.cfg, call.par, call.pools)
        assert np.all(np.abs(want[k] - scalar) <= 1e-12 * np.abs(scalar))


def test_plain_class_times_match_the_vectorized_model_bit_for_bit():
    """A random fabric sweep (partial carves, residual virtual dims, every
    kind and algo, both modes), packed as ``_pack_class_tables`` packs it:
    the twin equals the JAX package's ``multidim_collective_time_vec`` with
    the host-exact scale bit for bit."""
    c_ = J.collectives
    TopoDim, Network, carve_dims = J.topology.TopoDim, J.topology.Network, J.topology.carve_dims
    rng = np.random.default_rng(5)
    P, C, D = 6, 40, 6
    tab = dict(npus=np.ones((P, C, D)), bw=np.ones((P, C, D)), lat=np.zeros((P, C, D)),
               scale=np.ones((P, C, D)), topo=np.zeros((P, C, D), np.int32),
               algo=np.zeros((P, C, D), np.int32))
    kind = rng.integers(0, 4, C).astype(np.int32)
    size = rng.uniform(1e3, 1e9, C)
    size[3] = 0.0
    for p in range(P):
        for c in range(C):
            ndim = int(rng.integers(2, 5))
            dims = tuple(TopoDim(str(rng.choice(J.topology.TOPO_KINDS)), int(rng.choice((2, 4, 8))),
                                 float(rng.uniform(25.0, 900.0)), float(rng.uniform(0.1, 1.5)))
                         for _ in range(ndim))
            algos = [str(rng.choice(list(c_.ALGO_IDS))) for _ in range(ndim)]
            carved = carve_dims(Network(dims).dims, [d.npus for d in dims],
                                int(rng.choice((1, 2, 3, 6, 8, 24, 96))))
            s = 1.0
            for j, (src, d) in enumerate(carved):
                tab["npus"][p, c, j], tab["bw"][p, c, j] = d.npus, d.bw
                tab["lat"][p, c, j] = d.latency_us
                tab["topo"][p, c, j] = c_.TOPO_KIND_IDS[d.kind]
                tab["algo"][p, c, j] = c_.ALGO_IDS[algos[src]]
                tab["scale"][p, c, j] = 1.0 if kind[c] == c_.COLL_KIND_IDS["all_to_all"] else s
                s /= d.npus
    chunks = rng.choice((1.0, 2.0, 4.0, 16.0), P)
    blue = rng.random(P) < 0.5
    is_xfer = rng.random(C) < 0.2
    xfer_bw, xfer_lat = rng.uniform(10.0, 400.0, P), rng.uniform(0.5, 9.0, P)
    coll = c_.multidim_collective_time_vec(kind[None, :], size[None, :], tab["npus"],
                                           tab["bw"], tab["lat"], tab["topo"], tab["algo"],
                                           chunks[:, None], blue[:, None], scale=tab["scale"])
    want = np.where(is_xfer[None, :], xfer_lat[:, None] + (size[None, :] / xfer_bw[:, None])
                    * 1e-3, coll)
    t = {k: torch.from_numpy(v) for k, v in tab.items()}
    got = dse_sim.dse_class_times(
        torch.from_numpy(kind), torch.from_numpy(size), torch.from_numpy(is_xfer), t["npus"],
        t["bw"], t["lat"], t["scale"], t["topo"], t["algo"], torch.from_numpy(chunks),
        torch.from_numpy(blue), torch.from_numpy(xfer_bw), torch.from_numpy(xfer_lat))
    assert np.array_equal(got.numpy(), want)
    assert (want > 0).sum() > P * C // 2


def _numpy_max_plus(parents, dur):
    """finish[i] = dur[i] + max(finish[parents[i]]) in uid order, numpy."""
    n_ops, P = dur.shape
    fin = np.zeros((n_ops + 1, P))
    for i in range(n_ops):
        fin[i] = dur[i] + fin[parents[i]].max(axis=0)
    return fin


@pytest.mark.parametrize("calls_of", [_train_calls, _stream_calls], ids=["train", "stream"])
def test_plain_sweep_is_bit_identical_to_a_numpy_max_plus(calls_of):
    """The plain sweep's finish times equal a numpy max-plus over the JAX
    package's parents table and numpy durations."""
    from repro.core.backends.jax_backend import _plan_parents as j_plan_parents
    tr, calls = calls_of()
    plan, _, _, dur, finish = _plain_durations(tr, calls)
    parents = _plan_parents(tr, plan)
    j_tr, j_calls = calls_of(J)
    j_plan, j_dur = J.simulator.plan_durations_batch(j_tr, j_calls)
    j_parents = j_plan_parents(j_tr, j_plan)
    assert np.array_equal(parents, j_parents)
    assert np.array_equal(finish, _numpy_max_plus(j_parents, j_dur.T))
    # the given-durations mode (the unfused path) gives the same bits
    d = torch.from_numpy(dur)
    same, fin2 = dse_sim.dse_sweep(torch.from_numpy(parents), dur=d)
    assert same is d and np.array_equal(fin2.numpy(), finish)


# synthetic parent tables (seed, n_ops, W, P): parents up to 5,000 ops back
# (past the sweep kernel's ring), wide and narrow rows, op counts that are
# no multiple of the kernel's 256-op tile; tests/test_torch_cuda.py holds the
# kernel to the same cases
SYNTHETIC_SWEEPS = [(0, 6001, 8, 3), (1, 1037, 3, 33), (2, 700, 300, 2), (3, 5, 2, 1),
                    (4, 1, 1, 4)]


@pytest.mark.parametrize("seed,n_ops,W,P", SYNTHETIC_SWEEPS)
def test_plain_sweep_on_synthetic_far_parents_is_bit_identical_to_a_numpy_max_plus(
        seed, n_ops, W, P):
    parents, dur = dse_sim.synthetic_sweep_case(seed, n_ops, W, P)
    assert parents.shape == (n_ops, W) and dur.shape == (n_ops, P)
    d = torch.from_numpy(dur)
    same, finish = dse_sim.dse_sweep(torch.from_numpy(parents), dur=d)
    assert same is d
    assert np.array_equal(finish.numpy(), _numpy_max_plus(parents, dur))


def test_synthetic_sweep_case_reaches_every_source_of_parent_reads():
    parents, dur = dse_sim.synthetic_sweep_case(0, 6001, 8, 3)
    again = dse_sim.synthetic_sweep_case(0, 6001, 8, 3)
    assert np.array_equal(parents, again[0]) and np.array_equal(dur, again[1])
    served = dse_sim.sweep_served_from(torch.from_numpy(parents))
    assert min(served.values()) > 1000, served
    i = np.arange(6001)[:, None]
    real = parents < 6001
    assert ((i - parents)[real] >= 1).all() and (i - parents)[real].max() > 4000
    assert (~real).all(axis=1).sum() > 100            # ops with only padded parents
    assert ((parents[:, 0] == parents[:, 1]) & real[:, 0]).sum() > 100  # a parent twice
    assert (dur >= 0).all() and (dur == 0).mean() > 0.02


def test_sweep_served_from_counts_by_distance():
    n = 300
    parents = torch.full((n, 6), n, dtype=torch.int32)
    parents[299] = torch.tensor([298, 297, 296, 299 - dse_sim.RING, 298 - dse_sim.RING, n])
    parents[10, :2] = torch.tensor([-1, 11])  # outside [0, i): read as the padded slot
    assert dse_sim.sweep_served_from(parents) == {"registers": 2, "ring": 2, "table": 1}


def test_ring_depth_is_the_kernels():
    src = (Path(dse_sim.__file__).parent.parent / "csrc" / "dse_sim.cu").read_text()
    assert int(re.search(r"constexpr int kRing = (\d+);", src).group(1)) == dse_sim.RING


def test_tile_is_the_kernels():
    src = (Path(dse_sim.__file__).parent.parent / "csrc" / "dse_sim.cu").read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == dse_sim.TILE


def test_fp64_chain_probe_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        dse_sim.fp64_chain_probe(16, "cpu")


def test_unfused_backend_equals_fused_and_single():
    tr, calls = _train_calls()
    fused = _tb(True).simulate_batch(tr, calls)
    unfused = _tb(False).simulate_batch(tr, calls)
    for k, call in enumerate(calls):
        assert _rel(fused[k].makespan_us, unfused[k].makespan_us) < RTOL, k
        one = _tb(False).simulate(tr, call.cfg, call.par)
        assert unfused[k].makespan_us == one.makespan_us
        assert unfused[k].comm_busy_us == one.comm_busy_us
        for res, busy in unfused[k].comm_busy_us.items():
            assert _rel(fused[k].comm_busy_us[res], busy) < RTOL
    for fused_flag in (True, False):
        assert set(_tb(fused_flag).last_timings) == {"durations_s", "sweep_s"}


def test_sweep_levels_order_every_op_after_its_parents():
    tr, calls = _stream_calls()
    parents = torch.from_numpy(_plan_parents(tr, _sim_plan(tr)))
    levels = dse_sim.sweep_levels(parents)
    seen = torch.zeros(parents.shape[0] + 1, dtype=torch.bool)
    seen[-1] = True  # the padded slot
    for ops in levels:
        assert seen[parents[ops].long()].all()
        seen[ops] = True
    assert seen.all() and sum(len(o) for o in levels) == parents.shape[0]


def test_wrappers_refuse_other_devices_and_bad_arguments():
    meta = torch.empty((2, 3, 6), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        dse_sim.dse_class_times(*([meta] * 13))
    par = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        dse_sim.dse_sweep(par, dur=torch.zeros((4, 2), device="meta"))
    with pytest.raises(ValueError, match="either dur or sources"):
        dse_sim.dse_sweep(torch.zeros((4, 2), dtype=torch.int32))
