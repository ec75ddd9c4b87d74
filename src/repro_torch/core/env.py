"""CosmicEnv: the ArchGym-style environment wrapping the simulator.

An agent submits a PsA configuration; the environment materializes the
(workload, collective, network, compute) stacks and hands the resolved
``EnvContext`` to its ``Scenario``, which runs the WTG + simulator and
returns the reward.  Fixed parameters (single-stack baselines) are handled
upstream by ``ParameterSet.restrict`` — the env is stack-agnostic.

Batched evaluation: ``step_batch`` evaluates a population of configurations
at once, deduplicating repeated design points through a per-env evaluation
memo (evaluation is a pure function of the config) and optionally fanning
the distinct points out to a ``concurrent.futures`` process pool.  Results
are identical to serial ``step`` calls in the same order.  With a
vectorized simulation backend (``backend="torch"``), the surviving unique
points are instead described as declarative ``SimJob``s and swept through
the backend's population-batched ``simulate_batch``, grouped by shared
trace.

Cross-search sharing: pass the same ``eval_store`` dict to several envs
over the same (spec, scenario, system) and they share one evaluation memo —
benchmark sweeps running four agents over one space stop re-evaluating
identical design points per agent.  Hit/miss counters live on each env.
"""
from __future__ import annotations

import itertools
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Any, Sequence

from repro_torch.configs.base import ArchSpec
from repro_torch.core.backends import BACKEND_REGISTRY, get_backend, run_sim_jobs
from repro_torch.core.cache import cache_epoch, caches_enabled
from repro_torch.core.compute import Device
from repro_torch.core.rewards import Evaluation, Objective, get_objective
from repro_torch.core.scenario import EnvContext, Scenario, TrainScenario
from repro_torch.core.simulator import SystemConfig
from repro_torch.core.topology import Network, build_network


@dataclass
class StepRecord:
    step: int
    config: dict[str, Any]
    reward: float
    latency_ms: float
    valid: bool


def _config_key(config: dict[str, Any]) -> tuple:
    """Canonical hashable key for one design point."""
    return tuple(sorted((k, v) for k, v in config.items()))


# -- process-pool plumbing ---------------------------------------------------
# Workers hold a history-free copy of the env (installed once per worker via
# the pool initializer) and evaluate configs against it; only (config ->
# Evaluation) crosses the process boundary.
_WORKER_ENV: "CosmicEnv | None" = None


def _pool_init(env: "CosmicEnv") -> None:
    global _WORKER_ENV
    _WORKER_ENV = env


_WORKER_SEEN_EPOCH: int | None = None


def _pool_eval(config: dict[str, Any], caches_on: bool,
               epoch: int) -> Evaluation:
    assert _WORKER_ENV is not None, "pool worker not initialized"
    # the parent's runtime cache toggle and clear_all_caches() epoch don't
    # reach long-lived workers (fork freezes state at pool creation, spawn
    # re-imports the defaults), so every task carries both
    global _WORKER_SEEN_EPOCH
    from repro_torch.core import cache as _cache
    if _WORKER_SEEN_EPOCH is not None and _WORKER_SEEN_EPOCH != epoch:
        _cache.clear_all_caches()
    _WORKER_SEEN_EPOCH = epoch
    if _cache.caches_enabled() != caches_on:
        _cache.set_caches_enabled(caches_on)
    return _WORKER_ENV.evaluate_config(config)


@dataclass
class CosmicEnv:
    spec: ArchSpec
    n_npus: int
    device: Device
    # the workload shape under design.  Either pass a Scenario, or use the
    # legacy (batch, seq, mode, decode_tokens) fields and get a TrainScenario
    # built for you — older call sites keep working unchanged.
    scenario: Scenario | None = None
    batch: int | None = None
    seq: int | None = None
    mode: str | None = "train"
    decode_tokens: int | None = 64
    # an Objective-registry name or an Objective instance; resolved to an
    # Objective at construction (self.objective is always an Objective after
    # __post_init__)
    objective: "str | Objective" = "perf_per_bw"
    capacity_gb: float = 24.0
    fixed_network: Network | None = None   # for workload/collective-only DSE
    # simulation-backend registry name (``repro_torch.core.backends``): how every
    # design point's traces are scheduled.  Vectorized backends ("torch")
    # additionally reroute ``step_batch`` through the population-batched
    # ``simulate_batch`` path.  Kept a string so envs pickle to pool workers.
    backend: str = "reference"
    # where a torch backend computes ("cuda", "cpu"); None is its default,
    # the card (see ``backends.get_backend``).  The reference backend is
    # host numpy and ignores it.
    sim_device: str | None = None
    # optional cross-search shared memo (see module docstring)
    eval_store: dict[tuple, Evaluation] | None = None
    store_hits: int = 0
    store_misses: int = 0
    # optional observer of fresh evaluations: called (config, Evaluation)
    # once per memo miss (the persistent cross-campaign eval store hooks in
    # here).  Not forwarded to pool workers — the parent records results as
    # they come back.
    eval_record: Any = None
    history: list[StepRecord] = field(default_factory=list)
    _eval_cache: dict[tuple, Evaluation] = field(default_factory=dict, repr=False)
    _sig_cache: tuple | None = field(default=None, repr=False)
    _memo_epoch: int = field(default=-1, repr=False)
    _executor: ProcessPoolExecutor | None = field(default=None, repr=False)
    _executor_workers: int = field(default=0, repr=False)
    _in_context: bool = field(default=False, repr=False)  # inside `with env:`

    def __post_init__(self) -> None:
        # fail at construction on a bad objective, not deep in a search:
        # resolve the name through the Objective registry; streaming-required
        # objectives (e.g. "goodput") additionally need a scenario that
        # resolves per-request metrics itself
        self.objective = get_objective(self.objective)
        if self.objective.streaming and self.scenario is not None \
                and not getattr(self.scenario, "supports_stream_objectives",
                                False):
            raise ValueError(
                f"objective {self.objective.name!r} needs a streaming "
                f"scenario (per-request metrics); "
                f"{type(self.scenario).__name__} only supports scalar "
                f"(one-latency) objectives")
        if self.backend not in BACKEND_REGISTRY:
            raise ValueError(f"unknown simulation backend {self.backend!r}; "
                             f"known: {sorted(BACKEND_REGISTRY)}")
        if self.scenario is None:
            if self.objective.streaming:
                raise ValueError(f"objective {self.objective.name!r} needs a "
                                 f"streaming scenario, not the legacy "
                                 f"batch/seq TrainScenario path")
            if self.batch is None or self.seq is None:
                raise TypeError("CosmicEnv needs either a scenario or "
                                "legacy batch/seq fields")
            self.scenario = TrainScenario(self.batch, self.seq, self.mode,
                                          self.decode_tokens)
        else:
            # the scenario owns the workload shape — drop legacy fields so
            # nothing reads stale workload metadata off the env
            self.batch = self.seq = self.mode = self.decode_tokens = None

    def _network(self, config: dict[str, Any]) -> Network:
        if self.fixed_network is not None and "topology" not in config:
            return self.fixed_network
        return build_network(config["topology"], config["npus_per_dim"],
                             config["bw_per_dim"])

    def context(self, config: dict[str, Any]) -> EnvContext:
        """Resolve one design point's network/system stacks for the scenario."""
        net = self._network(config)
        sys_cfg = SystemConfig(
            network=net, device=self.device,
            coll_algo=tuple(config["coll_algo"]),
            chunks=int(config["chunks"]),
            sched_policy=config["sched_policy"],
            multidim_coll=config["multidim_coll"],
        )
        backend = self.backend if self.sim_device is None \
            else get_backend(self.backend, self.sim_device)
        return EnvContext(spec=self.spec, n_npus=self.n_npus,
                          device=self.device, objective=self.objective,
                          capacity_gb=self.capacity_gb, config=config,
                          network=net, sys_cfg=sys_cfg, backend=backend)

    def evaluate_config(self, config: dict[str, Any]) -> Evaluation:
        """Pure evaluation of one design point (no history, no memo)."""
        return self.scenario.evaluate(self.context(config))

    def clear_memo(self) -> None:
        self._eval_cache.clear()
        if self.eval_store is not None:
            # evict only this env's signature from the shared store —
            # other envs' entries are theirs to manage
            sig = self._store_sig()
            for k in [k for k in self.eval_store if k[0] == sig]:
                del self.eval_store[k]

    # -- memoization -------------------------------------------------------
    # Private memo keys are the bare config; the shared store prefixes the
    # env signature so envs over different (spec, scenario, system) can
    # safely share one dict.
    def _store_sig(self) -> tuple:
        if self._sig_cache is None:  # all inputs are frozen value objects
            # hash the full spec/device (not just names): same-named but
            # differing objects must not share store entries.  The backend
            # is part of the signature — a vectorized backend's results may
            # differ (within tolerance) from the reference oracle's, so
            # they must not cross-hit through a shared store.
            self._sig_cache = (self.spec, self.n_npus, self.device,
                               self.objective, self.capacity_gb,
                               self.scenario, self.fixed_network,
                               self.backend)
        return self._sig_cache

    def _point_key(self, config: dict[str, Any]) -> tuple:
        canon = getattr(self.scenario, "canonical", None)
        if canon is not None:
            config = canon(config)
        key = _config_key(config)
        return (self._store_sig(), key) if self.eval_store is not None else key

    def _memo(self) -> dict[tuple, Evaluation]:
        """The evaluation memo, honoring cache.clear_all_caches() epochs."""
        if self.eval_store is not None:
            return self.eval_store  # lifetime is the caller's to manage
        if self._memo_epoch != cache_epoch():
            self._eval_cache.clear()
            self._memo_epoch = cache_epoch()
        return self._eval_cache

    def store_records(self) -> list[tuple[dict[str, Any], float]]:
        """(config, reward) pairs this env has memoized — from its slice of
        a shared ``eval_store`` (only this env's signature) or its private
        memo.  The surrogate layer's dataset builders consume this shape
        (``repro_torch.core.surrogate.build_dataset``)."""
        memo = self._memo()
        if self.eval_store is not None:
            sig = self._store_sig()
            return [(dict(k[1]), ev.reward)
                    for k, ev in memo.items() if k[0] == sig]
        return [(dict(k), ev.reward) for k, ev in memo.items()]

    def _evaluate_memo(self, config: dict[str, Any]) -> Evaluation:
        if not caches_enabled():
            return self.evaluate_config(config)
        memo = self._memo()
        key = self._point_key(config)
        ev = memo.get(key)
        if ev is None:
            self.store_misses += self.eval_store is not None
            ev = self.evaluate_config(config)
            memo[key] = ev
            if self.eval_record is not None:
                self.eval_record(config, ev)
        else:
            self.store_hits += self.eval_store is not None
        return ev

    def step(self, config: dict[str, Any]) -> Evaluation:
        ev = self._evaluate_memo(config)
        self.history.append(StepRecord(len(self.history), config, ev.reward,
                                       ev.latency_ms, ev.valid))
        return ev

    def step_batch(self, configs: Sequence[dict[str, Any]],
                   workers: int = 0) -> list[Evaluation]:
        """Evaluate a population of design points.

        Distinct uncached points are computed once each — serially, or on a
        process pool when ``workers > 1`` — then results are recorded in
        input order, so history and returned evaluations match what serial
        ``step`` calls would have produced.
        """
        memo_on = caches_enabled()
        if memo_on:
            # evaluate each distinct uncached point once
            memo = self._memo()
            shared = self.eval_store is not None
            keys = [self._point_key(c) for c in configs]
            todo: dict[tuple, dict[str, Any]] = {}
            for key, cfg in zip(keys, configs):
                if key not in memo:
                    todo.setdefault(key, cfg)
            if shared:
                # per-occurrence accounting matching serial step() calls:
                # the first sighting of a new key is the miss, duplicates
                # (within the batch or not) are hits
                counted_new: set = set()
                for key in keys:
                    if key not in todo or key in counted_new:
                        self.store_hits += 1
                    else:
                        self.store_misses += 1
                        counted_new.add(key)
            if todo:
                evs = self._eval_many(list(todo.values()), workers)
                memo.update(zip(todo.keys(), evs))
                if self.eval_record is not None:
                    for cfg, ev in zip(todo.values(), evs):
                        self.eval_record(cfg, ev)
            out = [memo[key] for key in keys]
        else:
            # caches off = the honest uncached baseline: every occurrence
            # is evaluated, including within-batch duplicates
            out = self._eval_many(list(configs), workers)
        for cfg, ev in zip(configs, out):
            self.history.append(StepRecord(len(self.history), cfg, ev.reward,
                                           ev.latency_ms, ev.valid))
        return out

    def _eval_many(self, cfgs: list[dict[str, Any]],
                   workers: int) -> list[Evaluation]:
        backend = get_backend(self.backend, self.sim_device)
        if backend.vectorized and len(cfgs) > 1 \
                and hasattr(self.scenario, "sim_job"):
            # population-vectorized path: describe every point's simulator
            # calls declaratively, then sweep the calls sharing a trace —
            # and therefore a scheduling plan — in one simulate_batch each.
            # Takes precedence over the process pool: fanning single-point
            # evaluations out to workers would forfeit the shared-plan
            # sweep (and pay a per-worker kernel load).
            jobs = [self.scenario.sim_job(self.context(c)) for c in cfgs]
            return run_sim_jobs(jobs, backend)
        if workers > 1 and len(cfgs) > 1:
            pool = self._get_executor(workers)
            chunk = max(1, len(cfgs) // (self._executor_workers * 2))
            flags = itertools.repeat(caches_enabled())
            epochs = itertools.repeat(cache_epoch())
            return list(pool.map(_pool_eval, cfgs, flags, epochs,
                                 chunksize=chunk))
        return [self.evaluate_config(c) for c in cfgs]

    # -- pool lifecycle ---------------------------------------------------
    def pool_is_caller_managed(self) -> bool:
        """True when the caller controls pool lifetime — the env is inside a
        ``with`` block, or a pool already exists from earlier use.  Search
        drivers use this to decide whether to reap the pool they caused."""
        return self._executor is not None or self._in_context

    def _get_executor(self, workers: int) -> ProcessPoolExecutor:
        workers = min(workers, os.cpu_count() or 1)
        if self._executor is not None and self._executor_workers != workers:
            self.close()
        if self._executor is None:
            bare = replace(self, history=[], _eval_cache={}, _executor=None,
                           _executor_workers=0, eval_store=None,
                           store_hits=0, store_misses=0, eval_record=None)
            # fork gives near-free workers, but a child forked after CUDA
            # initialisation cannot use the card, so fall back to spawn
            # there (slower startup, re-imports per worker)
            torch = sys.modules.get("torch")
            cuda_up = torch is not None and torch.cuda.is_initialized()
            method = "spawn" if (cuda_up
                                 or "fork" not in multiprocessing.get_all_start_methods()) \
                else "fork"
            self._executor = ProcessPoolExecutor(
                max_workers=workers, initializer=_pool_init, initargs=(bare,),
                mp_context=multiprocessing.get_context(method))
            self._executor_workers = workers
        return self._executor

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown()
            self._executor = None
            self._executor_workers = 0

    def __enter__(self) -> "CosmicEnv":
        self._in_context = True
        return self

    def __exit__(self, *exc) -> None:
        self._in_context = False
        self.close()

    def best(self) -> StepRecord | None:
        valid = [r for r in self.history if r.valid]
        return max(valid, key=lambda r: r.reward) if valid else None
