"""Design-space-exploration driver: agent x environment loop with
convergence bookkeeping (reward-vs-step curves, steps-to-peak — the data
behind the paper's Fig. 9/10).

The loop is batch-driven: each round asks the agent for a population of
``batch_size`` proposals, pushes them through ``CosmicEnv.step_batch``
(memoized, optionally on a process pool), and feeds every reward back at
once.  ``batch_size=1`` reproduces the sequential propose/step/observe loop
exactly — same RNG stream, same rewards, same convergence bookkeeping.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.core.agents import make_agent
from repro_torch.core.env import CosmicEnv
from repro_torch.core.psa import ParameterSet
from repro_torch.core.space import DesignSpace


@dataclass
class SearchResult:
    agent: str
    steps: int
    best_reward: float
    best_config: dict[str, Any] | None
    best_latency_ms: float
    steps_to_peak: int
    reward_curve: list[float]
    invalid_rate: float
    wall_s: float
    batch_size: int = 1
    points_per_s: float = 0.0
    # corpus records handed to the agent before step 0 (surrogate warm
    # start from a persistent eval store); 0 for agents without one
    warm_start_points: int = 0

    def summary(self) -> dict[str, Any]:
        return {
            "agent": self.agent, "steps": self.steps,
            "best_reward": self.best_reward,
            "best_latency_ms": self.best_latency_ms,
            "steps_to_peak": self.steps_to_peak,
            "invalid_rate": round(self.invalid_rate, 4),
            "wall_s": round(self.wall_s, 2),
            "batch_size": self.batch_size,
            "points_per_s": round(self.points_per_s, 1),
        }


def run_search(pset: ParameterSet, env: CosmicEnv, agent_kind: str = "ga",
               steps: int = 500, seed: int = 0, batch_size: int = 1,
               workers: int = 0, warm_start: Any = None,
               **agent_hyper) -> SearchResult:
    """Explore ``steps`` design points.

    batch_size: population evaluated per agent round (1 = sequential).
    workers:    >1 fans distinct points of each batch out to a process pool.
    warm_start: optional (config, reward) records from prior campaigns
                (e.g. a persistent eval store); handed to the agent's
                ``warm_start()`` before step 0 when it has one — a
                surrogate agent starts with a trained predictor instead of
                burning its budget on warmup coverage.  Agents without a
                ``warm_start`` method ignore the records.
    """
    space = DesignSpace(pset)
    agent = make_agent(agent_kind, space, seed=seed, **agent_hyper)
    warm_n = 0
    if warm_start and hasattr(agent, "warm_start"):
        warm_n = agent.warm_start(warm_start)
    t0 = time.time()
    curve: list[float] = []
    best, best_step, best_lat = -np.inf, 0, float("inf")
    best_cfg = None
    n_invalid = 0
    i = 0
    # reap a pool this search causes to exist, but leave one the caller set
    # up (context-managed env) alone so it can amortize across searches
    caller_owns_pool = env.pool_is_caller_managed()
    try:
        while i < steps:
            n = min(max(batch_size, 1), steps - i)
            cfgs = agent.propose_batch(n)
            evs = env.step_batch(cfgs, workers=workers)
            agent.observe_batch(cfgs, [ev.reward for ev in evs])
            for cfg, ev in zip(cfgs, evs):
                n_invalid += not ev.valid
                if ev.reward > best:
                    best, best_step, best_cfg, best_lat = ev.reward, i, cfg, ev.latency_ms
                curve.append(best)
                i += 1
    finally:
        if workers > 1 and not caller_owns_pool:
            env.close()  # don't leak pool workers past the search
    wall = time.time() - t0
    return SearchResult(
        agent=agent_kind, steps=steps, best_reward=float(best),
        best_config=best_cfg, best_latency_ms=float(best_lat),
        steps_to_peak=best_step, reward_curve=curve,
        invalid_rate=n_invalid / max(steps, 1), wall_s=wall,
        batch_size=max(batch_size, 1),
        points_per_s=steps / max(wall, 1e-9),
        warm_start_points=warm_n,
    )
