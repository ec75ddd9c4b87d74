"""Agent interface.  The PSS hands every agent the same synthesized
DesignSpace — agents are domain-blind by construction (the paper's
'separation of concerns' principle)."""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from repro_torch.core.space import DesignSpace


class Agent:
    name = "agent"

    def __init__(self, space: DesignSpace, seed: int = 0):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.best_reward = -np.inf
        self.best_config: dict[str, Any] | None = None

    def propose(self) -> dict[str, Any]:
        raise NotImplementedError

    def observe(self, config: dict[str, Any], reward: float) -> None:
        if reward > self.best_reward:
            self.best_reward = reward
            self.best_config = config

    # -- population API ----------------------------------------------------
    # The batched DSE driver asks for a whole population, evaluates it (with
    # memoization / a process pool), then feeds back every reward at once.
    # Defaults fall back to the scalar methods, so ``propose_batch(1)`` /
    # ``observe_batch([c], [r])`` consume the RNG and mutate state exactly
    # like one sequential propose/observe round.

    def propose_batch(self, n: int) -> list[dict[str, Any]]:
        return [self.propose() for _ in range(n)]

    def observe_batch(self, configs: Sequence[dict[str, Any]],
                      rewards: Sequence[float]) -> None:
        for config, reward in zip(configs, rewards):
            self.observe(config, reward)


# the registered agent kinds, importable without the agent modules (StudySpec
# validates agent grids at spec time, before any search machinery loads)
KNOWN_AGENTS = ("rw", "ga", "aco", "bo", "surrogate")

# hyper names each kind's __init__ accepts (beyond space/seed) — the spec
# layer rejects unknown keys at spec time instead of TypeError'ing cells
# deep into a campaign; a sync assert in make_agent keeps this honest
AGENT_HYPER: dict[str, frozenset[str]] = {
    "rw": frozenset({"population"}),
    "ga": frozenset({"population", "p_mut", "tournament"}),
    "aco": frozenset({"ants", "greediness", "evaporation", "deposit"}),
    "bo": frozenset({"n_init", "candidates", "lengthscale", "noise",
                     "max_fit"}),
    "surrogate": frozenset({"model", "pool", "explore", "warmup", "elite",
                            "p_mut", "random_frac", "max_fit"}),
}


def make_agent(kind: str, space: DesignSpace, seed: int = 0, **hyper) -> Agent:
    from repro_torch.core.agents.aco import AntColony
    from repro_torch.core.agents.bayesian import BayesianOptimizer
    from repro_torch.core.agents.genetic import GeneticAlgorithm
    from repro_torch.core.agents.random_walk import RandomWalker
    from repro_torch.core.agents.surrogate import SurrogateScreeningAgent

    kinds = {"rw": RandomWalker, "ga": GeneticAlgorithm,
             "aco": AntColony, "bo": BayesianOptimizer,
             "surrogate": SurrogateScreeningAgent}
    assert set(kinds) == set(KNOWN_AGENTS) == set(AGENT_HYPER), \
        "KNOWN_AGENTS/AGENT_HYPER out of sync with make_agent's registry"
    if kind not in kinds:
        raise ValueError(f"unknown agent kind {kind!r}; "
                         f"known: {sorted(kinds)}")
    return kinds[kind](space, seed=seed, **hyper)
