"""Genetic algorithm: tournament selection + uniform crossover + mutation,
with constraint repair from the PSS (paper knobs: population size, mutation
probability)."""
from __future__ import annotations

from typing import Any

from repro_torch.core.agents.base import Agent


class GeneticAlgorithm(Agent):
    name = "ga"

    def __init__(self, space, seed: int = 0, population: int = 32,
                 p_mut: float = 0.15, tournament: int = 3):
        super().__init__(space, seed)
        self.pop_size = population
        self.p_mut = p_mut
        self.tournament = tournament
        self.pop: list[tuple[float, dict[str, Any]]] = []

    def _select(self) -> dict[str, Any]:
        idx = self.rng.integers(len(self.pop), size=min(self.tournament, len(self.pop)))
        best = max((self.pop[i] for i in idx), key=lambda t: t[0])
        return best[1]

    def propose(self) -> dict[str, Any]:
        if len(self.pop) < self.pop_size:
            return self.space.sample(self.rng)
        a, b = self._select(), self._select()
        child = self.space.crossover(a, b, self.rng)
        return self.space.mutate(child, self.rng, self.p_mut)

    def observe(self, config: dict[str, Any], reward: float) -> None:
        super().observe(config, reward)
        self.pop.append((reward, config))
        if len(self.pop) > self.pop_size:
            self.pop.sort(key=lambda t: t[0], reverse=True)
            self.pop = self.pop[: self.pop_size]

    # The inherited population API already realizes whole-generation GA:
    # propose only reads the current population (never mid-batch rewards),
    # so propose_batch(n) breeds one generation, and the per-individual
    # trims in observe_batch keep exactly the top-pop_size survivors.
