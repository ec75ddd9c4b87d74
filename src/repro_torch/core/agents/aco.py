"""Ant colony optimization (Dorigo & Di Caro, 1999) over the gene lattice:
pheromone per (gene, choice); paper knobs: number of ants, greediness q0,
evaporation rate rho."""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core.agents.base import Agent


class AntColony(Agent):
    name = "aco"

    def __init__(self, space, seed: int = 0, ants: int = 16,
                 greediness: float = 0.2, evaporation: float = 0.05,
                 deposit: float = 1.0):
        super().__init__(space, seed)
        self.q0 = greediness
        self.rho = evaporation
        self.deposit = deposit
        self.ants = ants
        self.tau = [np.ones(len(g.choices)) for g in space.genes]

    def propose(self) -> dict[str, Any]:
        vec = []
        for i, g in enumerate(self.space.genes):
            t = self.tau[i]
            if self.rng.random() < self.q0:
                vec.append(int(np.argmax(t)))
            else:
                p = t / t.sum()
                vec.append(int(self.rng.choice(len(t), p=p)))
        config = self.space.repair(self.space.decode(vec), self.rng)
        if not self.space.is_valid(config):
            config = self.space.sample(self.rng)
        return config

    # The inherited population API already realizes colony semantics: tau is
    # only touched on observe, so propose_batch(n) walks n ants over the
    # same pheromone field and observe_batch evaporates/deposits per ant.

    def observe(self, config: dict[str, Any], reward: float) -> None:
        super().observe(config, reward)
        vec = self.space.encode(config)
        rel = reward / (abs(self.best_reward) + 1e-30) if self.best_reward > 0 else 0.0
        for i, choice in enumerate(vec):
            self.tau[i] *= (1.0 - self.rho)
            # elitist deposit: only near-best ants lay pheromone, weighted
            # superlinearly so mediocre trails fade
            if rel >= 0.8:
                self.tau[i][choice] += self.deposit * rel * rel
            self.tau[i] = np.maximum(self.tau[i], 1e-6)
