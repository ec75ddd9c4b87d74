"""Random Walker (Pearson, 1905): history-free uniform exploration — the
paper's baseline agent."""
from __future__ import annotations

from typing import Any

from repro_torch.core.agents.base import Agent


class RandomWalker(Agent):
    name = "rw"

    def __init__(self, space, seed: int = 0, population: int = 1):
        super().__init__(space, seed)
        self.population = population  # paper knob: number of walkers (batch)

    def propose(self) -> dict[str, Any]:
        return self.space.sample(self.rng)

    # The inherited propose_batch(n) is n independent walkers; proposals are
    # history-free, so batched and sequential searches coincide at every
    # step for any batch size.
