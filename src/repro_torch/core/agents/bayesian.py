"""Bayesian optimization: numpy Gaussian-process surrogate (RBF kernel) +
expected-improvement acquisition over a sampled candidate pool.  The paper
randomizes the surrogate's seed; we expose it plus the usual GP knobs."""
from __future__ import annotations

import math
from typing import Any

import numpy as np

from repro_torch.core.agents.base import Agent


def _rbf(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / (ls * ls))


class BayesianOptimizer(Agent):
    name = "bo"

    def __init__(self, space, seed: int = 0, n_init: int = 16,
                 candidates: int = 128, lengthscale: float = 0.35,
                 noise: float = 1e-4, max_fit: int = 256):
        super().__init__(space, seed)
        self.n_init = n_init
        self.cands = candidates
        self.ls = lengthscale
        self.noise = noise
        self.max_fit = max_fit
        self.X: list[np.ndarray] = []
        self.y: list[float] = []

    def propose(self) -> dict[str, Any]:
        return self._propose_q(1)[0]

    # -- population API: q-batch expected improvement -----------------------
    # One GP fit amortizes over the whole batch (the cubic Cholesky is BO's
    # bottleneck); the top-q pool candidates by EI form the batch.
    def propose_batch(self, n: int) -> list[dict[str, Any]]:
        return self._propose_q(n)

    def _propose_q(self, q: int) -> list[dict[str, Any]]:
        if len(self.X) < self.n_init:
            return [self.space.sample(self.rng) for _ in range(q)]
        X = np.array(self.X[-self.max_fit:])
        y = np.array(self.y[-self.max_fit:])
        mu, sd = y.mean(), y.std() + 1e-9
        yn = (y - mu) / sd
        K = _rbf(X, X, self.ls) + self.noise * np.eye(len(X))
        try:
            L = np.linalg.cholesky(K)
        except np.linalg.LinAlgError:
            return [self.space.sample(self.rng) for _ in range(q)]
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))

        n_pool = max(self.cands, q)
        pool = [self.space.sample(self.rng) for _ in range(n_pool)]
        Z = np.array([self.space.normalize(self.space.encode(c)) for c in pool])
        Ks = _rbf(Z, X, self.ls)
        mean = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.maximum(1.0 - (v * v).sum(0), 1e-12)
        std = np.sqrt(var)
        fbest = yn.max()
        z = (mean - fbest) / std
        ei = std * (z * _ncdf(z) + _npdf(z))
        order = np.argsort(-ei, kind="stable")[:q]
        return [pool[int(i)] for i in order]

    def observe(self, config: dict[str, Any], reward: float) -> None:
        super().observe(config, reward)
        self.X.append(self.space.normalize(self.space.encode(config)))
        self.y.append(reward)


def _ncdf(z):
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def _npdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
