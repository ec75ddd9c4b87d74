"""Surrogate-guided screening agent (CubicML-style).

Every other agent pays one true simulation per design point it looks at.
This one decouples *looking* from *paying*: each generation it draws a
large raw candidate pool from the ``DesignSpace`` (vectorized — 10^4-10^5
decodes cost milliseconds, see ``DesignSpace.raw_decode_batch``), scores
the pool through a cheap learned predictor of the reward surface
(``repro_torch.core.surrogate``), and sends only the top-scoring slice to
``CosmicEnv.step_batch`` for true simulation.  The predictor refits online
as observations arrive, and ``warm_start()`` seeds it from a persistent
eval store's corpus before the first step — so a campaign that already
burned 10^3 simulations hands the next one a trained model for free.

Screening score is UCB-style: ``predicted_mean + explore * predicted_std``
— the uncertainty term keeps the agent from strip-mining one basin the
early model happens to like.  A small ``random_frac`` of every batch
bypasses the model entirely (insurance against a confidently-wrong
surrogate), and a mutant cloud around the elite observed configs keeps the
pool dense near the incumbent basin (raw uniform decodes alone almost
never land next to a good point in a 10^9-point space).

Fully deterministic under a fixed seed: one ``numpy`` Generator drives
pool draws, mutants, and random slots in a fixed order, and each refit
rebuilds the predictor from the same seed — so resuming a study re-runs a
cell bit-identically.
"""
from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np

from repro_torch.core.agents.base import Agent
from repro_torch.core.surrogate import Featurizer, make_surrogate


def _key(config: dict[str, Any]) -> tuple:
    return tuple(sorted(config.items()))


class SurrogateScreeningAgent(Agent):
    name = "surrogate"

    def __init__(self, space, seed: int = 0, model: str = "knn",
                 pool: int = 8192, explore: float = 0.1, warmup: int = 32,
                 elite: int = 4, p_mut: float = 0.15,
                 random_frac: float = 0.0625, max_fit: int = 2048):
        super().__init__(space, seed)
        self.model_name = model
        self.pool = int(pool)
        self.explore = float(explore)
        self.warmup = int(warmup)
        self.elite = int(elite)
        self.p_mut = float(p_mut)
        self.random_frac = float(random_frac)
        self.max_fit = int(max_fit)
        self._model_seed = seed
        self.featurizer = Featurizer(space)
        # training corpus: configs, cached feature rows, rewards
        self._cfgs: list[dict[str, Any]] = []
        self._X: list[np.ndarray] = []
        self._y: list[float] = []
        self._seen: set[tuple] = set()
        self._model: Any = None
        self._dirty = True
        self.warm_start_points = 0

    # -- corpus ------------------------------------------------------------
    def _add(self, config: dict[str, Any], reward: float) -> None:
        self._cfgs.append(config)
        self._X.append(self.featurizer.featurize(config))
        self._y.append(float(reward))
        self._seen.add(_key(config))
        self._dirty = True

    def warm_start(self,
                   records: Iterable[tuple[dict[str, Any], float]]) -> int:
        """Seed the corpus from (config, reward) records of a prior
        campaign (same ``eval_signature()`` => same design space, so a
        record that doesn't featurize raises the Featurizer's loud
        mismatch error).  Warm points train the model and count as seen —
        the search budget goes to new designs — but never claim
        ``best_config``: that must be earned by a simulation this search
        actually ran."""
        n0 = len(self._cfgs)
        for cfg, reward in records:
            cfg = dict(cfg)
            if _key(cfg) in self._seen:
                continue
            self._add(cfg, reward)
        self.warm_start_points += len(self._cfgs) - n0
        return len(self._cfgs) - n0

    def _refit(self) -> None:
        if not self._dirty and self._model is not None:
            return
        X = np.asarray(self._X[-self.max_fit:])
        y = np.asarray(self._y[-self.max_fit:])
        self._model = make_surrogate(self.model_name, seed=self._model_seed)
        self._model.fit(X, y)
        self._dirty = False

    # -- proposals ---------------------------------------------------------
    def propose(self) -> dict[str, Any]:
        return self.propose_batch(1)[0]

    def propose_batch(self, n: int) -> list[dict[str, Any]]:
        if len(self._cfgs) < self.warmup:
            # not enough corpus to trust a fit — spend the round on
            # uniform coverage (this also feeds the first fit a spread-out
            # design, not a cluster)
            return self.space.sample_batch(n, self.rng)
        self._refit()
        # candidate pool: vectorized raw decodes, validity-masked ...
        raw = self.space.raw_decode_batch(self.pool, self.rng)
        cand = raw[self.space.valid_mask(raw)]
        # ... plus a mutant cloud around the elite observed configs
        order = np.argsort(-np.asarray(self._y), kind="stable")
        elites = [self._cfgs[i] for i in order[:max(self.elite, 1)]]
        mutants = np.empty((4 * n, raw.shape[1]), dtype=np.int64)
        for i in range(4 * n):
            m = self.space.mutate(elites[i % len(elites)], self.rng,
                                  self.p_mut)
            mutants[i] = self.space.encode(m)
        cand = np.concatenate([cand, mutants]) if len(cand) else mutants
        # screen: UCB score over the whole pool through the predictor
        mu, sd = self._model.predict(self.featurizer.featurize_vecs(cand))
        score = mu + self.explore * sd
        rank = np.argsort(-score, kind="stable")
        n_rand = min(n, int(round(self.random_frac * n)))
        picked: list[dict[str, Any]] = []
        pk: set[tuple] = set()
        for lo in range(0, len(rank), max(4 * n, 64)):
            for cfg in self.space.decode_batch(
                    cand[rank[lo:lo + max(4 * n, 64)]]):
                k = _key(cfg)
                if k in self._seen or k in pk:
                    continue
                picked.append(cfg)
                pk.add(k)
                if len(picked) >= n - n_rand:
                    break
            if len(picked) >= n - n_rand:
                break
        # random slots: insurance against a confidently-wrong model (and
        # the fill when the screened pool dedupes dry)
        while len(picked) < n:
            picked.append(self.space.sample(self.rng))
        return picked

    def observe(self, config: dict[str, Any], reward: float) -> None:
        super().observe(config, reward)
        self._add(config, reward)

    def observe_batch(self, configs: Sequence[dict[str, Any]],
                      rewards: Sequence[float]) -> None:
        for config, reward in zip(configs, rewards):
            self.observe(config, reward)
