"""Learned performance surrogates over eval-store corpora (CubicML-style).

Every agent in the repo pays one simulation per design point, which caps a
campaign at ~10^3-10^4 evaluations.  This module is the other half of the
trade: a cheap learned predictor of the reward surface, trained on the
(design point -> reward) corpora the eval stores already accumulate, that
can screen 10^4-10^5 candidate configurations per generation so only the
most promising slice pays a true simulation.

Three layers:

* **Featurization** — ``Featurizer`` turns a ``DesignSpace`` into a
  deterministic, signature-stable vector encoding: numeric knobs whose
  choice sets span a multiplicative range (parallelism degrees, NPUs per
  dim, chunks, bandwidths) are log2-scaled then min-max normalized over
  their declared choices; other numeric knobs are min-max normalized
  linearly; categorical knobs are one-hot over the PsA choice tuple.
  Scenario/engine/fleet stack parameters contribute features only when
  searched — pinned parameters have no genes, so they never leak into the
  encoding.  ``feature_signature()`` hashes the schema; datasets record it
  and every consumer checks it, so a corpus built for a different design
  space fails loudly instead of silently misfeaturizing.

* **Dataset building** — ``build_dataset`` ingests (config, reward)
  records from any source; ``store_records`` reads the JSONL persistent
  eval stores (``repro_torch.core.study.PersistentEvalStore`` files, keyed by
  ``StudySpec.eval_signature()``, torn-tail tolerant) and
  ``env_store_records`` reads a live in-memory ``CosmicEnv.eval_store``.

* **Predictors** — ``SURROGATE_REGISTRY`` holds small, pure-numpy, seeded
  models with a common fit/predict/uncertainty surface:
  ``ridge`` (random-Fourier-feature ridge regression with a Bayesian
  predictive variance) and ``knn`` (distance-weighted k-nearest-neighbour —
  the tree-free bagging alternative).  ``holdout_fidelity`` reports how
  well a model ranks unseen design points (Spearman rank correlation,
  top-k recall) — the number that decides whether a surrogate is safe to
  screen with.

The search-side consumer is ``repro_torch.core.agents.surrogate``.
"""
from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.space import DesignSpace

# ---------------------------------------------------------------------------
# Featurization
# ---------------------------------------------------------------------------

# numeric choice sets spanning at least this multiplicative range are
# log2-scaled (parallelism degrees, npus/bandwidth per dim, chunk counts);
# narrower ones (fractions, small enums) stay linear
_LOG_SCALE_RATIO = 8.0


def _gene_encoding(choices: tuple) -> tuple[str, int]:
    """(kind, width) for one gene's choice tuple.  kind: 'log2' | 'linear'
    | 'onehot' | 'const' (single choice — zero-width, schema-recorded)."""
    if len(choices) == 1:
        return "const", 0
    numeric = all(isinstance(v, (int, float)) and not isinstance(v, bool)
                  for v in choices)
    if not numeric:
        return "onehot", len(choices)
    vals = [float(v) for v in choices]
    if min(vals) > 0 and max(vals) / min(vals) >= _LOG_SCALE_RATIO:
        return "log2", 1
    return "linear", 1


class Featurizer:
    """Deterministic design-point -> feature-vector encoding for one
    ``DesignSpace``.  The encoding depends only on the space's gene list
    (slot order, choice tuples), so two processes building a Featurizer
    from equal ParameterSets produce identical vectors and signatures."""

    def __init__(self, space: DesignSpace,
                 expect_signature: "str | None" = None):
        self.space = space
        self._tables: list[np.ndarray] = []   # per gene: (n_choices, width)
        self.feature_names: list[str] = []
        schema: list[list] = []
        for g in space.genes:
            kind, width = _gene_encoding(g.choices)
            schema.append([g.slot, [str(v) for v in g.choices], kind])
            if kind == "onehot":
                tab = np.eye(len(g.choices))
                self.feature_names.extend(f"{g.slot}={v}" for v in g.choices)
            elif kind == "const":
                tab = np.zeros((len(g.choices), 0))
            else:
                vals = np.array([float(v) for v in g.choices])
                if kind == "log2":
                    vals = np.log2(vals)
                lo, hi = vals.min(), vals.max()
                tab = ((vals - lo) / (hi - lo))[:, None]
                self.feature_names.append(f"{g.slot}:{kind}")
            self._tables.append(tab)
        self._schema = schema
        self.signature = hashlib.sha256(
            json.dumps(schema, separators=(",", ":")).encode()
        ).hexdigest()[:16]
        if expect_signature is not None and expect_signature != self.signature:
            raise ValueError(
                f"feature-signature mismatch: this design space encodes as "
                f"{self.signature}, expected {expect_signature} — the "
                f"corpus was built for a different ParameterSet (changed "
                f"choices, pins, or scenario knobs)")
        self._offsets = np.cumsum([0] + [t.shape[1] for t in self._tables])
        self.n_features = int(self._offsets[-1])

    def feature_signature(self) -> str:
        return self.signature

    # -- encoding ---------------------------------------------------------
    def featurize_vecs(self, vecs: np.ndarray) -> np.ndarray:
        """(n, n_genes) index matrix -> (n, n_features) float matrix, fully
        vectorized (one gather per gene) — the screening-pool hot path."""
        vecs = np.asarray(vecs, dtype=np.int64)
        out = np.empty((vecs.shape[0], self.n_features))
        for i, tab in enumerate(self._tables):
            if tab.shape[1]:
                out[:, self._offsets[i]:self._offsets[i + 1]] = \
                    tab[vecs[:, i]]
        return out

    def featurize_configs(self,
                          configs: Sequence[Mapping[str, Any]]) -> np.ndarray:
        """Config dicts -> (n, n_features).  A config holding a value the
        schema has never seen (a different design space) fails loudly with
        the signature in the message."""
        vecs = np.empty((len(configs), len(self.space.genes)), dtype=np.int64)
        for r, cfg in enumerate(configs):
            try:
                vecs[r] = self.space.encode(dict(cfg))
            except KeyError as e:
                raise ValueError(
                    f"config cannot be featurized under schema "
                    f"{self.signature}: value/parameter {e} is not in this "
                    f"design space's choices — the record was built for a "
                    f"different ParameterSet") from None
        return self.featurize_vecs(vecs)

    def featurize(self, config: Mapping[str, Any]) -> np.ndarray:
        return self.featurize_configs([config])[0]


# ---------------------------------------------------------------------------
# Dataset building — in-memory env stores + JSONL persistent stores
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SurrogateDataset:
    """A featurized (design point -> reward) corpus, stamped with the
    feature schema it was encoded under."""
    X: np.ndarray
    y: np.ndarray
    configs: tuple
    feature_signature: str

    @property
    def n(self) -> int:
        return len(self.y)


def build_dataset(featurizer: Featurizer,
                  records: Iterable[tuple[Mapping[str, Any], float]]
                  ) -> SurrogateDataset:
    """Featurize (config, reward) records into a training corpus."""
    records = list(records)
    configs = tuple(dict(cfg) for cfg, _ in records)
    X = featurizer.featurize_configs(configs) if records \
        else np.zeros((0, featurizer.n_features))
    y = np.array([float(r) for _, r in records])
    return SurrogateDataset(X=X, y=y, configs=configs,
                            feature_signature=featurizer.signature)


def _freeze_value(v: Any) -> Any:
    return tuple(_freeze_value(x) for x in v) if isinstance(v, list) else v


def store_records(path: "str | Path", signature: "str | None" = None
                  ) -> list[tuple[dict[str, Any], float]]:
    """(config, reward) records from a JSONL persistent eval store
    (``PersistentEvalStore`` format), filtered to one
    ``StudySpec.eval_signature()`` when given.  Torn tails and malformed
    lines are skipped — the store is a cache, not a ledger.  JSON lists in
    configs are re-frozen to tuples so records round-trip through
    ``DesignSpace.encode``."""
    from repro_torch.core.study import iter_jsonl_lenient

    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"eval store {path} does not exist")
    out: list[tuple[dict[str, Any], float]] = []
    for rec in iter_jsonl_lenient(path):
        cfg = rec.get("config")
        if not isinstance(cfg, dict) or "reward" not in rec:
            continue
        if signature is not None and rec.get("sig") != signature:
            continue
        out.append(({k: _freeze_value(v) for k, v in cfg.items()},
                    float(rec["reward"])))
    return out


def env_store_records(store: Mapping[tuple, Any]
                      ) -> list[tuple[dict[str, Any], float]]:
    """(config, reward) records from a live in-memory eval store — either a
    shared ``CosmicEnv.eval_store`` (keys ``(env_signature, config_pairs)``)
    or a private memo (keys are the bare config pairs)."""
    out: list[tuple[dict[str, Any], float]] = []
    for key, ev in store.items():
        pairs = key
        if len(key) == 2 and not _looks_like_pairs(key):
            pairs = key[1]
        if not _looks_like_pairs(pairs):
            continue
        out.append((dict(pairs), float(ev.reward)))
    return out


def _looks_like_pairs(obj: Any) -> bool:
    return isinstance(obj, tuple) and len(obj) > 0 and all(
        isinstance(p, tuple) and len(p) == 2 and isinstance(p[0], str)
        for p in obj)


# ---------------------------------------------------------------------------
# Predictors
# ---------------------------------------------------------------------------

def _log_transform(y: np.ndarray) -> np.ndarray:
    """Rewards span orders of magnitude (and invalid points are exactly 0):
    fit in log space so ranking isn't dominated by the heavy tail.  The
    transform is monotone, so predicted scores stay rank-faithful to the
    raw reward."""
    return np.log(np.maximum(y, 0.0) + 1e-12)


class RidgeRFF:
    """Ridge regression on random Fourier features — a linear-cost GP
    stand-in.  fit: O(n·D + D^3) for D random features; predict gives a
    Bayesian predictive mean and epistemic std.  Seeded: the random feature
    bank is a pure function of (seed, n_features, lengthscale)."""

    name = "ridge"

    def __init__(self, seed: int = 0, n_features: int = 256,
                 lengthscale: "float | None" = None, l2: float = 1e-2,
                 log_target: bool = True):
        self.seed = seed
        self.n_features = n_features
        self.lengthscale = lengthscale
        self.l2 = l2
        self.log_target = log_target
        self._fitted = False

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RidgeRFF":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        t = _log_transform(y) if self.log_target else y
        self._xm = X.mean(axis=0)
        xs = X.std(axis=0)
        xs[xs == 0] = 1.0
        self._xs = xs
        self._tm, ts = t.mean(), t.std()
        self._ts = ts if ts > 0 else 1.0
        rng = np.random.default_rng(self.seed)
        d = self.n_features
        # default lengthscale ~ sqrt(dim): standardized points sit ~sqrt(2d)
        # apart, so a unit lengthscale would see every pair as infinitely
        # far and the kernel would flatline
        ls = self.lengthscale if self.lengthscale is not None \
            else math.sqrt(max(X.shape[1], 1))
        self._W = rng.normal(0.0, 1.0 / ls, (X.shape[1], d))
        self._b = rng.uniform(0.0, 2.0 * math.pi, d)
        phi = self._phi(X)
        tn = (t - self._tm) / self._ts
        A = phi.T @ phi + self.l2 * np.eye(d)
        self._L = np.linalg.cholesky(A)
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, phi.T @ tn))
        resid = phi @ self._alpha - tn
        self._sigma2 = float(resid @ resid) / max(len(tn), 1) + 1e-6
        self._fitted = True
        return self

    def _phi(self, X: np.ndarray) -> np.ndarray:
        Z = (np.asarray(X, dtype=np.float64) - self._xm) / self._xs
        return math.sqrt(2.0 / self.n_features) * np.cos(Z @ self._W + self._b)

    def predict(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(mean, std) per row.  Scores live in the model's (transformed,
        standardized-then-unstandardized) target space — monotone in the
        raw reward, which is all screening and rank fidelity need."""
        assert self._fitted, "predict() before fit()"
        out_m = np.empty(len(X))
        out_s = np.empty(len(X))
        for lo in range(0, len(X), 16384):   # bound memory on 10^5 pools
            phi = self._phi(X[lo:lo + 16384])
            out_m[lo:lo + 16384] = phi @ self._alpha * self._ts + self._tm
            v = np.linalg.solve(self._L, phi.T)
            out_s[lo:lo + 16384] = self._ts * np.sqrt(
                self._sigma2 * np.maximum((v * v).sum(axis=0), 1e-12))
        return out_m, out_s


class KNNSurrogate:
    """Distance-weighted k-nearest-neighbour with ARD feature relevance —
    the assumption-free alternative (no linearity, no feature bank).  Each
    feature dimension is scaled by its |Spearman| correlation with the
    target on the training set, so distances concentrate on the knobs that
    actually move the reward (in a ~45-dim one-hot-heavy encoding, an
    unweighted metric drowns the 3-4 load-bearing knobs in categorical
    noise — measured ρ 0.20 → 0.65+ on a 10^3-point gpt3-13b corpus).
    Default target is the in-corpus reward RANK: monotone (so screening
    order is unchanged) and immune to the reward's heavy tail + the
    invalid-point mass at exactly 0.  std is a heuristic: neighbour
    disagreement plus a distance term, so far-from-data candidates read as
    uncertain."""

    name = "knn"

    def __init__(self, seed: int = 0, k: int = 8, target: str = "rank",
                 ard: bool = True):
        self.seed = seed     # unused (deterministic), kept for the registry
        self.k = k
        assert target in ("rank", "log", "raw"), target
        self.target = target
        self.ard = ard
        self._fitted = False

    def fit(self, X: np.ndarray, y: np.ndarray) -> "KNNSurrogate":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self._xm = X.mean(axis=0)
        xs = X.std(axis=0)
        xs[xs == 0] = 1.0
        self._xs = xs
        Z = (X - self._xm) / xs
        t = {"rank": lambda v: _rankdata(v), "log": _log_transform,
             "raw": lambda v: v}[self.target](y)
        if self.ard and len(y) >= 8:
            # + a floor so a zero-relevance feature still breaks distance
            # ties (and an early small-corpus fit isn't all floor)
            w = np.array([abs(spearman(Z[:, j], t)) if xs0 > 0 else 0.0
                          for j, xs0 in enumerate(Z.std(axis=0))])
            w = np.where(np.isnan(w), 0.0, w) + 0.02
        else:
            w = np.ones(X.shape[1])
        self._w = w
        self._X = Z * w
        self._x2 = (self._X * self._X).sum(axis=1)
        self._t = t
        self._tstd = float(self._t.std()) or 1.0
        self._fitted = True
        return self

    def predict(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        assert self._fitted, "predict() before fit()"
        k = min(self.k, len(self._t))
        out_m = np.empty(len(X))
        out_s = np.empty(len(X))
        for lo in range(0, len(X), 4096):
            Z = ((np.asarray(X[lo:lo + 4096], dtype=np.float64)
                  - self._xm) / self._xs) * self._w
            # |a-b|^2 via the matmul identity — O(chunk x train) memory,
            # never the 3-D broadcast (that's GBs on a 10^4 screening pool)
            d2 = ((Z * Z).sum(axis=1)[:, None] + self._x2[None, :]
                  - 2.0 * (Z @ self._X.T))
            np.maximum(d2, 0.0, out=d2)
            idx = np.argpartition(d2, k - 1, axis=1)[:, :k]
            dk = np.sqrt(np.take_along_axis(d2, idx, axis=1))
            w = 1.0 / (dk + 1e-6)
            w /= w.sum(axis=1, keepdims=True)
            tk = self._t[idx]
            mean = (w * tk).sum(axis=1)
            var = (w * (tk - mean[:, None]) ** 2).sum(axis=1)
            out_m[lo:lo + 4096] = mean
            out_s[lo:lo + 4096] = np.sqrt(var) \
                + dk.mean(axis=1) * 0.1 * self._tstd
        return out_m, out_s


SURROGATE_REGISTRY: dict[str, Callable[..., Any]] = {
    "ridge": RidgeRFF,
    "knn": KNNSurrogate,
}


def make_surrogate(name: str, seed: int = 0, **kw) -> Any:
    if name not in SURROGATE_REGISTRY:
        raise ValueError(f"unknown surrogate model {name!r}; "
                         f"known: {sorted(SURROGATE_REGISTRY)}")
    return SURROGATE_REGISTRY[name](seed=seed, **kw)


def list_surrogates() -> dict[str, str]:
    return {name: (cls.__doc__ or "").strip().splitlines()[0]
            for name, cls in SURROGATE_REGISTRY.items()}


# ---------------------------------------------------------------------------
# Fidelity reporting
# ---------------------------------------------------------------------------

def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties share their mean rank) — enough Spearman
    machinery to stay scipy-free."""
    x = np.asarray(x, dtype=np.float64)
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x))
    ranks[order] = np.arange(1, len(x) + 1, dtype=np.float64)
    xs = x[order]
    i = 0
    while i < len(xs):
        j = i
        while j + 1 < len(xs) and xs[j + 1] == xs[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return ranks


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation (Pearson over average ranks)."""
    if len(a) < 2:
        return float("nan")
    ra, rb = _rankdata(a), _rankdata(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = math.sqrt(float(ra @ ra) * float(rb @ rb))
    return float(ra @ rb) / denom if denom > 0 else float("nan")


def holdout_fidelity(model_name: str, X: np.ndarray, y: np.ndarray, *,
                     holdout_frac: float = 0.25, top_frac: float = 0.1,
                     seed: int = 0, **model_kw) -> dict[str, Any]:
    """Fit on a shuffled train split, score the held-out rest: Spearman
    rank correlation between predicted score and true reward, plus top-k
    recall (fraction of the holdout's true top-k the predictor also ranks
    top-k — the quantity screening actually relies on)."""
    X = np.asarray(X)
    y = np.asarray(y, dtype=np.float64)
    n = len(y)
    if n < 8:
        raise ValueError(f"fidelity report needs >= 8 points, got {n}")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_hold = max(2, int(round(holdout_frac * n)))
    hold, train = perm[:n_hold], perm[n_hold:]
    model = make_surrogate(model_name, seed=seed, **model_kw)
    model.fit(X[train], y[train])
    pred, _ = model.predict(X[hold])
    rho = spearman(pred, y[hold])
    k = max(1, int(round(top_frac * n_hold)))
    true_top = set(np.argsort(-y[hold], kind="stable")[:k].tolist())
    pred_top = set(np.argsort(-pred, kind="stable")[:k].tolist())
    return {"model": model_name, "n_train": int(len(train)),
            "n_holdout": int(n_hold), "spearman": rho,
            "top_k": k, "topk_recall": len(true_top & pred_top) / k}
