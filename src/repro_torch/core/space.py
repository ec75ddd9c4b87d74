"""Parameter Set Scheduler (PSS): PsA schema -> agent-ready design space.

The paper's PSS "automatically establishes the abstraction layer between
agents and the design space" (Section 4.3): it synthesizes the action space
(one categorical gene per scalar slot), encodes/decodes configurations,
samples valid points under the declared constraints, and repairs invalid
proposals — so agents never need domain knowledge and experts never touch
agent internals.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterable, Sequence

import numpy as np

from repro_torch.core.psa import Constraint, Parameter, ParameterSet


@dataclass(frozen=True)
class Gene:
    """One scalar slot of the action space."""
    slot: str          # e.g. 'dp' or 'coll_algo[2]'
    param: str         # owning parameter name
    dim: int           # slot index within a multidim parameter
    choices: tuple


class DesignSpace:
    """The synthesized action space for one ParameterSet."""

    def __init__(self, pset: ParameterSet):
        self.pset = pset
        self.genes: list[Gene] = []
        for p in pset.params:
            if p.name in pset.fixed:
                continue
            for d in range(p.ndim):
                self.genes.append(Gene(p.slots[d], p.name, d, p.choices))
        self._index = {g.slot: i for i, g in enumerate(self.genes)}
        # per-gene metadata resolved once (encode/decode sit on the agents'
        # batched hot path): owning Parameter, scalar-slot flag, choice index
        self._gene_param = [pset.by_name(g.param) for g in self.genes]
        self._gene_scalar = [p.ndim == 1 for p in self._gene_param]
        self._gene_choice_idx = [{v: i for i, v in enumerate(g.choices)}
                                 for g in self.genes]
        # batch-sampling tables: per-gene cardinality vector and object-dtype
        # choice arrays (object dtype so a vectorized gather hands back the
        # ORIGINAL python values — decode_batch must be bit-identical to
        # decode, numpy scalar types included)
        self._gene_sizes = np.array([len(g.choices) for g in self.genes],
                                    dtype=np.int64)
        self._gene_values: list[np.ndarray] = []
        for g in self.genes:
            arr = np.empty(len(g.choices), dtype=object)
            arr[:] = g.choices
            self._gene_values.append(arr)

    # -- config <-> vector ----------------------------------------------
    def n_genes(self) -> int:
        return len(self.genes)

    def encode(self, config: dict[str, Any]) -> np.ndarray:
        """config -> integer index vector (one index per gene)."""
        vec = np.zeros(len(self.genes), dtype=np.int64)
        for i, g in enumerate(self.genes):
            val = config[g.param] if g.dim == 0 and self._gene_scalar[i] \
                else config[g.param][g.dim]
            vec[i] = self._gene_choice_idx[i][val]
        return vec

    def decode(self, vec: Sequence[int]) -> dict[str, Any]:
        config: dict[str, Any] = dict(self.pset.fixed)
        tmp: dict[str, list] = {}
        for i, g in enumerate(self.genes):
            val = g.choices[int(vec[i]) % len(g.choices)]
            if self._gene_scalar[i]:
                config[g.param] = val
            else:
                tmp.setdefault(g.param, [None] * self._gene_param[i].ndim)[g.dim] = val
        for k, v in tmp.items():
            config[k] = tuple(v)
        return config

    def normalize(self, vec: Sequence[int]) -> np.ndarray:
        """index vector -> [0,1]^n floats (for BO surrogates)."""
        out = np.zeros(len(self.genes))
        for i, g in enumerate(self.genes):
            out[i] = vec[i] / max(len(g.choices) - 1, 1)
        return out

    # -- validity ----------------------------------------------------------
    def _slot_value(self, config: dict[str, Any], slot: str):
        if "[" in slot:
            base, idx = slot[:-1].split("[")
            return config[base][int(idx)]
        return config[slot]

    def is_valid(self, config: dict[str, Any]) -> bool:
        for c in self.pset.constraints:
            if not self._check(config, c):
                return False
        return True

    def violations(self, config: dict[str, Any]) -> list[str]:
        return [c.describe() for c in self.pset.constraints if not self._check(config, c)]

    def _check(self, config: dict[str, Any], c: Constraint) -> bool:
        if c.kind == "predicate":
            return bool(c.fn(config))
        slots = self.pset.expand_constraint_params(c)
        target = config[c.target] if isinstance(c.target, str) else c.target
        if c.kind == "sum_le":
            return sum(self._slot_value(config, s) for s in slots) <= target
        prod = 1
        for s in slots:
            prod *= self._slot_value(config, s)
        if c.kind == "product_eq":
            return prod == target
        if c.kind == "product_le":
            return prod <= target
        raise ValueError(c.kind)

    # -- batch sampling ------------------------------------------------------
    # The raw-decode probe machinery (the lint's) vectorized: one broadcast
    # ``rng.integers(0, sizes, size=(n, G))`` block is draw-for-draw
    # identical to n repeated config-major scalar loops
    # ``[int(rng.integers(len(g.choices))) for g in genes]`` (numpy's
    # bounded-integer path consumes the bit stream element by element in
    # C order), so batched and scalar probes share one seed policy.

    def raw_decode_batch(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """(n, n_genes) raw index matrix — unconstrained uniform decodes.
        Stream-identical to n repeated scalar raw draws from the same rng."""
        if not self.genes:
            return np.zeros((n, 0), dtype=np.int64)
        return rng.integers(0, self._gene_sizes, size=(n, len(self.genes)),
                            dtype=np.int64)

    def decode_batch(self, vecs: np.ndarray) -> list[dict[str, Any]]:
        """Vectorized ``decode`` over an (n, n_genes) index matrix: one
        object-dtype gather per gene, then per-row dict assembly.  Row i is
        bit-identical to ``decode(vecs[i])``."""
        vecs = np.asarray(vecs, dtype=np.int64) % self._gene_sizes
        cols = [self._gene_values[i][vecs[:, i]]
                for i in range(len(self.genes))]
        out: list[dict[str, Any]] = []
        for r in range(vecs.shape[0]):
            config: dict[str, Any] = dict(self.pset.fixed)
            tmp: dict[str, list] = {}
            for i, g in enumerate(self.genes):
                if self._gene_scalar[i]:
                    config[g.param] = cols[i][r]
                else:
                    tmp.setdefault(
                        g.param,
                        [None] * self._gene_param[i].ndim)[g.dim] = cols[i][r]
            for k, v in tmp.items():
                config[k] = tuple(v)
            out.append(config)
        return out

    def _slot_column(self, vecs: np.ndarray, slot: str) -> "np.ndarray | None":
        """One slot's numeric value column over an index matrix; None when
        the slot's values are non-numeric (vectorized checks then fall back
        to the scalar path)."""
        if slot in self._index:
            gi = self._index[slot]
            vals = self.genes[gi].choices
            if not all(isinstance(v, (int, float)) for v in vals):
                return None
            return np.asarray(vals, dtype=np.float64)[vecs[:, gi]]
        # a fixed (pinned) slot: constant column
        base, idx = (slot[:-1].split("[") + ["0"])[:2] if "[" in slot \
            else (slot, None)
        if base not in self.pset.fixed:
            return None
        v = self.pset.fixed[base]
        if idx is not None:
            v = v[int(idx)]
        if not isinstance(v, (int, float)):
            return None
        return np.full(vecs.shape[0], float(v))

    def constraint_mask(self, vecs: np.ndarray, c: Constraint) -> np.ndarray:
        """Vectorized ``_check`` over an (n, n_genes) index matrix: True per
        row where the constraint holds.  product/sum constraints over
        numeric slots run as column arithmetic; predicate constraints (and
        non-numeric slots) fall back to per-row decode + scalar check."""
        n = vecs.shape[0]
        if c.kind != "predicate":
            cols = [self._slot_column(vecs, s)
                    for s in self.pset.expand_constraint_params(c)]
            target = self._slot_column(vecs, c.target) \
                if isinstance(c.target, str) else np.full(n, float(c.target))
            if target is not None and all(col is not None for col in cols):
                stacked = np.stack(cols) if cols else np.zeros((0, n))
                if c.kind == "sum_le":
                    return stacked.sum(axis=0) <= target
                prod = stacked.prod(axis=0) if cols else np.ones(n)
                if c.kind == "product_eq":
                    return prod == target
                if c.kind == "product_le":
                    return prod <= target
                raise ValueError(c.kind)
        return np.array([self._check(cfg, c)
                         for cfg in self.decode_batch(vecs)], dtype=bool)

    def valid_mask(self, vecs: np.ndarray) -> np.ndarray:
        """Row-wise ``is_valid`` over an (n, n_genes) index matrix."""
        mask = np.ones(vecs.shape[0], dtype=bool)
        for c in self.pset.constraints:
            mask &= self.constraint_mask(vecs, c)
        return mask

    def sample_batch(self, n: int,
                     rng: np.random.Generator) -> list[dict[str, Any]]:
        """n valid samples, vectorized where it counts — drawing a 10^5
        screening pool must not dominate a search generation.

        Seed policy (documented + pinned by test): the raw decodes come
        from ONE broadcast integer block that consumes the rng exactly like
        n repeated scalar ``sample`` raw draws; a row whose raw decode
        already satisfies every constraint is returned as-is — so over a
        constraint-free space ``sample_batch(n, rng)`` is bit-identical to
        ``[space.sample(rng) for _ in range(n)]``.  Rows that need work go
        through ``sample``'s own repair-then-resample path per row (in row
        order, after the block), so constrained spaces stay deterministic
        per (seed, n) but diverge from the interleaved scalar stream."""
        vecs = self.raw_decode_batch(n, rng)
        mask = self.valid_mask(vecs)
        out: list[dict[str, Any] | None] = [None] * n
        if mask.any():
            decoded = self.decode_batch(vecs[mask])
            for j, i in enumerate(np.flatnonzero(mask)):
                out[i] = decoded[j]
        for i in np.flatnonzero(~mask):
            cfg = self.repair(self.decode(vecs[i]), rng)
            out[i] = cfg if self.is_valid(cfg) else self.sample(rng)
        return out  # type: ignore[return-value]

    # -- sampling / repair ---------------------------------------------------
    def sample(self, rng: np.random.Generator, max_tries: int = 512) -> dict[str, Any]:
        """Uniform valid sample: rejection + constraint-aware repair.

        An infeasible (or near-infeasible) space raises with the constraints
        that kept failing, so a bad PsA restriction — e.g. a StudySpec
        pinning values no constraint-satisfying config can contain — is
        debuggable instead of a bare 'could not sample'."""
        fail_counts: dict[str, int] = {}
        for _ in range(max_tries):
            vec = [int(rng.integers(len(g.choices))) for g in self.genes]
            config = self.decode(vec)
            config = self.repair(config, rng)
            violated = self.violations(config)
            if not violated:
                return config
            for v in violated:
                fail_counts[v] = fail_counts.get(v, 0) + 1
        worst = sorted(fail_counts.items(), key=lambda kv: -kv[1])
        detail = "; ".join(f"{name} (violated in {n}/{max_tries} tries)"
                           for name, n in worst[:4])
        raise RuntimeError(
            f"could not sample a valid config for {self.pset.name} in "
            f"{max_tries} tries — persistent constraint violations: {detail}."
            f" Check the fixed/pinned values against these constraints.")

    def constraint_violation_rates(self, rng: np.random.Generator,
                                   tries: int = 256) -> dict[str, float]:
        """Per-constraint violation fraction over raw uniform decodes (no
        repair) — the satisfiability probe ``repro_torch.core.analysis.lint_pset``
        uses to tell an unsatisfiable constraint (rate 1.0) from one the
        repair path merely has to work at."""
        vecs = self.raw_decode_batch(tries, rng)  # stream-identical to the
        counts: dict[str, int] = {}               # old scalar probe loop
        for c in self.pset.constraints:
            counts[c.describe()] = int(tries - self.constraint_mask(vecs, c).sum())
        return {name: n / max(tries, 1) for name, n in counts.items()}

    def repair(self, config: dict[str, Any], rng: np.random.Generator,
               max_tries: int = 64) -> dict[str, Any]:
        """Project a config toward the feasible set by resampling the slots
        participating in each violated constraint."""
        config = dict(config)
        for c in self.pset.constraints:
            tries = 0
            while not self._check(config, c) and tries < max_tries:
                tries += 1
                slots = [s for s in self.pset.expand_constraint_params(c)
                         if self._slot_mutable(s)]
                if not slots:
                    break
                if c.kind in ("product_eq", "product_le") and self._try_factor_repair(config, c, rng):
                    continue
                if c.kind == "sum_le" and self._try_sum_repair(config, c, rng):
                    continue
                s = slots[int(rng.integers(len(slots)))]
                self._set_slot(config, s, self._random_choice(s, rng))
        return config

    def _slot_mutable(self, slot: str) -> bool:
        base = slot.split("[")[0]
        return base not in self.pset.fixed and base in {g.param for g in self.genes}

    def _random_choice(self, slot: str, rng: np.random.Generator):
        g = self.genes[self._index[slot]]
        return g.choices[int(rng.integers(len(g.choices)))]

    def _set_slot(self, config: dict[str, Any], slot: str, value):
        if "[" in slot:
            base, idx = slot[:-1].split("[")
            vals = list(config[base])
            vals[int(idx)] = value
            config[base] = tuple(vals)
        else:
            config[slot] = value

    def _try_factor_repair(self, config: dict[str, Any], c: Constraint,
                           rng: np.random.Generator) -> bool:
        """Exact repair for product constraints over power-of-two-ish slots:
        sample a random factorization of the target across the slots."""
        target = config[c.target] if isinstance(c.target, str) else c.target
        slots = [s for s in self.pset.expand_constraint_params(c) if self._slot_mutable(s)]
        if not slots or target <= 0:
            return False
        for _ in range(32):
            vals = {}
            rem = target
            order = list(slots)
            rng.shuffle(order)
            ok = True
            for i, s in enumerate(order):
                g = self.genes[self._index[s]]
                divisors = [v for v in g.choices
                            if isinstance(v, int) and v >= 1 and rem % v == 0]
                if c.kind == "product_le":
                    divisors = [v for v in g.choices
                                if isinstance(v, int) and 1 <= v <= rem]
                if not divisors:
                    ok = False
                    break
                v = divisors[int(rng.integers(len(divisors)))]
                vals[s] = v
                if c.kind == "product_eq":
                    if i == len(order) - 1 and rem // v != 1:
                        # force the last slot to close the product if possible
                        if rem in g.choices:
                            vals[s] = rem
                            v = rem
                        else:
                            ok = False
                            break
                    rem //= v
                else:
                    rem = max(rem // v, 1)
            if ok:
                for s, v in vals.items():
                    self._set_slot(config, s, v)
                if self._check(config, c):
                    return True
        return False

    def _try_sum_repair(self, config: dict[str, Any], c: Constraint,
                        rng: np.random.Generator) -> bool:
        """Exact repair for sum budgets (partition sizes): greedily resample
        each slot from the choices that still fit the remaining budget."""
        target = config[c.target] if isinstance(c.target, str) else c.target
        all_slots = self.pset.expand_constraint_params(c)
        slots = [s for s in all_slots if self._slot_mutable(s)]
        if not slots:
            return False
        # immutable (fixed) slots spend budget the repair can't touch
        budget = target - sum(
            v for s in all_slots if not self._slot_mutable(s)
            and isinstance((v := self._slot_value(config, s)), (int, float)))
        for _ in range(32):
            rem = budget
            vals = {}
            order = list(slots)
            rng.shuffle(order)
            ok = True
            for s in order:
                g = self.genes[self._index[s]]
                fitting = [v for v in g.choices
                           if isinstance(v, (int, float)) and v <= rem]
                if not fitting:
                    ok = False
                    break
                v = fitting[int(rng.integers(len(fitting)))]
                vals[s] = v
                rem -= v
            if ok:
                for s, v in vals.items():
                    self._set_slot(config, s, v)
                if self._check(config, c):
                    return True
        return False

    # -- neighborhood (for GA mutation / local search) -----------------------
    def mutate(self, config: dict[str, Any], rng: np.random.Generator,
               p_mut: float = 0.15) -> dict[str, Any]:
        vec = self.encode(config)
        for i, g in enumerate(self.genes):
            if rng.random() < p_mut:
                vec[i] = int(rng.integers(len(g.choices)))
        out = self.repair(self.decode(vec), rng)
        return out if self.is_valid(out) else self.sample(rng)

    def crossover(self, a: dict[str, Any], b: dict[str, Any],
                  rng: np.random.Generator) -> dict[str, Any]:
        va, vb = self.encode(a), self.encode(b)
        mask = rng.integers(0, 2, size=len(va)).astype(bool)
        child = np.where(mask, va, vb)
        out = self.repair(self.decode(child), rng)
        return out if self.is_valid(out) else self.sample(rng)


def constrained_parallelization_count(n_npus: int, dims: int = 4) -> int:
    """#(d_1..d_dims) power-of-two with product == n_npus — the paper's '286
    possible combinations' for 4 parallelization dims over 1024 NPUs."""
    k = int(math.log2(n_npus))
    return math.comb(k + dims - 1, dims - 1)
