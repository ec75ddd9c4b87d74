"""Parameter Set Architecture (PsA) — the paper's central abstraction.

Like an ISA delineates software/hardware, the PsA delineates the interface
between search agents and the system under design: a declarative schema of
searchable parameters, their value ranges, and cross-parameter constraints
(Section 4.2 of the paper).  Domain experts author ``ParameterSet``s; the
Parameter Set Scheduler (``repro_torch.core.space``) turns them into agent action
spaces automatically.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Sequence

# 'scenario' parameters are contributed by the active Scenario (e.g. the
# disaggregated-serving prefill/decode split) via ``Scenario.psa_params()``
# and searched alongside the paper's four stacks.
Stack = str  # 'workload' | 'collective' | 'network' | 'compute' | 'scenario'


@dataclass(frozen=True)
class Parameter:
    """One searchable knob.

    ``choices`` is the explicit (ordered) value set; ``ndim > 1`` declares a
    multi-dimensional knob (one independent slot per network dimension, like
    the paper's ``MultiDim {Ring, Direct, RHD, DBT}``).
    """

    name: str
    stack: Stack
    choices: tuple
    ndim: int = 1
    doc: str = ""

    def __post_init__(self):
        if not self.choices:
            raise ValueError(f"parameter {self.name}: empty choice set")
        if self.ndim < 1:
            raise ValueError(f"parameter {self.name}: ndim must be >= 1")

    @property
    def slots(self) -> list[str]:
        if self.ndim == 1:
            return [self.name]
        return [f"{self.name}[{i}]" for i in range(self.ndim)]

    def cardinality(self) -> int:
        return len(self.choices) ** self.ndim


@dataclass(frozen=True)
class Constraint:
    """Declarative cross-parameter constraint.

    kinds:
      product_eq : prod(values of `params`) == target
      product_le : prod(values of `params`) <= target
      sum_le     : sum(values of `params`) <= target   (partition budgets)
      predicate  : fn(config) -> bool  (escape hatch)
    `params` may name scalar parameters or a multidim parameter (expands to
    all of its slots).
    """

    kind: str
    params: tuple[str, ...] = ()
    target: float | int | str = 0
    fn: Callable[[dict], bool] | None = None
    name: str = ""

    def describe(self) -> str:
        if self.name:
            return self.name
        if self.kind == "predicate":
            return "predicate"
        if self.kind == "sum_le":
            return f"sum({', '.join(self.params)}) <= {self.target}"
        op = {"product_eq": "==", "product_le": "<="}[self.kind]
        return f"product({', '.join(self.params)}) {op} {self.target}"


@dataclass
class ParameterSet:
    """A PsA schema instance: parameters + constraints (+ fixed values).

    ``fixed`` pins parameters to constants — this is how the paper's
    single-stack baselines are expressed (e.g. workload-only search fixes
    the collective and network stacks).
    """

    params: list[Parameter]
    constraints: list[Constraint] = field(default_factory=list)
    fixed: dict[str, Any] = field(default_factory=dict)
    name: str = "psa"

    def __post_init__(self):
        names = [p.name for p in self.params]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate parameter names in {self.name}")

    # ------------------------------------------------------------------
    def by_name(self, name: str) -> Parameter:
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(name)

    def stacks(self) -> set[str]:
        return {p.stack for p in self.params}

    def restrict(self, stacks: Iterable[str], defaults: dict[str, Any]) -> "ParameterSet":
        """Single-stack ablation: keep `stacks` searchable, pin the rest to
        `defaults` (the paper's workload-only / collective-only / network-only
        baselines)."""
        stacks = set(stacks)
        fixed = dict(self.fixed)
        for p in self.params:
            if p.stack not in stacks and p.name not in fixed:
                if p.name not in defaults:
                    raise KeyError(f"no default for pinned parameter {p.name}")
                fixed[p.name] = defaults[p.name]
        return ParameterSet(self.params, self.constraints, fixed,
                            name=f"{self.name}:{'+'.join(sorted(stacks))}")

    def extend(self, params: Iterable[Parameter],
               constraints: Iterable[Constraint] = (),
               name: str | None = None) -> "ParameterSet":
        """A new ParameterSet with extra parameters/constraints appended —
        how a Scenario contributes its searchable knobs to a base PsA."""
        return ParameterSet(self.params + list(params),
                            self.constraints + list(constraints),
                            dict(self.fixed), name=name or self.name)

    def pin(self, overrides: dict[str, Any]) -> "ParameterSet":
        """A new ParameterSet with ``overrides`` pinned as fixed values —
        how a StudySpec's ``psa_overrides`` narrow a search.  Every key must
        name an existing parameter and every value must lie inside its
        declared choices (per slot for multidim parameters) — a typo'd pin
        must not silently search outside the design space."""
        pinned: dict[str, Any] = {}
        for k, v in overrides.items():
            try:
                p = self.by_name(k)
            except KeyError:
                raise ValueError(
                    f"unknown pinned parameter {k!r}; known: "
                    f"{[q.name for q in self.params]}") from None
            if p.ndim == 1:
                if v not in p.choices:
                    raise ValueError(f"pin {k}={v!r} is outside the "
                                     f"parameter's choices {p.choices}")
                pinned[k] = v
            else:
                vv = tuple(v) if isinstance(v, (list, tuple)) else (v,)
                if len(vv) != p.ndim or any(x not in p.choices for x in vv):
                    raise ValueError(
                        f"pin {k}={v!r} must be {p.ndim} values, each from "
                        f"{p.choices}")
                pinned[k] = vv
        return ParameterSet(self.params, self.constraints,
                            {**self.fixed, **pinned}, name=self.name)

    def cardinality(self) -> float:
        """Raw design-space size (unconstrained product — Table 1's count)."""
        total = 1.0
        for p in self.params:
            if p.name in self.fixed:
                continue
            total *= p.cardinality()
        return total

    def searched_params(self) -> list[Parameter]:
        """The parameters an agent actually searches over: not pinned via
        ``fixed`` and with more than one choice (the lint layer's dead-knob
        pass only flags these — a 1-choice or pinned knob is inert by
        construction, not a defect)."""
        return [p for p in self.params
                if p.name not in self.fixed and p.cardinality() > 1]

    def slot_names(self) -> list[str]:
        out: list[str] = []
        for p in self.params:
            if p.name in self.fixed:
                continue
            out.extend(p.slots)
        return out

    def expand_constraint_params(self, c: Constraint) -> list[str]:
        """Multidim params in a constraint expand to all their slots."""
        out: list[str] = []
        for name in c.params:
            try:
                p = self.by_name(name)
                out.extend(p.slots)
            except KeyError:
                out.append(name)  # already a slot name
        return out


# ---------------------------------------------------------------------------
# The paper's evaluation PsA (Table 4), with TPU-flavoured compute presets.
# ---------------------------------------------------------------------------

def pow2_range(lo: int, hi: int) -> tuple[int, ...]:
    """All powers of two from ``lo`` to ``hi`` inclusive.  Both bounds must
    themselves be powers of two — a non-power-of-two bound used to be
    silently truncated (``pow2_range(1, 1000)`` -> ... 512), which turned a
    typo'd cluster size into a quietly smaller design space."""
    for v, side in ((lo, "lo"), (hi, "hi")):
        if not isinstance(v, int) or v < 1:
            raise ValueError(f"pow2_range {side}={v!r} must be a positive "
                             f"integer power of two")
        if v & (v - 1):
            raise ValueError(
                f"pow2_range {side}={v} is not a power of two "
                f"(nearest are {2 ** (v.bit_length() - 1)} and "
                f"{2 ** v.bit_length()})")
    if lo > hi:
        raise ValueError(f"pow2_range lo={lo} > hi={hi}")
    return tuple(2 ** i for i in range(int(math.log2(lo)), int(math.log2(hi)) + 1))


COLL_ALGOS = ("ring", "direct", "rhd", "dbt")
TOPOLOGIES = ("ring", "switch", "fc")


def paper_psa(n_npus: int = 1024, net_dims: int = 4, *, searchable_npus: bool = False,
              max_pp: int = 4) -> ParameterSet:
    """The PsA of Table 4.  `n_npus` fixes the cluster size (1024 for
    System 2); parallelization degrees and NPUs-per-dim must multiply to it."""
    params = [
        Parameter("dp", "workload", pow2_range(1, n_npus), doc="data parallelism"),
        Parameter("pp", "workload", pow2_range(1, max_pp), doc="pipeline parallelism"),
        Parameter("sp", "workload", pow2_range(1, n_npus), doc="sequence parallelism"),
        Parameter("weight_sharded", "workload", (0, 1), doc="ZeRO weight sharding"),
        Parameter("sched_policy", "collective", ("lifo", "fifo")),
        Parameter("coll_algo", "collective", COLL_ALGOS, ndim=net_dims),
        Parameter("chunks", "collective", (2, 4, 8, 16)),
        Parameter("multidim_coll", "collective", ("baseline", "blueconnect")),
        Parameter("topology", "network", TOPOLOGIES, ndim=net_dims),
        Parameter("npus_per_dim", "network", (4, 8, 16), ndim=net_dims),
        Parameter("bw_per_dim", "network", tuple(range(50, 501, 50)), ndim=net_dims),
    ]
    constraints = [
        Constraint("product_le", ("dp", "sp", "pp"), n_npus,
                   name=f"product(DP,SP,PP) <= {n_npus}"),
        Constraint("product_eq", ("npus_per_dim",), n_npus,
                   name=f"product(NPUs per dim) == {n_npus}"),
    ]
    return ParameterSet(params, constraints, name=f"paper-psa-{n_npus}")


def table1_psa(n_npus: int = 1024, net_dims: int = 4) -> ParameterSet:
    """The motivation-section schema (Table 1): chunks 1..32, BW in
    {100..500}.  Raw cardinality reproduces the paper's 7.69e13."""
    params = [
        Parameter("dp", "workload", pow2_range(1, n_npus)),
        Parameter("pp", "workload", pow2_range(1, n_npus)),
        Parameter("sp", "workload", pow2_range(1, n_npus)),
        Parameter("weight_sharded", "workload", (0, 1)),
        Parameter("sched_policy", "collective", ("lifo", "fifo")),
        Parameter("coll_algo", "collective", COLL_ALGOS, ndim=net_dims),
        Parameter("chunks", "collective", tuple(range(1, 33))),
        Parameter("multidim_coll", "collective", ("baseline", "blueconnect")),
        Parameter("topology", "network", TOPOLOGIES, ndim=net_dims),
        Parameter("npus_per_dim", "network", (4, 8, 16), ndim=net_dims),
        Parameter("bw_per_dim", "network", (100, 200, 300, 400, 500), ndim=net_dims),
    ]
    constraints = [
        Constraint("product_le", ("dp", "sp", "pp"), n_npus),
        Constraint("product_eq", ("npus_per_dim",), n_npus),
    ]
    return ParameterSet(params, constraints, name="table1-psa")
