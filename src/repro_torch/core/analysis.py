"""Static verification, critical-path attribution, and PsA/StudySpec lint.

Three layers, all of which run WITHOUT simulating anything:

  * **Trace/plan verifier** (``verify_trace`` / ``verify_plan``): every
    defect that would hang or crash the event loop — a dependency cycle, a
    dangling dep or resource reference, an unprovisioned pool, a negative
    repeat/delay/cost — is reported as a structured ``AnalysisReport``
    BEFORE a campaign burns hours on it.  The engine's resources are
    unit-capacity single servers, so acyclicity + valid references is a
    *complete* termination criterion for the reference loop: a trace this
    verifier passes cannot deadlock it.  Checks run vectorized over the
    ``_SimPlan``'s flat arrays (the plan is built once per trace and shared
    with simulation, so verification adds no per-op Python pass); the
    report is memoized on the trace, so repeat verifications are free.

  * **Critical-path analysis** (``critical_path``): the longest chain
    through the dependency DAG with per-op slack and per-resource busy-time
    lower bounds.  Both are lower bounds on any schedule's makespan
    (``length_us <= makespan_us``), and the per-category split of the path
    (compute vs collective vs xfer vs gate time) is the per-evaluation
    bottleneck attribution ``simulate(..., analyze=True)`` attaches to
    ``SimResult.analysis`` and ``python -m repro_torch.dse analyze`` tabulates.

  * **PsA/StudySpec lint** (``lint_pset`` / ``lint_study``): constraint-set
    satisfiability (analytic impossibility over sum/product constraints +
    repair-aware sampling probes) and dead-knob detection — searched
    parameters no evaluation path ever reads, found by recording config-key
    accesses while building (not running) a few probe ``SimJob``s.

``preflight`` is the fail-fast gate ``run_study`` applies to the first
plan of every cell; the CLI surfaces all three layers as
``python -m repro_torch.dse lint|analyze``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core.simulator import _SimPlan, _sim_plan, plan_durations
from repro_torch.core.space import DesignSpace
from repro_torch.core.workload import Parallelism, Trace

_OP_KINDS = ("comp", "coll", "delay")


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Issue:
    """One finding: a machine-readable code, a human message, and the
    offending op/pool/resource/constraint where attributable."""
    code: str
    message: str
    severity: str = "error"             # "error" | "warning"
    op: int | None = None
    pool: int | None = None
    resource: int | None = None
    constraint: str | None = None


@dataclass(frozen=True)
class AnalysisReport:
    """A static-analysis verdict: what was analyzed, summary facts about
    it (``info``), and the issues found.  ``ok`` means no errors (warnings
    don't fail a run); ``raise_if_issues`` turns errors into a
    ``PlanVerificationError`` carrying the full report."""
    subject: str
    issues: tuple[Issue, ...] = ()
    info: Mapping[str, Any] = field(default_factory=dict)

    @property
    def errors(self) -> tuple[Issue, ...]:
        return tuple(i for i in self.issues if i.severity == "error")

    @property
    def warnings(self) -> tuple[Issue, ...]:
        return tuple(i for i in self.issues if i.severity == "warning")

    @property
    def ok(self) -> bool:
        return not self.errors

    def raise_if_issues(self, *, warnings_fatal: bool = False) -> "AnalysisReport":
        if (self.issues if warnings_fatal else self.errors):
            raise PlanVerificationError(self)
        return self

    def to_dict(self) -> dict[str, Any]:
        return {"subject": self.subject, "ok": self.ok,
                "info": dict(self.info),
                "issues": [dataclasses.asdict(i) for i in self.issues]}

    def format(self) -> str:
        head = f"{self.subject}: " + (
            "ok" if not self.issues else
            f"{len(self.errors)} error(s), {len(self.warnings)} warning(s)")
        lines = [head]
        if self.info:
            lines.append("  " + " ".join(f"{k}={v}"
                                         for k, v in self.info.items()))
        for i in self.issues:
            where = " ".join(
                f"{k}={v}" for k, v in (("op", i.op), ("pool", i.pool),
                                        ("resource", i.resource))
                if v is not None)
            lines.append(f"  [{i.severity}] {i.code}: {i.message}"
                         + (f" ({where})" if where else ""))
        return "\n".join(lines)


class PlanVerificationError(RuntimeError):
    """A static check failed; ``.report`` holds the full ``AnalysisReport``
    (also rendered as the exception message)."""

    def __init__(self, report: AnalysisReport) -> None:
        self.report = report
        super().__init__(report.format())


# ---------------------------------------------------------------------------
# Trace / plan verifier
# ---------------------------------------------------------------------------

def _kahn_unfinished(n: int, ndeps0: Sequence[int],
                     children: Sequence[Sequence[int]]) -> list[int]:
    """Uids that can never become ready (on a dependency cycle, or
    downstream of one) — empty iff the dependency graph is a DAG."""
    ndeps = list(ndeps0)
    queue = [u for u in range(n) if ndeps[u] == 0]
    head = 0
    while head < len(queue):
        u = queue[head]
        head += 1
        for c in children[u]:
            ndeps[c] -= 1
            if ndeps[c] == 0:
                queue.append(c)
    if head == n:
        return []
    done = set(queue)
    return [u for u in range(n) if u not in done]


def _plan_arrays(plan: _SimPlan) -> tuple[np.ndarray, np.ndarray]:
    """``(res_of, ndeps0)`` as int64 arrays, cached on the plan's memo dict
    (the plan keeps them as Python lists for the event loop's scalar
    indexing; converting 26k-element lists per verification would eat the
    whole overhead budget)."""
    arrs = plan.pack_memo.get("_analysis_arrays")
    if arrs is None:
        arrs = (np.asarray(plan.res_of, dtype=np.int64),
                np.asarray(plan.ndeps0, dtype=np.int64))
        plan.pack_memo["_analysis_arrays"] = arrs
    return arrs


def _plan_issues(plan: _SimPlan) -> list[Issue]:
    """Structural checks over the plan's flat arrays (vectorized — no
    per-op Python pass on the happy path)."""
    issues: list[Issue] = []
    n = plan.n_ops
    n_res = len(plan.res_names)

    # resource references: every op must map to a provisioned resource
    res_of, _ndeps = _plan_arrays(plan)
    if len(plan.res_pool) != n_res or res_of.size != n:
        issues.append(Issue(
            "res-structure",
            f"resource bookkeeping is inconsistent: {res_of.size} op->"
            f"resource entries / {n_res} names / {len(plan.res_pool)} pools "
            f"for {n} ops"))
    elif n:
        bad = (res_of < 0) | (res_of >= n_res)
        if bad.any():
            u = int(np.argmax(bad))
            issues.append(Issue(
                "dangling-resource",
                f"op {u} demands resource id {int(res_of[u])} but the plan "
                f"only provisions resources 0..{n_res - 1} — the op could "
                f"never be scheduled (guaranteed deadlock)",
                op=u, resource=int(res_of[u])))

    # dependency references + acyclicity
    ndeps = _ndeps
    deps = np.asarray(plan.deps_flat, dtype=np.int64)
    if ndeps.size != n or (n and (ndeps < 0).any()) \
            or int(ndeps.sum()) != deps.size or len(plan.children) != n:
        issues.append(Issue(
            "dep-structure",
            "dependency bookkeeping is inconsistent "
            "(ndeps0 / children / deps_flat disagree)"))
        return issues
    owner = np.repeat(np.arange(n, dtype=np.int64), ndeps)
    out_of_range = (deps < 0) | (deps >= n)
    if out_of_range.any():
        i = int(np.argmax(out_of_range))
        issues.append(Issue(
            "dangling-dep",
            f"op {int(owner[i])} depends on uid {int(deps[i])}, outside "
            f"0..{n - 1} — it would never be released", op=int(owner[i])))
    elif (deps == owner).any():
        i = int(np.argmax(deps == owner))
        issues.append(Issue("dep-cycle",
                            f"op {int(owner[i])} depends on itself",
                            op=int(owner[i])))
    elif deps.size and not bool((deps < owner).all()):
        # TraceBuilder only ever emits backward deps, so this fast check IS
        # the acyclicity proof for builder traces; anything else gets the
        # full Kahn toposort
        stuck = _kahn_unfinished(n, plan.ndeps0, plan.children)
        if stuck:
            sample = ", ".join(str(u) for u in stuck[:6])
            issues.append(Issue(
                "dep-cycle",
                f"dependency cycle: {len(stuck)} op(s) can never become "
                f"ready (e.g. {sample}) — the event loop would deadlock at "
                f"{n - len(stuck)}/{n} ops", op=stuck[0]))

    # repeat / delay / cost sanity (compute repeats fold into flops/bytes)
    cr = plan.coll_repeat
    if cr.size:
        bad = ~np.isfinite(cr) | (cr < 1)
        if bad.any():
            i = int(np.argmax(bad))
            issues.append(Issue(
                "bad-repeat",
                f"collective op {int(plan.coll_uids[i])} has repeat "
                f"{cr[i]!r} (must be a finite count >= 1)",
                op=int(plan.coll_uids[i])))
    for what, arr in (("flops", plan.comp_flops), ("bytes", plan.comp_bytes)):
        if arr.size:
            bad = ~np.isfinite(arr) | (arr < 0)
            if bad.any():
                i = int(np.argmax(bad))
                issues.append(Issue(
                    "bad-cost",
                    f"compute op {int(plan.comp_uids[i])} has {what} "
                    f"{arr[i]!r} (must be finite and >= 0)",
                    op=int(plan.comp_uids[i])))
    for uid, delay in plan.delay_ops:
        if not (np.isfinite(delay) and delay >= 0):
            issues.append(Issue(
                "bad-delay",
                f"delay op {uid} has delay_us {delay!r} (must be finite "
                f"and >= 0)", op=uid))
            break
    for ci, (pool, _group, _coll, size) in enumerate(plan.coll_shapes):
        if not (np.isfinite(size) and size >= 0):
            uid = int(plan.coll_uids[int(np.argmax(plan.coll_class == ci))])
            issues.append(Issue(
                "bad-cost",
                f"collective op {uid} has size_bytes {size!r} (must be "
                f"finite and >= 0)", op=uid, pool=pool))
    return issues


def _diagnose_trace(trace: Trace) -> list[Issue]:
    """Precise per-op diagnosis for traces whose plan cannot even be built
    (non-dense uids, wildly out-of-range deps).  Slow path: only runs on
    defective traces."""
    issues: list[Issue] = []
    n = len(trace.ops)
    for i, op in enumerate(trace.ops):
        if op.uid != i:
            issues.append(Issue(
                "bad-uid",
                f"ops[{i}] has uid {op.uid} — the scheduler requires dense "
                f"uids (0..{n - 1} in list order; build traces with "
                f"TraceBuilder)", op=i))
            break
    for op in trace.ops:
        if op.kind not in _OP_KINDS:
            issues.append(Issue(
                "bad-kind", f"op {op.uid} has unknown kind {op.kind!r}; "
                f"known: {_OP_KINDS}", op=op.uid))
            break
    for op in trace.ops:
        bad = [d for d in op.deps if not 0 <= d < n]
        if bad:
            issues.append(Issue(
                "dangling-dep",
                f"op {op.uid} depends on uid {bad[0]}, outside 0..{n - 1} — "
                f"it would never be released", op=op.uid))
            break
    return issues


def _example_op_on_pool(plan: _SimPlan, pool: int) -> int | None:
    rp = np.asarray(plan.res_pool, dtype=np.int64)
    ro = np.asarray(plan.res_of, dtype=np.int64)
    mask = rp[ro] == pool
    return int(np.argmax(mask)) if mask.any() else None


def _context_issues(plan: _SimPlan, cfg: Any, par: Parallelism | None,
                    pools: Mapping[int, Any] | None) -> list[Issue]:
    """Design-point-dependent feasibility: each pool the trace schedules
    onto must be provisioned with a placement that fits its network."""
    issues: list[Issue] = []
    for p in plan.pools:
        entry = par if pools is None else pools.get(p, par)
        if pools is not None and p not in pools:
            issues.append(Issue(
                "pool-unmapped",
                f"trace schedules ops onto pool {p} but the pools mapping "
                f"only provisions {sorted(pools)} — pool {p} silently falls "
                f"back to the global parallelism",
                severity="warning", pool=p, op=_example_op_on_pool(plan, p)))
        if isinstance(entry, tuple):    # (Par, Net) or (Par, Net, dim_map)
            par_p, net_p = entry[0], entry[1]
        else:
            par_p, net_p = entry, (cfg.network if cfg is not None else None)
        if par_p is None:
            continue
        if net_p is not None:
            capacity = 1
            for d in net_p.dims:
                capacity *= d.npus
            if par_p.n_npus > capacity:
                issues.append(Issue(
                    "pool-capacity",
                    f"pool {p} demands {par_p.n_npus} NPUs but its network "
                    f"provides {capacity} — an infeasible placement "
                    f"(collectives would be priced on links that don't "
                    f"exist)", pool=p, op=_example_op_on_pool(plan, p)))
        if not par_p.valid():
            issues.append(Issue(
                "bad-parallelism",
                f"pool {p}: dp*sp*pp = {par_p.dp * par_p.sp * par_p.pp} "
                f"does not evenly divide n_npus = {par_p.n_npus}", pool=p))
    return issues


def verify_plan(plan: _SimPlan, subject: str = "plan") -> AnalysisReport:
    """Statically verify one ``_SimPlan``'s structure (no design-point
    context).  For the common entry point see ``verify_trace``."""
    return AnalysisReport(
        subject=subject, issues=tuple(_plan_issues(plan)),
        info={"n_ops": plan.n_ops, "n_resources": len(plan.res_names),
              "n_pools": len(plan.pools),
              "n_deps": int(np.asarray(plan.deps_flat).size)})


def verify_trace(trace: Trace, cfg: Any = None,
                 par: Parallelism | None = None,
                 pools: Mapping[int, Any] | None = None) -> AnalysisReport:
    """Statically verify a trace's scheduling plan.

    The structural verdict (references, acyclicity, repeat/delay/cost
    sanity) is memoized on the trace — traces are interned by the WTG
    cache, so a campaign pays it once per distinct trace.  Passing the
    design-point context (``cfg``/``par``/``pools``, the ``simulate()``
    arguments) adds pool-feasibility checks on top.

    A structurally clean plan provably cannot deadlock the reference event
    loop: every resource is a unit-capacity single server, so valid
    references + an acyclic dependency DAG guarantee all ops finish."""
    rep = getattr(trace, "_verify_report", None)
    if rep is None:
        try:
            plan = _sim_plan(trace)
        except (ValueError, IndexError, TypeError, KeyError) as e:
            issues = _diagnose_trace(trace)
            if not issues:
                issues = [Issue("plan-error",
                                f"scheduling-plan construction failed: {e}")]
            rep = AnalysisReport(subject=_subject(trace),
                                 issues=tuple(issues),
                                 info={"n_ops": len(trace.ops)})
        else:
            rep = verify_plan(plan, subject=_subject(trace))
        trace._verify_report = rep
    if cfg is not None or par is not None or pools is not None:
        plan = getattr(trace, "_sim_plan", None)
        if plan is not None:
            extra = _context_issues(plan, cfg, par, pools)
            if extra:
                rep = dataclasses.replace(rep,
                                          issues=rep.issues + tuple(extra))
    return rep


def _subject(trace: Trace) -> str:
    return f"trace[{len(trace.ops)} ops]"


# ---------------------------------------------------------------------------
# Critical-path analysis
# ---------------------------------------------------------------------------

# bottleneck categories a resource (and through it, an op) falls into
_CATEGORIES = ("compute", "collective", "xfer", "gate")


def _res_categories(plan: _SimPlan) -> np.ndarray:
    cats = np.empty(len(plan.res_names), dtype=np.int64)
    for r, name in enumerate(plan.res_names):
        cats[r] = (0 if name == "compute"
                   else 3 if name.startswith("_delay")
                   else 2 if name == "xfer" else 1)
    return cats


@dataclass(frozen=True)
class CriticalPath:
    """The longest chain through the dependency DAG under one design
    point's durations — a lower bound on every schedule's makespan.

    ``slack_us[u]`` is how much op ``u`` can slip without lengthening the
    path (zero-slack ops lie on a critical path);  ``breakdown_us`` splits
    the reported path's time into compute / collective / xfer / gate;
    ``resource_busy_us`` is each resource's total demand — its max is the
    other makespan lower bound (a resource can't serve more than one op at
    a time)."""
    length_us: float
    path: tuple[int, ...]
    slack_us: np.ndarray
    breakdown_us: dict[str, float]
    resource_busy_us: dict[str, float]
    n_critical: int

    @property
    def resource_lb_us(self) -> float:
        return max(self.resource_busy_us.values(), default=0.0)

    def binding_resource(self) -> str:
        """The busiest resource's label — the capacity bound's witness."""
        if not self.resource_busy_us:
            return "none"
        return max(self.resource_busy_us, key=self.resource_busy_us.get)

    def summary(self, makespan_us: float | None = None) -> dict[str, Any]:
        """The attribution dict ``SimResult.analysis`` carries."""
        total = sum(self.breakdown_us.values())
        out: dict[str, Any] = {
            "critical_path_us": self.length_us,
            "path_ops": len(self.path),
            "n_critical_ops": self.n_critical,
            "breakdown_us": dict(self.breakdown_us),
            "breakdown_frac": {k: (v / total if total else 0.0)
                               for k, v in self.breakdown_us.items()},
            "resource_lb_us": self.resource_lb_us,
            "binding_resource": self.binding_resource(),
        }
        if makespan_us is not None:
            out["makespan_us"] = makespan_us
            out["cp_frac_of_makespan"] = \
                self.length_us / makespan_us if makespan_us else 1.0
            # which lower bound explains the schedule: the dependency chain
            # or the busiest resource's capacity
            out["bound"] = ("dependency-path"
                            if self.length_us >= self.resource_lb_us
                            else f"resource:{self.binding_resource()}")
        return out


def critical_path(plan: _SimPlan, dur: np.ndarray) -> CriticalPath:
    """Longest path + per-op slack over the dependency DAG.

    Requires a verified plan (raises on a cyclic one).  Durations are the
    per-op vector ``plan_durations`` produces for one design point."""
    n = plan.n_ops
    dur = np.asarray(dur, dtype=np.float64)
    res_of, ndeps = _plan_arrays(plan)
    deps = np.asarray(plan.deps_flat, dtype=np.int64)
    backward = not deps.size or bool(
        (deps < np.repeat(np.arange(n, dtype=np.int64), ndeps)).all())
    if backward:
        order: Sequence[int] = range(n)
    else:
        stuck = _kahn_unfinished(n, plan.ndeps0, plan.children)
        if stuck:
            raise PlanVerificationError(verify_plan(plan))
        ndeps_left = list(plan.ndeps0)
        order = [u for u in range(n) if ndeps_left[u] == 0]
        head = 0
        while head < len(order):
            for c in plan.children[order[head]]:
                ndeps_left[c] -= 1
                if ndeps_left[c] == 0:
                    order.append(c)  # type: ignore[attr-defined]
            head += 1

    children = plan.children
    d = dur.tolist()
    est = [0.0] * n
    finish = [0.0] * n
    for u in order:
        f = est[u] + d[u]
        finish[u] = f
        for c in children[u]:
            if f > est[c]:
                est[c] = f
    length = max(finish, default=0.0)

    # backward pass: latest finish under the fixed path length
    lat = [length] * n
    for u in reversed(list(order)):
        m = lat[u]
        for c in children[u]:
            v = lat[c] - d[c]
            if v < m:
                m = v
        lat[u] = m
    slack = np.asarray(lat) - dur - np.asarray(est)

    # walk one critical chain back from the latest-finishing sink
    path: list[int] = []
    if n:
        fin = np.asarray(finish)
        offsets = np.concatenate(([0], np.cumsum(ndeps)))
        u = int(np.argmax(fin))
        path.append(u)
        while True:
            seg = deps[offsets[u]:offsets[u + 1]]
            if not seg.size:
                break
            u = int(seg[int(np.argmax(fin[seg]))])
            path.append(u)
        path.reverse()

    cats = _res_categories(plan)[res_of]
    pa = np.asarray(path, dtype=np.intp)
    sums = np.bincount(cats[pa], weights=dur[pa], minlength=4) if len(path) \
        else np.zeros(4)
    busy = np.bincount(res_of, weights=dur, minlength=len(plan.res_names))
    resource_busy = {
        f"pool{plan.res_pool[r]}:{plan.res_names[r]}": float(busy[r])
        for r in range(len(plan.res_names))
        if not plan.res_names[r].startswith("_delay")}
    tol = max(length, 1.0) * 1e-9
    return CriticalPath(
        length_us=float(length), path=tuple(path), slack_us=slack,
        breakdown_us=dict(zip(_CATEGORIES, (float(s) for s in sums))),
        resource_busy_us=resource_busy,
        n_critical=int((slack <= tol).sum()))


def analyze_job(job: Any, backend: "str | Any | None" = None
                ) -> tuple[Any, list[dict[str, Any]]]:
    """Run one scenario ``SimJob`` with per-call critical-path attribution:
    ``(finalized evaluation, one summary dict per call)``.  A non-``SimJob``
    input (a gated-invalid ``Evaluation``) passes through with no
    summaries."""
    from repro_torch.core.backends.base import SimJob
    from repro_torch.core.simulator import simulate

    if not isinstance(job, SimJob):
        return job, []
    results = []
    summaries = []
    for c in job.calls:
        res = simulate(c.trace, c.cfg, c.par, pools=c.pools,
                       record_per_op=c.record_per_op,
                       record_finish=c.record_finish,
                       backend=backend, analyze=True)
        results.append(res)
        summaries.append(res.analysis)
    return job.finalize(results), summaries


def aggregate_summaries(summaries: Sequence[Mapping[str, Any]]
                        ) -> dict[str, Any] | None:
    """Fold per-call attribution summaries into one design-point view
    (calls chain — disaggregated phases — so times add)."""
    summaries = [s for s in summaries if s]
    if not summaries:
        return None
    breakdown = {k: sum(s["breakdown_us"].get(k, 0.0) for s in summaries)
                 for k in _CATEGORIES}
    total = sum(breakdown.values())
    makespan = sum(s.get("makespan_us", 0.0) for s in summaries)
    cp = sum(s["critical_path_us"] for s in summaries)
    dominant = max(summaries,
                   key=lambda s: s.get("makespan_us", s["critical_path_us"]))
    return {"calls": len(summaries), "makespan_us": makespan,
            "critical_path_us": cp,
            "cp_frac_of_makespan": cp / makespan if makespan else 1.0,
            "breakdown_us": breakdown,
            "breakdown_frac": {k: (v / total if total else 0.0)
                               for k, v in breakdown.items()},
            "bound": dominant.get("bound", "dependency-path"),
            "binding_resource": dominant.get("binding_resource", "none")}


# ---------------------------------------------------------------------------
# PsA / StudySpec lint
# ---------------------------------------------------------------------------

class _RecordingConfig(dict):
    """A config dict that records which keys the evaluation path reads —
    the dead-knob probe wraps ``ctx.config`` in one while BUILDING (not
    running) a ``SimJob``."""

    def __init__(self, data: Mapping[str, Any], seen: set) -> None:
        super().__init__(data)
        self._seen = seen

    def __getitem__(self, key):
        self._seen.add(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        self._seen.add(key)
        return super().get(key, default)


def _numeric_choices(pset, slot: str) -> "tuple[float, ...] | None":
    """The numeric value set one constraint slot can take (respecting
    ``fixed``), or None when it isn't numeric."""
    base, idx = (slot[:-1].split("[") if "[" in slot else (slot, None))
    try:
        p = pset.by_name(base)
    except (KeyError, ValueError):
        return None
    if base in pset.fixed:
        v = pset.fixed[base]
        v = v[int(idx)] if idx is not None and isinstance(v, tuple) else v
        vals: tuple = (v,)
    else:
        vals = tuple(p.choices)
    if not all(isinstance(v, (int, float)) and not isinstance(v, bool)
               for v in vals):
        return None
    return vals


def _unsat_constraints(pset) -> list[Issue]:
    """Analytic impossibility over the declared constraint set: individual
    constraints no slot assignment can satisfy, and same-slot pairs with
    incompatible targets (e.g. ``product_eq N`` vs ``product_le N/2``)."""
    issues: list[Issue] = []
    resolved = []  # (constraint, sorted slot tuple, numeric target | None)
    for c in pset.constraints:
        if c.kind == "predicate":
            continue
        target = None if isinstance(c.target, str) else c.target
        slots = tuple(sorted(pset.expand_constraint_params(c)))
        choices = [_numeric_choices(pset, s) for s in slots]
        if target is None or any(ch is None for ch in choices):
            continue
        resolved.append((c, slots, target, choices))
        if c.kind == "sum_le":
            lo = sum(min(ch) for ch in choices)
            if lo > target:
                issues.append(Issue(
                    "constraint-unsat",
                    f"{c.describe()} is unsatisfiable: the smallest "
                    f"possible sum over {list(slots)} is {lo} > "
                    f"{target} (oversubscribed budget)",
                    constraint=c.describe()))
        elif c.kind == "product_le":
            lo = 1.0
            for ch in choices:
                lo *= min(ch)
            if lo > target:
                issues.append(Issue(
                    "constraint-unsat",
                    f"{c.describe()} is unsatisfiable: the smallest "
                    f"possible product is {lo} > {target}",
                    constraint=c.describe()))
        elif c.kind == "product_eq":
            reachable = {1.0}
            for ch in choices:
                reachable = {r * v for r in reachable for v in set(ch)}
                if len(reachable) > 65536:
                    reachable = set()
                    break
            if reachable and target not in reachable:
                issues.append(Issue(
                    "constraint-unsat",
                    f"{c.describe()} is unsatisfiable: no assignment of "
                    f"{list(slots)} multiplies to {target}",
                    constraint=c.describe()))
    # incompatible same-slot pairs
    for i, (a, slots_a, ta, _) in enumerate(resolved):
        for b, slots_b, tb, _ in resolved[i + 1:]:
            if slots_a != slots_b:
                continue
            pair = f"{a.describe()} vs {b.describe()}"
            if a.kind == "product_eq" and b.kind == "product_eq" and ta != tb:
                issues.append(Issue(
                    "constraint-unsat",
                    f"unsatisfiable constraint pair: {pair} (two exact "
                    f"products over the same slots)", constraint=pair))
            for eq, le in ((a, b), (b, a)):
                if eq.kind == "product_eq" and le.kind == "product_le":
                    t_eq = ta if eq is a else tb
                    t_le = tb if eq is a else ta
                    if t_eq > t_le:
                        issues.append(Issue(
                            "constraint-unsat",
                            f"unsatisfiable constraint pair: {pair} "
                            f"(required product {t_eq} exceeds the cap "
                            f"{t_le})", constraint=pair))
    return issues


def _dead_knobs(env: Any, pset, configs: Sequence[dict]) -> list[Issue]:
    """Searched parameters no evaluation path reads: build (don't run) each
    probe config's ``SimJob`` with a recording config and union the keys
    the env/scenario touched."""
    from repro_torch.core.backends.base import SimJob  # noqa: F401 (probe path)

    seen: set = set()
    for cfg in configs:
        rec = _RecordingConfig(cfg, seen)
        try:
            ctx = env.context(rec)
            env.scenario.sim_job(ctx)
        except Exception as e:  # a probe crash is a finding, not a crash
            return [Issue("probe-error",
                          f"dead-knob probe failed while building a "
                          f"SimJob: {e}", severity="warning")]
    return [Issue(
        "dead-knob",
        f"searched parameter {p.name!r} is never read by the evaluation "
        f"path — its {p.cardinality()} choices only dilute the search",
        constraint=p.name)
        for p in pset.searched_params() if p.name not in seen]


def lint_pset(pset, env: Any = None, *, probes: int = 256,
              eval_probes: int = 2, seed: int = 0) -> AnalysisReport:
    """Lint one ``ParameterSet``/``DesignSpace``: constraint-set
    satisfiability (analytic + sampling with the repair path, i.e. exactly
    what agents rely on) and — given an env — dead-knob detection."""
    issues: list[Issue] = list(_unsat_constraints(pset))
    space = DesignSpace(pset)
    rng = np.random.default_rng(seed)
    info = {"params": len(pset.params),
            "searched": len(pset.searched_params()),
            "genes": space.n_genes(),
            "constraints": len(pset.constraints),
            "cardinality": f"{pset.cardinality():.3g}"}
    configs: list[dict] = []
    if not issues:
        try:
            for _ in range(eval_probes):
                configs.append(space.sample(rng))
        except RuntimeError as e:
            rates = space.constraint_violation_rates(rng, tries=probes)
            always = sorted(name for name, r in rates.items() if r >= 1.0)
            hint = (f" Constraint(s) no raw sample ever satisfies: "
                    f"{always}." if always else "")
            issues.append(Issue("constraint-unsat", f"{e}{hint}",
                                constraint=always[0] if always else None))
    if env is not None and configs:
        issues.extend(_dead_knobs(env, pset, configs))
    return AnalysisReport(subject=f"pset[{pset.name}]",
                          issues=tuple(issues), info=info)


def preflight(env: Any, pset, seed: int = 0, tries: int = 4
              ) -> AnalysisReport | None:
    """Sample a design point and statically verify the scheduling plan(s)
    its ``SimJob`` would run — the always-on fail-fast gate ``run_study``
    applies to each cell before searching.  Returns the merged report for
    the first config that yields a ``SimJob`` (structural verdicts are
    memoized per trace, so this is ~free when traces are shared), or None
    when every probe gated invalid (nothing to verify)."""
    from repro_torch.core.backends.base import SimJob

    space = DesignSpace(pset)
    rng = np.random.default_rng(seed)
    for _ in range(tries):
        try:
            cfg = space.sample(rng)
        except RuntimeError as e:
            # surfaces as a clean CLI error instead of a mid-search traceback
            raise ValueError(str(e)) from None
        job = env.scenario.sim_job(env.context(cfg))
        if not isinstance(job, SimJob):
            continue
        reports = [verify_trace(c.trace, c.cfg, c.par, c.pools)
                   for c in job.calls]
        issues = tuple(i for r in reports for i in r.issues)
        info = {"calls": len(reports),
                "n_ops": sum(r.info.get("n_ops", 0) for r in reports)}
        return AnalysisReport(subject="cell preflight", issues=issues,
                              info=info)
    return None


def lint_study(spec) -> AnalysisReport:
    """Lint a ``StudySpec`` without running it: resolve every registry
    (arch / system / scenario / objective / backend — the spec constructor
    already validated them), lint the assembled PsA, statically verify a
    probe design point's scheduling plan, and report campaign shape/cost."""
    pset = spec.build_pset()
    env = spec.build_env()
    rep = lint_pset(pset, env=env)
    issues = list(rep.issues)
    cells = spec.cells()
    info = dict(rep.info)
    info.update({
        "cells": len(cells),
        "evaluations_max": sum((a.steps or spec.steps) for _, a, _ in cells),
        "backend": spec.backend,
    })
    try:
        plan_rep = preflight(env, pset, seed=int(spec.seeds[0]))
    except ValueError as e:
        plan_rep = None
        issues.append(Issue("constraint-unsat", str(e)))
    if plan_rep is not None:
        issues.extend(plan_rep.issues)
        info["trace_ops"] = plan_rep.info.get("n_ops", 0)
        info["sim_calls"] = plan_rep.info.get("calls", 0)
    # scenarios can contribute shape facts of their own (e.g. the fleet
    # scenario reports its replica count so the lint output shows the
    # campaign's cost multiplier: replicas x trace ops)
    hook = getattr(env.scenario, "lint_info", None)
    if callable(hook):
        info.update(hook())
    return AnalysisReport(
        subject=f"study[{spec.name}] {spec.arch} on {spec.system}, "
                f"scenario={spec.scenario}, objective={spec.objective}",
        issues=tuple(issues), info=info)
