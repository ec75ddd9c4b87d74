"""The simulation-backend API: how a trace gets evaluated is a first-class,
swappable axis of the engine.

A ``SimBackend`` turns (trace, system config, parallelization) into a
``SimResult``.  Two entry points:

  * ``simulate(trace, cfg, par, pools=..., ...)`` — one design point, the
    drop-in contract of the original ``core.simulator.simulate`` (which is
    now a thin delegate onto the selected backend);
  * ``simulate_batch(trace, calls)`` — a whole agent population evaluated
    against ONE shared scheduling plan (``core.simulator._sim_plan``), the
    seam vectorized backends exploit: the trace-dependent structure is
    resolved once and only the per-design-point durations vary.

Backends register in ``BACKEND_REGISTRY`` by name (factories, so optional
heavy deps — torch and the CUDA kernels — import only when the backend is
actually requested); ``get_backend`` resolves names to process-wide
singletons, one per (name, device) where a device is asked for.  ``repro_torch.dse
list-backends`` enumerates the registry.

Scenarios talk to backends through ``SimJob``: a declarative bundle of
``SimCall``s plus a ``finalize`` closure turning the results into one
``Evaluation``.  ``run_sim_job`` executes one job; ``run_sim_jobs``
executes a population of jobs, grouping calls that share a trace so a
vectorized backend sweeps each shared plan in a single ``simulate_batch``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Protocol, Sequence, runtime_checkable

from repro_torch.core.simulator import SimResult, SystemConfig
from repro_torch.core.workload import Parallelism, Trace


@dataclass(frozen=True)
class SimCall:
    """One simulator invocation a scenario wants executed: the positional
    ``simulate()`` arguments plus the opt-in recording flags."""
    trace: Trace
    cfg: SystemConfig
    par: Parallelism
    pools: dict[int, Any] | None = None
    record_per_op: bool = False
    record_finish: bool = False


@dataclass(frozen=True)
class SimJob:
    """Everything one design point needs simulated, plus how to turn the
    results into an ``Evaluation``.  ``finalize`` receives the ``SimResult``s
    in ``calls`` order.  Scenarios return a ``SimJob`` (or a terminal
    ``Evaluation`` for gated-invalid points) from ``sim_job(ctx)``; the
    generic drivers below execute it on any backend."""
    calls: tuple[SimCall, ...]
    finalize: Callable[[list[SimResult]], Any]


@runtime_checkable
class SimBackend(Protocol):
    """Structural protocol for simulation backends.

    ``vectorized`` declares that ``simulate_batch`` genuinely evaluates the
    population in one sweep (rather than looping ``simulate``) — the env's
    batched evaluation path only reroutes through ``run_sim_jobs`` for
    vectorized backends, keeping the reference path bit-identical to serial
    evaluation."""

    name: str
    vectorized: bool

    def simulate(self, trace: Trace, cfg: SystemConfig, par: Parallelism, *,
                 pools: dict[int, Any] | None = None,
                 record_per_op: bool = False,
                 record_finish: bool = False) -> SimResult: ...

    def simulate_batch(self, trace: Trace,
                       calls: Sequence[SimCall]) -> list[SimResult]: ...


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# name -> (factory, one-line doc).  Factories defer heavy imports (torch)
# to first use; ``get_backend`` memoizes the constructed singleton per name
# (the default device) or per (name, device).
BACKEND_REGISTRY: dict[str, tuple[Callable[..., SimBackend], str]] = {}
_instances: dict[Any, SimBackend] = {}


def register_backend(name: str, factory: Callable[[], SimBackend], *,
                     doc: str = "", replace: bool = False) -> None:
    if not replace and name in BACKEND_REGISTRY:
        raise ValueError(f"backend {name!r} already registered")
    BACKEND_REGISTRY[name] = (factory, doc)
    for key in [k for k in _instances
                if k == name or (isinstance(k, tuple) and k[0] == name)]:
        del _instances[key]


def get_backend(backend: "str | SimBackend | None",
                device: "str | None" = None) -> SimBackend:
    """Resolve a backend name to its process-wide instance (or pass an
    instance through).  ``None`` resolves to the reference backend.

    ``device`` is where a backend that computes with torch runs ("cuda",
    "cpu"); ``None`` is the backend's default, the card for the torch
    backends (which raise without CUDA).  The factory receives it as its
    ``device`` keyword; host-only backends ignore it."""
    if backend is None:
        backend = "reference"
    if not isinstance(backend, str):
        return backend
    key = backend if device is None else (backend, str(device))
    inst = _instances.get(key)
    if inst is None:
        try:
            factory, _ = BACKEND_REGISTRY[backend]
        except KeyError:
            raise ValueError(f"unknown simulation backend {backend!r}; "
                             f"known: {sorted(BACKEND_REGISTRY)}") from None
        inst = factory() if device is None else factory(device=device)
        _instances[key] = inst
    return inst


def list_backends() -> dict[str, str]:
    """name -> one-line description (no instantiation: an unavailable
    optional backend still lists, and fails with a clear error on use)."""
    return {name: doc for name, (_, doc) in BACKEND_REGISTRY.items()}


def backend_available(name: str) -> bool:
    """True when the backend's dependencies import and its default device
    exists (instantiates it)."""
    try:
        get_backend(name)
        return True
    except (ImportError, ValueError, RuntimeError):
        return False


# ---------------------------------------------------------------------------
# Job drivers
# ---------------------------------------------------------------------------

def run_sim_job(job: Any, backend: "str | SimBackend | None" = None, *,
                verify: bool = False) -> Any:
    """Execute one scenario job on a backend.  A non-``SimJob`` input (a
    terminal ``Evaluation`` from a gated-invalid design point) passes
    through untouched.

    ``verify=True`` statically checks each call's scheduling plan first
    (``repro_torch.core.analysis.verify_trace`` — acyclicity, dangling dep /
    resource references, pool feasibility) and raises
    ``PlanVerificationError`` instead of handing a defective plan to the
    event loop; the verdict is memoized per trace, so the steady-state
    cost is a dict lookup."""
    if not isinstance(job, SimJob):
        return job
    if verify:
        from repro_torch.core.analysis import verify_trace  # lazy: avoids a cycle
        for c in job.calls:
            verify_trace(c.trace, c.cfg, c.par, c.pools).raise_if_issues()
    be = get_backend(backend)
    results = [be.simulate(c.trace, c.cfg, c.par, pools=c.pools,
                           record_per_op=c.record_per_op,
                           record_finish=c.record_finish)
               for c in job.calls]
    return job.finalize(results)


def run_sim_jobs(jobs: Sequence[Any],
                 backend: "str | SimBackend | None" = None) -> list[Any]:
    """Execute a population of scenario jobs, batching calls that share a
    trace into one ``simulate_batch`` per shared scheduling plan.

    Calls are grouped by trace identity (traces are interned by the WTG
    cache, so design points differing only in non-trace-shaping knobs share
    the object — and its piggybacked ``_SimPlan``).  Results are finalized
    in input order; non-``SimJob`` entries pass through untouched."""
    be = get_backend(backend)
    # (job index, call index) slots to fill, grouped by trace identity
    groups: dict[int, tuple[Trace, list[tuple[int, int]]]] = {}
    slots: list[list[SimResult | None]] = []
    for ji, job in enumerate(jobs):
        if not isinstance(job, SimJob):
            slots.append([])
            continue
        slots.append([None] * len(job.calls))
        for ci, call in enumerate(job.calls):
            key = id(call.trace)
            entry = groups.get(key)
            if entry is None or entry[0] is not call.trace:
                groups[key] = entry = (call.trace, [])
            entry[1].append((ji, ci))
    for trace, members in groups.values():
        calls = [jobs[ji].calls[ci] for ji, ci in members]
        results = be.simulate_batch(trace, calls)
        for (ji, ci), res in zip(members, results):
            slots[ji][ci] = res
    out = []
    for ji, job in enumerate(jobs):
        if not isinstance(job, SimJob):
            out.append(job)
            continue
        out.append(job.finalize(list(slots[ji])))
    return out
