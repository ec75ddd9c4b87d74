"""Optimization objectives (paper Section 5.4).

Both rewards regularize raw ML latency by a network-resource denominator so
the agent can't just buy infinite bandwidth:

  reward_bw   = 1 / sqrt((Latency * sum(BW per dim) - 1)^2)
  reward_cost = 1 / sqrt((Latency * NetworkCost    - 1)^2)

(the paper's minus-one offset avoids division blow-ups on degenerate
configs).  A memory footprint above the capacity gate makes the design
invalid: reward 0.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from repro_torch.configs.base import ArchSpec
from repro_torch.core.backends import SimCall, SimJob, run_sim_job
from repro_torch.core.memory import footprint
from repro_torch.core.simulator import SimResult, SystemConfig
from repro_torch.core.topology import Network
from repro_torch.core.workload import Parallelism, Trace, generate_trace


@dataclass(frozen=True)
class Evaluation:
    """One design point's outcome.  Frozen because the env's evaluation memo
    hands the same instance to every duplicate design point; treat `detail`
    as read-only too."""
    reward: float
    latency_ms: float
    valid: bool
    detail: dict[str, Any]


def reward_perf_per_bw(latency_ms: float, net: Network) -> float:
    x = latency_ms * net.bw_per_npu() - 1.0
    return 1.0 / math.sqrt(x * x + 1e-12)


def reward_perf_per_cost(latency_ms: float, net: Network) -> float:
    x = latency_ms * (net.dollar_cost() / 1e6) - 1.0
    return 1.0 / math.sqrt(x * x + 1e-12)


def reward_latency(latency_ms: float, net: Network) -> float:
    return 1.0 / max(latency_ms, 1e-9)


REWARDS: dict[str, Callable[[float, Network], float]] = {
    "perf_per_bw": reward_perf_per_bw,
    "perf_per_cost": reward_perf_per_cost,
    "latency": reward_latency,
}


# ---------------------------------------------------------------------------
# Objective registry — first-class objective objects
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Objective:
    """A first-class optimization objective, resolvable by name.

    ``scalar_fn`` rewards one end-to-end latency (every scenario has one);
    ``stream_fn`` rewards per-request ``StreamMetrics`` and is only
    satisfiable by streaming scenarios.  An objective with ONLY a
    ``stream_fn`` is *streaming-required* and is rejected at env/spec
    construction for scenarios that can't produce per-request metrics.

    Composite objectives (latency x cost, goodput per dollar, ...) are just
    new ``Objective`` instances registered with ``register_objective`` —
    neither the env nor the scenarios need to change.  Functions should be
    module-level so envs stay picklable for the process pool."""
    name: str
    scalar_fn: Callable[[float, Network], float] | None = None
    stream_fn: Callable[["StreamMetrics", Network], float] | None = None
    doc: str = ""

    def __post_init__(self):
        if self.scalar_fn is None and self.stream_fn is None:
            raise ValueError(f"objective {self.name!r} needs a scalar_fn "
                             f"and/or a stream_fn")

    @property
    def streaming(self) -> bool:
        """True when this objective REQUIRES per-request stream metrics."""
        return self.scalar_fn is None

    def scalar(self, latency_ms: float, net: Network) -> float:
        if self.scalar_fn is None:
            raise ValueError(f"objective {self.name!r} has no scalar form — "
                             f"it needs a streaming scenario")
        return self.scalar_fn(latency_ms, net)

    def stream(self, metrics: "StreamMetrics", net: Network) -> float:
        """Reward for per-request metrics; scalar-only objectives apply to
        the p99 end-to-end request latency (so e.g. ``perf_per_cost`` still
        regularizes by the network spend)."""
        if self.stream_fn is not None:
            return self.stream_fn(metrics, net)
        return self.scalar_fn(metrics.latency_p99_ms, net)


OBJECTIVES: dict[str, Objective] = {}


def register_objective(obj: Objective, *, replace: bool = False) -> Objective:
    if not replace and obj.name in OBJECTIVES:
        raise ValueError(f"objective {obj.name!r} already registered")
    OBJECTIVES[obj.name] = obj
    return obj


def get_objective(objective: "str | Objective") -> Objective:
    """Resolve an objective by name (or pass an ``Objective`` through —
    ad-hoc composites don't have to be registered)."""
    if isinstance(objective, Objective):
        return objective
    try:
        return OBJECTIVES[objective]
    except KeyError:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"known: {sorted(OBJECTIVES)}") from None


def list_objectives() -> dict[str, Objective]:
    return dict(OBJECTIVES)


def slo_attainment(latency_ms: float, slo_ms: float) -> float:
    """Soft SLO attainment in [0, 1]: 1 when the latency meets the SLO,
    degrading proportionally when it misses (multi-tenant objective)."""
    if latency_ms <= 0 or math.isinf(latency_ms):
        return 0.0
    return min(1.0, slo_ms / latency_ms)


# ---------------------------------------------------------------------------
# Streaming (request-stream serving) objectives
# ---------------------------------------------------------------------------

# kept as a compat alias; the source of truth is Objective.streaming
# (an objective whose reward is a function of per-request metrics, not one
# latency).  Derived after the built-in registrations below.
STREAM_OBJECTIVES: tuple[str, ...] = ()


def percentile(values: "list[float] | np.ndarray", p: float) -> float:
    """Numpy's default linear-interpolated percentile over a per-request
    metric list; 0.0 on empty input (np.percentile raises there)."""
    if len(values) == 0:
        return 0.0
    return float(np.percentile(values, p))


@dataclass(frozen=True)
class StreamMetrics:
    """Per-request serving metrics aggregated over one simulated request
    stream: time-to-first-token and time-per-output-token percentiles, plus
    goodput — requests meeting BOTH SLOs, per second of simulated horizon."""
    n_requests: int
    n_ok: int
    ttft_p50_ms: float
    ttft_p99_ms: float
    tpot_p50_ms: float
    tpot_p99_ms: float
    latency_p99_ms: float       # end-to-end (arrival -> last token)
    goodput_rps: float
    horizon_ms: float
    # dollars of capacity actually provisioned over the horizon (the fleet
    # layer sums replica-seconds per autoscaler decisions); None means a
    # single statically-provisioned network — cost objectives then fall
    # back to ``net.dollar_cost()``, bit-identical to the pre-fleet path
    provisioned_cost: float | None = None

    def detail(self) -> dict[str, float]:
        d = {
            "n_requests": self.n_requests, "n_ok": self.n_ok,
            "ttft_p50_ms": self.ttft_p50_ms, "ttft_p99_ms": self.ttft_p99_ms,
            "tpot_p50_ms": self.tpot_p50_ms, "tpot_p99_ms": self.tpot_p99_ms,
            "latency_p99_ms": self.latency_p99_ms,
            "goodput_rps": self.goodput_rps, "horizon_ms": self.horizon_ms,
        }
        if self.provisioned_cost is not None:
            d["provisioned_cost"] = self.provisioned_cost
        return d


def stream_metrics(ttft_ms: "list[float] | np.ndarray",
                   tpot_ms: "list[float] | np.ndarray",
                   latency_ms: "list[float] | np.ndarray", *,
                   ttft_slo_ms: float, tpot_slo_ms: float,
                   horizon_ms: float) -> StreamMetrics:
    """Aggregate per-request TTFT/TPOT/e2e-latency lists into percentiles
    and SLO goodput.  ``horizon_ms`` is the simulated span the goodput rate
    is normalized over (last completion or last arrival, whichever later).

    Accepts lists or numpy arrays; the SLO count and the paired p50/p99
    reads are vectorized (one ``np.percentile`` call per metric — the same
    linear interpolation per q as separate calls, so values are unchanged)."""
    ttft = np.asarray(ttft_ms, dtype=np.float64)
    tpot = np.asarray(tpot_ms, dtype=np.float64)
    lat = np.asarray(latency_ms, dtype=np.float64)
    n_ok = int(np.count_nonzero((ttft <= ttft_slo_ms)
                                & (tpot <= tpot_slo_ms)))
    t50, t99 = (np.percentile(ttft, (50, 99)) if len(ttft) else (0.0, 0.0))
    p50, p99 = (np.percentile(tpot, (50, 99)) if len(tpot) else (0.0, 0.0))
    return StreamMetrics(
        n_requests=len(ttft), n_ok=n_ok,
        ttft_p50_ms=float(t50), ttft_p99_ms=float(t99),
        tpot_p50_ms=float(p50), tpot_p99_ms=float(p99),
        latency_p99_ms=percentile(lat, 99),
        goodput_rps=n_ok / max(horizon_ms / 1e3, 1e-9),
        horizon_ms=horizon_ms,
    )


def stream_reward(objective: "str | Objective", metrics: StreamMetrics,
                  net: Network) -> float:
    """Resolve a streaming scenario's reward: ``goodput`` maximizes SLO-
    meeting requests/sec; any scalar objective is applied to the p99
    end-to-end request latency (so e.g. ``perf_per_cost`` still regularizes
    by the network spend)."""
    return get_objective(objective).stream(metrics, net)


def reward_goodput(metrics: StreamMetrics, net: Network) -> float:
    return metrics.goodput_rps


def serving_cost(metrics: StreamMetrics, net: Network) -> float:
    """The dollar denominator for cost-normalized streaming objectives.
    Fleet scenarios price the replica-seconds actually provisioned by the
    autoscaler (``metrics.provisioned_cost``); single-engine scenarios have
    no fleet layer and pay the static network cost."""
    if metrics.provisioned_cost is not None:
        return metrics.provisioned_cost
    return net.dollar_cost()


def reward_goodput_per_cost(metrics: StreamMetrics, net: Network) -> float:
    """Composite example: SLO-meeting requests/sec per million dollars of
    provisioned capacity — extensible objectives never touch the env or
    the scenarios."""
    return metrics.goodput_rps / max(serving_cost(metrics, net) / 1e6, 1e-9)


def reward_goodput_per_dollar(metrics: StreamMetrics, net: Network) -> float:
    """The fleet-first-class form of goodput-per-cost: with an autoscaler,
    replicas scaled down during traffic troughs stop costing, so the
    denominator tracks provisioned replica-seconds rather than one static
    ``Network`` price.  Identical to ``goodput_per_cost`` arithmetic — the
    distinction is semantic intent (fleet studies name this one)."""
    return reward_goodput_per_cost(metrics, net)


register_objective(Objective("perf_per_bw", scalar_fn=reward_perf_per_bw,
                             doc="1/|latency * BW-per-NPU - 1| (paper 5.4)"))
register_objective(Objective("perf_per_cost", scalar_fn=reward_perf_per_cost,
                             doc="1/|latency * network-$ - 1| (paper 5.4)"))
register_objective(Objective("latency", scalar_fn=reward_latency,
                             doc="1/latency — raw end-to-end speed"))
register_objective(Objective("goodput", stream_fn=reward_goodput,
                             doc="SLO-meeting requests/sec (streaming only)"))
register_objective(Objective(
    "goodput_per_cost", stream_fn=reward_goodput_per_cost,
    doc="SLO goodput per network $M (streaming only, composite)"))
register_objective(Objective(
    "goodput_per_dollar", stream_fn=reward_goodput_per_dollar,
    doc="SLO goodput per provisioned $M — autoscaler-aware (fleet)"))

STREAM_OBJECTIVES = tuple(n for n, o in OBJECTIVES.items() if o.streaming)


def evaluate_job(spec: ArchSpec, par: Parallelism, cfg: SystemConfig, *,
                 batch: int, seq: int, mode: str = "train",
                 objective: "str | Objective" = "perf_per_bw",
                 capacity_gb: float = 24.0,
                 decode_tokens: int = 64) -> "SimJob | Evaluation":
    """The paper pipeline as a declarative ``SimJob``: validity/memory gates
    resolve immediately to an ``Evaluation``; surviving points return the
    simulator calls plus the reward-finalization closure, executable on any
    simulation backend (and batchable across an agent population)."""
    obj = get_objective(objective)
    if not par.valid():
        return Evaluation(0.0, float("inf"), False, {"why": "parallelization invalid"})
    fp = footprint(spec, par, batch=batch, seq=seq, mode=mode)
    if fp.total_gb > capacity_gb:
        return Evaluation(0.0, float("inf"), False,
                          {"why": f"memory {fp.total_gb:.1f}GB > {capacity_gb}GB"})
    if mode == "serve":
        # prefill the prompt once + decode `decode_tokens` new tokens
        pre_tr = generate_trace(spec, par, batch=batch, seq=seq,
                                mode="inference")
        dec_tr = generate_trace(spec, par, batch=batch, seq=seq,
                                mode="decode")

        def fin_serve(results: list[SimResult]) -> Evaluation:
            pre, dec = results
            latency_ms = pre.latency_ms + decode_tokens * dec.latency_ms
            r = obj.scalar(latency_ms, cfg.network)
            return Evaluation(r, latency_ms, True, {
                "footprint_gb": fp.total_gb,
                "prefill_ms": pre.latency_ms, "decode_ms": dec.latency_ms,
            })

        return SimJob((SimCall(pre_tr, cfg, par), SimCall(dec_tr, cfg, par)),
                      fin_serve)
    trace = generate_trace(spec, par, batch=batch, seq=seq, mode=mode)

    def fin(results: list[SimResult]) -> Evaluation:
        res = results[0]
        r = obj.scalar(res.latency_ms, cfg.network)
        return Evaluation(r, res.latency_ms, True, {
            "footprint_gb": fp.total_gb,
            "exposed_comm_us": res.exposed_comm_us,
            "compute_busy_us": res.compute_busy_us,
            "comm_busy_us": res.comm_busy_us,
        })

    return SimJob((SimCall(trace, cfg, par),), fin)


def evaluate(spec: ArchSpec, par: Parallelism, cfg: SystemConfig, *,
             batch: int, seq: int, mode: str = "train",
             objective: "str | Objective" = "perf_per_bw",
             capacity_gb: float = 24.0, decode_tokens: int = 64,
             backend: "str | None" = None) -> Evaluation:
    """Full paper pipeline: WTG -> simulate -> reward (+ memory gate), on
    the selected simulation backend (default: reference)."""
    return run_sim_job(
        evaluate_job(spec, par, cfg, batch=batch, seq=seq, mode=mode,
                     objective=objective, capacity_gb=capacity_gb,
                     decode_tokens=decode_tokens), backend)
