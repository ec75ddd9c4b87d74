"""repro_torch.core.fleet — serving at fleet scale.

Generalizes ``RequestStreamScenario``'s single engine to N model replicas
over a (possibly heterogeneous) ``topology.Cluster``:

  * **Arrival-trace generators** — seeded, deterministic request streams:
    homogeneous Poisson, ``diurnal`` (sinusoidal non-homogeneous Poisson —
    the day/night cycle of millions-of-users traffic), ``bursty``
    (Markov-modulated Poisson: calm <-> burst phases), and ``replayed``
    (cycled inter-arrival gaps from a production trace).
  * **Router policies** — deterministic pre-simulation request->replica
    assignment: ``round-robin``, ``least-outstanding`` (greedy virtual-queue
    argmin under an analytic service-time estimate), and ``prefix-hash``
    (session-affinity hashing; with ``n_sessions > 0`` a replica-local
    prefix-cache hit shrinks the request's effective prompt).
  * **Autoscaler** — target-utilization up/down with cooldown over fixed
    decision epochs; replicas scaled down stop accruing provisioned cost.
  * **``FleetScenario``** — each replica's routed sub-stream evaluates
    through the shared ``RequestStreamScenario.stream_call`` engine core as
    one ``SimCall`` on the replica's cluster partition, so the whole fleet
    is a single ``SimJob`` and vectorized backends sweep replicas like
    population members.  Fleet metrics concatenate per-replica per-request
    arrays; the ``goodput_per_dollar`` objective divides by the dollars of
    capacity *actually provisioned* (``StreamMetrics.provisioned_cost``).

A 1-replica fleet with a static router/autoscaler and preemption off
reduces bit-identically to ``RequestStreamScenario`` — the subsystem
provably contains the single-engine model (see ``tests/test_fleet.py``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, replace
from typing import Any, ClassVar, Mapping

import numpy as np

from repro_torch.configs.base import ArchSpec
from repro_torch.core.backends import SimJob, run_sim_job
from repro_torch.core.cache import switchable_lru_cache
from repro_torch.core.compute import DEVICES, Device
from repro_torch.core.psa import Constraint, Parameter
from repro_torch.core.rewards import Evaluation, stream_metrics, stream_reward
from repro_torch.core.scenario import (EnvContext, RequestStreamScenario, _invalid,
                                 _arrivals_cached, _request_shapes_cached,
                                 _request_tiers_cached,
                                 dataclass_scenario_builder, register_scenario)
from repro_torch.core.simulator import SimResult
from repro_torch.core.topology import Cluster, partition_cluster

# ---------------------------------------------------------------------------
# Arrival-trace generators
# ---------------------------------------------------------------------------

ARRIVAL_KINDS = ("poisson", "diurnal", "bursty", "replayed")


def _diurnal_times_impl(n: int, base_rps: float, peak_rps: float,
                        period_s: float, seed: int) -> tuple[float, ...]:
    """Non-homogeneous Poisson arrivals under a sinusoidal rate that starts
    at the trough: ``rate(t) = base + (peak-base) * (1 - cos(2*pi*t/T))/2``.
    Each gap is drawn exponential at the instantaneous rate (the rate moves
    slowly against the gaps, so the realized mean tracks ``(base+peak)/2``
    over whole periods)."""
    rng = np.random.default_rng([seed, 0xD1])
    period_ms = max(period_s, 1e-9) * 1e3
    t, out = 0.0, []
    for _ in range(n):
        r = base_rps + (peak_rps - base_rps) * 0.5 \
            * (1.0 - math.cos(2.0 * math.pi * t / period_ms))
        t += rng.exponential(1000.0 / max(r, 1e-9))
        out.append(t)
    return tuple(out)


def _bursty_times_impl(n: int, rate_rps: float, burst_factor: float,
                       burst_s: float, seed: int) -> tuple[float, ...]:
    """Markov-modulated Poisson arrivals: calm phases at ``rate_rps``,
    burst phases at ``rate_rps * burst_factor``; mean dwell ``burst_s`` in
    a burst and ``3 * burst_s`` calm (so ~25% of wall time is burst)."""
    rng = np.random.default_rng([seed, 0xB5])
    t, burst, out = 0.0, False, []
    for _ in range(n):
        r = rate_rps * (burst_factor if burst else 1.0)
        g = rng.exponential(1000.0 / max(r, 1e-9))
        t += g
        out.append(t)
        dwell_ms = (burst_s if burst else 3.0 * burst_s) * 1e3
        if rng.random() < 1.0 - math.exp(-g / max(dwell_ms, 1e-9)):
            burst = not burst
    return tuple(out)


_diurnal_times = switchable_lru_cache(maxsize=64)(_diurnal_times_impl)
_bursty_times = switchable_lru_cache(maxsize=64)(_bursty_times_impl)


def arrival_times_ms(kind: str, n: int, *, rate_rps: float = 8.0,
                     peak_rps: float = 0.0, period_s: float = 60.0,
                     burst_factor: float = 4.0, burst_s: float = 2.0,
                     gaps_ms: tuple = (), seed: int = 0) -> tuple[float, ...]:
    """Deterministic seeded arrival times for one of ``ARRIVAL_KINDS``.
    ``poisson`` and ``replayed`` delegate to the engine's generator (same
    draws as ``RequestStreamScenario`` — the fleet reduction depends on
    this); ``diurnal`` defaults its peak to ``2 * rate_rps`` when
    ``peak_rps`` is unset."""
    if n < 1:
        raise ValueError(f"need n >= 1 arrivals, got {n}")
    if kind == "poisson":
        return _arrivals_cached((), n, rate_rps, seed)
    if kind == "replayed":
        if not gaps_ms:
            raise ValueError("replayed arrivals need arrival_gaps_ms")
        return _arrivals_cached(tuple(gaps_ms), n, rate_rps, seed)
    if kind == "diurnal":
        peak = peak_rps if peak_rps > 0.0 else 2.0 * rate_rps
        return _diurnal_times(n, rate_rps, peak, period_s, seed)
    if kind == "bursty":
        return _bursty_times(n, rate_rps, burst_factor, burst_s, seed)
    raise ValueError(f"unknown arrival kind {kind!r}; "
                     f"known: {list(ARRIVAL_KINDS)}")


def _session_groups_impl(n: int, n_sessions: int,
                         seed: int) -> tuple[int, ...]:
    if n_sessions <= 0:
        return tuple(range(n))    # every request its own session: no reuse
    rng = np.random.default_rng([seed, 0x5E])
    return tuple(int(v) for v in rng.integers(0, n_sessions, size=n))


_session_groups = switchable_lru_cache(maxsize=64)(_session_groups_impl)


# ---------------------------------------------------------------------------
# Router + autoscaler (deterministic pre-simulation policies)
# ---------------------------------------------------------------------------

ROUTER_POLICIES = ("round-robin", "least-outstanding", "prefix-hash")


def svc_est_ms(spec: ArchSpec, device: Device, n_npus: int, mfu: float,
               prompt: int, decode: int) -> float:
    """Analytic per-request service-time estimate (ms): 2*P flops per token
    over the replica's aggregate compute at ``mfu`` utilization — the
    router/autoscaler hint, NOT the simulated time."""
    flops = 2.0 * spec.param_count() * (prompt + decode)
    return flops / max(mfu * device.peak_tflops * 1e12 * n_npus, 1e-9) * 1e3


def autoscale_active(arrivals_ms: tuple, *, epoch_ms: float,
                     min_replicas: int, max_replicas: int,
                     target_util: float, cooldown_epochs: int,
                     replica_rps: float) -> tuple[int, ...]:
    """Per-epoch active replica counts from a reactive target-utilization
    policy: each epoch's capacity is decided BEFORE its arrivals land (from
    the previous epochs' observed rate), scale-up jumps straight to the
    demanded count, scale-down sheds one replica per cooldown window.
    ``target_util <= 0`` disables autoscaling (static full fleet)."""
    n_epochs = int(arrivals_ms[-1] // epoch_ms) + 1 if arrivals_ms else 1
    if target_util <= 0.0:
        return (max_replicas,) * n_epochs
    counts = np.bincount(
        np.minimum(np.asarray(arrivals_ms) // epoch_ms,
                   n_epochs - 1).astype(int), minlength=n_epochs)
    active, cool, out = min_replicas, 0, []
    for c in counts:
        out.append(active)
        rate = float(c) / (epoch_ms / 1e3)
        desired = math.ceil(rate / max(target_util * replica_rps, 1e-9))
        desired = min(max_replicas, max(min_replicas, desired))
        cool -= 1
        if cool <= 0 and desired != active:
            active = desired if desired > active else active - 1
            cool = cooldown_epochs
    return tuple(out)


def route_requests(policy: str, arrivals_ms: tuple, active_per_req: list,
                   svc_ms: list, groups: tuple,
                   max_replicas: int) -> tuple[int, ...]:
    """Deterministic request -> replica assignment among the replicas active
    at each request's arrival epoch (replicas ``0..active-1``)."""
    assign: list[int] = []
    if policy == "round-robin":
        for k, a in enumerate(active_per_req):
            assign.append(k % a)
    elif policy == "least-outstanding":
        busy = [0.0] * max_replicas
        for i, (t, a) in enumerate(zip(arrivals_ms, active_per_req)):
            r = min(range(a), key=lambda j: (busy[j], j))
            assign.append(r)
            busy[r] = max(busy[r], t) + svc_ms[i]
    elif policy == "prefix-hash":
        for g, a in zip(groups, active_per_req):
            # Knuth multiplicative hash keeps low session ids well spread
            assign.append((g * 2654435761) % (1 << 32) % a)
    else:
        raise ValueError(f"unknown router policy {policy!r}; "
                         f"known: {list(ROUTER_POLICIES)}")
    return tuple(assign)


# ---------------------------------------------------------------------------
# FleetScenario
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FleetScenario:
    """A fleet of ``replicas`` serving engines over disjoint partitions of
    one cluster, fed by a routed arrival trace and scaled by a
    target-utilization autoscaler.

    Each replica is a full ``RequestStreamScenario`` engine (disaggregated
    prefill/decode pools, admission waves, the opt-in continuous-batching
    knobs) on ``n_npus / replicas`` NPUs of the cluster fabric — carved via
    ``partition_cluster``, so a replica's collectives are priced on its own
    sub-network and ``replica_devices`` can install heterogeneous compute.
    The searchable scenario stack adds ``router``, ``autoscale_target``
    (0 = static full fleet) and ``autoscale_cooldown_s`` on top of the
    engine knobs; ``objective="goodput_per_dollar"`` divides fleet SLO
    goodput by the dollars of capacity actually provisioned (autoscaled
    replica-seconds), making goodput-per-dollar searchable end to end."""
    supports_stream_objectives: ClassVar[bool] = True

    # -- request stream shape (engine fields, shared by every replica) -----
    n_requests: int = 256
    seq: int = 2048
    decode_tokens: int = 64
    seed: int = 0
    prompt_len_range: tuple = ()
    decode_len_range: tuple = ()
    prompt_lens: tuple = ()
    decode_lens: tuple = ()
    max_batch: int = 32
    ttft_slo_ms: float = 4000.0
    tpot_slo_ms: float = 200.0
    priority_frac: float = 0.0
    priorities: tuple = ()
    # -- arrival trace -----------------------------------------------------
    arrival: str = "poisson"         # poisson | diurnal | bursty | replayed
    rate_rps: float = 8.0            # base rate (diurnal trough)
    peak_rps: float = 0.0            # diurnal peak (0 -> 2 * rate_rps)
    period_s: float = 60.0           # diurnal period
    burst_factor: float = 4.0        # bursty rate multiplier
    burst_s: float = 2.0             # bursty mean burst dwell
    arrival_gaps_ms: tuple = ()      # replayed inter-arrival gaps
    # -- fleet shape -------------------------------------------------------
    replicas: int = 2                # cluster is carved into this many
    min_replicas: int = 1            # autoscaler floor
    replica_devices: tuple = ()      # per-replica DEVICES names ("" = env)
    epoch_s: float = 10.0            # autoscaler decision epoch
    mfu_hint: float = 0.35           # analytic capacity estimate for hints
    n_sessions: int = 0              # >0 enables the prefix-cache model
    prefix_hit_frac: float = 0.75    # prompt fraction skipped on a hit
    # -- searchable knobs (scenario stack) ---------------------------------
    routers: tuple = ROUTER_POLICIES
    autoscale_targets: tuple = (0.0, 0.55, 0.75, 0.9)
    autoscale_cooldowns_s: tuple = (10.0, 30.0)
    # -- engine knobs forwarded to every replica ---------------------------
    batch_windows_ms: tuple = (0.0, 50.0, 200.0, 500.0, 1000.0)
    max_inflights: tuple = (1, 2, 4, 8)
    prefill_fracs: tuple = (0.25, 0.5, 0.625, 0.75, 0.875)
    decode_batches: tuple = (4, 8, 16, 32)
    admissions: tuple = ()
    prefill_chunk_choices: tuple = ()
    preempt_choices: tuple = ()
    kv_headrooms: tuple = ()
    name: str = "fleet"

    # -- engine assembly ---------------------------------------------------
    def _engine_template(self) -> RequestStreamScenario:
        """An engine with this fleet's knob choice tuples (for PsA params —
        request shapes are irrelevant there)."""
        return RequestStreamScenario(
            batch_windows_ms=self.batch_windows_ms,
            max_inflights=self.max_inflights,
            prefill_fracs=self.prefill_fracs,
            decode_batches=self.decode_batches,
            admissions=self.admissions,
            prefill_chunk_choices=self.prefill_chunk_choices,
            preempt_choices=self.preempt_choices,
            kv_headrooms=self.kv_headrooms)

    def _engine(self, n: int, times: tuple, prompts: tuple, decodes: tuple,
                tiers: tuple) -> RequestStreamScenario:
        """One replica's engine: the routed sub-stream replayed as explicit
        arrival times / per-request lengths / priority tiers."""
        return replace(self._engine_template(), n_requests=n,
                       seq=self.seq, decode_tokens=self.decode_tokens,
                       seed=self.seed, max_batch=self.max_batch,
                       ttft_slo_ms=self.ttft_slo_ms,
                       tpot_slo_ms=self.tpot_slo_ms,
                       arrival_times_ms=times, prompt_lens=prompts,
                       decode_lens=decodes, priorities=tiers)

    # -- deterministic pre-simulation inputs -------------------------------
    def arrivals_ms(self) -> tuple[float, ...]:
        return arrival_times_ms(
            self.arrival, self.n_requests, rate_rps=self.rate_rps,
            peak_rps=self.peak_rps, period_s=self.period_s,
            burst_factor=self.burst_factor, burst_s=self.burst_s,
            gaps_ms=self.arrival_gaps_ms, seed=self.seed)

    def request_shapes(self) -> tuple[tuple[int, int], ...]:
        return _request_shapes_cached(
            self.n_requests, self.seq, self.decode_tokens, self.prompt_lens,
            self.decode_lens, self.prompt_len_range, self.decode_len_range,
            self.seed)

    def request_tiers(self) -> tuple[int, ...]:
        return _request_tiers_cached(self.n_requests, self.priorities,
                                     self.priority_frac, self.seed)

    def session_groups(self) -> tuple[int, ...]:
        return _session_groups(self.n_requests, self.n_sessions, self.seed)

    # -- PsA ---------------------------------------------------------------
    def psa_params(self) -> list[Parameter]:
        params = self._engine_template().psa_params()
        params.extend([
            Parameter("router", "scenario", self.routers,
                      doc="request -> replica routing policy"),
            Parameter("autoscale_target", "scenario", self.autoscale_targets,
                      doc="target utilization (0 = static full fleet)"),
            Parameter("autoscale_cooldown_s", "scenario",
                      self.autoscale_cooldowns_s,
                      doc="min seconds between autoscaler decisions"),
        ])
        return params

    def psa_constraints(self, n_npus: int) -> list[Constraint]:
        # every replica runs the parallelism on its own carve-out, so the
        # searchable (dp, sp, pp) must fit ONE replica, not the cluster —
        # without this the agents mostly sample dead full-cluster layouts
        per = max(n_npus // max(self.replicas, 1), 1)
        return [Constraint("product_le", ("dp", "sp", "pp"), per,
                           name=f"parallelism fits one replica ({per} NPUs)")]

    def canonical(self, config: Mapping[str, Any]) -> Mapping[str, Any]:
        """Memo-key canonicalization: with autoscaling off the cooldown is
        dead, and with one replica the router is dead — don't re-evaluate
        their aliases."""
        cfg = dict(config)
        changed = False
        if float(cfg.get("autoscale_target", 0.0)) <= 0.0 \
                and "autoscale_cooldown_s" in cfg:
            cfg["autoscale_cooldown_s"] = self.autoscale_cooldowns_s[0]
            changed = True
        if self.replicas == 1 and "router" in cfg:
            cfg["router"] = self.routers[0]
            changed = True
        return cfg if changed else config

    def lint_info(self) -> dict[str, Any]:
        """Extra shape facts for ``python -m repro_torch.dse lint``: the fleet
        cost multiplier over a single engine's trace."""
        return {"replicas": self.replicas, "arrival": self.arrival,
                "fleet_requests": self.n_requests}

    # -- the fleet plan (deterministic, pre-simulation) --------------------
    def _cluster(self, ctx: EnvContext) -> Cluster:
        per = ctx.n_npus // self.replicas
        names = [f"replica{r}" for r in range(self.replicas)]
        devices = []
        for r in range(self.replicas):
            nm = self.replica_devices[r] if r < len(self.replica_devices) \
                else ""
            devices.append(DEVICES[nm] if nm else ctx.device)
        return partition_cluster(ctx.network, [per] * self.replicas,
                                 devices, names=names)

    def _plan(self, ctx: EnvContext):
        """(active-per-epoch, per-request assignment, effective prompts,
        epoch_ms) — everything the router/autoscaler decides before any
        simulation runs."""
        arrivals = self.arrivals_ms()
        shapes = self.request_shapes()
        groups = self.session_groups()
        epoch_ms = max(self.epoch_s, 1e-3) * 1e3
        svc = [svc_est_ms(ctx.spec, ctx.device,
                          ctx.n_npus // self.replicas, self.mfu_hint, p, d)
               for p, d in shapes]
        replica_rps = 1000.0 * len(svc) / max(sum(svc), 1e-9)
        target = float(ctx.config["autoscale_target"])
        cooldown = max(1, int(round(
            float(ctx.config["autoscale_cooldown_s"])
            / max(self.epoch_s, 1e-9))))
        active = autoscale_active(
            arrivals, epoch_ms=epoch_ms, min_replicas=self.min_replicas,
            max_replicas=self.replicas, target_util=target,
            cooldown_epochs=cooldown, replica_rps=replica_rps)
        epoch_of = [min(int(t // epoch_ms), len(active) - 1)
                    for t in arrivals]
        active_per_req = [active[e] for e in epoch_of]
        assign = route_requests(str(ctx.config["router"]), arrivals,
                                active_per_req, svc, groups, self.replicas)
        # replica-local prefix-cache: a repeat session on the same replica
        # skips prefix_hit_frac of its prompt (affinity routing earns hits)
        eff_prompt = [p for p, _ in shapes]
        if self.n_sessions > 0:
            seen: list[set] = [set() for _ in range(self.replicas)]
            for i, r in enumerate(assign):
                if groups[i] in seen[r]:
                    eff_prompt[i] = max(1, int(round(
                        eff_prompt[i] * (1.0 - self.prefix_hit_frac))))
                seen[r].add(groups[i])
        return arrivals, shapes, active, assign, eff_prompt, epoch_ms, target

    def traces(self, ctx: EnvContext):
        out = {}
        got = self._replica_calls(ctx)
        if isinstance(got, Evaluation):
            return out
        for r, _, call, _, _, _ in got[0]:
            out[f"replica{r}"] = call.trace
        return out

    def _replica_calls(self, ctx: EnvContext):
        if self.replicas < 1:
            return _invalid(f"need >= 1 replicas, got {self.replicas}")
        if ctx.n_npus % self.replicas:
            return _invalid(f"{ctx.n_npus} NPUs not divisible into "
                            f"{self.replicas} replicas")
        if self.replica_devices and \
                len(self.replica_devices) != self.replicas:
            return _invalid(
                f"replica_devices has {len(self.replica_devices)} entries "
                f"for {self.replicas} replicas")
        cluster = self._cluster(ctx)
        arrivals, shapes, active, assign, eff_prompt, epoch_ms, target = \
            self._plan(ctx)
        tiers = self.request_tiers()
        per_replica: list[list[int]] = [[] for _ in range(self.replicas)]
        for i, r in enumerate(assign):
            per_replica[r].append(i)
        slices = []
        for r, idxs in enumerate(per_replica):
            if not idxs:
                continue
            part = cluster.partitions[r]
            eng = self._engine(
                len(idxs), tuple(arrivals[i] for i in idxs),
                tuple(eff_prompt[i] for i in idxs),
                tuple(shapes[i][1] for i in idxs),
                tuple(tiers[i] for i in idxs))
            rctx = replace(
                ctx, n_npus=part.n_npus, device=part.device,
                network=part.network,
                sys_cfg=replace(ctx.sys_cfg, network=part.network,
                                device=part.device))
            got = eng.stream_call(rctx)
            if isinstance(got, Evaluation):
                return replace(got, detail=dict(
                    got.detail, scenario=self.name, replica=r))
            call, request_times, rdetail, last_arr = got
            slices.append((r, idxs, call, request_times, rdetail, last_arr))
        if not slices:
            return _invalid("no replica received any requests")
        return slices, cluster, active, assign, epoch_ms, target, arrivals

    def sim_job(self, ctx: EnvContext) -> "SimJob | Evaluation":
        got = self._replica_calls(ctx)
        if isinstance(got, Evaluation):
            return got
        slices, cluster, active, assign, epoch_ms, target, arrivals = got
        router = str(ctx.config["router"])
        cooldown_s = float(ctx.config["autoscale_cooldown_s"])

        def fin(results: list[SimResult]) -> Evaluation:
            tt, tp, la = [], [], []
            makespan = {}
            for (r, idxs, _, request_times, _, _), res in zip(slices,
                                                              results):
                a, b, c = request_times(res)
                tt.append(a)
                tp.append(b)
                la.append(c)
                makespan[r] = res.latency_ms
            ttfts = np.concatenate(tt)
            tpots = np.concatenate(tp)
            lats = np.concatenate(la)
            horizon_ms = max(max(makespan.values()), arrivals[-1])
            m = stream_metrics(ttfts, tpots, lats,
                               ttft_slo_ms=self.ttft_slo_ms,
                               tpot_slo_ms=self.tpot_slo_ms,
                               horizon_ms=horizon_ms)
            # provisioned cost: static fleets pay every partition for the
            # whole horizon (1-replica case == net.dollar_cost() exactly);
            # autoscaled fleets pay per-replica provisioned epochs plus the
            # drain tail past each replica's last active epoch
            prov_ms = []
            for r, part in enumerate(cluster.partitions):
                if target <= 0.0:
                    prov_ms.append(horizon_ms)
                    continue
                epochs_on = [e for e, a_ in enumerate(active) if a_ > r]
                on_ms = epoch_ms * len(epochs_on)
                drain = 0.0
                if epochs_on and r in makespan:
                    end = epoch_ms * (epochs_on[-1] + 1)
                    drain = max(0.0, makespan[r] - end)
                prov_ms.append(on_ms + drain)
            cost = sum(
                part.network.dollar_cost() * (pm / max(horizon_ms, 1e-9))
                for part, pm in zip(cluster.partitions, prov_ms))
            m = dataclasses.replace(m, provisioned_cost=cost)
            r_ = stream_reward(ctx.objective, m, ctx.sys_cfg.network)
            n_req = [0] * self.replicas
            for r, idxs, *_ in slices:
                n_req[r] = len(idxs)
            return Evaluation(r_, m.latency_p99_ms, True, {
                "scenario": self.name, "replicas": self.replicas,
                "replica_npus": ctx.n_npus // self.replicas,
                "arrival": self.arrival, "router": router,
                "autoscale_target": target,
                "autoscale_cooldown_s": cooldown_s,
                "active_per_epoch": list(active),
                "replica_requests": n_req,
                "replica_makespan_ms": {str(r): ms
                                        for r, ms in sorted(makespan.items())},
                "provisioned_replica_s": [pm / 1e3 for pm in prov_ms],
                "makespan_ms": max(makespan.values()),
                "cluster": cluster.describe(),
                **m.detail(),
            })

        return SimJob(tuple(call for _, _, call, _, _, _ in slices), fin)

    def evaluate(self, ctx: EnvContext) -> Evaluation:
        return run_sim_job(self.sim_job(ctx), ctx.backend)


register_scenario("fleet", dataclass_scenario_builder(FleetScenario))
