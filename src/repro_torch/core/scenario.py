"""The scenario layer: what workload shape is the cluster being designed for?

COSMIC's co-design loop is scenario-agnostic — the paper evaluates training,
serving, and mixed clusters with the same PsA/agent machinery.  A
``Scenario`` packages everything workload-shape-specific behind three
methods:

  * ``psa_params()`` / ``psa_constraints(n_npus)`` — the searchable knobs
    this scenario contributes to the PsA (stack ``"scenario"``), searched by
    agents alongside the workload/collective/network stacks;
  * ``traces(ctx)`` — the symbolic phase traces behind one design point
    (inspection/debug);
  * ``evaluate(ctx)`` — design point -> ``Evaluation`` (reward, latency,
    validity gate), where ``ctx`` is the env-resolved ``EnvContext``.

Four built-ins:

  ``TrainScenario``         one homogeneous training (or monolithic-serving)
                            job — bit-identical to the pre-scenario engine.
  ``DisaggServeScenario``   disaggregated serving: separate prefill and
                            decode NPU pools sized by a searchable
                            ``prefill_frac``, a KV-cache transfer collective
                            between pools, and decode continuous batching
                            with a searchable ``decode_batch``.  Multi-wave
                            loads run as a pipelined multi-wave trace.
  ``RequestStreamScenario`` serving driven by an arrival process (Poisson
                            rate or a replayable inter-arrival trace):
                            requests queue, admit under a searchable
                            batching window / max-in-flight cap, and the
                            admitted waves run as one pipelined multi-pool
                            trace; rewards are streaming metrics (TTFT/TPOT
                            percentiles, SLO goodput).
  ``MultiTenantScenario``   N workloads on disjoint (possibly heterogeneous)
                            cluster partitions whose sizes are searchable;
                            reward is weighted SLO attainment.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, replace
from typing import (Any, Callable, ClassVar, Mapping, Protocol,
                    runtime_checkable)

import numpy as np

from repro_torch.configs.base import ArchSpec
from repro_torch.core.backends import SimCall, SimJob, run_sim_job
from repro_torch.core.cache import switchable_lru_cache
from repro_torch.core.compute import DEVICES, Device
from repro_torch.core.memory import footprint, kv_cache_bytes
from repro_torch.core.psa import Constraint, Parameter, ParameterSet
from repro_torch.core.rewards import (Evaluation, Objective, evaluate_job,
                                slo_attainment, stream_metrics, stream_reward)
from repro_torch.core.simulator import SimResult, SystemConfig
from repro_torch.core.topology import (Cluster, Network, partition_cluster,
                                 sub_network, sub_network_indexed)
from repro_torch.core.workload import (Parallelism, Trace, Wave, WaveSegment,
                                 compose_phases, compose_request_waves,
                                 generate_trace)


@dataclass(frozen=True)
class EnvContext:
    """Everything the env resolves before handing a design point to its
    scenario: the fixed system description plus the per-point config and the
    network/system stacks built from it.  ``backend`` selects the simulation
    backend (``repro_torch.core.backends``) the scenario's ``SimJob`` runs on —
    a registry name (kept a string so envs stay picklable for the process
    pool); ``None`` means the reference event loop."""
    spec: ArchSpec
    n_npus: int
    device: Device
    objective: Objective
    capacity_gb: float
    config: Mapping[str, Any]
    network: Network
    sys_cfg: SystemConfig
    backend: Any = None

    def parallelism(self, n_npus: int | None = None) -> Parallelism:
        """The config's workload-stack knobs resolved against a pool size."""
        c = self.config
        return Parallelism(n_npus if n_npus is not None else self.n_npus,
                           c["dp"], c["sp"], c["pp"],
                           bool(c["weight_sharded"]))

    def reward(self, latency_ms: float) -> float:
        """The env objective applied to one end-to-end latency (scenarios
        with richer metrics — streaming — resolve rewards themselves)."""
        return self.objective.scalar(latency_ms, self.sys_cfg.network)


@runtime_checkable
class Scenario(Protocol):
    """Structural protocol — any frozen, picklable object with these methods
    can drive ``CosmicEnv`` (process-pool workers receive a copy).

    Optional capability: ``sim_job(ctx) -> SimJob | Evaluation`` describes
    the design point's simulator calls declaratively (see
    ``repro_torch.core.backends``).  Scenarios that provide it get population-
    vectorized evaluation for free — ``CosmicEnv.step_batch`` hands the
    surviving unique configs of a batch to the backend's ``simulate_batch``
    (grouped by shared trace) instead of looping ``evaluate``.  All four
    built-ins implement it; ``evaluate`` is then just ``run_sim_job(
    self.sim_job(ctx), ctx.backend)``."""

    name: str

    def psa_params(self) -> list[Parameter]: ...
    def psa_constraints(self, n_npus: int) -> list[Constraint]: ...
    def traces(self, ctx: EnvContext) -> dict[str, Trace]: ...
    def evaluate(self, ctx: EnvContext) -> Evaluation: ...


def scenario_psa(base: ParameterSet, scenario: Scenario,
                 n_npus: int) -> ParameterSet:
    """The base PsA extended with the scenario's searchable knobs — the
    'scenario' stack of the design space."""
    params = scenario.psa_params()
    if not params:
        return base
    return base.extend(params, scenario.psa_constraints(n_npus),
                       name=f"{base.name}+{scenario.name}")


def _invalid(why: str) -> Evaluation:
    return Evaluation(0.0, float("inf"), False, {"why": why})


# ---------------------------------------------------------------------------
# TrainScenario — the pre-scenario engine, verbatim
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainScenario:
    """One homogeneous job on the whole cluster: the engine's original
    behavior (``mode="train"`` training step latency, or ``mode="serve"``
    monolithic prefill+decode serving), reward-identical to the
    pre-scenario code path."""
    batch: int
    seq: int
    mode: str = "train"            # train | serve | inference
    decode_tokens: int = 64
    name: str = "train"

    def psa_params(self) -> list[Parameter]:
        return []

    def psa_constraints(self, n_npus: int) -> list[Constraint]:
        return []

    def traces(self, ctx: EnvContext) -> dict[str, Trace]:
        par = ctx.parallelism()
        if self.mode == "serve":
            return {"prefill": generate_trace(ctx.spec, par, batch=self.batch,
                                              seq=self.seq, mode="prefill"),
                    "decode": generate_trace(ctx.spec, par, batch=self.batch,
                                             seq=self.seq, mode="decode")}
        return {self.mode: generate_trace(ctx.spec, par, batch=self.batch,
                                          seq=self.seq, mode=self.mode)}

    def sim_job(self, ctx: EnvContext) -> "SimJob | Evaluation":
        return evaluate_job(ctx.spec, ctx.parallelism(), ctx.sys_cfg,
                            batch=self.batch, seq=self.seq, mode=self.mode,
                            objective=ctx.objective,
                            capacity_gb=ctx.capacity_gb,
                            decode_tokens=self.decode_tokens)

    def evaluate(self, ctx: EnvContext) -> Evaluation:
        return run_sim_job(self.sim_job(ctx), ctx.backend)


# ---------------------------------------------------------------------------
# DisaggServeScenario — prefill/decode disaggregation
# ---------------------------------------------------------------------------

def _decode_pool(n_dec: int, batch: int, decode_batch: int) -> tuple[Parallelism, int, int]:
    """(decode-pool parallelism, waves, resident requests): ``replicas``
    continuous-batching groups of up to ``decode_batch`` requests, each TP
    over its pool share; ``waves`` serial passes drain ``batch`` requests."""
    replicas = min(n_dec, max(1, math.ceil(batch / decode_batch)))
    tp = n_dec // replicas
    par = Parallelism(replicas * tp, dp=replicas, sp=1, pp=1)
    waves = math.ceil(batch / (replicas * decode_batch))
    # no more requests can be in flight than exist
    resident = min(decode_batch * replicas, batch)
    return par, waves, resident


def _serving_wave_trace(spec: ArchSpec, par_pre: Parallelism,
                        par_dec: Parallelism, *,
                        wave_shapes: list[tuple[int, int, int]],
                        releases_ms: list[float],
                        max_inflight: int | None,
                        meta: dict[str, Any],
                        wave_tiers: tuple | None = None,
                        admission: str = "gated",
                        prefill_chunks: int = 1) -> Trace:
    """The pipelined multi-wave disagg trace: each wave is prefill (pool 0)
    -> KV ``xfer`` -> first decode token -> remaining tokens (pool 1,
    op-level ``repeat``).  Decode waves chain (the pool holds one wave's KV
    at a time) while wave k+1's prefill overlaps wave k's decode in the
    event loop; ``max_inflight`` (if given) additionally gates wave w's
    prefill behind wave w-max_inflight's completion, and ``releases_ms``
    gates each wave behind its arrival-process admission time.

    ``wave_shapes`` is one ``(size, seq, decode_tokens)`` per wave —
    heterogeneous request lengths reach the trace here, each wave padded to
    its longest admitted prompt and chained to its longest decode.

    Continuous-batching engine knobs (all default to the classic chained
    behavior):

      ``admission="continuous"``   wave w's decode gates on wave w-1's
                                   FIRST token instead of its completion —
                                   the wave joins the resident batch
                                   mid-wave (per-step admission).
      ``prefill_chunks > 1``       chunked prefill: only the final KV chunk
                                   is on the TTFT critical path (see
                                   ``WaveSegment.transfer_chunks``).
      ``wave_tiers``               per-wave priority tiers (lower = more
                                   interactive); a wave's decode chains on
                                   the last earlier wave of its own or a
                                   higher tier, so interactive waves
                                   preempt batch-tier decode chaining.

    Memoized on every trace-shaping input (the network/collective stacks
    don't shape the trace), so design points differing only in those stacks
    share one composed trace — and its piggybacked simulator plan."""
    return _serving_wave_trace_cached(
        spec, par_pre, par_dec, tuple(tuple(s) for s in wave_shapes),
        tuple(releases_ms), max_inflight,
        str(meta.get("arch", "")), str(meta.get("scenario", "")),
        wave_tiers, admission, prefill_chunks)


def _serving_wave_trace_impl(spec: ArchSpec, par_pre: Parallelism,
                             par_dec: Parallelism, wave_shapes: tuple,
                             releases_ms: tuple, max_inflight: int | None,
                             arch: str, scenario: str,
                             wave_tiers: tuple | None = None,
                             admission: str = "gated",
                             prefill_chunks: int = 1) -> Trace:
    meta = dict(arch=arch, scenario=scenario)
    lanes = max(1, min(par_pre.n_npus, par_dec.n_npus))
    continuous = admission == "continuous"
    # each wave's last segment index (gates reference the EARLIER wave's
    # completion, so a one-token wave's last segment is 1, not 2)
    last_seg = [2 if dec > 1 else 1 for _, _, dec in wave_shapes]
    waves: list[Wave] = []
    for w, (size, seq, decode_tokens) in enumerate(wave_shapes):
        pre = generate_trace(spec, par_pre, batch=size, seq=seq,
                             mode="prefill")
        dec = generate_trace(spec, par_dec, batch=size, seq=seq,
                             mode="decode")
        xb = kv_cache_bytes(spec, batch=size, seq=seq) / lanes
        segs = [WaveSegment(pre, 0, 1, xb, transfer_chunks=prefill_chunks),
                WaveSegment(dec, 1)]
        if decode_tokens > 1:
            segs.append(WaveSegment(dec, 1, decode_tokens - 1))
        gates = []
        prev = w - 1
        if wave_tiers is not None:
            # preemptive chaining: an interactive wave never waits behind a
            # batch-tier wave's decode — it chains on the last earlier wave
            # of its own-or-higher priority (batch tiers still pay full
            # resource contention against the interactive waves' decode)
            prev = next((v for v in range(w - 1, -1, -1)
                         if wave_tiers[v] <= wave_tiers[w]), -1)
        if prev >= 0:
            gates.append((1, prev, 1 if continuous else last_seg[prev]))
        if max_inflight is not None and w >= max_inflight:
            gates.append((0, w - max_inflight, last_seg[w - max_inflight]))
        waves.append(Wave(tuple(segs), release_ms=releases_ms[w],
                          gates=tuple(gates)))
    return compose_request_waves(waves, meta=meta)


_serving_wave_trace_cached = \
    switchable_lru_cache(maxsize=512)(_serving_wave_trace_impl)


def _wave_mark_index(trace: Trace):
    """Flattened wave-mark tail uids + segment offsets, built once and
    piggybacked on the (cached, immutable) trace so the per-evaluation read
    is two fancy gathers instead of thousands of dict lookups."""
    idx = getattr(trace, "_wave_mark_idx", None)
    if idx is None:
        first: list[int] = []
        done: list[int] = []
        off_f = [0]
        off_d = [0]
        for mk in trace.meta["wave_marks"]:
            first.extend(mk["seg_tails"][1])
            done.extend(mk["seg_tails"][-1])
            off_f.append(len(first))
            off_d.append(len(done))
        idx = (np.asarray(first, dtype=np.intp), np.asarray(off_f[:-1]),
               np.asarray(done, dtype=np.intp), np.asarray(off_d[:-1]))
        trace._wave_mark_idx = idx
    return idx


def _wave_times_ms(trace: Trace, res: SimResult) -> list[tuple[float, float]]:
    """Per wave ``(first_token_ms, last_token_ms)`` completion times, read
    off the recorded op finish times through ``meta["wave_marks"]``."""
    fin = res.op_finish_us
    row = getattr(fin, "_row", None)
    if row is not None and trace.meta["wave_marks"]:
        # vectorized backends expose the finish times as one array row:
        # segment-max the tail uids instead of looping dict reads (reduceat
        # takes the max over the same floats, so values are bit-identical)
        uids_f, off_f, uids_d, off_d = _wave_mark_index(trace)
        t_first = np.maximum.reduceat(row[uids_f], off_f) / 1e3
        t_done = np.maximum.reduceat(row[uids_d], off_d) / 1e3
        return list(zip(t_first.tolist(), t_done.tolist()))
    out = []
    for mk in trace.meta["wave_marks"]:
        t_first = max(fin[u] for u in mk["seg_tails"][1]) / 1e3
        t_done = max(fin[u] for u in mk["seg_tails"][-1]) / 1e3
        out.append((t_first, t_done))
    return out


def _compose_memo(pre: Trace, dec: Trace, xfer_bytes: float,
                  meta: dict[str, Any]) -> Trace:
    """compose_phases memoized by input-trace identity: phase traces are
    interned by the trace cache, so repeated design points sharing them get
    the same composed trace (and its piggybacked ``_SimPlan``) back.  The
    memo rides on the prefill trace, dying with it when caches are off."""
    memo = getattr(pre, "_composed", None)
    if memo is None:
        memo = pre._composed = {}
    # entries hold a strong ref to their decode trace, so a live key's id
    # can't be recycled by a different (evicted-and-rebuilt) trace
    key = (id(dec), xfer_bytes)
    entry = memo.get(key)
    if entry is None or entry[0] is not dec:
        tr = compose_phases([(pre, 0), (dec, 1)],
                            transfers=[xfer_bytes], meta=meta)
        memo[key] = entry = (dec, tr)
    return entry[1]


@dataclass(frozen=True)
class DisaggServeScenario:
    """Disaggregated serving: ``prefill_frac`` of the cluster prefills
    prompts, the rest decodes, and finished prompts hand their KV caches
    across a transfer collective bridging the pools.

    The prefill pool is parallelized by the config's workload knobs; the
    decode pool is carved into ``ceil(batch / decode_batch)`` continuous-
    batching replicas, each tensor-parallel over its share of the pool —
    so the search can give prefill its MXU-efficient moderate TP while
    decode shards weight/KV reads as widely as the pool allows.

    ``prefill_frac = 1.0`` degenerates to the monolithic serve path
    (``TrainScenario(mode="serve")``): one pool, one parallelization for
    both phases, no transfer.

    ``pipelined=True`` (default) runs multi-wave loads as ONE pipelined
    multi-wave trace (per-wave prefill/xfer/decode, wave k+1's prefill
    overlapping wave k's decode in the event loop); ``pipelined=False``
    keeps the older analytic composition — one full-batch prefill then
    ``waves * decode_tokens`` serial token steps — for comparison.
    """
    batch: int
    seq: int
    decode_tokens: int = 64
    prefill_fracs: tuple = (0.25, 0.5, 0.625, 0.75, 0.875, 1.0)
    decode_batches: tuple = (4, 8, 16, 32, 64, 128)
    pipelined: bool = True
    name: str = "disagg-serve"

    def psa_params(self) -> list[Parameter]:
        return [
            Parameter("prefill_frac", "scenario", self.prefill_fracs,
                      doc="fraction of the cluster in the prefill pool"),
            Parameter("decode_batch", "scenario", self.decode_batches,
                      doc="requests continuously batched per decode replica"),
        ]

    def psa_constraints(self, n_npus: int) -> list[Constraint]:
        return []

    def canonical(self, config: Mapping[str, Any]) -> Mapping[str, Any]:
        """Memo-key canonicalization: at ``prefill_frac >= 1.0`` the decode
        pool doesn't exist and ``decode_batch`` is ignored, so all its
        values are one design point — don't re-evaluate them."""
        if float(config.get("prefill_frac", 0.0)) >= 1.0 \
                and "decode_batch" in config:
            return dict(config, decode_batch=self.decode_batches[0])
        return config

    # -- pool sizing -------------------------------------------------------
    def _pools(self, ctx: EnvContext) -> tuple[int, int]:
        frac = float(ctx.config["prefill_frac"])
        n_pre = int(round(frac * ctx.n_npus))
        return n_pre, ctx.n_npus - n_pre

    def _decode_par(self, n_dec: int, decode_batch: int) -> tuple[Parallelism, int, int]:
        return _decode_pool(n_dec, self.batch, decode_batch)

    def _wave_sizes(self, waves: int, resident: int) -> list[int]:
        """Per-wave request counts: full ``resident`` waves + the tail."""
        return [resident] * (waves - 1) + [self.batch - resident * (waves - 1)]

    def _pipelined_trace(self, ctx: EnvContext, par_pre: Parallelism,
                         par_dec: Parallelism, waves: int,
                         resident: int) -> Trace:
        return _serving_wave_trace(
            ctx.spec, par_pre, par_dec,
            wave_shapes=[(size, self.seq, self.decode_tokens)
                         for size in self._wave_sizes(waves, resident)],
            releases_ms=[0.0] * waves, max_inflight=None,
            meta=dict(arch=ctx.spec.name, scenario=self.name))

    def _phase_traces(self, ctx: EnvContext, par_pre: Parallelism,
                      par_dec: Parallelism, resident: int) -> tuple[Trace, Trace, Trace]:
        pre = generate_trace(ctx.spec, par_pre, batch=self.batch,
                             seq=self.seq, mode="prefill")
        dec = generate_trace(ctx.spec, par_dec, batch=resident,
                             seq=self.seq, mode="decode")
        # prefill -> KV transfer -> first decode step, on separate pools
        combined = _compose_memo(
            pre, dec, self._xfer_bytes(ctx, par_pre.n_npus, par_dec.n_npus),
            meta=dict(arch=ctx.spec.name, scenario=self.name))
        return pre, dec, combined

    def traces(self, ctx: EnvContext) -> dict[str, Trace]:
        if float(ctx.config["prefill_frac"]) >= 1.0:
            return TrainScenario(self.batch, self.seq, "serve",
                                 self.decode_tokens).traces(ctx)
        n_pre, n_dec = self._pools(ctx)
        if n_pre < 1 or n_dec < 1:
            raise ValueError(f"degenerate pool split {n_pre}/{n_dec} for "
                             f"prefill_frac={ctx.config['prefill_frac']} on "
                             f"{ctx.n_npus} NPUs")
        par_pre = ctx.parallelism(n_pre)
        par_dec, waves, resident = self._decode_par(
            n_dec, int(ctx.config["decode_batch"]))
        if self.pipelined:
            sizes = self._wave_sizes(waves, resident)
            pre = generate_trace(ctx.spec, par_pre, batch=sizes[0],
                                 seq=self.seq, mode="prefill")
            dec = generate_trace(ctx.spec, par_dec, batch=sizes[0],
                                 seq=self.seq, mode="decode")
            combined = self._pipelined_trace(ctx, par_pre, par_dec, waves,
                                             resident)
            return {"prefill": pre, "decode": dec, "combined": combined}
        pre, dec, combined = self._phase_traces(ctx, par_pre, par_dec,
                                                resident)
        return {"prefill": pre, "decode": dec, "combined": combined}

    def _xfer_bytes(self, ctx: EnvContext, n_pre: int, n_dec: int) -> float:
        """KV handoff per transfer lane: the whole batch's caches move, with
        one concurrent lane per (prefill, decode) NPU pair."""
        total = kv_cache_bytes(ctx.spec, batch=self.batch, seq=self.seq)
        return total / max(1, min(n_pre, n_dec))

    def sim_job(self, ctx: EnvContext) -> "SimJob | Evaluation":
        frac = float(ctx.config["prefill_frac"])
        if frac >= 1.0:
            # degenerate: one pool serves both phases (the monolithic path)
            def mono(ev: Evaluation) -> Evaluation:
                if ev.valid:
                    ev = replace(ev, detail=dict(ev.detail,
                                                 scenario=self.name,
                                                 monolithic=True))
                return ev

            inner = TrainScenario(self.batch, self.seq, "serve",
                                  self.decode_tokens).sim_job(ctx)
            if not isinstance(inner, SimJob):
                return mono(inner)
            return SimJob(inner.calls, lambda rs: mono(inner.finalize(rs)))
        decode_batch = int(ctx.config["decode_batch"])
        n_pre, n_dec = self._pools(ctx)
        if n_pre < 1 or n_dec < 1:
            return _invalid(f"degenerate pool split {n_pre}/{n_dec}")
        par_pre = ctx.parallelism(n_pre)
        if not par_pre.valid():
            return _invalid(f"prefill parallelization invalid on {n_pre} NPUs")
        fp_pre = footprint(ctx.spec, par_pre, batch=self.batch, seq=self.seq,
                           mode="inference")
        if fp_pre.total_gb > ctx.capacity_gb:
            return _invalid(f"prefill memory {fp_pre.total_gb:.1f}GB "
                            f"> {ctx.capacity_gb}GB")
        par_dec, waves, resident = self._decode_par(n_dec, decode_batch)
        fp_dec = footprint(ctx.spec, par_dec, batch=resident, seq=self.seq,
                           mode="decode")
        if fp_dec.total_gb > ctx.capacity_gb:
            return _invalid(f"decode memory {fp_dec.total_gb:.1f}GB "
                            f"> {ctx.capacity_gb}GB")

        # each pool's collectives are priced on the sub-fabric its NPU
        # slice spans, not the whole cluster (same carving rule as
        # MultiTenantScenario partitions), with each sub-dim's algorithm
        # resolved against its SOURCE physical dim
        pre_pool = (par_pre, *sub_network_indexed(ctx.network, par_pre.n_npus))
        dec_pool = (par_dec, *sub_network_indexed(ctx.network, par_dec.n_npus))
        detail = {
            "scenario": self.name, "prefill_npus": n_pre,
            "decode_npus": par_dec.n_npus, "decode_tp": par_dec.tp,
            "decode_replicas": par_dec.dp, "decode_batch": decode_batch,
            "waves": waves, "pipelined": self.pipelined,
            "prefill_gb": fp_pre.total_gb, "decode_gb": fp_dec.total_gb,
        }
        if self.pipelined:
            tr = self._pipelined_trace(ctx, par_pre, par_dec, waves, resident)

            def fin_pipe(results: list[SimResult]) -> Evaluation:
                res = results[0]
                t_first, t_done = _wave_times_ms(tr, res)[0]
                latency_ms = res.latency_ms
                detail.update(
                    ttft_ms=t_first,
                    p50_token_latency_ms=(t_done - t_first)
                    / max(self.decode_tokens - 1, 1))
                return Evaluation(ctx.reward(latency_ms), latency_ms, True,
                                  detail)

            return SimJob((SimCall(tr, ctx.sys_cfg, par_pre,
                                   pools={0: pre_pool, 1: dec_pool},
                                   record_finish=True),), fin_pipe)

        _, dec_tr, combined = self._phase_traces(ctx, par_pre, par_dec,
                                                 resident)

        def fin_analytic(results: list[SimResult]) -> Evaluation:
            first, step = results
            t_token_ms = step.latency_ms
            latency_ms = first.latency_ms \
                + (self.decode_tokens * waves - 1) * t_token_ms
            detail.update(ttft_ms=first.latency_ms - t_token_ms,
                          p50_token_latency_ms=t_token_ms)
            return Evaluation(ctx.reward(latency_ms), latency_ms, True,
                              detail)

        return SimJob((SimCall(combined, ctx.sys_cfg, par_pre,
                               pools={0: pre_pool, 1: dec_pool}),
                       SimCall(dec_tr, ctx.sys_cfg, par_dec,
                               pools={0: dec_pool})), fin_analytic)

    def evaluate(self, ctx: EnvContext) -> Evaluation:
        return run_sim_job(self.sim_job(ctx), ctx.backend)


# ---------------------------------------------------------------------------
# RequestStreamScenario — arrival-process serving with queueing
# ---------------------------------------------------------------------------

def _arrivals_impl(gaps_ms: tuple, n_requests: int, rate_rps: float,
                   seed: int) -> tuple[float, ...]:
    if gaps_ms:
        gaps = [float(gaps_ms[i % len(gaps_ms)]) for i in range(n_requests)]
    else:
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1000.0 / rate_rps, n_requests).tolist()
    t, out = 0.0, []
    for g in gaps:
        t += g
        out.append(t)
    return tuple(out)


_arrivals_cached = switchable_lru_cache(maxsize=64)(_arrivals_impl)


def _request_shapes_impl(n: int, seq: int, decode_tokens: int,
                         prompt_lens: tuple, decode_lens: tuple,
                         prompt_len_range: tuple, decode_len_range: tuple,
                         seed: int) -> tuple[tuple[int, int], ...]:
    """Per-request ``(prompt_len, decode_len)`` pairs: replayed traces win
    over seeded uniform ranges, which win over the homogeneous defaults."""
    def resolve(replay: tuple, lo_hi: tuple, fixed: int,
                tag: int, what: str) -> list[int]:
        if replay:
            out = [int(replay[i % len(replay)]) for i in range(n)]
        elif lo_hi:
            lo, hi = int(lo_hi[0]), int(lo_hi[1])
            if not 1 <= lo <= hi:
                raise ValueError(f"{what} range ({lo}, {hi}) must satisfy "
                                 f"1 <= lo <= hi")
            # a distinct stream per (seed, field) so lengths don't perturb
            # the arrival process draws
            rng = np.random.default_rng([seed, tag])
            out = [int(v) for v in rng.integers(lo, hi + 1, size=n)]
        else:
            out = [int(fixed)] * n
        if min(out) < 1:
            raise ValueError(f"{what} lengths must be >= 1, got {min(out)}")
        return out

    prompts = resolve(prompt_lens, prompt_len_range, seq, 0x9E, "prompt")
    decodes = resolve(decode_lens, decode_len_range, decode_tokens, 0x51,
                      "decode")
    return tuple(zip(prompts, decodes))


_request_shapes_cached = switchable_lru_cache(maxsize=64)(_request_shapes_impl)


@switchable_lru_cache(maxsize=1024)
def _form_waves_cached(arrivals: tuple, window_ms: float,
                       cap: int) -> tuple[tuple[tuple[int, ...], float], ...]:
    """Queueing/admission memo: the wave grouping depends only on the
    (cached) arrival process and two scenario knobs, so a population that
    shares them — the common case in a search batch — forms waves once."""
    waves: list[tuple[tuple[int, ...], float]] = []
    cur: list[int] = []
    deadline = 0.0
    for i, t in enumerate(arrivals):
        if cur and t > deadline:
            waves.append((tuple(cur), deadline))
            cur = []
        cur.append(i)
        if len(cur) == 1:
            deadline = t + window_ms
        if len(cur) == cap:
            waves.append((tuple(cur), t))
            cur = []
    if cur:
        waves.append((tuple(cur), deadline))
    return tuple(waves)


@switchable_lru_cache(maxsize=1024)
def _wave_shapes_cached(shapes: tuple, waves: tuple) -> tuple:
    return tuple((len(idxs), max(shapes[i][0] for i in idxs),
                  max(shapes[i][1] for i in idxs)) for idxs, _ in waves)


@switchable_lru_cache(maxsize=1024)
def _wave_request_index(waves: tuple) -> tuple:
    """Flattened admitted-request indices + per-wave counts for the
    vectorized streaming-metrics pass."""
    cat = np.asarray([i for idxs, _ in waves for i in idxs], dtype=np.intp)
    counts = np.asarray([len(idxs) for idxs, _ in waves], dtype=np.intp)
    return cat, counts


def _request_tiers_impl(n: int, priorities: tuple, frac: float,
                        seed: int) -> tuple[int, ...]:
    if priorities:
        return tuple(int(priorities[i % len(priorities)]) for i in range(n))
    if frac <= 0.0:
        return (1,) * n
    # a distinct stream per (seed, field), like the shape draws, so tiers
    # don't perturb the arrival/length processes
    rng = np.random.default_rng([seed, 0x7E])
    return tuple(int(v) for v in (rng.random(n) >= frac))


_request_tiers_cached = switchable_lru_cache(maxsize=64)(_request_tiers_impl)


@switchable_lru_cache(maxsize=1024)
def _form_waves_tiered(arrivals: tuple, tiers: tuple, window_ms: float,
                       cap: int) -> tuple[tuple[tuple[int, ...], float, int], ...]:
    """Per-tier admission queues merged by release time: each priority tier
    forms its own waves (an interactive request never waits for a batch-tier
    wave to fill), tagged with the tier for the preemption gates.  Returns
    ``((indices, release_ms, tier), ...)`` sorted by (release, tier)."""
    out: list[tuple[tuple[int, ...], float, int]] = []
    for tier in sorted(set(tiers)):
        idxs = tuple(i for i, t in enumerate(tiers) if t == tier)
        sub = tuple(arrivals[i] for i in idxs)
        for w_idxs, rel in _form_waves_cached(sub, window_ms, cap):
            out.append((tuple(idxs[j] for j in w_idxs), rel, tier))
    out.sort(key=lambda w: (w[1], w[2]))
    return tuple(out)


def _per_request_times(waves, wave_shapes, shapes, arrivals,
                       wt) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized per-request ``(ttft, tpot, latency)`` arrays from the
    per-wave ``(first_token, last_token)`` times, flattened in (wave,
    admitted-index) order: same arithmetic as the per-request loop it
    replaces (one subtract / one multiply-add per request, identical
    operand order).  Shared by the single-engine finalize and the fleet
    layer's per-replica concatenation."""
    t_first = np.asarray([t for t, _ in wt])
    t_done = np.asarray([t for _, t in wt])
    wave_dec = np.asarray([d for _, _, d in wave_shapes])
    tpot_w = (t_done - t_first) / np.maximum(wave_dec - 1, 1)
    cat, counts = _wave_request_index(tuple(waves))
    dec_r = np.asarray([d for _, d in shapes])[cat]
    t_first_r = np.repeat(t_first, counts)
    tpot_r = np.repeat(tpot_w, counts)
    # a request finishes after ITS decode length at the wave's
    # token cadence (== t_done for the wave's longest request)
    done_r = np.where(dec_r == np.repeat(wave_dec, counts),
                      np.repeat(t_done, counts),
                      t_first_r + tpot_r * (dec_r - 1))
    arr_r = np.asarray(arrivals)[cat]
    return t_first_r - arr_r, tpot_r, done_r - arr_r


def _kv_inflight_cap(spec: ArchSpec, par_dec: Parallelism, resident: int,
                     full_seq: int, headroom: float, capacity_gb: float,
                     static_gb: float) -> int:
    """KV paging-pressure admission cap: how many waves' resident caches fit
    the decode pool's free HBM (capacity minus the non-KV footprint
    ``static_gb`` — weights + activations) at ``headroom`` occupancy.  One
    wave's cache is priced per decode NPU at its full post-decode length
    (prompt + decode tokens; batch shards over the pool's replicas, KV over
    its TP)."""
    per_wave_gb = kv_cache_bytes(spec, batch=resident / par_dec.dp,
                                 seq=full_seq, tp=par_dec.tp) / 1e9
    free_gb = capacity_gb - static_gb
    return max(1, int((free_gb * headroom) // max(per_wave_gb, 1e-12)))


@dataclass(frozen=True)
class RequestStreamScenario:
    """Serving a request STREAM instead of one analytic batch: requests
    arrive by a Poisson process (``rate_rps``) or a replayable inter-arrival
    trace (``arrival_gaps_ms``, cycled over ``n_requests``), queue, and are
    admitted in waves under a searchable batching window; admitted waves run
    through disaggregated prefill/decode pools as ONE pipelined multi-wave
    trace (per-wave prefill -> KV ``xfer`` -> decode, wave k+1's prefill
    overlapping wave k's decode on separate pool resources, with release
    delays carrying the arrival times into the event loop).

    Searchable scenario knobs (alongside the workload/collective/network
    stacks):

      ``batch_window_ms``  how long an open wave waits for more requests —
                           trades queueing delay (TTFT) against batching
                           efficiency; a wave also closes when it reaches
                           ``max_batch`` requests.
      ``max_inflight``     admission cap: wave w's prefill is gated behind
                           wave w-max_inflight's completion.
      ``prefill_frac``     prefill/decode pool split (as DisaggServe).
      ``decode_batch``     continuous-batching replica size (as DisaggServe).

    Heterogeneous request lengths: by default every request is ``seq``
    prompt tokens and ``decode_tokens`` output tokens, but per-request
    lengths can be drawn from a seeded uniform distribution
    (``prompt_len_range`` / ``decode_len_range``, inclusive ``(lo, hi)``)
    or replayed from a trace (``prompt_lens`` / ``decode_lens``, cycled
    over ``n_requests``).  Each admitted wave is padded to its longest
    prompt and chains to its longest decode; a request's completion time is
    its own decode length times the wave's token cadence.

    Continuous-batching engine knobs are opt-in: each empty choice tuple
    below contributes no PsA parameter and leaves the wave model
    bit-identical to the classic chained behavior.  Non-empty tuples expose
    (as scenario-stack knobs) ``admission`` (gated vs continuous mid-wave
    join), ``prefill_chunks`` (chunked-prefill KV streaming),
    ``preempt`` (priority-tier decode preemption; pair with
    ``priority_frac`` or replayed ``priorities``), and ``kv_headroom``
    (KV paging pressure throttling ``max_inflight`` against free HBM).

    Rewards are streaming metrics: ``objective="goodput"`` maximizes
    requests meeting BOTH SLOs per second; any classic objective applies to
    the p99 end-to-end request latency.  TTFT/TPOT p50/p99 are always in
    ``Evaluation.detail``."""
    # class marker: this scenario resolves STREAM_OBJECTIVES ("goodput")
    # itself — CosmicEnv rejects those objectives for scenarios without it
    supports_stream_objectives: ClassVar[bool] = True

    n_requests: int = 64
    seq: int = 2048
    decode_tokens: int = 64
    rate_rps: float = 8.0
    arrival_gaps_ms: tuple = ()      # replayable inter-arrival gaps (ms)
    seed: int = 0
    prompt_len_range: tuple = ()     # (lo, hi) seeded per-request prompt lens
    decode_len_range: tuple = ()     # (lo, hi) seeded per-request decode lens
    prompt_lens: tuple = ()          # replayed per-request prompt lens
    decode_lens: tuple = ()          # replayed per-request decode lens
    max_batch: int = 32              # hard cap on requests per wave
    ttft_slo_ms: float = 4000.0
    tpot_slo_ms: float = 200.0
    batch_windows_ms: tuple = (0.0, 50.0, 200.0, 500.0, 1000.0)
    max_inflights: tuple = (1, 2, 4, 8)
    prefill_fracs: tuple = (0.25, 0.5, 0.625, 0.75, 0.875)
    decode_batches: tuple = (4, 8, 16, 32)
    # -- continuous-batching engine knobs (opt-in; empty = classic model) --
    arrival_times_ms: tuple = ()     # explicit arrival times (fleet routing
    #                                  replay; wins over gaps/rate)
    priority_frac: float = 0.0       # fraction of interactive (tier-0) reqs
    priorities: tuple = ()           # replayed per-request tiers (0 = hi)
    admissions: tuple = ()           # e.g. ("gated", "continuous")
    prefill_chunk_choices: tuple = ()  # e.g. (1, 2, 4)
    preempt_choices: tuple = ()      # e.g. (0, 1)
    kv_headrooms: tuple = ()         # e.g. (0.5, 0.8) of free HBM for KV
    name: str = "request-stream"

    def psa_params(self) -> list[Parameter]:
        params = [
            Parameter("batch_window_ms", "scenario", self.batch_windows_ms,
                      doc="max wait for an open admission wave to fill"),
            Parameter("max_inflight", "scenario", self.max_inflights,
                      doc="admission cap on waves in flight"),
            Parameter("prefill_frac", "scenario", self.prefill_fracs,
                      doc="fraction of the cluster in the prefill pool"),
            Parameter("decode_batch", "scenario", self.decode_batches,
                      doc="requests continuously batched per decode replica"),
        ]
        if self.admissions:
            params.append(Parameter(
                "admission", "scenario", self.admissions,
                doc="gated: wave chains on predecessor completion; "
                    "continuous: joins the resident batch mid-wave"))
        if self.prefill_chunk_choices:
            params.append(Parameter(
                "prefill_chunks", "scenario", self.prefill_chunk_choices,
                doc="KV chunks streamed during prefill — only the last is "
                    "on the TTFT critical path"))
        if self.preempt_choices:
            params.append(Parameter(
                "preempt", "scenario", self.preempt_choices,
                doc="1: interactive (tier-0) waves preempt batch-tier "
                    "decode chaining"))
        if self.kv_headrooms:
            params.append(Parameter(
                "kv_headroom", "scenario", self.kv_headrooms,
                doc="fraction of free HBM usable by resident KV — throttles "
                    "max_inflight under paging pressure"))
        return params

    def psa_constraints(self, n_npus: int) -> list[Constraint]:
        return []

    # -- arrival process ---------------------------------------------------
    def arrivals_ms(self) -> tuple[float, ...]:
        """Request arrival times: deterministic given the scenario fields
        (explicit times, replayed gaps, or seeded exponential gaps for a
        Poisson process).  Memoized — arrivals are identical for every
        design point of a search, so the hot path shouldn't redraw them per
        evaluation."""
        if self.arrival_times_ms:
            if len(self.arrival_times_ms) != self.n_requests:
                raise ValueError(
                    f"arrival_times_ms has {len(self.arrival_times_ms)} "
                    f"entries for n_requests={self.n_requests}")
            return tuple(float(t) for t in self.arrival_times_ms)
        return _arrivals_cached(self.arrival_gaps_ms, self.n_requests,
                                self.rate_rps, self.seed)

    def request_shapes(self) -> tuple[tuple[int, int], ...]:
        """Per-request ``(prompt_len, decode_len)``: deterministic given the
        scenario fields (replayed traces, seeded ranges, or the homogeneous
        ``(seq, decode_tokens)`` defaults).  Memoized like the arrivals."""
        return _request_shapes_cached(
            self.n_requests, self.seq, self.decode_tokens, self.prompt_lens,
            self.decode_lens, self.prompt_len_range, self.decode_len_range,
            self.seed)

    def heterogeneous(self) -> bool:
        return bool(self.prompt_len_range or self.decode_len_range
                    or self.prompt_lens or self.decode_lens)

    def request_tiers(self) -> tuple[int, ...]:
        """Per-request priority tier (0 = interactive, 1 = batch): replayed
        (``priorities``, cycled) or seeded Bernoulli(``priority_frac``) on a
        stream distinct from the arrival/shape draws.  The all-one-tier
        default keeps wave formation and gating bit-identical to the
        pre-tier path."""
        return _request_tiers_cached(self.n_requests, self.priorities,
                                     self.priority_frac, self.seed)

    def engine_extended(self) -> bool:
        """True when any opt-in continuous-batching knob is exposed."""
        return bool(self.admissions or self.prefill_chunk_choices
                    or self.preempt_choices or self.kv_headrooms)

    def _engine_knobs(self, config: Mapping[str, Any]) -> tuple[str, int, bool]:
        """(admission, prefill_chunks, preempt) resolved from a design
        point, defaulting to the classic chained model when the knobs
        aren't in the search space."""
        return (str(config.get("admission", "gated")),
                int(config.get("prefill_chunks", 1)),
                bool(int(config.get("preempt", 0))))

    def _admitted(self, ctx: EnvContext, resident: int,
                  preempt: bool) -> tuple[tuple, tuple | None]:
        """(waves, wave_tiers): per-tier admission queues when preemption is
        on and the stream is tier-mixed, the classic single queue (tiers
        None) otherwise."""
        window = float(ctx.config["batch_window_ms"])
        tiers = self.request_tiers()
        if preempt and len(set(tiers)) > 1:
            tw = _form_waves_tiered(self.arrivals_ms(), tiers, window,
                                    max(1, resident))
            return (tuple((idxs, rel) for idxs, rel, _ in tw),
                    tuple(t for _, _, t in tw))
        return self.form_waves(window, max_batch=resident), None

    def _wave_shapes(self, waves) -> tuple:
        """Per-wave ``(size, seq, decode_tokens)``: each wave pads to its
        longest admitted prompt and chains to its longest decode.  Memoized
        with the wave grouping itself (see ``_wave_shapes_cached``)."""
        return _wave_shapes_cached(self.request_shapes(), tuple(waves))

    def form_waves(self, window_ms: float,
                   max_batch: int | None = None) -> tuple:
        """Queueing/admission: group arrivals into waves of request indices.
        A wave opens at its first request, releases at ``open + window_ms``
        or the instant it fills to the admission cap; each ``(indices,
        release_ms)`` becomes one wave of the pipelined trace.

        ``max_batch`` overrides the scenario cap — ``evaluate`` passes the
        decode pool's resident capacity (``replicas * decode_batch``, itself
        capped by the scenario ``max_batch``) so an admitted wave never
        exceeds what the decode pool can actually hold.  Memoized per
        ``(arrivals, window, cap)`` — see ``_form_waves_cached``."""
        cap = self.max_batch if max_batch is None else max(1, max_batch)
        return _form_waves_cached(self.arrivals_ms(), window_ms, cap)

    # -- pools (same carving as DisaggServeScenario) -----------------------
    def _pools(self, ctx: EnvContext) -> tuple[int, int]:
        frac = float(ctx.config["prefill_frac"])
        n_pre = int(round(frac * ctx.n_npus))
        return n_pre, ctx.n_npus - n_pre

    def _stream_trace(self, ctx: EnvContext, par_pre: Parallelism,
                      par_dec: Parallelism,
                      waves: list[tuple[list[int], float]], *,
                      max_inflight: int,
                      wave_tiers: tuple | None = None,
                      admission: str = "gated",
                      prefill_chunks: int = 1) -> Trace:
        return _serving_wave_trace(
            ctx.spec, par_pre, par_dec,
            wave_shapes=self._wave_shapes(waves),
            releases_ms=[rel for _, rel in waves],
            max_inflight=max_inflight,
            meta=dict(arch=ctx.spec.name, scenario=self.name),
            wave_tiers=wave_tiers, admission=admission,
            prefill_chunks=prefill_chunks)

    def _resolved(self, ctx: EnvContext):
        n_pre, n_dec = self._pools(ctx)
        if n_pre < 1 or n_dec < 1:
            raise ValueError(f"degenerate pool split {n_pre}/{n_dec}")
        par_pre = ctx.parallelism(n_pre)
        par_dec, _, resident = _decode_pool(n_dec, self.max_batch,
                                            int(ctx.config["decode_batch"]))
        return par_pre, par_dec, resident

    def traces(self, ctx: EnvContext) -> dict[str, Trace]:
        par_pre, par_dec, resident = self._resolved(ctx)
        admission, prefill_chunks, preempt = self._engine_knobs(ctx.config)
        waves, wave_tiers = self._admitted(ctx, resident, preempt)
        return {"stream": self._stream_trace(
            ctx, par_pre, par_dec, waves,
            max_inflight=int(ctx.config["max_inflight"]),
            wave_tiers=wave_tiers, admission=admission,
            prefill_chunks=prefill_chunks)}

    def stream_call(self, ctx: EnvContext):
        """The engine core behind ``sim_job``, reusable per fleet replica:
        resolve pools, gate memory, admit waves, build the one pipelined
        SimCall.  Returns ``(call, request_times, detail, last_arrival_ms)``
        where ``request_times(res)`` maps the call's ``SimResult`` to
        per-request ``(ttft, tpot, latency)`` arrays — or an ``Evaluation``
        when a validity gate trips."""
        try:
            par_pre, par_dec, resident = self._resolved(ctx)
        except ValueError as e:
            return _invalid(str(e))
        if not par_pre.valid():
            return _invalid(f"prefill parallelization invalid on "
                            f"{par_pre.n_npus} NPUs")
        shapes = self.request_shapes()
        max_seq = max(p for p, _ in shapes)   # == self.seq when homogeneous
        fp_pre = footprint(ctx.spec, par_pre, batch=self.max_batch,
                           seq=max_seq, mode="inference")
        if fp_pre.total_gb > ctx.capacity_gb:
            return _invalid(f"prefill memory {fp_pre.total_gb:.1f}GB "
                            f"> {ctx.capacity_gb}GB")
        fp_dec = footprint(ctx.spec, par_dec, batch=resident, seq=max_seq,
                           mode="decode")
        if fp_dec.total_gb > ctx.capacity_gb:
            return _invalid(f"decode memory {fp_dec.total_gb:.1f}GB "
                            f"> {ctx.capacity_gb}GB")

        admission, prefill_chunks, preempt = self._engine_knobs(ctx.config)
        max_inflight = int(ctx.config["max_inflight"])
        kv_headroom = ctx.config.get("kv_headroom")
        kv_cap = None
        if kv_headroom is not None:
            kv_cap = _kv_inflight_cap(
                ctx.spec, par_dec, resident,
                max_seq + max(d for _, d in shapes), float(kv_headroom),
                ctx.capacity_gb, fp_dec.total_gb - fp_dec.kv_cache_gb)
            max_inflight = min(max_inflight, kv_cap)

        waves, wave_tiers = self._admitted(ctx, resident, preempt)
        tr = self._stream_trace(ctx, par_pre, par_dec, waves,
                                max_inflight=max_inflight,
                                wave_tiers=wave_tiers, admission=admission,
                                prefill_chunks=prefill_chunks)
        pre_pool = (par_pre, *sub_network_indexed(ctx.network, par_pre.n_npus))
        dec_pool = (par_dec, *sub_network_indexed(ctx.network, par_dec.n_npus))
        arrivals = self.arrivals_ms()
        wave_shapes = self._wave_shapes(waves)

        def request_times(res: SimResult):
            return _per_request_times(waves, wave_shapes, shapes, arrivals,
                                      _wave_times_ms(tr, res))

        detail = {
            "scenario": self.name, "prefill_npus": par_pre.n_npus,
            "decode_npus": par_dec.n_npus, "decode_tp": par_dec.tp,
            "decode_replicas": par_dec.dp,
            "decode_batch": int(ctx.config["decode_batch"]),
            "batch_window_ms": float(ctx.config["batch_window_ms"]),
            "max_inflight": int(ctx.config["max_inflight"]),
            "waves": len(waves),
            "wave_sizes": [len(idxs) for idxs, _ in waves],
            "prefill_gb": fp_pre.total_gb, "decode_gb": fp_dec.total_gb,
            **({"prompt_len_mean":
                sum(p for p, _ in shapes) / len(shapes),
                "prompt_len_max": max_seq,
                "decode_len_mean":
                sum(d for _, d in shapes) / len(shapes),
                "decode_len_max": max(d for _, d in shapes)}
               if self.heterogeneous() else {}),
            **({"admission": admission, "prefill_chunks": prefill_chunks,
                "preempt": int(preempt),
                "effective_max_inflight": max_inflight,
                **({"kv_inflight_cap": kv_cap} if kv_cap is not None
                   else {})}
               if self.engine_extended() else {}),
        }
        call = SimCall(tr, ctx.sys_cfg, par_pre,
                       pools={0: pre_pool, 1: dec_pool}, record_finish=True)
        return call, request_times, detail, arrivals[-1]

    def sim_job(self, ctx: EnvContext) -> "SimJob | Evaluation":
        got = self.stream_call(ctx)
        if isinstance(got, Evaluation):
            return got
        call, request_times, detail, last_arrival_ms = got

        def fin(results: list[SimResult]) -> Evaluation:
            res = results[0]
            ttfts, tpots, lats = request_times(res)
            horizon_ms = max(res.latency_ms, last_arrival_ms)
            m = stream_metrics(ttfts, tpots, lats,
                               ttft_slo_ms=self.ttft_slo_ms,
                               tpot_slo_ms=self.tpot_slo_ms,
                               horizon_ms=horizon_ms)
            r = stream_reward(ctx.objective, m, ctx.sys_cfg.network)
            return Evaluation(r, m.latency_p99_ms, True, {
                **detail, "makespan_ms": res.latency_ms, **m.detail(),
            })

        return SimJob((call,), fin)

    def evaluate(self, ctx: EnvContext) -> Evaluation:
        return run_sim_job(self.sim_job(ctx), ctx.backend)


# ---------------------------------------------------------------------------
# MultiTenantScenario — N workloads on disjoint heterogeneous partitions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Tenant:
    """One workload sharing the cluster: an architecture, its batch/seq, a
    latency SLO, and an importance weight.  ``device_name`` installs a
    different compute device in this tenant's partition (heterogeneous
    clusters); empty inherits the env device."""
    name: str
    arch: ArchSpec
    batch: int
    seq: int
    phase: str = "train"           # train | serve
    slo_ms: float = 1e4
    weight: float = 1.0
    decode_tokens: int = 64
    device_name: str = ""


def _auto_parallelism(spec: ArchSpec, n: int, batch: int, phase: str,
                      seq: int, capacity_gb: float) -> Parallelism | None:
    """Deterministic per-tenant parallelization: the least tensor sharding
    (fewest collectives) whose footprint fits the capacity gate."""
    mode = "train" if phase == "train" else "inference"
    tp = 1
    while tp <= n:
        if n % tp == 0:
            dp = n // tp
            par = Parallelism(n, dp=dp, sp=1, pp=1,
                              weight_sharded=(phase == "train" and dp > 1))
            if dp <= max(batch, 1) and \
                    footprint(spec, par, batch=batch, seq=seq,
                              mode=mode).total_gb <= capacity_gb:
                return par
        tp *= 2
    return None


@dataclass(frozen=True)
class MultiTenantScenario:
    """N tenants on disjoint partitions of one fabric.  The partition sizes
    are searchable (``tenant_npus``, one slot per tenant, summing to at most
    the cluster); each partition runs its tenant's workload on its own
    sub-network and device.  Reward is importance-weighted SLO attainment;
    oversubscribed or infeasible partitions gate to reward 0.  NOTE: the
    SLO objective is intrinsic to the scenario — ``ctx.objective`` is not
    consulted (per-tenant latencies and weighted goodput are in ``detail``
    for callers wanting other aggregations)."""
    tenants: tuple[Tenant, ...]
    size_choices: tuple = (32, 64, 128, 256, 512, 1024)
    name: str = "multi-tenant"

    def psa_params(self) -> list[Parameter]:
        return [Parameter("tenant_npus", "scenario", self.size_choices,
                          ndim=len(self.tenants),
                          doc="NPUs owned by each tenant's partition")]

    def psa_constraints(self, n_npus: int) -> list[Constraint]:
        return [Constraint("sum_le", ("tenant_npus",), n_npus,
                           name=f"sum(tenant_npus) <= {n_npus}")]

    def _cluster(self, ctx: EnvContext, sizes: tuple[int, ...]) -> Cluster:
        devices = [DEVICES[t.device_name] if t.device_name else ctx.device
                   for t in self.tenants]
        return partition_cluster(ctx.network, sizes, devices,
                                 names=[t.name for t in self.tenants])

    def _sizes(self, ctx: EnvContext) -> tuple[int, ...]:
        v = ctx.config["tenant_npus"]
        return tuple(int(x) for x in (v if isinstance(v, (tuple, list)) else (v,)))

    def traces(self, ctx: EnvContext) -> dict[str, Trace]:
        out: dict[str, Trace] = {}
        for t, size in zip(self.tenants, self._sizes(ctx)):
            par = _auto_parallelism(t.arch, size, t.batch, t.phase, t.seq,
                                    ctx.capacity_gb)
            if par is not None:
                out[t.name] = generate_trace(
                    t.arch, par, batch=t.batch, seq=t.seq,
                    mode="train" if t.phase == "train" else "prefill")
        return out

    def _tenant_calls(self, ctx: EnvContext, t: Tenant, network: Network,
                      device: Device, par: Parallelism) -> list[SimCall]:
        """One tenant's simulator calls on its partition's sub-fabric —
        prefill + decode for serving tenants, one training step otherwise
        (``_tenant_latency`` is the matching results combiner)."""
        sys_cfg = replace(ctx.sys_cfg, network=network, device=device)
        if t.phase == "serve":
            return [SimCall(generate_trace(t.arch, par, batch=t.batch,
                                           seq=t.seq, mode="prefill"),
                            sys_cfg, par),
                    SimCall(generate_trace(t.arch, par, batch=t.batch,
                                           seq=t.seq, mode="decode"),
                            sys_cfg, par)]
        return [SimCall(generate_trace(t.arch, par, batch=t.batch, seq=t.seq,
                                       mode="train"), sys_cfg, par)]

    @staticmethod
    def _tenant_latency(t: Tenant, results: list[SimResult]) -> float:
        if t.phase == "serve":
            pre, dec = results
            return pre.latency_ms + t.decode_tokens * dec.latency_ms
        return results[0].latency_ms

    def sim_job(self, ctx: EnvContext) -> "SimJob | Evaluation":
        sizes = self._sizes(ctx)
        if len(sizes) != len(self.tenants):
            return _invalid(f"need {len(self.tenants)} partition sizes, "
                            f"got {len(sizes)}")
        if sum(sizes) > ctx.n_npus:
            return _invalid(f"partitions {list(sizes)} oversubscribe "
                            f"{ctx.n_npus}-NPU cluster")
        cluster = self._cluster(ctx, sizes)
        calls: list[SimCall] = []
        slices: list[tuple[Tenant, Any, Parallelism, int, int]] = []
        for t, part in zip(self.tenants, cluster.partitions):
            par = _auto_parallelism(t.arch, part.n_npus, t.batch, t.phase,
                                    t.seq, ctx.capacity_gb)
            if par is None:
                return _invalid(f"tenant {t.name!r} infeasible on "
                                f"{part.n_npus} NPUs")
            tcalls = self._tenant_calls(ctx, t, part.network, part.device,
                                        par)
            slices.append((t, part, par, len(calls), len(tcalls)))
            calls.extend(tcalls)

        def fin(results: list[SimResult]) -> Evaluation:
            per_tenant: dict[str, dict[str, float]] = {}
            attained, weight_sum, goodput = 0.0, 0.0, 0.0
            worst = 0.0
            for t, part, par, off, n in slices:
                lat = self._tenant_latency(t, results[off:off + n])
                att = slo_attainment(lat, t.slo_ms)
                tput = t.batch * t.seq / max(lat, 1e-9)  # tokens/ms
                attained += t.weight * att
                goodput += t.weight * tput * (1.0 if lat <= t.slo_ms else 0.0)
                weight_sum += t.weight
                worst = max(worst, lat)
                per_tenant[t.name] = {
                    "npus": part.n_npus, "range": part.npu_range(),
                    "latency_ms": lat, "slo_ms": t.slo_ms, "attainment": att,
                    "tp": par.tp, "dp": par.dp,
                }
            reward = attained / max(weight_sum, 1e-9)
            return Evaluation(reward, worst, True, {
                "scenario": self.name, "tenants": per_tenant,
                "weighted_goodput_tok_per_ms": goodput,
                "cluster": cluster.describe(),
            })

        return SimJob(tuple(calls), fin)

    def evaluate(self, ctx: EnvContext) -> Evaluation:
        return run_sim_job(self.sim_job(ctx), ctx.backend)


# ---------------------------------------------------------------------------
# Scenario registry — construct-from-dict front door for StudySpec / CLI
# ---------------------------------------------------------------------------

SCENARIO_REGISTRY: dict[str, Callable[..., Scenario]] = {}


def register_scenario(kind: str, builder: Callable[..., Scenario], *,
                      replace_existing: bool = False) -> None:
    """Register a scenario kind.  ``builder(**params)`` must return a
    ``Scenario``; params arrive JSON-shaped (lists, dicts, scalars)."""
    if not replace_existing and kind in SCENARIO_REGISTRY:
        raise ValueError(f"scenario kind {kind!r} already registered")
    SCENARIO_REGISTRY[kind] = builder


def build_scenario(kind: str, params: Mapping[str, Any] | None = None) -> Scenario:
    """Instantiate a registered scenario kind from JSON-shaped params."""
    try:
        builder = SCENARIO_REGISTRY[kind]
    except KeyError:
        raise ValueError(f"unknown scenario kind {kind!r}; "
                         f"known: {sorted(SCENARIO_REGISTRY)}") from None
    return builder(**dict(params or {}))


def list_scenarios() -> dict[str, str]:
    """kind -> one-line description (the builder's scenario docstring)."""
    out = {}
    for kind, builder in SCENARIO_REGISTRY.items():
        cls = getattr(builder, "scenario_cls", None)
        doc = (cls.__doc__ or builder.__doc__ or "").strip().splitlines()
        out[kind] = doc[0] if doc else ""
    return out


def _tuplify(v: Any) -> Any:
    """JSON arrays -> tuples, recursively (scenario dataclasses use tuples
    for every sequence field so instances stay frozen/hashable)."""
    if isinstance(v, (list, tuple)):
        return tuple(_tuplify(x) for x in v)
    return v


def dataclass_scenario_builder(cls) -> Callable[..., Scenario]:
    """A construct-from-dict builder for a scenario dataclass: validates
    parameter names and coerces JSON arrays to the tuples the frozen
    dataclasses expect."""
    names = {f.name for f in dataclasses.fields(cls)}

    def build(**params) -> Scenario:
        unknown = sorted(set(params) - names)
        if unknown:
            raise ValueError(
                f"unknown {cls.__name__} scenario params {unknown}; "
                f"known: {sorted(names - {'name'})}")
        return cls(**{k: _tuplify(v) for k, v in params.items()})

    build.scenario_cls = cls
    return build


_multi_tenant_fields = dataclass_scenario_builder(MultiTenantScenario)


def _build_multi_tenant(**params) -> MultiTenantScenario:
    """Multi-tenant builder: resolves ``tenants`` entries given as dicts
    whose ``arch`` is an ``ARCHS`` registry name (the JSON form), then
    delegates validation/coercion to the generic dataclass builder."""
    from repro_torch.configs import ARCHS

    tenants = []
    for i, t in enumerate(params.pop("tenants", ()) or ()):
        if isinstance(t, Tenant):
            tenants.append(t)
            continue
        t = dict(t)
        if "arch" not in t:
            raise ValueError(f"tenant {i} ({t.get('name', '?')!r}) is "
                             f"missing 'arch' — an ARCHS registry name")
        arch = t.pop("arch")
        if isinstance(arch, str) and arch not in ARCHS:
            raise ValueError(f"tenant {i} ({t.get('name', '?')!r}) names "
                             f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
        known = {f.name for f in dataclasses.fields(Tenant)}
        unknown = sorted(set(t) - known)
        if unknown:
            raise ValueError(
                f"tenant {i} ({t.get('name', '?')!r}) has unknown "
                f"key(s) {unknown}; known: {sorted(known)}")
        tenants.append(Tenant(arch=ARCHS[arch] if isinstance(arch, str)
                              else arch, **t))
    return _multi_tenant_fields(tenants=tuple(tenants), **params)


_build_multi_tenant.scenario_cls = MultiTenantScenario

register_scenario("train", dataclass_scenario_builder(TrainScenario))
register_scenario("disagg-serve",
                  dataclass_scenario_builder(DisaggServeScenario))
register_scenario("request-stream",
                  dataclass_scenario_builder(RequestStreamScenario))
register_scenario("multi-tenant", _build_multi_tenant)

# the fleet subsystem (repro_torch.core.fleet) registers its scenario on import;
# importing it here — after every name it needs is defined — makes the
# "fleet" kind resolvable wherever the scenario registry is
from repro_torch.core import fleet as _fleet  # noqa: E402,F401  (cycle-closing)
