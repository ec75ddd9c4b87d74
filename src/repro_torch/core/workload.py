"""Workload Trace Generator (WTG).

The paper's WTG expands symbolic per-layer operator templates — shapes in
{B, S, D, H, FF, ...} and partitioning in {dp, sp, tp, pp} — into concrete
traces with collectives injected at tensor producer/consumer boundaries
(Section 4.4).  Ours consumes the SAME ``ArchSpec`` the real JAX models are
built from, so the symbolic trace and the executable model can never drift
apart: one source of truth for dense/GQA/MoE/SSM/hybrid templates.

A trace is the op list of ONE representative NPU (SPMD-symmetric), with
dependency edges; ``repro_torch.core.simulator`` schedules it on a device+network.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Literal

from repro_torch.configs.base import ArchSpec, LayerDef
from repro_torch.core.cache import switchable_lru_cache


@dataclass
class Op:
    uid: int
    name: str
    kind: Literal["comp", "coll", "delay"]
    deps: list[int]
    # comp
    flops: float = 0.0
    bytes: float = 0.0
    # coll
    coll: str = ""        # all_reduce | all_gather | reduce_scatter | all_to_all | xfer
    size_bytes: float = 0.0
    group: str = ""       # tp | dp | ep | pp | xfer
    # which partition's resources this op occupies (multi-pool scenarios:
    # disaggregated prefill/decode pools get their own compute streams)
    pool: int = 0
    # back-to-back executions of this op (condensed decode-token chains:
    # k repeats occupy the resource for k x the single duration)
    repeat: int = 1
    # kind == "delay": a pure time offset on a private timer resource
    # (request-stream arrival releases); never serializes with real work
    delay_us: float = 0.0


# Scenario phases a trace can describe.  The legacy mode strings remain
# accepted spellings ("inference" == "prefill"); traces are generated per
# phase and scenarios compose phases into end-to-end evaluations.
PHASES = ("train", "prefill", "decode")
_PHASE_ALIASES = {"inference": "prefill"}


def resolve_phase(mode: str) -> str:
    phase = _PHASE_ALIASES.get(mode, mode)
    if phase not in PHASES:
        raise ValueError(f"unknown workload phase {mode!r}; "
                         f"known: {PHASES + tuple(_PHASE_ALIASES)}")
    return phase


@dataclass(frozen=True)
class Parallelism:
    """The paper's Workload knobs, resolved against a cluster size."""
    n_npus: int
    dp: int
    sp: int
    pp: int
    weight_sharded: bool = False

    @property
    def tp(self) -> int:
        tp = self.n_npus // (self.dp * self.sp * self.pp)
        return max(tp, 1)

    def valid(self) -> bool:
        return self.dp * self.sp * self.pp <= self.n_npus and \
            self.n_npus % (self.dp * self.sp * self.pp) == 0


@dataclass
class Trace:
    """Op list with dense uids (ops[i].uid == i, as TraceBuilder assigns) —
    the simulator's flat-array scheduling plan relies on it and validates."""
    ops: list[Op]
    meta: dict[str, Any] = field(default_factory=dict)

    def total_flops(self) -> float:
        return sum(o.flops for o in self.ops)

    def total_coll_bytes(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for o in self.ops:
            if o.kind == "coll":
                out[o.group] = out.get(o.group, 0.0) + o.size_bytes
        return out


BYTES_ACT = 2  # bf16 activations
BYTES_GRAD = 2


class TraceBuilder:
    def __init__(self):
        self.ops: list[Op] = []

    def comp(self, name, flops, bytes_, deps):
        op = Op(len(self.ops), name, "comp", list(deps), flops=flops, bytes=bytes_)
        self.ops.append(op)
        return op.uid

    def coll(self, name, coll, size, group, deps):
        op = Op(len(self.ops), name, "coll", list(deps), coll=coll,
                size_bytes=size, group=group)
        self.ops.append(op)
        return op.uid


def _layer_flops_fwd(spec: ArchSpec, ld: LayerDef, b: float, s: float,
                     seq_total: float) -> tuple[float, float]:
    """(mixer, ffn) forward FLOPs for b*s tokens on one NPU shard
    (`seq_total` = full sequence length for attention's S^2 term)."""
    d, hd = spec.d_model, spec.resolved_head_dim
    tok = b * s
    if ld.mixer == "mamba":
        din, ds, nh = spec.d_inner, spec.ssm_state, spec.ssm_heads
        proj = 2 * tok * d * (2 * din + 2 * spec.ssm_groups * ds + nh) + 2 * tok * din * d
        ssd = 2 * tok * nh * spec.ssm_head_dim * ds * 2  # state update + output
        mixer = proj + ssd
    else:
        qkvo = 2 * tok * d * (2 * spec.n_heads * hd + 2 * spec.n_kv_heads * hd)
        ctx = seq_total if ld.mixer != "attn_local" or not spec.sliding_window \
            else min(seq_total, spec.sliding_window)
        attn = 2 * tok * ctx * spec.n_heads * hd * 2  # QK^T + PV (causal ~ /2 folded into ctx avg)
        mixer = qkvo + attn * 0.5
    if ld.ffn == "mlp":
        mults = 3 if spec.act == "silu" else 2
        ffn = 2.0 * tok * d * spec.d_ff * mults
    elif ld.ffn == "moe":
        ffn = 2.0 * tok * d * spec.d_ff * 3 * spec.top_k + 2 * tok * d * spec.n_experts
    else:
        ffn = 0.0
    return mixer, ffn


def _layer_param_bytes(spec: ArchSpec, ld: LayerDef, tp: int, bytes_per: float) -> float:
    d, hd = spec.d_model, spec.resolved_head_dim
    if ld.mixer == "mamba":
        din, ds, nh = spec.d_inner, spec.ssm_state, spec.ssm_heads
        mixer = d * (2 * din + 2 * spec.ssm_groups * ds + nh) + din * d
    else:
        mixer = d * (spec.n_heads + 2 * spec.n_kv_heads) * hd + spec.n_heads * hd * d
    if ld.ffn == "mlp":
        ffn = (3 if spec.act == "silu" else 2) * d * spec.d_ff
    elif ld.ffn == "moe":
        ffn = spec.n_experts * 3 * d * spec.d_ff + d * spec.n_experts
    else:
        ffn = 0.0
    return (mixer + ffn) / tp * bytes_per


def generate_trace(spec: ArchSpec, par: Parallelism, *, batch: int, seq: int,
                   mode: str = "train", microbatches: int | None = None) -> Trace:
    """Expand the symbolic template into one NPU's op trace.

    Memoized on ``(spec, par, batch, seq, mode, microbatches)`` — every
    argument is a hashable value object, so a cache hit returns the SAME
    ``Trace`` built by the uncached expansion.  Callers must treat the
    returned trace as immutable (the simulator only reads it).

    train:   fwd + bwd per layer, TP collectives on activation boundaries,
             per-layer DP gradient reduction overlapping the backward pass,
             PP pipeline-bubble factor on compute.
    prefill: fwd only ("inference" accepted as a legacy spelling).
    decode:  one-token steps against a KV cache (per-token message sizes).
    """
    return _generate_trace_cached(spec, par, batch, seq, resolve_phase(mode),
                                  microbatches)


def _generate_trace_impl(spec: ArchSpec, par: Parallelism, batch: int,
                         seq: int, mode: str,
                         microbatches: int | None) -> Trace:
    mode = resolve_phase(mode)
    tb = TraceBuilder()
    b = batch / par.dp
    s = seq / par.sp
    tp = par.tp

    # most specs repeat one or two LayerDefs; compute per-layer costs once
    _flops_memo: dict[LayerDef, tuple[float, float]] = {}
    _pbytes_memo: dict[tuple[LayerDef, float], float] = {}

    def layer_flops(ld: LayerDef) -> tuple[float, float]:
        v = _flops_memo.get(ld)
        if v is None:
            v = _layer_flops_fwd(spec, ld, b, s, seq)
            _flops_memo[ld] = v
        return v

    def layer_pbytes(ld: LayerDef, bytes_per: float) -> float:
        v = _pbytes_memo.get((ld, bytes_per))
        if v is None:
            v = _layer_param_bytes(spec, ld, tp, bytes_per)
            _pbytes_memo[(ld, bytes_per)] = v
        return v

    if mode == "decode":
        # one token with a KV cache of `seq`: per layer a GEMV over the
        # layer's weights + attention over the cache + a SMALL (b x d)
        # TP all-reduce — the latency-dominated regime where the paper's
        # Expr-2 finds Direct/RHD/DBT beat Ring.  Unlike prefill/train,
        # PP does NOT divide per-token latency: the token traverses every
        # stage sequentially, paying a cross-stage hop at each boundary.
        layers_d = spec.layer_defs()
        n_l = len(layers_d)
        prev = []
        for i, ld in enumerate(layers_d):
            w_bytes = layer_pbytes(ld, BYTES_ACT)
            flops = w_bytes * b  # 2 flops per bf16 weight x b tokens
            kv_read = b * seq * spec.n_kv_heads * spec.resolved_head_dim * 2 * BYTES_ACT / tp                 if ld.mixer.startswith("attn") else 0.0
            u = tb.comp(f"L{i}.decode", flops, w_bytes + kv_read, prev)
            if tp > 1:
                u = tb.coll(f"L{i}.decode.ar", "all_reduce",
                            b * spec.d_model * BYTES_ACT, "tp", [u])
            # exactly pp-1 stage-boundary hops under a balanced partition
            if par.pp > 1 and i + 1 < n_l and \
                    (i + 1) * par.pp // n_l != i * par.pp // n_l:
                u = tb.coll(f"L{i}.decode.pp", "all_gather",
                            b * spec.d_model * BYTES_ACT, "pp", [u])
            prev = [u]
        head_b = spec.d_model * spec.vocab_size / tp * BYTES_ACT
        tb.comp("head.decode", head_b * b, head_b, prev)
        return Trace(tb.ops, meta=dict(arch=spec.name, mode=mode, batch=batch,
                                       seq=seq, dp=par.dp, sp=par.sp, pp=par.pp,
                                       tp=tp, microbatches=1, bubble=1.0,
                                       weight_sharded=par.weight_sharded))

    # MXU-granularity efficiency: a matmul sharded to fewer than ~256 lanes
    # per NPU underutilizes the systolic array; pathological TP degrees
    # inflate compute time (the physics behind the paper's 64.5x Fig-4
    # spread).  eff in (0.02, 1].
    def _eff(width: float) -> float:
        return max(0.02, min(1.0, width / tp / 256.0))

    hd = spec.resolved_head_dim
    mixer_width = max(spec.n_heads * hd, spec.d_inner or 1)
    ffn_width = max(spec.d_ff, 1) if spec.d_ff else mixer_width
    eff_mixer = _eff(mixer_width)
    eff_ffn = _eff(ffn_width)
    layers = spec.layer_defs()
    # one PP stage's layer slice: ceil division models the LARGEST stage, so
    # a non-divisible layers % pp never silently drops remainder layers from
    # the modeled compute (e.g. 34 layers @ pp=4 is a 9-layer stage, not 8)
    stage_layers = layers[: max(1, math.ceil(len(layers) / par.pp))]
    mb = microbatches or (2 * par.pp if par.pp > 1 else 1)
    bubble = 1.0 + (par.pp - 1) / mb if par.pp > 1 else 1.0

    act_bytes = b * s * spec.d_model * BYTES_ACT      # residual activation/NPU
    prev = []
    train = mode == "train"

    # embedding
    emb_flops = 2 * b * s * spec.d_model
    prev = [tb.comp("embed", emb_flops, act_bytes, [])]

    fwd_tail: dict[int, int] = {}
    for i, ld in enumerate(stage_layers):
        mixer_f, ffn_f = layer_flops(ld)
        u = tb.comp(f"L{i}.mixer.fwd", bubble * mixer_f / tp / eff_mixer,
                    3 * act_bytes / max(tp, 1), prev)
        if tp > 1:
            u = tb.coll(f"L{i}.mixer.ar", "all_reduce", act_bytes, "tp", [u])
        if ld.ffn != "none":
            u2 = tb.comp(f"L{i}.ffn.fwd", bubble * ffn_f / tp / eff_ffn,
                         3 * act_bytes / max(tp, 1), [u])
            if ld.ffn == "moe" and tp > 1:
                u2 = tb.coll(f"L{i}.moe.a2a.fwd", "all_to_all",
                             act_bytes * spec.top_k, "ep", [u2])
            elif tp > 1:
                u2 = tb.coll(f"L{i}.ffn.ar", "all_reduce", act_bytes, "tp", [u2])
            u = u2
        prev = [u]
        fwd_tail[i] = u

    # head + loss
    head_f = 2 * b * s * spec.d_model * spec.vocab_size / tp
    u = tb.comp("head", head_f, act_bytes, prev)
    if tp > 1:
        u = tb.coll("head.ar", "all_reduce", b * s * 4, "tp", [u])
    prev = [u]

    if train:
        grad_bytes_per = BYTES_GRAD
        dp_group_sz = par.dp
        for i in reversed(range(len(stage_layers))):
            ld = stage_layers[i]
            mixer_f, ffn_f = layer_flops(ld)
            u = tb.comp(f"L{i}.bwd",
                        bubble * 2.0 * (mixer_f / eff_mixer + ffn_f / eff_ffn) / tp,
                        6 * act_bytes / max(tp, 1), prev)
            if tp > 1:  # Megatron backward re-runs the activation collectives
                u = tb.coll(f"L{i}.bwd.ar", "all_reduce", 2 * act_bytes, "tp", [u])
            prev = [u]
            if dp_group_sz > 1:
                pb = layer_pbytes(ld, grad_bytes_per)
                kind = "reduce_scatter" if par.weight_sharded else "all_reduce"
                tb.coll(f"L{i}.grad.{kind}", kind, pb, "dp", [u])
        # embedding/head grads
        if dp_group_sz > 1:
            emb_b = spec.vocab_size * spec.d_model / tp * grad_bytes_per
            tb.coll("embed.grad", "reduce_scatter" if par.weight_sharded else "all_reduce",
                    emb_b, "dp", prev)
        if par.weight_sharded and dp_group_sz > 1:
            # optimizer re-gathers sharded params for the next step
            tot = sum(layer_pbytes(ld, BYTES_ACT) for ld in stage_layers)
            tb.coll("params.allgather", "all_gather", tot, "dp", prev)

    if par.pp > 1:
        p2p = act_bytes * mb
        tb.coll("pp.sendrecv", "all_gather", p2p, "pp", prev)  # stage handoff

    tr = Trace(tb.ops, meta=dict(arch=spec.name, mode=mode, batch=batch, seq=seq,
                                 dp=par.dp, sp=par.sp, pp=par.pp, tp=tp,
                                 weight_sharded=par.weight_sharded, bubble=bubble,
                                 microbatches=mb))
    return tr


_generate_trace_cached = switchable_lru_cache(maxsize=4096)(_generate_trace_impl)


@dataclass(frozen=True)
class WaveSegment:
    """One phase of one wave: a (cached, immutable) phase trace placed on a
    pool.  ``repeat`` multiplies every op's back-to-back execution count —
    how a ``decode_tokens``-long token chain is condensed into the one-token
    decode trace without op blow-up.  ``transfer_bytes`` inserts a
    cross-partition ``xfer`` collective between this segment and the next
    (the KV-cache handoff from a prefill pool to a decode pool).
    ``transfer_chunks > 1`` models chunked prefill: earlier KV chunks
    stream while the prompt is still computing, so only the LAST chunk
    (``bytes / chunks``) sits on the next segment's critical path; the
    remaining volume still occupies the transfer fabric as a trailing op."""
    trace: Trace
    pool: int
    repeat: int = 1
    transfer_bytes: float = 0.0
    transfer_chunks: int = 1


@dataclass(frozen=True)
class Wave:
    """One admitted request batch moving through its phase segments.

    ``release_ms`` gates the wave's first segment behind a delay op (the
    arrival-process admission time).  ``gates`` adds cross-wave dependency
    edges ``(seg_idx, earlier_wave_idx, earlier_seg_idx)`` — e.g. decode
    continuous-batching capacity (wave w's decode waits for wave w-1's) or
    a max-in-flight admission window (wave w's prefill waits for wave
    w-k's completion)."""
    segments: tuple[WaveSegment, ...]
    release_ms: float = 0.0
    gates: tuple[tuple[int, int, int], ...] = ()


def compose_request_waves(waves: list[Wave],
                          meta: dict[str, Any] | None = None) -> Trace:
    """Stitch K overlapping waves into one pipelined multi-pool trace.

    Within a wave, segment i+1's roots depend on segment i's tails (with an
    optional ``xfer`` collective on the boundary).  Across waves there are
    no implicit dependencies — same-pool phases of different waves contend
    for that pool's resources in the event loop (wave k+1's prefill overlaps
    wave k's decode), which is exactly the pipelining the analytic
    composition can't see.  Release times and explicit ``gates`` add the
    arrival-process and capacity edges.

    ``meta["wave_marks"]`` maps each wave to its op uids: ``release_uid``,
    per-segment ``seg_tails`` lists, and ``xfer_uids`` — scenarios read
    per-wave TTFT/TPOT off ``SimResult.op_finish_us`` through these.
    Input traces are not mutated (they may be cache-interned)."""
    ops: list[Op] = []
    marks: list[dict[str, Any]] = []
    multi = len(waves) > 1
    for wi, wave in enumerate(waves):
        prefix = f"w{wi}." if multi else ""
        gate_tails: dict[int, list[int]] = {}
        for seg_idx, gw, gs in wave.gates:
            gate_tails.setdefault(seg_idx, []).extend(
                marks[gw]["seg_tails"][gs])
        release_uid = None
        prev_tails: list[int] = []
        if wave.release_ms > 0:
            uid = len(ops)
            ops.append(Op(uid, f"{prefix}release", "delay", [],
                          pool=wave.segments[0].pool,
                          delay_us=wave.release_ms * 1e3))
            release_uid = uid
            prev_tails = [uid]
        seg_tails: list[list[int]] = []
        xfer_uids: list[int | None] = []
        for si, seg in enumerate(wave.segments):
            root_deps = prev_tails + gate_tails.get(si, [])
            off = len(ops)
            tr = seg.trace
            has_children = {d for op in tr.ops for d in op.deps}
            for op in tr.ops:
                deps = [d + off for d in op.deps] if op.deps else list(root_deps)
                ops.append(Op(op.uid + off, f"{prefix}s{si}.{op.name}",
                              op.kind, deps, flops=op.flops, bytes=op.bytes,
                              coll=op.coll, size_bytes=op.size_bytes,
                              group=op.group, pool=seg.pool,
                              repeat=op.repeat * seg.repeat,
                              delay_us=op.delay_us))
            tails = [op.uid + off for op in tr.ops
                     if op.uid not in has_children]
            seg_tails.append(tails)
            if seg.transfer_bytes > 0 and si < len(wave.segments) - 1:
                chunks = max(1, int(seg.transfer_chunks))
                uid = len(ops)
                ops.append(Op(uid, f"{prefix}s{si}.xfer", "coll", list(tails),
                              coll="xfer",
                              size_bytes=seg.transfer_bytes / chunks,
                              group="xfer", pool=seg.pool))
                xfer_uids.append(uid)
                prev_tails = [uid]
                if chunks > 1:
                    # chunked prefill: only the final chunk gates the next
                    # segment; the earlier chunks' volume trails behind it
                    # on the same transfer fabric (a sink op — it delays
                    # later waves' transfers, not this wave's first token)
                    bg = len(ops)
                    ops.append(Op(bg, f"{prefix}s{si}.xfer_bg", "coll",
                                  [uid], coll="xfer",
                                  size_bytes=seg.transfer_bytes
                                  * (chunks - 1) / chunks,
                                  group="xfer", pool=seg.pool))
            else:
                xfer_uids.append(None)
                prev_tails = tails
        marks.append({"release_uid": release_uid, "seg_tails": seg_tails,
                      "xfer_uids": xfer_uids})
    pools = sorted({seg.pool for w in waves for seg in w.segments})
    return Trace(ops, meta=dict(meta or {}, pools=pools, wave_marks=marks))


def compose_phases(segments: list[tuple[Trace, int]],
                   transfers: list[float] | tuple[float, ...] = (),
                   meta: dict[str, Any] | None = None) -> Trace:
    """Stitch per-pool phase traces into one multi-pool trace.

    ``segments[i]`` is ``(trace, pool)``; phase i+1's roots depend on phase
    i's tails.  ``transfers[i]`` (bytes) inserts a cross-partition transfer
    collective (group ``"xfer"``, e.g. the KV-cache handoff between a
    prefill and a decode pool) on that boundary; 0 means a bare dependency
    edge.  The single-wave special case of ``compose_request_waves``."""
    segs = tuple(
        WaveSegment(tr, pool,
                    transfer_bytes=(transfers[si] if si < len(transfers)
                                    else 0.0))
        for si, (tr, pool) in enumerate(segments))
    return compose_request_waves([Wave(segs)], meta=meta)
