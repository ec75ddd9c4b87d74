"""The yardstick's operation and byte counts, from shapes alone.

A roofline counts the work a call's shapes need, whatever implements it:
each input byte read once and each output byte written once, the
operations of the algorithm (causal pairs only; a recomputed forward is a
call of its own).  A step's model FLOPs count 6 per active matmul weight
per token in training and 2 in serving (routed experts by their share
``top_k / n_experts``, no capacity padding), plus the attention and SSD
terms from their shapes; a recompute is not counted there.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
ESIZE = {"float32": 4, "bfloat16": 2}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: operations over the peak rate of
    ``dtype`` or bytes over HBM's rate, whichever is longer."""
    return max(flops / PEAKS["flops_per_s"][dtype], nbytes / PEAKS["hbm_bytes_per_s"])


def causal_pairs(s: int, t: int | None = None, offset: int = 0, window: int = 0) -> int:
    """(query, key) pairs a causal mask keeps: query i at ``offset + i`` of
    ``s`` sees keys 0..offset + i of ``t`` (the last ``window`` of them if
    ``window``)."""
    t = s if t is None else t
    n = 0
    for i in range(s):
        hi = min(offset + i + 1, t)
        n += hi - (max(0, offset + i + 1 - window) if window else 0)
    return n


def _triangle(s: int) -> int:
    """Causal pairs of ``s`` positions: ``causal_pairs(s)`` in closed form."""
    return s * (s + 1) // 2


def chunk_pairs(s: int, chunk: int) -> int:
    """Causal pairs inside chunks of ``chunk`` positions (the last ragged)."""
    full, rest = divmod(s, chunk)
    return full * _triangle(chunk) + _triangle(rest)


# ---- the SSD scan: x (B, S, H, P), dt (B, S, H), a (H,), b/c (B, S, G, N) --

def ssd_fwd_flops(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int) -> int:
    """The chunked SSD form: per (batch, head) the chunk states and their
    read-out (4 S N P) and the masked scores times x (2 P a pair); per
    (batch, group) the scores C B^T (2 N a pair)."""
    pairs = chunk_pairs(s, chunk)
    return b * (h * (4 * s * n * p + 2 * p * pairs) + g * 2 * n * pairs)


def ssd_fwd_bytes(b, s, h, p, g, n, esize: int) -> int:
    """x and b, c read, y written (``esize`` each); dt, a read and the final
    state written in float32."""
    return esize * (2 * b * s * h * p + 2 * b * s * g * n) + 4 * (b * s * h + h + b * h * p * n)


def ssd_bwd_flops(b, s, h, p, g, n, chunk) -> int:
    """Each forward product's two gradient products."""
    return 2 * ssd_fwd_flops(b, s, h, p, g, n, chunk)


def ssd_bwd_bytes(b, s, h, p, g, n, esize: int, dstate: bool) -> int:
    """x, b, c, dy read and dx, db, dc written; dt, a read and their
    gradients written in float32; the final state's gradient read if any."""
    return (esize * (3 * b * s * h * p + 4 * b * s * g * n) + 4 * 2 * (b * s * h + h)
            + (4 * b * h * p * n if dstate else 0))


# ---- flash attention: q (B, S, H, hd), k/v (B, T, G, hd) -------------------

def flash_fwd_flops(b, s, t, h, hd, pairs: int) -> int:
    return 4 * hd * b * h * pairs


def flash_fwd_bytes(b, s, t, h, g, hd, esize: int, lse: bool) -> int:
    return esize * (2 * b * s * h * hd + 2 * b * t * g * hd) + (4 * b * h * s if lse else 0)


def flash_bwd_flops(b, s, t, h, hd, pairs: int) -> int:
    """The scores recomputed (2 hd), dV, dP, dQ and dK (8 hd) a pair."""
    return 10 * hd * b * h * pairs


def flash_bwd_bytes(b, s, t, h, g, hd, esize: int) -> int:
    """q, o, do read and dq written; k, v read and dk, dv written; the
    log-sum-exp read in float32."""
    return esize * (4 * b * s * h * hd + 4 * b * t * g * hd) + 4 * b * h * s


# ---- a model's FLOPs -------------------------------------------------------

def matmul_weights(arch: dict) -> tuple[float, float]:
    """(active matmul weights of the layers a token passes, the head's): a
    routed expert counts by its share top_k / n_experts; the embedding's
    lookup is no product, the head (tied or not) is."""
    d, v = arch["d_model"], arch["vocab_size"]
    layers = 0.0
    for i in range(arch["n_layers"]):
        if arch["family"] == "ssm":
            din = arch["ssm_expand"] * d
            gn, nh = arch["ssm_groups"] * arch["ssm_state"], din // arch["ssm_head_dim"]
            layers += d * (2 * din + 2 * gn + nh) + din * d
            continue
        hd = arch.get("head_dim") or d // arch["n_heads"]
        layers += d * (arch["n_heads"] + 2 * arch["n_kv_heads"]) * hd + arch["n_heads"] * hd * d
        if arch.get("n_experts"):
            layers += d * arch["n_experts"] + arch["top_k"] * 3 * d * arch["d_ff"]
        else:
            layers += (3 if arch.get("act", "silu") == "silu" else 2) * d * arch["d_ff"]
    return layers, float(d * v)


def mixer_fwd_flops(arch: dict, b: int, s: int, chunk: int = 256) -> float:
    """One forward pass's attention or SSD FLOPs over (B, S), all layers."""
    if arch["family"] == "ssm":
        din = arch["ssm_expand"] * arch["d_model"]
        h = din // arch["ssm_head_dim"]
        return arch["n_layers"] * ssd_fwd_flops(b, s, h, arch["ssm_head_dim"], arch["ssm_groups"],
                                                arch["ssm_state"], chunk)
    hd = arch.get("head_dim") or arch["d_model"] // arch["n_heads"]
    return arch["n_layers"] * flash_fwd_flops(b, s, s, arch["n_heads"], hd, _triangle(s))


def decode_mixer_flops(arch: dict, b: int, keys: int) -> float:
    """One decode step's attention (against ``keys`` cached positions) or
    SSD recurrence FLOPs, all layers."""
    if arch["family"] == "ssm":
        din = arch["ssm_expand"] * arch["d_model"]
        return arch["n_layers"] * b * (din // arch["ssm_head_dim"]) * 4 * arch["ssm_state"] \
            * arch["ssm_head_dim"]
    hd = arch.get("head_dim") or arch["d_model"] // arch["n_heads"]
    return arch["n_layers"] * 4 * hd * b * arch["n_heads"] * keys


def train_step_flops(arch: dict, b: int, s: int) -> float:
    layers, head = matmul_weights(arch)
    return 6 * (layers + head) * b * s + 3 * mixer_fwd_flops(arch, b, s)


def serve_batch_flops(arch: dict, b: int, s: int, new: int) -> float:
    """A static batch: prefill of (B, S) with the head on its last position,
    then ``new`` decode steps, each through every layer and the head."""
    layers, head = matmul_weights(arch)
    flops = 2 * layers * b * (s + new) + 2 * head * b * (1 + new) + mixer_fwd_flops(arch, b, s)
    return flops + sum(decode_mixer_flops(arch, b, s + i + 1) for i in range(new))


# ---- what the metric readers share ------------------------------------------

def roofline_pct(*ops) -> float | None:
    """Percent of the roofline over the calls of ``ops``, each (calls, bound):
    the calls' (shapes, concrete inputs, device s) of one op and the bound
    of one call.  The bound's seconds over the device's; None where no op
    ran."""
    bound_total = device = 0.0
    for calls, bound in ops:
        for shapes, conc, dev in calls:
            if dev > 0:
                bound_total += bound(shapes, conc)
                device += dev
    return 100.0 * bound_total / device if device else None


def chunk_of(ctx) -> int:
    return ctx.config.get("model", {}).get("chunk_size", 256)


def ssd_fwd_bound(ctx):
    esize, chunk = ESIZE[ctx.dtype], chunk_of(ctx)

    def bound(shapes, _):
        (b, s, h, p), (_, _, g, n) = shapes[0], shapes[3]
        return bound_s(ssd_fwd_flops(b, s, h, p, g, n, chunk),
                       ssd_fwd_bytes(b, s, h, p, g, n, esize), ctx.dtype)
    return bound


def ssd_bwd_bound(ctx):
    esize, chunk = ESIZE[ctx.dtype], chunk_of(ctx)

    def bound(shapes, _):
        (b, s, h, p), (_, _, g, n) = shapes[0], shapes[3]
        dstate = len(shapes) > 7 and bool(shapes[7])
        return bound_s(ssd_bwd_flops(b, s, h, p, g, n, chunk),
                       ssd_bwd_bytes(b, s, h, p, g, n, esize, dstate), ctx.dtype)
    return bound


def _mask(conc, first: int):
    """(causal, window, q_offset) from a flash call's concrete inputs."""
    causal, window = (conc[first], conc[first + 1]) if len(conc) > first + 1 else (True, 0)
    offset = conc[-1] if conc and isinstance(conc[-1], int) and not isinstance(conc[-1], bool) \
        else 0
    return causal, window or 0, offset or 0


def _pairs(s, t, causal, window, offset):
    return causal_pairs(s, t, offset, window) if causal else s * t


def flash_fwd_bound(ctx):
    esize = ESIZE[ctx.dtype]

    def bound(shapes, conc):
        (b, s, h, hd), (_, t, g, _) = shapes[0], shapes[1]
        causal, window, offset = _mask(conc, 3)
        lse = bool(conc[6]) if len(conc) > 6 else True
        return bound_s(flash_fwd_flops(b, s, t, h, hd, _pairs(s, t, causal, window, offset)),
                       flash_fwd_bytes(b, s, t, h, g, hd, esize, lse), ctx.dtype)
    return bound


def flash_bwd_bound(ctx):
    esize = ESIZE[ctx.dtype]

    def bound(shapes, conc):
        (b, s, h, hd), (_, t, g, _) = shapes[0], shapes[1]
        causal, window, offset = _mask(conc, 6)
        return bound_s(flash_bwd_flops(b, s, t, h, hd, _pairs(s, t, causal, window, offset)),
                       flash_bwd_bytes(b, s, t, h, g, hd, esize), ctx.dtype)
    return bound


def peak_flops(ctx) -> float:
    return PEAKS["flops_per_s"][ctx.dtype]
