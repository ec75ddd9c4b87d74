"""GQA attention: prefill/forward through the flash kernel + cached decode.

Counterpart of the JAX package's ``models/attention.py``.  Every prefill and
forward length goes through ``ops.mha_flash`` (the JAX module's dense branch
and its ``flash_attention_ref`` branch, :154-162, both become the kernel).
Decode attends one query row against the cache with plain tensor ops, as
the JAX package computes it outside any Pallas kernel (:248-256).

Caches are dicts of tensors that prefill and decode update in place (no
copy of the whole cache per token) and return.  A global layer's cache is
``{"k", "v"}`` of (B, T, G, hd) with T the serving length.  A
sliding-window layer keeps a ring buffer of ``t = min(window, T)`` slots,
the JAX ``attn_cache_defs`` (:170-180): token ``pos`` lives in slot
``pos % t`` and ``kpos[slot]`` holds ``pos + 1`` (0 = empty).  ``kpos`` is
int32 whatever the cache dtype, so it holds every position exactly; the JAX
package keeps it in the cache dtype, where bf16 rounds 513 to 512.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import ParamDef, apply_rope, checkpoint_name
from repro_torch.parallel.sharding import NULL_PLAN, ShardingPlan


def attn_defs(spec: ArchSpec) -> dict[str, ParamDef]:
    d, h, g, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.resolved_head_dim
    defs = {
        "wq": ParamDef((d, h, hd), ("embed", "q_heads", "head_dim")),
        "wk": ParamDef((d, g, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, g, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((h, hd, d), ("q_heads", "head_dim", "embed")),
    }
    if spec.qkv_bias:
        defs["bq"] = ParamDef((h, hd), ("q_heads", "head_dim"), "zeros")
        defs["bk"] = ParamDef((g, hd), ("kv_heads", "head_dim"), "zeros")
        defs["bv"] = ParamDef((g, hd), ("kv_heads", "head_dim"), "zeros")
    return defs


def _project_qkv(p, x, spec: ArchSpec):
    """x: (B, S, D) -> q (B, S, H, hd), k/v (B, S, G, hd)."""
    b, s, d = x.shape

    def proj(w, bias):
        y = (x @ w.reshape(d, -1).to(x.dtype)).view(b, s, *w.shape[1:])
        return y + bias.to(y.dtype) if spec.qkv_bias else y

    return (proj(p["wq"], p.get("bq")), proj(p["wk"], p.get("bk")),
            proj(p["wv"], p.get("bv")))


def _out_proj(p, o):
    """o: (B, S, H, hd) -> (B, S, D)."""
    h, hd, d = p["wo"].shape
    return o.reshape(*o.shape[:2], h * hd) @ p["wo"].reshape(h * hd, d).to(o.dtype)


def _repeat_kv(k, n_heads: int):
    """(B, T, G, hd) -> (B, T, H, hd) by repeating each group (JAX :52-58)."""
    b, t, g, hd = k.shape
    return k[:, :, :, None, :].expand(b, t, g, n_heads // g, hd).reshape(b, t, n_heads, hd)


def _attend(p, x, positions, spec: ArchSpec, window: int, plan: ShardingPlan = NULL_PLAN):
    """Self-attention over the sequence; also returns the roped k and v.

    The kernel masks by index, so ``positions`` (used for RoPE) must be
    ``arange(S)``, as every caller passes.  Under a plan, the JAX layout
    policy (:139-151): heads split over 'model' when they divide it
    (Megatron head-sharded attention; k/v's groups split with them, or are
    repeated to the heads first when they do not divide it), else q keeps
    the residual stream's sequence split, which ``ops.mha_flash`` gathers.
    """
    h, g = spec.n_heads, spec.n_kv_heads
    q, k, v = _project_qkv(p, x, spec)
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)
    k = plan.constrain(k, ("batch", None, None, None))
    v = plan.constrain(v, ("batch", None, None, None))
    # what the 'save_kv' remat policy keeps for the backward (JAX :141-142)
    k = checkpoint_name(k, "attn_kv")
    v = checkpoint_name(v, "attn_kv")
    if plan.can_shard("q_heads", h):
        kv_axes = ("batch", None, "kv_heads", None)
        if not plan.can_shard("kv_heads", g):
            kv_axes = ("batch", None, "q_heads", None)
            k, v = _repeat_kv(k, h), _repeat_kv(v, h)
        q = plan.constrain(q, ("batch", None, "q_heads", None))
        k = plan.constrain(k, kv_axes)
        v = plan.constrain(v, kv_axes)
    else:
        q = plan.constrain(q, ("batch", "seq", None, None))
    o = ops.mha_flash(q, k, v, causal=True, window=window,
                      scale=1.0 / math.sqrt(spec.resolved_head_dim))
    return _out_proj(p, o), k, v


def attention_fwd(p, x, positions, spec: ArchSpec, plan: ShardingPlan = NULL_PLAN, *,
                  window: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) self-attention over a full sequence."""
    return _attend(p, x, positions, spec, window, plan)[0]


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def attn_cache_defs(spec: ArchSpec, batch: int, seq: int, *,
                    window: int = 0) -> dict[str, ParamDef]:
    """``kpos`` (ring caches only) is int32: ``model.init_caches`` makes it so."""
    g, hd = spec.n_kv_heads, spec.resolved_head_dim
    t = min(window, seq) if window else seq
    axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    defs = {"k": ParamDef((batch, t, g, hd), axes, "zeros"),
            "v": ParamDef((batch, t, g, hd), axes, "zeros")}
    if window:
        defs["kpos"] = ParamDef((t,), (None,), "zeros")  # pos + 1 of each slot, 0 = empty
    return defs


def attn_prefill(p, x, positions, spec: ArchSpec, cache, *, window: int = 0):
    """Forward over the prompt, writing its k/v into the cache in place: a
    full cache takes them at ``[:, :S]``; a ring cache keeps the trailing
    ``min(S, t)`` tokens at slot ``pos % t`` and is emptied elsewhere, as
    the JAX ``attn_prefill`` (:193-201) rebuilds it."""
    s, t = x.shape[1], cache["k"].shape[1]
    y, k, v = _attend(p, x, positions, spec, window)
    if not window:
        if s > t:
            raise ValueError(f"prompt of {s} tokens does not fit a cache of {t}")
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        return y, cache
    m = min(s, t)
    tail = positions[s - m:].long()
    slots = tail % t
    for name, new in (("k", k), ("v", v)):
        cache[name][:, slots] = new[:, s - m:].to(cache[name].dtype)
        cache[name][:, m:] = 0  # m < t only when S < t: then slot i holds token i
    cache["kpos"][slots] = (tail + 1).to(cache["kpos"].dtype)
    cache["kpos"][m:] = 0
    return y, cache


def attn_decode(p, x, pos: int, spec: ArchSpec, cache, *, window: int = 0):
    """One decode step.  x: (B, D); pos: the new token's position (shared
    across the batch).  A full cache takes its k/v at slot ``min(pos, T-1)``
    in place and attends to slots ``0..pos``; a ring cache takes them at
    ``pos % t`` and attends to every slot under the JAX mask (:241): filled,
    not after ``pos``, and within the last ``t`` positions.

    GQA is computed with grouped einsums (no head-repeat copy).
    """
    b, d = x.shape
    h, g, hd = spec.n_heads, spec.n_kv_heads, spec.resolved_head_dim
    q, k, v = _project_qkv(p, x[:, None, :], spec)  # (B,1,...)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, spec.rope_theta)
    k = apply_rope(k, posv, spec.rope_theta)

    t = cache["k"].shape[1]
    slot = pos % t if window else min(pos, t - 1)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    if window:
        cache["kpos"][slot] = pos + 1
        kpos = cache["kpos"]
        valid = (kpos > 0) & (kpos - 1 <= pos) & (kpos - 1 > pos - t)
        n = t
    else:
        n = min(pos + 1, t)  # the slots the JAX mask `arange(T) <= pos` keeps

    qg = q[:, 0].reshape(b, g, h // g, hd)
    kk = cache["k"][:, :n].to(q.dtype)
    vv = cache["v"][:, :n].to(q.dtype)
    s = (torch.einsum("bgrk,btgk->bgrt", qg, kk) * (1.0 / math.sqrt(hd))).float()
    if window:
        s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bgrt,btgk->bgrk", pr, vv).reshape(b, 1, h, hd)
    return _out_proj(p, o)[:, 0], cache
