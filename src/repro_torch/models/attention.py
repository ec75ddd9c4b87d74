"""GQA attention: prefill/forward through the flash kernel + cached decode.

Counterpart of the JAX package's ``models/attention.py``.  Every prefill and
forward length goes through ``ops.mha_flash`` (the JAX module's dense branch
and its ``flash_attention_ref`` branch, :154-162, both become the kernel).
Decode attends one query row against the cache with plain tensor ops, as
the JAX package computes it outside any Pallas kernel (:248-256).

Caches are dicts of tensors that prefill and decode update in place (no
copy of the whole cache per token) and return.  Under a plan each is a
``DTensor`` placed by its cache axes (``kv_seq`` split over 'data' and
'model', or 'model' alone, when the batch and the groups leave them free):
every write at a position goes through ``local_shards.write_along``, so each
rank writes the rows that fall in its own shard and the cache is never
gathered.  Where ``kv_seq`` is split, decode reads each rank's own slots
under the JAX mask ``arange(T) <= pos`` (:233-246) and splits the softmax
over the row, as XLA does (``split_softmax``); where it is whole
(unsharded, or a plan that splits batch or groups instead) decode reads the
slots ``0..pos`` alone.  A global layer's cache is
``{"k", "v"}`` of (B, T, G, hd) with T the serving length.  A
sliding-window layer keeps a ring buffer of ``t = min(window, T)`` slots,
the JAX ``attn_cache_defs`` (:170-180): token ``pos`` lives in slot
``pos % t`` and ``kpos[slot]`` holds ``pos + 1`` (0 = empty).  ``kpos`` is
int32 whatever the cache dtype, so it holds every position exactly; the JAX
package keeps it in the cache dtype, where bf16 rounds 513 to 512.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import ParamDef, apply_rope, checkpoint_name, linear, linears
from repro_torch.parallel.local_shards import (grad_as_input, mesh_dims_along, on_local_shards,
                                               reduce_over, shard_extent, split_along,
                                               write_along)
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


def _project_qkv(p, x, spec: ArchSpec, plan: ShardingPlan = NULL_PLAN):
    """x: (B, S, D) -> q (B, S, H, hd), k/v (B, S, G, hd).  Under a plan a
    product whose heads do not split over 'model' is kept whole along its
    last dim, so that it can be viewed as (heads, hd)."""
    b, s, d = x.shape
    names = (("wq", "bq", "q_heads"), ("wk", "bk", "kv_heads"), ("wv", "bv", "kv_heads"))
    # the gradients view back
    ys = linears(x, *(grad_as_input(p[w].reshape(d, -1)) for w, _, _ in names))
    out = []
    for (w, bias, heads), y in zip(names, ys):
        if not plan.can_shard(heads, p[w].shape[1]):
            y = plan.constrain(y, ("batch", "seq", None))
        y = y.view(b, s, *p[w].shape[1:])
        out.append(y + p[bias].to(y.dtype) if spec.qkv_bias else y)
    return tuple(out)


def _out_proj(p, o):
    """o: (B, S, H, hd), or flat (B, S, H * hd) -> (B, S, D)."""
    h, hd, d = p["wo"].shape
    flat = grad_as_input(o.reshape(*o.shape[:2], h * hd))  # its gradient views back to (H, hd)
    return linear(flat, grad_as_input(p["wo"].reshape(h * hd, d)))


def _repeat_kv(k, n_heads: int):
    """(B, T, G, hd) -> (B, T, H, hd) by repeating each group (JAX :52-58)."""
    b, t, g, hd = k.shape
    return k[:, :, :, None, :].expand(b, t, g, n_heads // g, hd).reshape(b, t, n_heads, hd)


def _attend(p, x, positions, spec: ArchSpec, window: int, plan: ShardingPlan = NULL_PLAN):
    """Self-attention over the sequence; also returns the roped k and v
    (B, S, G, hd), as the cache takes them.

    The kernel masks by index, so ``positions`` (used for RoPE) must be
    ``arange(S)``, as every caller passes.  Under a plan, the JAX layout
    policy (:139-151): heads split over 'model' when they divide it
    (Megatron head-sharded attention; k/v's groups split with them, or are
    repeated to the heads first when they do not divide it), else q keeps
    the residual stream's sequence split, which ``ops.mha_flash`` gathers.
    """
    h, g = spec.n_heads, spec.n_kv_heads
    q, k, v = _project_qkv(p, x, spec, plan)
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)
    k = kc = plan.constrain(k, ("batch", None, None, None))
    v = vc = plan.constrain(v, ("batch", None, None, None))
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
    return _out_proj(p, o), kc, vc


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


def attn_prefill(p, x, positions, spec: ArchSpec, plan: ShardingPlan, cache, *,
                 window: int = 0):
    """Forward over the prompt, writing its k/v into the cache in place: a
    full cache takes them at ``[:, :S]``; a ring cache keeps the trailing
    ``m = min(S, t)`` tokens at slot ``pos % t`` and is emptied elsewhere, as
    the JAX ``attn_prefill`` (:193-201) rebuilds it."""
    s, t = x.shape[1], cache["k"].shape[1]
    y, k, v = _attend(p, x, positions, spec, window, plan)
    if not window:
        if s > t:
            raise ValueError(f"prompt of {s} tokens does not fit a cache of {t}")
        write_along(cache["k"], k, 0)
        write_along(cache["v"], v, 0)
        return y, constrain_cache(cache, plan)
    m = min(s, t)
    r = (s - m) % t  # the slot of the first kept token: the kept tokens wrap at t - r
    for name, new in (("k", k), ("v", v)):
        cache[name].zero_()  # m < t only when S < t: then slot i holds token i
        write_along(cache[name], new[:, s - m:s - r], r)
        write_along(cache[name], new[:, s - r:], 0)
    kpos = torch.zeros((t,), dtype=torch.int32, device=x.device)
    tail = torch.arange(s - m, s, device=x.device)
    kpos[tail % t] = (tail + 1).to(torch.int32)
    write_along(cache["kpos"], kpos, 0, dim=0)
    return y, constrain_cache(cache, plan)


def constrain_cache(cache, plan: ShardingPlan):
    """The cache's k and v laid out by their cache axes (JAX :211-215); the
    identity where they are already, as a cache placed by ``cache_axes``
    is."""
    out = dict(cache)
    for n in ("k", "v"):
        out[n] = plan.constrain(cache[n], ("batch", "kv_seq", "kv_heads", "head_dim"))
    return out


def _ring_valid(kpos, pos: int, t: int):
    """A ring cache's mask (JAX :241): filled, not after ``pos``, and within
    the last ``t`` positions."""
    return (kpos > 0) & (kpos - 1 <= pos) & (kpos - 1 > pos - t)


def split_softmax(s, groups):
    """The softmax over the last dim of a row split over ``groups`` (the
    ranks of each mesh dim that split it), on this rank's part ``s`` of it,
    as XLA lowers a softmax over a split dim (the combine step of a split-K
    decode): the row's max and then the sum of its exps are all-reduced.
    A part that is all ``NEG_INF`` (masked) comes out 0: its exps are taken
    against the row's max."""
    e = torch.exp(s - reduce_over(s.amax(dim=-1, keepdim=True), "max", groups))
    return e / reduce_over(e.sum(dim=-1, keepdim=True), "sum", groups)


def _own_slots(k, v, qg, kpos=None, *, pos: int, t: int, lo: int, groups):
    """Decode's attention over this rank's slots of a cache split along
    ``kv_seq`` (the slots ``lo`` onwards): this rank's share of o, (B, 1,
    H * hd), a sum over ``groups`` (the ranks of each mesh dim that splits
    ``kv_seq``): its slots' v weighted by their probabilities
    (``split_softmax``).  A slot past ``pos`` (on a shard that holds none
    yet, every slot) is masked.  ``kpos``: a ring cache's, its own slots;
    ``t``: the ring's length."""
    s = (torch.einsum("bgrk,btgk->bgrt", qg, k.to(qg.dtype)) * (1.0 / math.sqrt(qg.shape[-1]))
         ).float()
    valid = (torch.arange(lo, lo + k.shape[1], device=k.device) <= pos) if kpos is None \
        else _ring_valid(kpos, pos, t)
    pr = split_softmax(torch.where(valid, s, NEG_INF), groups).to(qg.dtype)
    o = torch.einsum("bgrt,btgk->bgrk", pr, v.to(qg.dtype))
    return o.reshape(o.shape[0], 1, -1)


def attn_decode(p, x, pos: int, spec: ArchSpec, plan: ShardingPlan, cache, *,
                window: int = 0):
    """One decode step.  x: (B, D); pos: the new token's position (shared
    across the batch).  A full cache takes its k/v at slot ``min(pos, T-1)``
    in place and attends to slots ``0..pos``; a ring cache takes them at
    ``pos % t`` and attends to every slot under the JAX mask (:241): filled,
    not after ``pos``, and within the last ``t`` positions.  A cache whose
    ``kv_seq`` a plan splits stays split: each rank attends to its own
    slots under the mask (``_own_slots``: the softmax's max and sum
    all-reduced), and o, the sum of the ranks' shares, goes to the output
    projection as a ``Partial``, flat: each rank runs the product on its
    share, as XLA does (a ``Partial`` flattened under ``DTensor`` is
    reduce-scattered, and the product then splits its contraction).

    GQA is computed with grouped einsums (no head-repeat copy).
    """
    b, d = x.shape
    h, g, hd = spec.n_heads, spec.n_kv_heads, spec.resolved_head_dim
    q, k, v = _project_qkv(p, x[:, None, :], spec, plan)  # (B,1,...)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, spec.rope_theta)
    k = apply_rope(k, posv, spec.rope_theta)

    t = cache["k"].shape[1]
    slot = pos % t if window else min(pos, t - 1)
    write_along(cache["k"], k, slot)
    write_along(cache["v"], v, slot)
    cache = constrain_cache(cache, plan)
    if window:
        write_along(cache["kpos"], pos + 1, slot, dim=0)

    # (B, H, hd) -> (B, G, R, hd): heads split only where the groups split too
    q1 = plan.constrain(q[:, 0], ("batch", "q_heads" if plan.can_shard("kv_heads", g) else None,
                                  None))
    qg = q1.reshape(b, g, h // g, hd)
    if split_along(cache["k"], 1):
        kc = cache["k"]
        fn = functools.partial(_own_slots, pos=pos, t=t, lo=shard_extent(kc, 1)[0],
                               groups=[kc.device_mesh.get_group(i)
                                       for i in mesh_dims_along(kc, 1)])
        args = (kc, cache["v"], qg) + ((cache["kpos"],) if window else ())
        o = on_local_shards(fn, args, (0, 1, 2),
                            follow=(None, None, {0: 0, 2: 1}, {1: 0})[:len(args)],
                            out={0: 0, 2: 2})
        return _out_proj(p, o)[:, 0], cache
    n, valid = t, None
    if window:
        valid = _ring_valid(cache["kpos"], pos, t)
    else:
        n = min(pos + 1, t)  # the slots the JAX mask `arange(T) <= pos` keeps
    kk, vv = (cache[name] if n == t else cache[name][:, :n] for name in ("k", "v"))
    kk, vv = kk.to(q.dtype), vv.to(q.dtype)
    s = (torch.einsum("bgrk,btgk->bgrt", qg, kk) * (1.0 / math.sqrt(hd))).float()
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bgrt,btgk->bgrk", pr, vv).reshape(b, 1, h, hd)
    return _out_proj(p, o)[:, 0], cache
