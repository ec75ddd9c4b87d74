"""Top-k routed Mixture-of-Experts with per-group expert capacity.

Counterpart of the JAX package's ``models/moe.py``: the same routing
(softmax, top-k, weights renormalised over the k), the same capacity per
(group, expert), ``C = group_size * top_k * CAPACITY_FACTOR / E`` rounded
up to a multiple of 8 (at least 8), the same drops (a token's position within an
expert counts earlier tokens first, then earlier routing slots, dropped
assignments included), the same group size (halved until it divides S) and
the same chunk-major group order, so the same tokens are dropped.  The
Switch load-balance loss over the top-1 choice and the dropped share come
back in ``aux``.

Where the JAX module builds (G, T, E, C) one-hot dispatch and combine
tensors and contracts them (the MXU-friendly form; about 2 x 32 GFLOP per
granite layer at B=4, S=1024), the port records which token each (group,
expert, slot) row of an expert-major (E, G, C, D) buffer holds, gathers those rows
(``index_select``), and gathers the expert outputs back by the same index.
Each kept (expert, slot) holds exactly one token, so both compute the same
function.  Nothing on the way asks the card for a count (no boolean-mask
indexing), so the host never waits for it.  The expert products are batched
matmuls, which the JAX package leaves to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchSpec
from repro_torch.models.layers import ParamDef
from repro_torch.parallel.local_shards import on_local_shards, replicate
from repro_torch.parallel.sharding import NULL_PLAN, ShardingPlan

CAPACITY_FACTOR = 1.25
GROUP_SIZE = 256


def moe_defs(spec: ArchSpec) -> dict[str, ParamDef]:
    d, f, e = spec.d_model, spec.d_ff, spec.n_experts
    return {
        "router": ParamDef((d, e), ("embed", "expert")),
        "w_gate": ParamDef((e, d, f), ("expert", "embed", "ff")),
        "w_up": ParamDef((e, d, f), ("expert", "embed", "ff")),
        "w_down": ParamDef((e, f, d), ("expert", "ff", "embed")),
    }


def expert_capacity(group_size: int, spec: ArchSpec) -> int:
    cap = int(group_size * spec.top_k * CAPACITY_FACTOR / spec.n_experts)
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


def group_size_for(s: int) -> int:
    """Tokens per routing group: ``GROUP_SIZE`` (or S if shorter), halved
    until it divides S; 1 at S = 1."""
    tg = min(GROUP_SIZE, s) if s > 1 else 1
    while s % tg:
        tg //= 2
    return tg


def balance(sums, n_tokens: int, e: int, k: int) -> dict:
    """The Switch load-balance loss over the top-1 assignment and the dropped
    share, from ``route``'s sums over ``n_tokens`` tokens: (count of top-1
    choices per expert (E,), routing probabilities per expert (E,), dropped
    assignments)."""
    top1, probs, dropped = sums
    lb_loss = e * torch.sum((top1 / n_tokens) * (probs / n_tokens))
    return {"lb_loss": lb_loss, "drop_frac": dropped / (n_tokens * k)}


def route(logits, k: int, cap: int):
    """logits: (G, T, E) f32 -> (experts (G,T,k), slots (G,T,k), keep (G,T,k),
    weights (G,T,k), aux).

    ``slots`` is each assignment's position within its expert: the number of
    assignments to that expert by earlier routing slots (all tokens of the
    group) plus those by earlier tokens in the same slot, i.e. a running
    count over the group's assignments taken slot-major.  ``aux["sums"]``
    holds what ``balance`` reads, so that groups routed apart add up.
    """
    g, t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    order = top_i.transpose(1, 2).reshape(g, 1, k * t)                  # slot-major
    # one-hot laid out (G, E, kT), so the running count scans the last dim
    oh = (order == torch.arange(e, device=logits.device)[:, None]).to(torch.int32)
    before = torch.cumsum(oh, dim=2, dtype=torch.int32) - oh
    slots = before.gather(1, order).view(g, k, t).transpose(1, 2)
    keep = slots < cap
    sums = (F.one_hot(top_i[..., 0], e).float().sum(dim=(0, 1)), probs.sum(dim=(0, 1)),
            (~keep).sum().float())
    return top_i, slots, keep, top_w, {**balance(sums, g * t, e, k), "sums": sums}


def _experts(xg, router, w_gate, w_up, w_down, k: int, cap: int):
    """Route the groups of xg (G, T, D) and run their kept tokens through the
    experts: y (G, T, D) and ``route``'s sums."""
    ng, tg, d = xg.shape
    e = router.shape[1]
    logits = (xg @ router.to(xg.dtype)).float()
    top_i, slots, keep, top_w, aux = route(logits, k, cap)

    # row of each assignment in the (E, G, C) buffer; a dropped one goes to a
    # spare last entry.  src: the token each buffer row holds, ng * tg (a
    # row of zeros) where none does
    n_rows, n_tok = e * ng * cap, ng * tg
    group = torch.arange(ng, device=xg.device)[:, None, None]
    row = (top_i * ng + group) * cap + slots                            # (G,T,k)
    tok = (group * tg + torch.arange(tg, device=xg.device)[None, :, None]).expand_as(row)
    src = torch.full((n_rows + 1,), n_tok, dtype=torch.int64, device=xg.device)
    src.scatter_(0, torch.where(keep, row, n_rows).reshape(-1), tok.reshape(-1))
    rows = F.pad(xg.reshape(n_tok, d), (0, 0, 0, 1))
    xe = rows.index_select(0, src[:n_rows]).view(e, ng * cap, d)

    gate = torch.bmm(xe, w_gate.to(xg.dtype))
    up = torch.bmm(xe, w_up.to(xg.dtype))
    ye = torch.bmm(F.silu(gate) * up, w_down.to(xg.dtype)).view(n_rows, d)

    w = (top_w * keep).to(xg.dtype)                                     # dropped: weight 0
    picked = ye.index_select(0, torch.where(keep, row, 0).reshape(-1)).view(ng, tg, k, d)
    return (torch.einsum("gtkd,gtk->gtd", picked, w), *aux["sums"])


def moe_apply(p, x, spec: ArchSpec, plan: ShardingPlan = NULL_PLAN):
    """x: (B, S, D) -> (y (B, S, D), aux {"lb_loss", "drop_frac"}).

    Under a plan the routing groups are split as the JAX ``moe_groups``
    constraint splits them (:103), and routing, dispatch and the expert
    products run on each rank's own groups (``on_local_shards``: they index by
    position, which ``DTensor`` does not take).  The expert weights are
    gathered whole into that region, and their gradients come back as the
    sum of every rank's share; the balance sums add up across ranks before
    the loss is formed.  The results do not depend on the split."""
    b, s, d = x.shape
    e, k = spec.n_experts, spec.top_k
    tg = group_size_for(s)
    nc, ng = s // tg, (b * s) // tg
    cap = expert_capacity(tg, spec)
    # chunk-major group order, G = chunk * B + b, as the JAX module has it
    xg = x.reshape(b, nc, tg, d).transpose(0, 1).reshape(ng, tg, d)
    xg = plan.constrain(xg, ("moe_groups", None, None))
    fn = functools.partial(_experts, k=k, cap=cap)
    weights = [p[name] for name in ("router", "w_gate", "w_up", "w_down")]
    y, *sums = on_local_shards(fn, (xg, *weights), (0,), follow=(None,) + ({},) * 4,
                               out=(None, {}, {}, {}))
    sums = [replicate(t) for t in sums]
    y = plan.constrain(y, ("moe_groups", None, None))
    y = y.reshape(nc, b, tg, d).transpose(0, 1).reshape(b, s, d)
    return y, balance(sums, ng * tg, e, k)
