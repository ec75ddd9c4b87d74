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

The program's tracer (``runtime/tracing.py``) sees a layer as the span
``moe`` around ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine``, and counts ``moe.assignments`` (tokens x k),
``moe.dropped`` (on the device: the assignments over capacity) and
``moe.rows`` (the buffer rows the expert products run on this rank).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ArchSpec
from repro_torch.models.layers import ParamDef
from repro_torch.parallel.local_shards import (all_to_all, keep_weight_split, mesh_dims_along,
                                               on_local_shards, replicate, shard_extent, sum_over)
from repro_torch.parallel.sharding import NULL_PLAN, ShardingPlan
from repro_torch.runtime import tracing

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


def _expert_ffn(xe, w_gate, w_up, w_down, contract=None):
    """SwiGLU of each expert's rows: xe (E, R, D) -> (E, R, D).  With
    ``contract`` (the ranks that split D, each holding its columns of xe and
    its rows of w_gate and w_up, and its columns of w_down), the gate and up
    products are summed over them, and each rank's output is its D columns."""
    gate = torch.bmm(xe, w_gate.to(xe.dtype))
    up = torch.bmm(xe, w_up.to(xe.dtype))
    if contract is not None:
        gate, up = sum_over(gate, contract), sum_over(up, contract)
    return torch.bmm(F.silu(gate) * up, w_down.to(xe.dtype))


def _experts(xg, router, w_gate, w_up, w_down, k: int, cap: int, e_start: int = 0,
             group=None, contract=None):
    """Route the groups of xg (G, T, D) and run their kept tokens through the
    experts: y (G, T, D) and ``route``'s sums.

    ``router`` holds every expert; ``w_*`` may hold a share of them: their
    ff columns (the products' partial sums come back, a share of y), or the
    experts from ``e_start`` on.  Those then run on this rank's own rows of
    the buffer (the rest of y is another rank's share), or, with ``group``
    (the ranks that split the experts, each holding its own groups), every
    rank's rows of them, exchanged by ``all_to_all`` there and back.  With
    ``contract`` (the ranks that split D, which hold the same groups), xg,
    the router and the weights are this rank's D columns or rows: the
    router's and the gate and up products' partial sums are summed over
    them, and y is this rank's D columns."""
    ng, tg, d = xg.shape
    e, el = router.shape[1], w_gate.shape[0]
    with tracing.span("moe.route"):
        logits = (xg @ router.to(xg.dtype)).float()
        if contract is not None:
            logits = sum_over(logits, contract)
        top_i, slots, keep, top_w, aux = route(logits, k, cap)

    # row of each assignment in the (E, G, C) buffer; a dropped one goes to a
    # spare last entry.  src: the token each buffer row holds, ng * tg (a
    # row of zeros) where none does
    n_rows, n_tok = e * ng * cap, ng * tg
    every, n = el == e or group is not None, e // el
    with tracing.span("moe.dispatch"):
        group_ix = torch.arange(ng, device=xg.device)[:, None, None]
        row = (top_i * ng + group_ix) * cap + slots                     # (G,T,k)
        tok = (group_ix * tg + torch.arange(tg, device=xg.device)[None, :, None]).expand_as(row)
        src = torch.full((n_rows + 1,), n_tok, dtype=torch.int64, device=xg.device)
        src.scatter_(0, torch.where(keep, row, n_rows).reshape(-1), tok.reshape(-1))
        rows = F.pad(xg.reshape(n_tok, d), (0, 0, 0, 1))
        if every:
            xe = rows.index_select(0, src[:n_rows]).view(e, ng * cap, d)
            if group is not None:  # (n, el, G C, D): chunk r to rank r, holding experts r el ...
                got = all_to_all(xe.view(n, el, ng * cap, d), group)  # chunk r: rank r's rows
                xe = got.transpose(0, 1).reshape(el, n * ng * cap, d)
        else:  # this rank's experts only
            lo, n_mine = e_start * ng * cap, el * ng * cap
            xe = rows.index_select(0, src[lo:lo + n_mine]).view(el, ng * cap, d)
    with tracing.span("moe.experts"):
        out = _expert_ffn(xe, w_gate, w_up, w_down, contract)
    with tracing.span("moe.combine"):
        w = (top_w * keep).to(xg.dtype)                                 # dropped: weight 0
        if every:
            ye = out if group is None else \
                all_to_all(out.view(el, n, ng * cap, d).transpose(0, 1), group)
            ye = ye.view(n_rows, d)
            picked = ye.index_select(0, torch.where(keep, row, 0).reshape(-1))
        else:  # a zero row for the others' assignments
            ye = F.pad(out.view(n_mine, d), (0, 0, 0, 1))
            mine = keep & (top_i >= e_start) & (top_i < e_start + el)
            picked = ye.index_select(0, torch.where(mine, row - lo, n_mine).reshape(-1))
        y = torch.einsum("gtkd,gtk->gtd", picked.view(ng, tg, k, d), w)
    tracing.count("moe.assignments", n_tok * k)
    tracing.count("moe.dropped", aux["sums"][2])
    tracing.count("moe.rows", xe.shape[0] * xe.shape[1])
    return (y, *aux["sums"])


def _moe_local(x, router, w_gate, w_up, w_down, *, k: int, cap: int, tg: int,
               e_start: int = 0, group=None, contract=None, first: bool = True):
    """``_experts`` on x (B, S, D) cut into groups of ``tg`` tokens in
    chunk-major order (G = chunk * B + b, as the JAX module has it), and y
    back in x's layout.  ``first``: whether this rank reports the routing
    sums (ranks that hold the same groups report them once)."""
    b, s, d = x.shape
    nc = s // tg
    xg = x.reshape(b, nc, tg, d).transpose(0, 1).reshape(nc * b, tg, d)
    y, *sums = _experts(xg, router, w_gate, w_up, w_down, k, cap, e_start, group, contract)
    if not first:
        sums = [t * 0 for t in sums]
    return y.reshape(nc, b, tg, d).transpose(0, 1).reshape(b, s, d), *sums


def _fsdp_bytes(x, weights, rows, fsdp, split, ep, tg: int, cap: int):
    """(the bytes moved to keep the experts' D split over the mesh dims
    ``fsdp``, the bytes of gathering it): x's rows over those dims and the
    router's, gate's and up's partial sums, against the router and the three
    expert weights, each as a rank holds it.  ``rows``: the mesh dims whose
    split of x's rows stays; ``split``: mesh dim -> the experts' split dim
    (0 experts, 2 ff); ``ep``: the mesh dims whose all-to-all brings every
    rank's capacity rows."""
    mesh, (router, wg) = x.device_mesh, weights[:2]
    size = lambda dims: math.prod(mesh.size(i) for i in dims)
    b, s, d = x.shape
    n_rows = b * s // size(i for i in rows if i not in fsdp)
    el = wg.shape[0] // size(i for i, dim in split.items() if dim == 0)
    fl = wg.shape[2] // size(i for i, dim in split.items() if dim == 2)
    buffer = el * size(ep) * (n_rows // tg) * cap  # the expert rows a rank runs
    move = n_rows * d * x.element_size() + n_rows * router.shape[1] * 4 \
        + 2 * buffer * fl * x.element_size()
    gather = (d * router.shape[1] + 3 * el * d * fl) * wg.element_size()
    return move, gather


def _ff_bytes(x, wg, over, i, tg: int, cap: int):
    """The costs of the experts' ff columns split over mesh dim ``i``, which
    splits x's sequence too, for ``keep_weight_split``: keeping the split,
    the bytes moved (x's rows gathered over ``i`` and y's partial sums
    reduced) plus the buffer held (the capacity rows of every group of the
    rank's rows); gathering the columns, the three weights' bytes moved
    plus the buffer held (the capacity rows of its own groups, and the
    gathered weights).  The held bytes count because the two ways hold
    unlike: the capacity buffer of every row is what outgrows the card.
    ``over``: x's dim -> the mesh dims that split it."""
    mesh = x.device_mesh
    b, s, d = x.shape
    rows = b * s // math.prod(mesh.size(j) for dim in (0, 1) for j in over[dim] if j != i)
    e, f = wg.to_local().shape[0], wg.shape[2]
    buffer = lambda n: e * (n // tg) * cap * d * x.element_size()
    gather = 3 * e * d * f * wg.element_size()
    return (2 * rows * d * x.element_size() + buffer(rows),
            2 * gather + buffer(rows // mesh.size(i)))


def moe_apply(p, x, spec: ArchSpec, plan: ShardingPlan = NULL_PLAN):
    """x: (B, S, D) -> (y (B, S, D), aux {"lb_loss", "drop_frac"}).

    Under a plan routing, dispatch and the expert products run on each
    rank's local shard of x (``on_local_shards``: they index by position,
    which ``DTensor`` does not take): its groups are the (row, chunk) groups
    its rows hold, the residual stream's layout (batch over 'data', the
    sequence over 'model'), which is where the JAX ``moe_groups`` constraint
    puts them when a rank's chunk of the sequence is one group; a sequence
    split that would cut a group is gathered.  The expert weights stay split
    as the plan places them (``moe_defs``), the router is gathered whole:
      * experts split over a mesh dim that splits the sequence too: each
        rank runs its experts on every rank's capacity rows, sent there and
        back by ``all_to_all`` (what the JAX ``xe`` constraint lowers to);
      * experts or their ff columns split over a mesh dim that leaves x
        whole: each rank runs its share (its experts, or its ff columns,
        ``w_down``'s partial sum) on the groups, and y is its share of a
        sum over that dim, which the residual stream's constraint reduces;
      * ff columns split over a mesh dim that splits the sequence: x is
        gathered over it as above, unless gathering the columns for use
        costs less in bytes moved and the largest buffer held
        (``keep_weight_split`` on ``_ff_bytes``: prefill and training's
        many rows, whose capacity buffer outgrows the experts); then x's
        groups stay split, each rank runs its own groups through whole
        experts, and the weights' gradients go back to their split.
    The weights' FSDP split of D over 'data' stays where moving x costs
    fewer bytes than gathering the experts (``keep_weight_split``: decode's
    few rows, batch 1 on every 'data' rank): x's rows are gathered over
    that mesh dim and each rank takes its D columns (at batch 1 the
    residual stream already holds them), the router's and the gate and up
    products' partial sums are summed over it, and each rank's y is its D
    columns.  Elsewhere the split is gathered for use.
    The balance sums add up across ranks before the loss is formed.  The
    results do not depend on the split."""
    with tracing.span("moe"):
        b, s, d = x.shape
        e, k = spec.n_experts, spec.top_k
        tg = group_size_for(s)
        cap = expert_capacity(tg, spec)
        weights = [p[name] for name in ("router", "w_gate", "w_up", "w_down")]
        fn = functools.partial(_moe_local, k=k, cap=cap, tg=tg)
        keep, own, follow = (0, 1), {2: (0, 2), 3: (0, 2), 4: (0, 1)}, (None,) + ({},) * 4
        if isinstance(x, DTensor):
            mesh, wg = x.device_mesh, weights[1]
            split = {i: q.dim for i, q in enumerate(getattr(wg, "placements", ()))
                     if isinstance(q, Shard) and q.dim in (0, 2)}  # mesh dim -> expert or ff
            over = {dim: mesh_dims_along(x, dim) for dim in keep}
            n = math.prod(mesh.size(i) for i in over[1])
            groups = s % n == 0 and (s // n) % tg == 0  # each rank's chunk holds whole groups
            # ff columns split over a mesh dim that splits the sequence: gathered
            # for use where that costs less than every rank routing every row
            cols = [i for i in over[1] if groups and split.get(i) == 2
                    and not keep_weight_split(*_ff_bytes(x, wg, over, i, tg, cap))]
            if cols:
                split = {i: dim for i, dim in split.items() if i not in cols}
                # the experts' own split stays, their ff columns not
                own = {2: (0,), 3: (0,), 4: (0,)}
            # a split of x stays where each rank's chunk holds whole groups and the
            # mesh dim splits no ff columns (whose partial sums need every row)
            keep = tuple(dim for dim in keep if all(split.get(i, 0) == 0 for i in over[dim])
                         and (dim == 0 or groups))
            rows = {i for dim in keep for i in over[dim]}
            whole = [i for i in split if i not in rows]
            ep = [i for i in split if i in rows]
            fsdp = mesh_dims_along(wg, 1)
            contract = None
            if fsdp and keep_weight_split(*_fsdp_bytes(x, weights, rows, fsdp, split, ep, tg, cap)):
                x = x.redistribute(mesh, tuple(Shard(2) if i in fsdp else q
                                               for i, q in enumerate(x.placements)))
                keep = keep + (2,)
                follow = (None, {2: 0}, {2: 1}, {2: 1}, {2: 2})  # D split as x's is
                contract, whole = mesh.get_group(fsdp[0]), whole + fsdp
            fn = functools.partial(
                fn, e_start=shard_extent(wg, 0)[0]
                if any(split[i] == 0 for i in whole if i in split) else 0,
                group=mesh.get_group(ep[0]) if ep else None, contract=contract,
                first=all(mesh.get_coordinate()[i] == 0 for i in whole))
        y, *sums = on_local_shards(fn, (x, *weights), keep, follow=follow,
                                   out=(None, {}, {}, {}), own=own)
        sums = [replicate(t) for t in sums]
        return y, balance(sums, b * s, e, k)
