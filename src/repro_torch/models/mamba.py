"""Mamba2 (SSD, state-space duality) mixer.

Counterpart of the JAX package's ``models/mamba.py``.  Forward and prefill
run the SSD scan through ``ops.ssd``, so the Hopper kernel runs there at
every prompt length (the JAX module's ``ssd_chunked`` call, :150 and :191,
becomes the kernel).  In training the scan differentiates through the
kernels' autograd Function (``kernels/ssd_scan.py`` ``SSDScanFn``, whose
backward is ``csrc/ssd_scan_bwd.cu``), where the JAX trainer differentiates
its jnp ``ssd_chunked``: every input of the call keeps its gradient, x and
the B/C views of the causal conv's outputs, dt (f32, through softplus) and
``a = -exp(a_log)``.  ``ssd_chunked`` itself stays a plain torch function,
held against the JAX one by the tests; nothing on the serving or training
path calls it.  The causal conv, the gate and the decode recurrence are
plain tensor ops, as the JAX package computes them outside any Pallas
kernel.

The decode cache is a dict ``{"conv": (B, cw-1, C), "ssm": (B, H, P, N)}``;
``conv`` holds the last cw-1 rows of the *pre-activation* conv input.
Prefill and decode update it in place and return it.  Under a plan the
cache's leaves are ``DTensor``s placed by their cache axes; what is written
into them is first laid out as they are (``_store``), so each rank copies
its own shard.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ArchSpec
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef, linear, linears, rmsnorm
from repro_torch.parallel.local_shards import (all_to_all, lift, mesh_dims_along,
                                               on_local_shards, split_along)
from repro_torch.parallel.sharding import NULL_PLAN, ShardingPlan, placements

DEFAULT_CHUNK = 256


def mamba_defs(spec: ArchSpec) -> dict[str, ParamDef]:
    d, din = spec.d_model, spec.d_inner
    g, ds, nh, cw = spec.ssm_groups, spec.ssm_state, spec.ssm_heads, spec.ssm_conv
    return {
        "w_z": ParamDef((d, din), ("embed", "d_inner")),
        "w_x": ParamDef((d, din), ("embed", "d_inner")),
        "w_b": ParamDef((d, g * ds), ("embed", None)),
        "w_c": ParamDef((d, g * ds), ("embed", None)),
        "w_dt": ParamDef((d, nh), ("embed", None)),
        "conv_x": ParamDef((cw, din), (None, "d_inner")),
        "conv_b": ParamDef((cw, g * ds), (None, None)),
        "conv_c": ParamDef((cw, g * ds), (None, None)),
        "a_log": ParamDef((nh,), (None,), "ssm_a_log"),
        "dt_bias": ParamDef((nh,), (None,), "ssm_dt_bias"),
        "d_skip": ParamDef((nh,), (None,), "ones"),
        "norm": ParamDef((din,), ("d_inner",), "zeros"),
        "w_out": ParamDef((din, d), ("d_inner", "embed")),
    }


def _causal_conv(x, w):
    """Depthwise causal conv along time.  x: (B,S,C); w: (cw, C).  A sharded
    x is convolved on each rank's rows (``on_local_shards``) with the sequence
    whole (a split one would need its neighbour's last cw-1 rows); batch
    and channels may stay split."""
    return on_local_shards(_causal_conv_local, (x, w), (0, 2), follow=(None, {2: 1}))


def _causal_conv_local(x, w):
    cw = w.shape[0]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros_like(x)
    for i in range(cw):  # cw is 4: unrolled adds, in the JAX module's order
        out = out + pad[:, i : i + x.shape[1]] * w[i].to(x.dtype)
    return F.silu(out)


def _segsum(t):
    """Stable 'segment sum' producing the lower-tri decay exponents.

    t: (..., L) -> (..., L, L) with out[i, j] = sum_{j < m <= i} t[m].
    """
    ln = t.shape[-1]
    cs = torch.cumsum(t, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((ln, ln), dtype=torch.bool, device=t.device))
    return out.masked_fill(~mask, -torch.inf)


def ssd_chunked(x, dt, a, b, c, chunk: int = DEFAULT_CHUNK, h0=None):
    """Chunked SSD scan (single pass over chunks), the JAX ``ssd_chunked``.

    x (B,S,H,P), dt (B,S,H), a (H,), b/c (B,S,G,N) -> y (B,S,H,P), final
    state (B,H,P,N).  A loop over chunks carries the f32 state; inside a
    chunk the dual quadratic form is two products.
    """
    bsz, s, h, p = x.shape
    ln = min(chunk, s)
    assert s % ln == 0, (s, ln)
    rep = h // b.shape[2]
    f32 = torch.float32
    af = a.float()
    hprev = torch.zeros((bsz, h, p, b.shape[3]), dtype=f32, device=x.device) \
        if h0 is None else h0.float()
    ys = []
    for c0 in range(0, s, ln):
        xi, dti = x[:, c0:c0 + ln], dt[:, c0:c0 + ln].float()
        bh = b[:, c0:c0 + ln].repeat_interleave(rep, dim=2).float()  # (B,L,H,N)
        ch = c[:, c0:c0 + ln].repeat_interleave(rep, dim=2).float()
        da = dti * af                                                # (B,L,H)
        da_cum = torch.cumsum(da, dim=1)
        seg = _segsum(da.transpose(-1, -2))                          # (B,H,L,L)
        cb = torch.einsum("blhn,bmhn->bhlm", ch, bh)
        att = cb * torch.exp(seg)
        xdt = xi.float() * dti[..., None]
        y_diag = torch.einsum("bhlm,bmhp->blhp", att, xdt)
        in_decay = torch.exp(da_cum)                                 # (B,L,H)
        y_off = torch.einsum("blhn,bhpn->blhp", ch * in_decay[..., None], hprev)
        decay_to_end = torch.exp(da_cum[:, -1:, :] - da_cum)         # (B,L,H)
        st = torch.einsum("blhn,blhp->bhpn", bh * (dti * decay_to_end)[..., None], xi.float())
        hprev = hprev * torch.exp(da_cum[:, -1, :])[..., None, None] + st
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.cat(ys, dim=1), hprev


def _heads(t, shape, plan: ShardingPlan, axes):
    """``t`` (..., d_inner) viewed as ``shape`` (..., heads, head_dim) and
    laid out by ``axes`` + ("ssm_heads", "ssm_head_dim"): split over 'model'
    by its heads where they divide it, else by its head_dim where that
    does (mamba2's 24 heads on 16 ranks: each rank scans 4 of the 64
    columns of every head, since every product of the scan but those of
    dt, a, B and C is independent across head_dim, as the JAX plan splits
    the SSM state), else whole.  A d_inner split that the heads do not
    follow moves to the head_dim split by one all-to-all of each rank's
    share (``_to_head_dim``), as XLA moves it; any other such split is
    gathered first: its pieces need not fall on heads."""
    nh = shape[-2]
    want = axes + ("ssm_heads", "ssm_head_dim")
    if not plan.can_shard("ssm_heads", nh):
        moved = _to_head_dim(t, shape, plan, want)
        if moved is not None:
            return moved
        t = plan.constrain(t, axes + (None,))
    return plan.constrain(t.view(*shape), want)


def _fold_heads(y, shape, plan: ShardingPlan, axes):
    """``y`` (..., heads, head_dim) viewed as ``shape`` (..., d_inner).  A
    head_dim split moves to the d_inner split of ``axes`` + ("d_inner",) by
    one all-to-all where the plan splits d_inner over the same mesh dim
    (``_from_head_dim``).  Otherwise, as a ``DTensor`` view may fold the two
    only where head_dim is not split, the split moves first: to the
    sequence of the scan's (B, S, H, P) (an all-to-all), or away from
    decode's (B, H, P) (a gather)."""
    moved = _from_head_dim(y, shape, plan, axes + ("d_inner",))
    if moved is not None:
        return moved
    d = y.ndim - 1
    if split_along(y, d):
        to = Shard(1) if y.ndim == 4 else Replicate()
        y = y.redistribute(y.device_mesh, tuple(to if q == Shard(d) else q for q in y.placements))
    return y.reshape(shape)


@functools.cache
def _head_dim_moves(din: int, hd: int, n: int, k: int):
    """Rank ``k`` of ``n`` holds d_inner's columns [k piece, (k + 1) piece)
    (piece = din / n) under the d_inner split, and the columns c with
    (c % hd) // (hd / n) = k, the k-th share of every head, under the
    head_dim split.  Returns (order, send, recv): its d_inner columns in the
    order they leave (by the rank whose head_dim share holds them, then by
    column), how many go to each rank, and how many come from each.  A
    rank's head_dim columns arrive in column order, that is (head, column
    of its share), so the counts differ by rank (mamba2: 8 or 4 of a
    rank's 96 columns to each of 16) and no gather pads them."""
    piece, share = din // n, hd // n
    owner = lambda c: (c % hd) // share
    order = sorted(range(piece), key=lambda i: (owner(k * piece + i), i))
    send = [sum(owner(k * piece + i) == q for i in range(piece)) for q in range(n)]
    recv = [sum(owner(r * piece + i) == k for i in range(piece)) for r in range(n)]
    return order, send, recv


def _one_mesh_dim(x, dim: int, target, d_target: int):
    """The one mesh dim that splits ``x``'s ``dim``, where ``target`` (the
    placements of the layout to move to) splits its ``d_target`` over that
    mesh dim; else None."""
    dims = mesh_dims_along(x, dim)
    if len(dims) != 1 or target[dims[0]] != Shard(d_target):
        return None
    return dims[0]


def _to_head_dim(t, shape, plan: ShardingPlan, want):
    """``t`` (..., d_inner), split over its last dim by one mesh dim, as the
    (..., heads, head_dim) view laid out by ``want``, which splits head_dim
    over that mesh dim: each rank sends each other its columns of that
    rank's head_dim share (``_head_dim_moves``), by one all-to-all.  None
    where the layouts do not fit that."""
    if not isinstance(t, DTensor):
        return None
    mesh, target = t.device_mesh, placements(plan.spec(want, shape), t.device_mesh)
    i = _one_mesh_dim(t, t.ndim - 1, target, len(shape) - 1)
    n = mesh.size(i) if i is not None else 0
    heads_split = any(p == Shard(len(shape) - 2) for p in target)
    if not n or t.shape[-1] % n or shape[-1] % n or heads_split:
        return None
    t = _laid_out(t, tuple(Shard(t.ndim - 1) if j == i else p for j, p in enumerate(target)))
    order, send, recv = _head_dim_moves(t.shape[-1], shape[-1], n, mesh.get_coordinate()[i])
    local = t.to_local()
    rows, nh = local.shape[:-1], shape[-2]
    index = torch.tensor(order, device=local.device)
    out = all_to_all(local.reshape(-1, local.shape[-1]).t().index_select(0, index),
                     mesh.get_group(i), recv, send)
    out = out.view(nh, shape[-1] // n, -1).permute(2, 0, 1).reshape(*rows, nh, shape[-1] // n)
    return DTensor.from_local(out.contiguous(), mesh, target, run_check=False)


def _from_head_dim(y, shape, plan: ShardingPlan, want):
    """The reverse of ``_to_head_dim``: ``y`` (..., heads, head_dim), split
    over head_dim by one mesh dim, as (..., d_inner) laid out by ``want``,
    which splits d_inner over that mesh dim.  None where the layouts do not
    fit that."""
    if not isinstance(y, DTensor):
        return None
    mesh, target = y.device_mesh, placements(plan.spec(want, shape), y.device_mesh)
    i = _one_mesh_dim(y, y.ndim - 1, target, len(shape) - 1)
    n = mesh.size(i) if i is not None else 0
    if not n or shape[-1] % n or y.shape[-1] % n or split_along(y, y.ndim - 2):
        return None
    y = _laid_out(y, tuple(Shard(y.ndim - 1) if j == i else p for j, p in enumerate(target)))
    order, send, recv = _head_dim_moves(shape[-1], y.shape[-1], n, mesh.get_coordinate()[i])
    local = y.to_local()
    rows = local.shape[:-2]
    flat = local.reshape(-1, local.shape[-2] * local.shape[-1]).t()  # columns in order
    got = all_to_all(flat, mesh.get_group(i), send, recv)  # this rank's columns, in `order`
    back = torch.tensor(sorted(range(len(order)), key=order.__getitem__), device=got.device)
    out = got.index_select(0, back).t().reshape(*rows, -1)
    return DTensor.from_local(out.contiguous(), mesh, target, run_check=False)


def _laid_out(x, want):
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def _in_proj(p, x):
    """x: (..., D) -> z, x, b, c (pre-conv) and dt (f32, through softplus)."""
    z, xi, bi, ci, dt = linears(x, *(p[k] for k in ("w_z", "w_x", "w_b", "w_c", "w_dt")))
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return z, xi, bi, ci, dt


def _scan(p, x, spec: ArchSpec, plan: ShardingPlan = NULL_PLAN):
    """The forward/prefill mixer body.  Returns (out, pre-conv stream, final
    state).  Under a plan, constrained at the JAX package's sites
    (:148-155)."""
    bsz, s, _ = x.shape
    din, g, ds, nh, hd = spec.d_inner, spec.ssm_groups, spec.ssm_state, spec.ssm_heads, \
        spec.ssm_head_dim
    z, xi0, bi0, ci0, dt = _in_proj(p, x)
    xi = _causal_conv(xi0, p["conv_x"])
    bi = _causal_conv(bi0, p["conv_b"])
    ci = _causal_conv(ci0, p["conv_c"])
    a = -torch.exp(p["a_log"].float())
    xh = _heads(xi, (bsz, s, nh, hd), plan, ("batch", None))
    dt = plan.constrain(dt, ("batch", None, "ssm_heads"))
    y, hlast = ops.ssd(xh, dt, a, bi.view(bsz, s, g, ds), ci.view(bsz, s, g, ds))
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = plan.constrain(_fold_heads(y, (bsz, s, din), plan, ("batch", "seq")),
                       ("batch", "seq", "d_inner"))
    y = rmsnorm(y * F.silu(z), p["norm"], spec.norm_eps)
    return linear(y, p["w_out"]), (xi0, bi0, ci0), hlast


def mamba_fwd(p, x, spec: ArchSpec, plan: ShardingPlan = NULL_PLAN):
    """x: (B, S, D) -> (B, S, D)."""
    return _scan(p, x, spec, plan)[0]


_CACHE_AXES = {"conv": ("batch", None, "d_inner"), "ssm": ("batch", None, "ssm_head_dim", None)}


def mamba_cache_defs(spec: ArchSpec, batch: int) -> dict[str, ParamDef]:
    din, g, ds, nh, hd, cw = (spec.d_inner, spec.ssm_groups, spec.ssm_state,
                              spec.ssm_heads, spec.ssm_head_dim, spec.ssm_conv)
    return {
        "conv": ParamDef((batch, cw - 1, din + 2 * g * ds), _CACHE_AXES["conv"], "zeros"),
        "ssm": ParamDef((batch, nh, hd, ds), _CACHE_AXES["ssm"], "zeros"),
    }


def _store(cache, plan: ShardingPlan, **new):
    """Copy each new leaf into the cache in place, laid out first by the
    cache's axes (``mamba_cache_defs``) so that the copy is each rank's own."""
    for name, t in new.items():
        cache[name].copy_(plan.constrain(t.to(cache[name].dtype), _CACHE_AXES[name]))
    return cache


def mamba_prefill(p, x, spec: ArchSpec, plan: ShardingPlan, cache):
    """Forward over the prompt, writing the conv tail and the final state
    into ``cache`` in place.  A prompt shorter than cw-1 leaves the zeros
    the causal conv pads with in front of it."""
    k = spec.ssm_conv - 1
    out, pre, hlast = _scan(p, x, spec, plan)
    tail = torch.cat([t[:, -k:] for t in pre], dim=-1)  # raw pre-activation rows
    if tail.shape[1] < k:
        tail = F.pad(tail, (0, 0, k - tail.shape[1], 0))
    return out, _store(cache, plan, conv=tail, ssm=hlast)


def _conv_whole_rows(p, conv, xi, bi, ci):
    """Decode's causal conv on whole rows, as the JAX module computes it
    (:217-223): the three streams' new row concatenated, the cache's cw-1
    rows before it, one product over all C channels.  Returns the streams
    after the conv and the cache's new rows (B, cw-1, C).  Under a plan
    whose layouts ``_conv_own_columns`` does not take, the concatenations
    gather what they join."""
    din, gds = xi.shape[-1], bi.shape[-1]
    window = torch.cat([conv.to(xi.dtype), torch.cat([xi, bi, ci], dim=-1)[:, None, :]], dim=1)
    wfull = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=1)            # (cw, C)
    out = F.silu(torch.einsum("bwc,wc->bc", window, wfull.to(xi.dtype)))
    return (out[:, :din], out[:, din:din + gds], out[:, din + gds:]), window[:, 1:]


@functools.cache
def _conv_moves(din: int, c: int, n: int, k: int):
    """Rank ``k`` of ``n`` holds the conv cache's channels [k cp, (k + 1) cp)
    (cp = c / n: its split of all C channels) and xi's columns
    [k dp, (k + 1) dp) (dp = din / n: the d_inner split); the channels past
    din are b's and c's, which every rank convolves whole.  Returns
    (order, send, recv, back_send, back_recv).  Load: the local channels
    this rank sends, by the rank they go to (a d_inner channel to the rank
    whose piece holds it, a b/c channel to every rank), how many go to each
    rank and how many come from each; what arrives is in channel order, so
    this rank's d_inner piece and then every b/c channel.  Store: how many
    of its d_inner piece's columns go back to each rank's channel piece,
    and how many of its own channel piece's d_inner columns come from
    each."""
    cp, dp = c // n, din // n
    goes_to = lambda ch, q: ch >= din or ch // dp == q
    held = lambda r: range(r * cp, (r + 1) * cp)
    order = [ch - k * cp for q in range(n) for ch in held(k) if goes_to(ch, q)]
    send = [sum(goes_to(ch, q) for ch in held(k)) for q in range(n)]
    recv = [sum(goes_to(ch, k) for ch in held(r)) for r in range(n)]
    overlap = lambda lo, hi, lo2, hi2: max(0, min(hi, hi2) - max(lo, lo2))
    back_send = [overlap(k * dp, (k + 1) * dp, q * cp, (q + 1) * cp) for q in range(n)]
    back_recv = [overlap(r * dp, (r + 1) * dp, k * cp, (k + 1) * cp) for r in range(n)]
    return order, send, recv, back_send, back_recv


def _conv_own_columns(p, conv, xi, bi, ci):
    """Decode's causal conv with the d_inner split kept, or None where the
    layouts do not fit it.  It fits where one mesh dim splits the cache's
    C channels (``_CACHE_AXES``: the leaf is laid out as the JAX cache, in
    pieces of C / n that do not follow xi's pieces of d_inner / n), xi's
    d_inner splits over it too, and any other split is the batch's.  Each
    rank then convolves its own d_inner columns of xi and b's and c's whole
    (as the plan lays them out): one all-to-all of unequal pieces brings it
    the cache's rows of those channels (``_conv_moves``), the same move as
    the head view's (``_to_head_dim``), and one more takes the new rows of
    its d_inner columns back to the cache's pieces.  Neither the cache's
    channels nor xi is gathered whole; b's and c's new rows (B x 2 g ds),
    which a ``DTensor`` product may hand over split, are.  Returns what
    ``_conv_whole_rows`` returns, xi's conv in its d_inner split and b's
    and c's whole."""
    if not (isinstance(conv, DTensor) and isinstance(xi, DTensor)):
        return None
    mesh, cache_pl = conv.device_mesh, tuple(conv.placements)
    dims = mesh_dims_along(conv, 2)
    if len(dims) != 1 or any(q not in (Replicate(), Shard(0), Shard(2)) for q in cache_pl):
        return None
    i, din, c = dims[0], xi.shape[-1], conv.shape[-1]
    n = mesh.size(i)
    if c % n or din % n:
        return None
    batch = tuple(Shard(0) if q == Shard(0) else Replicate() for q in cache_pl)
    x_pl = tuple(Shard(1) if j == i else q for j, q in enumerate(batch))
    w_pl = tuple(Shard(1) if j == i else Replicate() for j in range(mesh.ndim))
    xl = _laid_out(xi, x_pl).to_local()
    bl, cl = (_laid_out(t, batch).to_local() for t in (bi, ci))
    w = torch.cat([_laid_out(lift(p["conv_x"], conv), w_pl).to_local()] + [
        _laid_out(lift(p[k], conv), (Replicate(),) * mesh.ndim).to_local()
        for k in ("conv_b", "conv_c")], dim=1).to(xl.dtype)
    k = mesh.get_coordinate()[i]
    order, send, recv, back_send, back_recv = _conv_moves(din, c, n, k)
    group = mesh.get_group(i)
    old = conv.to_local().to(xl.dtype)                        # (b, cw-1, C / n)
    b, rows = old.shape[0], old.shape[0] * old.shape[1]
    index = torch.tensor(order, device=old.device)
    got = all_to_all(old.reshape(rows, -1).t().index_select(0, index), group, recv, send)
    window = torch.cat([got.t().reshape(b, old.shape[1], -1),
                        torch.cat([xl, bl, cl], dim=-1)[:, None, :]], dim=1)
    out = F.silu(torch.einsum("bwc,wc->bc", window, w))
    dp, gds = xl.shape[-1], bl.shape[-1]
    cp = c // n
    lo, hi = max(k * cp, din) - din, max((k + 1) * cp, din) - din  # its b/c channels
    back = all_to_all(window[:, 1:, :dp].reshape(rows, dp).t(), group, back_recv, back_send)
    mine = torch.cat([back.t().reshape(b, old.shape[1], -1), window[:, 1:, dp + lo:dp + hi]],
                     dim=-1)
    wrap = lambda t, pl: DTensor.from_local(t.contiguous(), mesh, pl, run_check=False)
    return ((wrap(out[:, :dp], x_pl), wrap(out[:, dp:dp + gds], batch),
             wrap(out[:, dp + gds:], batch)), wrap(mine, cache_pl))


def mamba_decode(p, x, spec: ArchSpec, plan: ShardingPlan, cache):
    """One-token recurrent update.  x: (B, D).  Updates ``cache`` in place.
    The conv keeps a plan's d_inner split where the layouts fit
    (``_conv_own_columns``), else runs on whole rows (``_conv_whole_rows``)."""
    bsz, _ = x.shape
    din, g, ds, nh, hd = spec.d_inner, spec.ssm_groups, spec.ssm_state, spec.ssm_heads, \
        spec.ssm_head_dim
    z, xi, bi, ci, dt = _in_proj(p, x)                       # dt: (B, nh)
    conv_args = (p, cache["conv"], xi, bi, ci)
    (xi, bi, ci), conv = _conv_own_columns(*conv_args) or _conv_whole_rows(*conv_args)

    a = -torch.exp(p["a_log"].float())                        # (nh,)
    decay = torch.exp(dt * a)                                 # (B, nh)
    xh = _heads(xi, (bsz, nh, hd), plan, ("batch",)).float()
    bh = bi.reshape(bsz, g, ds).repeat_interleave(nh // g, dim=1).float()  # (B,nh,ds)
    chp = ci.reshape(bsz, g, ds).repeat_interleave(nh // g, dim=1).float()
    h = cache["ssm"].float()
    h = h * decay[..., None, None] + (dt[..., None] * xh)[..., None] * bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h, chp).to(x.dtype)
    y = y + xh.to(x.dtype) * p["d_skip"].to(x.dtype)[None, :, None]
    y = rmsnorm(_fold_heads(y, (bsz, din), plan, ("batch",)) * F.silu(z), p["norm"],
                spec.norm_eps)
    out = y @ p["w_out"].to(x.dtype)
    return out, _store(cache, plan, conv=conv, ssm=h)
