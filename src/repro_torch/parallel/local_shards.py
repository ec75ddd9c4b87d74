"""Running code that cannot take a ``DTensor`` on each rank's local shards.

The kernels are ``ctypes`` calls on raw pointers, and the embedding lookup,
the loss's gold pick, the causal conv and the MoE dispatch index by
position, which ``DTensor`` does not take.  Each runs through
``on_local_shards``, the one place that says which splits such code may
keep, which it must have gathered, and how the gradients of inputs held
whole on every rank add up.  The serving caches' in-place writes at a
position (a prompt's rows, a decode slot) go through ``write_along``, the
same rule for a write: each rank writes the part of the rows that falls in
its own shard, at its own offset, and nothing is gathered.  It imports
nothing of the port, so the kernels' wrappers can use it.
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

R = Replicate()


def lift(t: torch.Tensor, like) -> torch.Tensor:
    """``t`` as a ``DTensor`` replicated on ``like``'s mesh when ``like`` is a
    ``DTensor`` (``t`` must then be the same on every rank); else ``t``."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [R] * mesh.ndim, run_check=False)


def mesh_dims_along(x: torch.Tensor, dim: int) -> list[int]:
    """The mesh dims that split ``x``'s ``dim`` (none for a plain tensor)."""
    if not isinstance(x, DTensor):
        return []
    return [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]


def split_along(x: torch.Tensor, dim: int) -> bool:
    """Does a mesh dim split ``x``'s ``dim``?  (Never for a plain tensor.)"""
    return bool(mesh_dims_along(x, dim))


def keep_weight_split(move_bytes: int, gather_bytes: int) -> bool:
    """The rule for a weight split over a mesh dim (the FSDP split of
    'embed' over 'data', the experts' ff columns over 'model'): the product
    runs on the weight's own shard, the activations moved to it (their rows
    gathered over that mesh dim, or at batch 1 the rank's slice of their
    contraction columns taken, and the partial products reduced into the
    output's layout), where that costs less, ``move_bytes``, than gathering
    the weight for use, each rank then running its own rows,
    ``gather_bytes``.  Each cost is the bytes that way moves, plus the
    largest buffer it makes a rank hold where the two ways hold unlike
    (the MoE's, ``moe._ff_bytes``).  Both are reckoned from the shapes
    before the product runs."""
    return move_bytes < gather_bytes


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` summed over ``group`` (each rank's share of a
    product whose contraction dim that group splits), inside code that runs
    on local shards.  Its gradient is the same sum of the gradients: what
    follows runs on each rank's own part of the result, so each rank's
    gradient is its share."""
    return _SumOver.apply(t, group)


def reduce_over(t: torch.Tensor, op: str, groups) -> torch.Tensor:
    """``t`` reduced by ``op`` (``"sum"``, ``"max"``) over each of ``groups``
    in turn (the ranks of each mesh dim that splits a dim), inside code that
    runs on local shards and takes no gradient (decode, or an autograd
    Function that reduces its own gradient: the split-row RMSNorm)."""
    for group in groups:
        t = _wait(funcol.all_reduce(t.contiguous(), op, group))
    return t


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _wait(funcol.all_reduce(t.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, g):
        return _wait(funcol.all_reduce(g.contiguous(), "sum", ctx.group)), None


def _wait(t):
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def all_to_all(t: torch.Tensor, group, out_sizes=None, in_sizes=None) -> torch.Tensor:
    """``t``'s dim-0 chunks, one to each rank of ``group`` in rank order
    (``in_sizes`` rows each, or equal chunks), and the chunks received in
    the same order (``out_sizes`` rows each), inside code that runs on local
    shards.  Its gradient is the reverse exchange.  Without grad mode
    (serving's ``inference_mode``, where torch 2.11 has no kernel for the
    autograd variant) the plain collective."""
    fn = funcol.all_to_all_single_autograd if torch.is_grad_enabled() else \
        funcol.all_to_all_single
    return _wait(fn(t.contiguous(), out_sizes, in_sizes, group))


def whole_along(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with ``dim`` split by no mesh dim, its other splits kept: a
    ``DTensor`` view may flatten dims only where the outer one alone is
    split, so a (B, S, D) residual stream split over its sequence is gathered
    along it before a product folds (B, S) into rows (sequence parallelism's
    gather before a projection).  A plain tensor as it is."""
    if not split_along(x, dim):
        return x
    return x.redistribute(x.device_mesh, tuple(
        R if isinstance(p, Shard) and p.dim == dim else p for p in x.placements))


class _GradAsInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):  # a partial sum's gradient is whole on every rank
        ctx.layout = x.device_mesh, tuple(R if p.is_partial() else p for p in x.placements)
        return x.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.layout)


def grad_as_input(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is laid out as ``x`` is: ``DTensor`` lays out a
    gradient op by op, and may split a dim that a view in the backward must
    then unflatten unevenly.  A plain tensor, or any tensor while grad mode
    is off (serving's ``inference_mode``, where torch 2.11 refuses the view
    of a tensor made outside it), as it is."""
    if isinstance(x, DTensor) and torch.is_grad_enabled():
        return _GradAsInput.apply(x)
    return x


def replicate(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` replicated on its mesh, one mesh dim at a time: partial
    sums over two dims are reduced in mesh-dim order, so every rank gets the
    same bits.  A plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh, pl = x.device_mesh, list(x.placements)
    for i in range(len(pl)):
        if not pl[i].is_replicate():
            pl[i] = R
            x = x.redistribute(mesh, tuple(pl))
    return x


def shard_extent(t: DTensor, dim: int) -> tuple[int, int]:
    """(offset, length) along ``dim`` of this rank's shard of ``t``: each mesh
    dim that shards ``dim`` splits the extent left by those before it into
    ``torch.chunk`` pieces (ceil-sized, the last possibly short), as
    ``DTensor`` lays out a ``Shard``."""
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    offset, length = 0, t.shape[dim]
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            piece = -(-length // mesh.size(i))
            start = min(coord[i] * piece, length)
            offset, length = offset + start, min(piece, length - start)
    return offset, length


def write_along(dst: torch.Tensor, src, start: int, dim: int = 1) -> None:
    """``dst[start:start + n] = src`` along ``dim``, in place, where ``src``
    has ``n`` rows along ``dim`` (or is a number, written to one row).  A
    ``DTensor`` ``dst`` is written on each rank's own shard: ``src`` is laid
    out as ``dst`` is on every other dim and whole along ``dim``, and each
    rank copies the rows that fall within its shard, at its own offset
    (``shard_extent``).  The dst is never gathered."""
    number = isinstance(src, (int, float))
    n = 1 if number else src.shape[dim]
    if isinstance(dst, DTensor):
        (lo, length), mine = shard_extent(dst, dim), dst.to_local()
        if not number:
            want = tuple(R if isinstance(p, Shard) and p.dim == dim else p for p in dst.placements)
            src = lift(src, dst).redistribute(dst.device_mesh, want).to_local()
    else:
        lo, length, mine = 0, dst.shape[dim], dst
    first, stop = max(start, lo), min(start + n, lo + length)
    if first < stop:
        rows = mine.narrow(dim, first - lo, stop - first)
        if number:
            rows.fill_(src)
        else:
            rows.copy_(src.narrow(dim, first - start, stop - first))


def on_local_shards(fn, args, keep, *, lead: int = 0, follow=None, out=None, own=None):
    """``fn(*args)``, run on each rank's local shards when an arg is a ``DTensor``.

    The splits of ``args[lead]`` over its dims ``keep`` stay; every other
    split of it, and any partial sum, is resolved first.  Each other arg
    follows the lead through ``follow[i]``, a dict from a lead dim to the
    arg's own dim (``None``: the lead's kept dims, one to one): that dim is
    split as the lead's is.  Where the lead is split over a dim the dict
    leaves out, the arg is whole on every rank and its gradient is the sum
    of every rank's share (``Partial``).  A split is dropped where a
    following arg's dim does not divide by it.  ``out`` maps each result the
    same way: one dict, a tuple of them for a tuple of results, or ``None``
    for one result laid out as the lead; a result whose dict leaves out a
    split dim is this rank's share of a sum (``Partial``).  ``own`` (a dict
    from an arg's index to some of its dims) keeps that arg's own splits of
    those dims: ``fn`` sees its local shard along them and its gradient stays
    so split.  Over a mesh dim where the lead is whole, the other args are
    whole (their gradients summed) and every result is this rank's share of
    a sum over it (``Partial``: a vocabulary-split table's lookup, say);
    where the lead is split too, ``fn`` itself exchanges what crosses it (an
    all-to-all of the MoE's capacity rows, say).  Plain tensors among
    ``args`` are taken as replicated (``lift``).
    """
    ref = next((a for a in args if isinstance(a, DTensor)), None)
    if ref is None:
        return fn(*args)
    mesh = ref.device_mesh
    args = [lift(a, ref) for a in args]
    kept = {d: d for d in keep}
    maps = [kept if i == lead or f is None else f
            for i, f in enumerate(follow or [None] * len(args))]
    pl = [p if isinstance(p, Shard) and p.dim in keep else R for p in args[lead].placements]
    for d in {p.dim for p in pl if isinstance(p, Shard)}:
        n = math.prod(mesh.size(i) for i, p in enumerate(pl) if p == Shard(d))
        if any(d in m and a.shape[m[d]] % n for a, m in zip(args, maps)):
            pl = [R if p == Shard(d) else p for p in pl]
    owned: dict[int, dict[int, int]] = {}  # mesh dim -> {arg: its dim split there}
    for j, dims in (own or {}).items():
        for i, p in enumerate(args[j].placements):
            if isinstance(p, Shard) and p.dim in dims:
                owned.setdefault(i, {})[j] = p.dim

    def place(m, share, j=None):
        out = []
        for i, p in enumerate(pl):
            if j in owned.get(i, ()):
                out.append(Shard(owned[i][j]))
            elif isinstance(p, Shard):
                out.append(Shard(m[p.dim]) if p.dim in m else Partial() if share else R)
            else:
                out.append(Partial() if share and i in owned else R)
        return tuple(out)

    outs = tuple(place(kept if o is None else o, True)
                 for o in (out if isinstance(out, tuple) else (out,)))
    return local_map(fn, out_placements=outs if isinstance(out, tuple) else list(outs[0]),
                     in_placements=tuple(place(m, False, j) for j, m in enumerate(maps)),
                     in_grad_placements=tuple(place(m, True, j) for j, m in enumerate(maps)),
                     device_mesh=mesh, redistribute_inputs=True)(*args)
