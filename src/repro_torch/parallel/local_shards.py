"""Running code that cannot take a ``DTensor`` on each rank's local shards.

The kernels are ``ctypes`` calls on raw pointers, and the embedding lookup,
the loss's gold pick, the causal conv and the MoE dispatch index by
position, which ``DTensor`` does not take.  Each runs through
``on_local_shards``, the one place that says which splits such code may
keep, which it must have gathered, and how the gradients of inputs held
whole on every rank add up.  It imports nothing of the port, so the
kernels' wrappers can use it.
"""
from __future__ import annotations

import math

import torch
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


def on_local_shards(fn, args, keep, *, lead: int = 0, follow=None, out=None):
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
    split dim is this rank's share of a sum (``Partial``).  Plain tensors
    among ``args`` are taken as replicated (``lift``).
    """
    ref = next((a for a in args if isinstance(a, DTensor)), None)
    if ref is None:
        return fn(*args)
    mesh = ref.device_mesh
    args = [lift(a, ref) for a in args]
    own = {d: d for d in keep}
    maps = [own if i == lead or f is None else f
            for i, f in enumerate(follow or [None] * len(args))]
    pl = [p if isinstance(p, Shard) and p.dim in keep else R for p in args[lead].placements]
    for d in {p.dim for p in pl if isinstance(p, Shard)}:
        n = math.prod(mesh.size(i) for i, p in enumerate(pl) if p == Shard(d))
        if any(d in m and a.shape[m[d]] % n for a, m in zip(args, maps)):
            pl = [R if p == Shard(d) else p for p in pl]

    def place(m, share):
        return tuple(Shard(m[p.dim]) if isinstance(p, Shard) and p.dim in m
                     else Partial() if share and isinstance(p, Shard) else R for p in pl)

    outs = tuple(place(own if o is None else o, True)
                 for o in (out if isinstance(out, tuple) else (out,)))
    return local_map(fn, out_placements=outs if isinstance(out, tuple) else list(outs[0]),
                     in_placements=tuple(place(m, False) for m in maps),
                     in_grad_placements=tuple(place(m, True) for m in maps),
                     device_mesh=mesh, redistribute_inputs=True)(*args)
