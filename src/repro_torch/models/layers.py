"""Parameter descriptors + primitive layers (PyTorch, nested-dict params).

Counterpart of the JAX package's ``models/layers.py``.  Every parameter is
declared as a ``ParamDef(shape, axes, init, scale)`` with the same leaf
names, shapes, logical sharding axes and init kinds as the JAX ``ParamDef``
(:20-45); ``repro_torch.parallel.sharding`` maps the axes onto a device
mesh.  ``<module>_defs(spec)`` returns a nested dict (a list for the layer
stack) of ParamDefs, ``init_tree`` materialises it from a
``torch.Generator``, ``abstract_tree`` makes fake stand-ins of it for the
dry run, ``axes_tree`` takes its axes, and the ``apply`` functions consume
the resulting tree of tensors.
"""
from __future__ import annotations

import functools
import math
import threading
from typing import Any, Callable, NamedTuple

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Shard

from repro_torch.kernels import ops
from repro_torch.parallel.local_shards import (grad_as_input, keep_weight_split, lift,
                                               mesh_dims_along, on_local_shards, shard_extent,
                                               split_along, whole_along)


class ParamDef(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple  # logical axis name (or None) per dim
    init: str = "normal"  # normal | zeros | ones | ssm_a_log | ssm_dt_bias
    scale: float = 1.0


def map_with_path(fn: Callable[[tuple, Any], Any], tree, path: tuple = ()):
    """Apply ``fn(path, leaf)`` over nested dicts and lists, keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _init_leaf(d: ParamDef, generator: torch.Generator, device, dtype):
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "ssm_a_log":  # A in [-16, -1]: log for positivity
        u = torch.empty(d.shape, dtype=torch.float32, device=device)
        return u.uniform_(1.0, 16.0, generator=generator).log_().to(dtype)
    if d.init == "ssm_dt_bias":  # dt in [1e-3, 1e-1] through softplus
        u = torch.empty(d.shape, dtype=torch.float32, device=device).uniform_(generator=generator)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)  # inverse softplus
    if d.init != "normal":
        raise ValueError(f"unknown init kind {d.init!r}")
    fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[-1], 1)
    std = d.scale / math.sqrt(fan_in)
    x = torch.empty(d.shape, dtype=torch.float32, device=device)
    return x.normal_(generator=generator).mul_(std).to(dtype)


def init_tree(defs, generator: torch.Generator, *, device, dtype=torch.float32):
    """Materialise a tree of ParamDefs, drawing leaves in tree order."""
    return map_with_path(lambda _, d: _init_leaf(d, generator, device, dtype), defs)


def fake_mode() -> FakeTensorMode:
    """The active ``FakeTensorMode``, or a new one."""
    return detect_fake_mode() or FakeTensorMode()


def abstract_tree(defs, dtype=torch.float32, *, device=None):
    """The JAX ``abstract_tree``: a stand-in for each ParamDef, a
    ``FakeTensor`` of its shape and ``dtype`` labelled ``device`` (the card,
    ``cuda``, unless ``cpu`` is asked for), made in the active
    ``FakeTensorMode`` or a new one.  A stand-in has no storage: nothing is
    allocated and no kernel can launch on it.  The JAX package stacks a
    repeating block pattern's defs (``stack_defs``) for its scanned stack;
    the port's stack is a list of layers, so ``stack_defs`` has no
    counterpart."""
    dev = torch.device(device or "cuda")
    with fake_mode():
        return map_with_path(lambda _, d: torch.empty(d.shape, dtype=dtype, device=dev), defs)


def axes_tree(defs):
    return map_with_path(lambda _, d: d.axes, defs)


def param_count(defs) -> int:
    n = []
    map_with_path(lambda _, d: n.append(math.prod(d.shape)), defs)
    return sum(n)


# ---------------------------------------------------------------------------
# primitive ops
# ---------------------------------------------------------------------------

def rmsnorm(x, weight, eps: float = 1e-5):
    """Through the fused kernel.  Unlike the JAX layer, which casts before
    the ``(1 + w)`` multiply, this multiplies in f32 and casts once: equal in
    fp32, one bf16 rounding apart in bf16 (see ``kernels/rmsnorm.py``)."""
    return ops.fused_rmsnorm(x, weight, eps=eps)


# the names a remat policy keeps (.saving) and the name being made (.current);
# set by models/blocks.py
REMAT_NAMES = threading.local()


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Counterpart of ``jax.ad_checkpoint.checkpoint_name``: marks ``x`` for a
    remat policy that saves ``name``.  Where such a policy runs, ``x`` is
    copied once under the name (the one op the policy then saves); elsewhere
    ``x`` comes back as it is."""
    if name not in getattr(REMAT_NAMES, "saving", ()):
        return x
    REMAT_NAMES.current = name
    try:
        return x.clone()
    finally:
        REMAT_NAMES.current = None


def linear(x, w, b=None):
    """x (..., K) @ w (K, N) [+ b].  A (B, S, K) ``DTensor`` ``x`` is taken
    whole along S, and the product's gradient laid out as the product: the
    product folds (B, S) into rows, which a ``DTensor`` view may do only
    where S is not split, forward and backward."""
    if x.ndim == 3:
        y = grad_as_input(whole_along(x, 1) @ w.to(x.dtype))
    else:
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def linears(x, *ws):
    """``linear(x, w)`` for each of ``ws``, in order, as they are taken: a
    (B, S, K) ``DTensor`` ``x`` split along S is gathered once for all of
    them (``linear`` alone gathers it for each; XLA gathers it once), and
    held only as long as they are being taken."""
    if x.ndim == 3:
        x = whole_along(x, 1)
    return (linear(x, w) for w in ws)


def _rows_in_shard(table, tokens, start: int):
    """The rows of ``table`` (the table's rows ``start`` onwards) at
    ``tokens``, zeros for a token outside them."""
    local = tokens - start
    mine = (local >= 0) & (local < table.shape[0])
    return table[local.clamp(0, table.shape[0] - 1)] * mine[..., None].to(table.dtype)


def take_embedding(table, tokens):
    """The rows of ``table`` at ``tokens``, looked up on local shards
    (``on_local_shards``).  A table split over its vocabulary (the JAX
    ``jnp.take`` on the vocab-split table) stays split: each rank looks the
    tokens up in its own rows, zeros for the rest, and the result is its
    share of a sum over the ranks that split the vocabulary (``Partial``,
    which the residual stream's constraint reduce-scatters); the table's
    gradient stays on each rank's rows.  A table whose columns are split
    (the FSDP split of 'embed' over 'data') stays split too where the
    tokens cost fewer bytes to move (``keep_weight_split``: decode's few
    tokens against the table): each rank looks every token up in its own
    columns, and the caller's constraint lays the rows out.  Otherwise the
    lookup runs on each rank's tokens with the table's columns gathered,
    their gradient the sum of every rank's share."""
    vocab = split_along(table, 0)
    fn = functools.partial(_rows_in_shard, start=shard_extent(table, 0)[0]) if vocab \
        else (lambda t, i: t[i])
    own = {0: (0,)} if vocab else None  # the vocabulary's split stays
    fsdp = mesh_dims_along(table, 1)
    if fsdp:
        mesh, local = table.device_mesh, table.to_local()
        cols = table.shape[1] // math.prod(mesh.size(i) for i in fsdp)
        move = tokens.numel() * (cols * table.element_size() + tokens.element_size())
        if keep_weight_split(move, local.shape[0] * table.shape[1] * table.element_size()):
            # every token on every rank, looked up in the rank's own columns
            return on_local_shards(fn, (table, tokens), (1,), follow=(None, {}),
                                   out={1: tokens.ndim}, own=own)
    return on_local_shards(fn, (table, tokens), range(tokens.ndim), lead=1, follow=({}, None),
                           own=own)


def head_product(h, w, plan):
    """The LM head, ``h (..., D) @ w (D, V)``, keeping split the work that a
    plain product under the plan would repeat on every rank:
      * a 'model' axis that splits neither operand (a vocabulary that does
        not divide it, in decode and prefill, whose rows it leaves whole)
        splits w's vocabulary columns in ``DTensor``'s ceil-sized pieces,
        the last one short, as XLA pads the vocabulary and splits the
        product; each rank computes its columns' logits, which the caller's
        constraint lays out;
      * w's FSDP split of D over a mesh dim stays where moving h's rows
        there costs fewer bytes than gathering w (``keep_weight_split``):
        h's rows are gathered over that mesh dim with their D split as w's
        is, and the partial products, a ``Partial`` sum, are reduced into
        the caller's layout.
    Under no plan, or where neither applies, ``linear``."""
    if not isinstance(w, DTensor):
        return linear(h, w)
    mesh = w.device_mesh
    names = mesh.mesh_dim_names or ()
    if "model" in names:
        i = names.index("model")
        if mesh.size(i) > 1 and not plan.can_shard("vocab", w.shape[1]) and all(
                not isinstance(t, DTensor) or t.placements[i].is_replicate() for t in (h, w)):
            w = w.redistribute(mesh, tuple(Shard(1) if j == i else q
                                           for j, q in enumerate(w.placements)))
    fsdp = [i for i in mesh_dims_along(w, 0) if i not in mesh_dims_along(h, h.ndim - 1)]
    if fsdp and isinstance(h, DTensor):
        local = h.to_local()
        rows = local.numel() // local.shape[-1] * math.prod(
            mesh.size(i) for i in fsdp if isinstance(h.placements[i], Shard))
        cols = w.to_local().shape[1]
        move = rows * (h.shape[-1] // math.prod(mesh.size(i) for i in fsdp) + cols) \
            * h.element_size()
        if keep_weight_split(move, w.shape[0] * cols * w.element_size()):
            h = h.redistribute(mesh, tuple(Shard(h.ndim - 1) if j in fsdp else q
                                           for j, q in enumerate(h.placements)))
    return linear(h, w)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (S,).  Half-split rotation, f32 angles."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    cos, sin = lift(cos, x), lift(sin, x)  # the angles are the same on every rank
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
