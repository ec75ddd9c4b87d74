"""Logical-axis sharding over a ``torch.distributed`` ``DeviceMesh``.

Counterpart of the JAX package's ``parallel/sharding.py``.  Model code names
every parameter dim and key activation dim with a *logical* axis ('embed',
'ff', 'vocab', 'batch', ...).  A ``ShardingPlan`` maps logical axes to mesh
axes through an ordered rule table with divisibility-aware fallbacks, so the
same model definition runs unsharded, on a (data, model) mesh of gloo ranks,
or on a mesh of one card.  ``_PRIORITY``, ``_default_rules``,
``ShardingPlan.spec`` and ``can_shard`` are the JAX logic unchanged.

Where the JAX package emits a ``PartitionSpec``, ``spec`` returns a tuple
with the same entries (a mesh-axis name, a tuple of names, or ``None``;
trailing ``None``s trimmed), and ``placements`` turns it into one
``Shard(d)`` or ``Replicate()`` per mesh dim.  ``constrain`` is
``DTensor.redistribute`` (``with_sharding_constraint`` in JAX) and the
identity on a plain tensor or under ``NULL_PLAN``.

Order of a dim split over two mesh axes.  A spec may give one tensor dim two
mesh axes in an order other than the mesh's: ``kv_seq`` takes
``("data", "model")``, the mesh's order, but ``moe_groups`` takes
``("model", "data")``, model-major, on a (data, model) mesh.  DTensor's
``[Shard(d), Shard(d)]`` always splits in mesh-dim order, so such a dim is
split data-major here.  That changes which rank holds which chunk, never
the values: compare full tensors, not local shards against JAX's device
order.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.models.layers import map_with_path

# Order in which logical axes get first pick of mesh axes.  Earlier entries
# claim 'model' before later ones can.
_PRIORITY = (
    "expert", "ff", "vocab", "q_heads", "kv_heads", "d_inner", "ssm_heads",
    "batch", "kv_seq", "moe_groups", "seq", "embed", "ssm_head_dim", "head_dim",
)


def _default_rules(fsdp: bool, sp: bool) -> dict[str, list[tuple[str, ...]]]:
    """logical axis -> candidate mesh-axis tuples, best first."""
    rules: dict[str, list[tuple[str, ...]]] = {
        "expert": [("model",)],
        "ff": [("model",)],
        "vocab": [("model",)],
        "q_heads": [("model",)],
        "kv_heads": [("model",)],
        "d_inner": [("model",)],
        "ssm_heads": [("model",)],
        # chunk-major token groups: model (seq chunks) is the MAJOR axis
        "moe_groups": [("model", "pod", "data"), ("model", "data"),
                       ("model",), ("pod", "data"), ("data",)],
        "kv_seq": [("data", "model"), ("model",)],
        "batch": [("pod", "data"), ("data",)],
        "seq": [("model",)] if sp else [],
        "embed": [("data",)] if fsdp else [],
        "ssm_head_dim": [("model",)],
        "head_dim": [],
    }
    return rules


Spec = tuple  # per tensor dim: a mesh-axis name, a tuple of names, or None


@dataclass(frozen=True)
class ShardingPlan:
    """Maps logical axes to a concrete mesh."""

    axis_sizes: dict[str, int] = field(default_factory=dict)  # mesh axis -> size
    fsdp: bool = True            # ZeRO-style weight sharding over 'data'
    sp: bool = True              # sequence parallelism on the residual stream
    rules: dict[str, list[tuple[str, ...]]] | None = None

    def _rules(self) -> dict[str, list[tuple[str, ...]]]:
        return self.rules if self.rules is not None else _default_rules(self.fsdp, self.sp)

    # ------------------------------------------------------------------
    def spec(self, axes: Sequence[str | None], shape: Sequence[int] | None = None) -> Spec:
        """The spec of a tensor with the given logical axes.

        Mesh axes are assigned greedily in _PRIORITY order, subject to:
        (i) each mesh axis used at most once per tensor, and (ii) the dim
        size (when known) divisible by the mesh-axis product.
        """
        rules = self._rules()
        n = len(axes)
        assignment: list[tuple[str, ...] | None] = [None] * n
        used: set[str] = set()
        order = sorted(
            range(n),
            key=lambda i: _PRIORITY.index(axes[i]) if axes[i] in _PRIORITY else len(_PRIORITY),
        )
        for i in order:
            name = axes[i]
            if name is None or name not in rules:
                continue
            for option in rules[name]:
                opt = tuple(a for a in option if a in self.axis_sizes)
                if not opt or any(a in used for a in opt):
                    continue
                prod = 1
                for a in opt:
                    prod *= self.axis_sizes[a]
                if prod <= 1:
                    continue
                if shape is not None and shape[i] % prod != 0:
                    continue
                assignment[i] = opt
                used.update(opt)
                break
        parts = [
            (a if a is None or len(a) > 1 else a[0]) for a in assignment
        ]
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    # ------------------------------------------------------------------
    def constrain(self, x: torch.Tensor, axes: Sequence[str | None]) -> torch.Tensor:
        """Redistribute a DTensor to this plan's layout for ``axes``; the
        identity on a plain tensor or under a null plan."""
        if not self.axis_sizes or not isinstance(x, DTensor):
            return x
        want = placements(self.spec(axes, x.shape), x.device_mesh)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)

    def can_shard(self, axis: str, size: int) -> bool:
        """Would `axis` of this size actually get sharded (ignoring siblings)?"""
        for option in self._rules().get(axis, []):
            opt = tuple(a for a in option if a in self.axis_sizes)
            if not opt:
                continue
            prod = 1
            for a in opt:
                prod *= self.axis_sizes[a]
            if prod > 1 and size % prod == 0:
                return True
        return False


NULL_PLAN = ShardingPlan(axis_sizes={}, fsdp=False, sp=False)


def plan_for_mesh(mesh, *, fsdp: bool = True, sp: bool = True,
                  rules: dict[str, list[tuple[str, ...]]] | None = None) -> ShardingPlan:
    if mesh is None:
        return NULL_PLAN
    return ShardingPlan(
        axis_sizes=dict(zip(mesh.mesh_dim_names, mesh.shape)),
        fsdp=fsdp, sp=sp, rules=rules,
    )


def placements(spec: Spec, mesh) -> tuple:
    """One ``Shard(d)`` or ``Replicate()`` per mesh dim: mesh axis ``a`` shards
    tensor dim ``d`` when the spec's entry ``d`` names ``a``."""
    dim_of = {}
    for d, entry in enumerate(spec):
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in mesh.mesh_dim_names)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (sharing its storage); a plain tensor
    as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_specs(plan: ShardingPlan, axes_tree, shape_tree):
    """Map a tree of logical-axes tuples + shapes (any leaf with ``.shape``)
    to specs."""
    return map_with_path(lambda path, axes: plan.spec(axes, tuple(_at(shape_tree, path).shape)),
                         axes_tree)


def distribute_tree(tree, axes_tree, plan: ShardingPlan, mesh):
    """Every tensor of ``tree`` as a DTensor on ``mesh``, placed by its
    logical axes.  Every rank must hold the same full tensors (each keeps
    its own shard; nothing is sent)."""
    return map_with_path(
        lambda path, axes: distribute_tensor(
            _at(tree, path).detach(), mesh,
            placements(plan.spec(axes, tuple(_at(tree, path).shape)), mesh),
            src_data_rank=None),
        axes_tree)
