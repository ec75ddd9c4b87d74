"""AdamW with mixed precision.

Counterpart of the JAX package's ``train/optimizer.py``, with its state
layout (a plain dict, the layout the checkpoints hold):
  params : compute-precision weights (bf16 under ``BF16_RUN``)
  master : f32 master copy (omitted when the params are f32)
  m, v   : f32 moments
  step   : int32 scalar tensor
and its math (:86-116): global-norm clipping, ``step + 1`` for the learning
rate and the bias corrections, decoupled weight decay on the f32 master.

Unlike the JAX version, which returns a new state, ``apply_updates`` updates
the state's tensors in place (``torch._foreach_*`` over the leaves; no
``torch.optim``, whose state would not match this layout): at qwen2-1.5b's
1.5 B parameters a second copy of params, m and v would take 18.5 GB.

Under a sharding plan the leaves are ``DTensor``s, and the gradients come
placed as their parameters are.  AdamW is elementwise, so the updates run on
each rank's local shards.  ``global_norm`` sums each sharded leaf's squares
over the mesh dims that split it (one all-reduce per mesh dim), so every
rank computes the same norm bit for bit; a leaf that no mesh dim splits
takes the same path as an unsharded one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
from repro_torch.models.layers import map_with_path
from repro_torch.parallel.sharding import local


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def leaves(tree) -> list:
    """The leaves of a dict/list tree, in tree order."""
    out: list = []
    map_with_path(lambda _, t: out.append(t), tree)
    return out


def lr_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * lr, in f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = (cfg.min_lr_ratio * cfg.lr
           + 0.5 * (1 - cfg.min_lr_ratio) * cfg.lr * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params, param_dtype=torch.float32) -> dict[str, Any]:
    """The state for ``params`` (any float dtype): params in ``param_dtype``
    and, when that is not f32, an f32 master copy; zero f32 moments."""
    f32 = lambda tree: map_with_path(lambda _, a: torch.zeros_like(a, dtype=torch.float32), tree)
    some = leaves(params)[0]
    state = {
        "params": map_with_path(lambda _, a: a.detach().to(param_dtype).clone(), params),
        "m": f32(params),
        "v": f32(params),
        "step": torch.zeros((), dtype=torch.int32, device=some.device),
    }
    if param_dtype != torch.float32:
        state["master"] = map_with_path(lambda _, a: a.detach().float().clone(), params)
    return state


def state_axes(param_axes_tree, param_dtype=torch.float32):
    """Logical-axes tree mirroring the state (for ``ShardingPlan.spec``)."""
    state = {
        "params": param_axes_tree,
        "m": param_axes_tree,
        "v": param_axes_tree,
        "step": (),
    }
    if param_dtype != torch.float32:
        state["master"] = param_axes_tree
    return state


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element, in f32: a plain tensor,
    the same on every rank when the tensors are ``DTensor``s."""
    norms = torch.stack(torch._foreach_norm([local(t).float() for t in tensors]))
    split: dict[int, list[int]] = {}  # mesh dim -> the leaves it shards
    for j, t in enumerate(tensors):
        for dim, pl in enumerate(getattr(t, "placements", ())):
            if pl.is_partial():
                raise ValueError("global_norm takes placed tensors, not partial sums")
            if pl.is_shard():
                split.setdefault(dim, []).append(j)
    if split:
        sq = norms.square()
        for dim, idx in split.items():
            part = sq[idx]
            dist.all_reduce(part, group=tensors[idx[0]].device_mesh.get_group(dim))
            sq[idx] = part
        some = sorted({j for idx in split.values() for j in idx})
        norms[some] = sq[some].sqrt()
    return torch.linalg.vector_norm(norms)


@torch.no_grad()
def apply_updates(state: dict[str, Any], grads, cfg: OptConfig):
    """One AdamW step, in place.  grads: a tree matching params (any float
    dtype), or the list of its leaves; f32 grads are scaled in place by the
    clip.  Returns (state, {"grad_norm", "lr"}) as device scalars."""
    grads = grads if isinstance(grads, list) else leaves(grads)
    gnorm = global_norm(grads)
    g32 = [local(g).float() for g in grads]
    if cfg.grad_clip:
        torch._foreach_mul_(g32, torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0))

    step = local(state["step"])
    step += 1
    step = step.to(torch.float32)
    lr = lr_schedule(cfg, step)
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step

    master = [local(t) for t in leaves(state.get("master", state["params"]))]
    m, v = [local(t) for t in leaves(state["m"])], [local(t) for t in leaves(state["v"])]
    torch._foreach_mul_(m, cfg.b1)
    torch._foreach_add_(m, g32, alpha=1 - cfg.b1)
    torch._foreach_mul_(v, cfg.b2)
    torch._foreach_addcmul_(v, g32, g32, value=1 - cfg.b2)
    # p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    upd = torch._foreach_div(m, bc1)
    torch._foreach_div_(upd, denom)
    del denom
    torch._foreach_add_(upd, master, alpha=cfg.weight_decay)
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(master, upd)
    if "master" in state:
        for p, mp in zip(leaves(state["params"]), master):
            local(p).copy_(mp)
    return state, {"grad_norm": gnorm, "lr": lr}
