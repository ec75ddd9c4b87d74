"""Train-step factory: microbatched gradient accumulation + AdamW + sharding.

Counterpart of the JAX package's ``train/train_step.py``: ``RunConfig`` with
the same knobs and defaults (remat policy, microbatches, dtypes, chunked CE),
``make_loss_fn`` (``ce + lb_weight * aux``), ``make_train_step(spec, plan,
cfg, opt_plan)``, ``init_train_state``, ``batch_axes`` and
``train_state_axes``, and the dry run's fake stand-ins
``abstract_train_state`` and ``batch_abstract`` (JAX :41-53, :129-134).

A step takes a batch of numpy arrays or tensors (``inputs``, ``labels``),
moves it to the parameters' device, differentiates the loss with
``torch.autograd.grad`` (the parameters are leaves that require grad) and
updates the state in place (``optimizer.apply_updates``).  Each call is a
``train.step`` span of the program's tracer (``runtime/tracing.py``) around
``train.to_device``, ``train.forward``, ``train.backward`` and
``train.optimizer``, their ``step`` the call's number since the step
function was made.

Under a plan (``init_train_state(..., mesh=)`` distributes the state by
``train_state_axes``) every parameter and optimizer leaf is a ``DTensor``
on the mesh; each step distributes the batch over the plan's ``batch``
axes, and each gradient is brought to its parameter's layout (or to
``opt_plan``'s, the JAX ``shard_grads``) as autograd makes it
(``grads_laid_out``), before it is accumulated: partial sums over the data
split are reduced there.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchSpec
from repro_torch.models import model as M
from repro_torch.models.layers import fake_mode
from repro_torch.parallel.sharding import (NULL_PLAN, ShardingPlan, distribute_tree, local,
                                           placements, plan_for_mesh)
from repro_torch.runtime import tracing
from repro_torch.train import optimizer as opt
from repro_torch.train.loss import chunked_cross_entropy, cross_entropy


@dataclass(frozen=True)
class RunConfig:
    compute_dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    remat: str = "dots"          # none | dots | full | save_kv
    microbatches: int = 1
    lb_weight: float = 0.01      # MoE load-balance loss weight
    loss_chunk: int = 0          # >0: chunked CE (never materialize logits)
    opt: opt.OptConfig = opt.OptConfig()

    def with_(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


BF16_RUN = RunConfig(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16)


def batch_abstract(spec: ArchSpec, batch: int, seq: int, compute_dtype=torch.bfloat16, *,
                   device=None):
    """Fake stand-ins of one batch: int32 tokens (or ``compute_dtype``
    embeddings) and int32 labels, labelled ``device`` (the card unless
    ``cpu`` is asked for)."""
    dev = torch.device(device or "cuda")
    with fake_mode():
        if spec.frontend == "tokens":
            inp = torch.empty((batch, seq), dtype=torch.int32, device=dev)
        else:
            inp = torch.empty((batch, seq, spec.d_model), dtype=compute_dtype, device=dev)
        return {"inputs": inp, "labels": torch.empty((batch, seq), dtype=torch.int32, device=dev)}


def batch_axes(spec: ArchSpec):
    inp = ("batch", None) if spec.frontend == "tokens" else ("batch", None, None)
    return {"inputs": inp, "labels": ("batch", None)}


def make_loss_fn(spec: ArchSpec, plan: ShardingPlan = NULL_PLAN, cfg: RunConfig = RunConfig()):
    def loss_fn(params, batch):
        if cfg.loss_chunk > 0:
            hidden, aux = M.forward_hidden(params, batch["inputs"], spec, plan,
                                           compute_dtype=cfg.compute_dtype, remat=cfg.remat)
            ce = chunked_cross_entropy(hidden, M.head_fn(params, spec, plan), batch["labels"],
                                       chunk=cfg.loss_chunk)
        else:
            logits, aux = M.forward(params, batch["inputs"], spec, plan,
                                    compute_dtype=cfg.compute_dtype, remat=cfg.remat)
            ce = cross_entropy(logits, batch["labels"])
        return ce + cfg.lb_weight * aux, {"ce": ce, "lb": aux}

    return loss_fn


def to_device(batch, device) -> dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device``; ``DTensor``s (a batch placed
    by the caller) as they are."""
    return {k: v if isinstance(v, DTensor) else torch.as_tensor(v, device=device)
            for k, v in batch.items()}


def make_train_step(spec: ArchSpec, plan: ShardingPlan = NULL_PLAN,
                    cfg: RunConfig = RunConfig(), opt_plan: ShardingPlan | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state is
    updated in place, metrics are device scalars (``loss``, ``grad_norm``,
    ``lr``, and ``ce``/``lb`` without microbatches), the same on every rank.

    opt_plan: optional plan for the gradients (and so the optimizer's
    update).  When weights are partially replicated, gradients are
    reduce-scattered into this layout per microbatch, ZeRO-2 style, as the
    JAX ``shard_grads`` (:83-90) constrains them."""
    loss_fn = make_loss_fn(spec, plan, cfg)
    axes = opt.leaves(M.param_axes(spec))

    def grads_of(params, batch, step: int, mb: int = 0):
        ps = opt.leaves(params)
        for p in ps:
            p.requires_grad_(True)
        with tracing.span("train.forward", step=step, microbatch=mb):
            loss, metrics = loss_fn(params, batch)
        with tracing.span("train.backward", step=step, microbatch=mb):
            grads = grads_laid_out(loss, ps, axes, opt_plan)
        return local(loss.detach()), {k: local(v.detach()) for k, v in metrics.items()}, grads

    calls = itertools.count()

    def train_step(state, batch):
        step = next(calls)
        with tracing.span("train.step", step=step):
            return one_step(state, batch, step)

    def one_step(state, batch, step: int):
        params = state["params"]
        some = opt.leaves(params)[0]

        def placed(b):
            """The batch laid out by its batch axes: a microbatch's slice of a
            batch split over its rows comes back whole on every rank
            (``DTensor`` slices a split dim whole), and is split again, so
            each rank runs its own rows as the JAX step's microbatches do."""
            if not isinstance(some, DTensor):
                return b
            if all(isinstance(t, DTensor) for t in b.values()):
                return {k: plan.constrain(t, batch_axes(spec)[k]) for k, t in b.items()}
            return distribute_tree(b, batch_axes(spec), plan, some.device_mesh)

        with tracing.span("train.to_device", step=step):
            batch = to_device(batch, some.device)
            if cfg.microbatches <= 1:
                batch = placed(batch)
        if cfg.microbatches <= 1:
            loss, metrics, grads = grads_of(params, batch, step)
        else:
            k = cfg.microbatches
            bsz = batch["labels"].shape[0]
            if bsz % k:
                raise ValueError(f"batch {bsz} does not split into {k} microbatches")
            mb = bsz // k
            grads, loss = None, 0.0
            for i in range(k):
                with tracing.span("train.to_device", step=step, microbatch=i):
                    sl = placed({name: a[i * mb:(i + 1) * mb] for name, a in batch.items()})
                l, _, g = grads_of(params, sl, step, i)
                if grads is None:
                    grads = [x.float() for x in g]  # a fresh f32 sum, or the grads themselves
                else:
                    torch._foreach_add_([local(x) for x in grads], [local(x).float() for x in g])
                loss = loss + l
            torch._foreach_div_([local(x) for x in grads], float(k))
            loss, metrics = loss / k, {}
        with tracing.span("train.optimizer", step=step):
            _, om = opt.apply_updates(state, grads, cfg.opt)
        return state, {"loss": loss, **metrics, **om}

    return train_step


def grads_laid_out(loss, ps, axes, opt_plan: ShardingPlan | None = None) -> list:
    """``torch.autograd.grad(loss, ps)``, each ``DTensor`` gradient brought to
    its parameter's layout, or to ``opt_plan``'s for its logical ``axes``
    (the JAX ``shard_grads``, :83-90: partial sums over the data split
    reduce-scattered into the optimizer's shards), as autograd makes it: a
    hook on each leaf redistributes the gradient the moment it is whole, so
    no rank holds a layer's unreduced gradient while the backward goes on
    (XLA reduces each as it is made).  The engine hands ``autograd.grad``
    what a leaf's hook returns."""
    hooks = []
    for p, ax in zip(ps, axes):
        if isinstance(p, DTensor):
            want = (p.placements if opt_plan is None else
                    placements(opt_plan.spec(ax, tuple(p.shape)), p.device_mesh))
            hooks.append(p.register_hook(
                lambda g, mesh=p.device_mesh, want=tuple(want): g.redistribute(mesh, want)))
    try:
        return list(torch.autograd.grad(loss, ps))
    finally:
        for h in hooks:
            h.remove()


def init_train_state(spec: ArchSpec, cfg: RunConfig = RunConfig(), *, seed: int = 0,
                     device=None, plan: ShardingPlan | None = None, mesh=None):
    """f32 parameters from ``M.init_params(spec, seed)`` (on the card unless
    ``device`` says otherwise) and the optimizer state around them.  With a
    ``mesh``, every leaf becomes a ``DTensor`` placed by ``train_state_axes``
    under ``plan`` (``plan_for_mesh(mesh)`` if none); every rank draws the
    same full state from the seed and keeps its own shards."""
    params = M.init_params(spec, seed, device=device, dtype=torch.float32)
    state = opt.init_state(params, cfg.param_dtype)
    if mesh is None:
        return state
    plan = plan_for_mesh(mesh) if plan is None else plan
    return distribute_tree(state, train_state_axes(spec, cfg), plan, mesh)


def abstract_train_state(spec: ArchSpec, cfg: RunConfig = RunConfig(), *, device=None):
    """Fake stand-ins of ``init_train_state``'s tree (params in
    ``cfg.param_dtype``, f32 moments and master copy, the int32 step)."""
    with fake_mode():
        return opt.init_state(M.abstract_params(spec, device=device), cfg.param_dtype)


def train_state_axes(spec: ArchSpec, cfg: RunConfig = RunConfig()):
    return opt.state_axes(M.param_axes(spec), cfg.param_dtype)
