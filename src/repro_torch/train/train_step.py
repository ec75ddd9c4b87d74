"""Train-step factory: microbatched gradient accumulation + AdamW.

Counterpart of the JAX package's ``train/train_step.py``: ``RunConfig`` with
the same knobs and defaults (remat policy, microbatches, dtypes, chunked CE),
``make_loss_fn`` (``ce + lb_weight * aux``), ``make_train_step`` and
``init_train_state``.  The port runs on one card, so there is no ``plan``
or ``opt_plan`` argument (ROADMAP.md Queue 1: parallel).

A step takes a batch of numpy arrays or tensors (``inputs``, ``labels``),
moves it to the parameters' device, differentiates the loss with
``torch.autograd.grad`` (the parameters are leaves that require grad) and
updates the state in place (``optimizer.apply_updates``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models import model as M
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


def make_loss_fn(spec: ArchSpec, cfg: RunConfig):
    def loss_fn(params, batch):
        if cfg.loss_chunk > 0:
            hidden, aux = M.forward_hidden(params, batch["inputs"], spec,
                                           compute_dtype=cfg.compute_dtype, remat=cfg.remat)
            ce = chunked_cross_entropy(hidden, M.head_fn(params, spec), batch["labels"],
                                       chunk=cfg.loss_chunk)
        else:
            logits, aux = M.forward(params, batch["inputs"], spec,
                                    compute_dtype=cfg.compute_dtype, remat=cfg.remat)
            ce = cross_entropy(logits, batch["labels"])
        return ce + cfg.lb_weight * aux, {"ce": ce, "lb": aux}

    return loss_fn


def to_device(batch, device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(spec: ArchSpec, cfg: RunConfig = RunConfig()):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state is
    updated in place, metrics are device scalars (``loss``, ``grad_norm``,
    ``lr``, and ``ce``/``lb`` without microbatches)."""
    loss_fn = make_loss_fn(spec, cfg)

    def grads_of(params, batch):
        ps = opt.leaves(params)
        for p in ps:
            p.requires_grad_(True)
        loss, metrics = loss_fn(params, batch)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            list(torch.autograd.grad(loss, ps))

    def train_step(state, batch):
        params = state["params"]
        batch = to_device(batch, opt.leaves(params)[0].device)
        if cfg.microbatches <= 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            k = cfg.microbatches
            bsz = batch["labels"].shape[0]
            if bsz % k:
                raise ValueError(f"batch {bsz} does not split into {k} microbatches")
            mb = bsz // k
            grads, loss = None, 0.0
            for i in range(k):
                sl = {name: a[i * mb:(i + 1) * mb] for name, a in batch.items()}
                l, _, g = grads_of(params, sl)
                if grads is None:
                    grads = [x.float() for x in g]  # a fresh f32 sum, or the grads themselves
                else:
                    torch._foreach_add_(grads, [x.float() for x in g])
                loss = loss + l
            torch._foreach_div_(grads, float(k))
            loss, metrics = loss / k, {}
        _, om = opt.apply_updates(state, grads, cfg.opt)
        return state, {"loss": loss, **metrics, **om}

    return train_step


def init_train_state(spec: ArchSpec, cfg: RunConfig = RunConfig(), *, seed: int = 0,
                     device=None):
    """f32 parameters from ``M.init_params(spec, seed)`` (on the card unless
    ``device`` says otherwise) and the optimizer state around them."""
    params = M.init_params(spec, seed, device=device, dtype=torch.float32)
    return opt.init_state(params, cfg.param_dtype)
