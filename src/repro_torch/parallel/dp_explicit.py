"""Explicit data-parallel train step: the path that can intercept the
gradient all-reduce, enabling int8 error-feedback gradient compression on
the wire.

Counterpart of the JAX package's ``parallel/dp_explicit.py`` (a
``shard_map`` there).  Layout: pure data parallelism over one mesh axis;
the parameters and optimizer state are plain tensors, the same on every
rank, and each rank takes its slice of the batch.  The gradients are
averaged over the axis's group (``all_reduce``), or, with ``compress_bits``
8, reduced by ``compressed_psum`` with the residual kept in the state's
``grad_error``.  The loss is averaged too.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchSpec
from repro_torch.parallel.compression import compressed_psum, init_error_state
from repro_torch.parallel.sharding import NULL_PLAN
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import RunConfig, make_loss_fn, to_device


def make_dp_train_step(spec: ArchSpec, mesh, cfg: RunConfig, *, axis: str = "data",
                       compress_bits: int = 0):
    """Returns (train_step, init_extra): ``train_step(state, batch)`` runs on
    every rank of ``mesh``'s ``axis`` with the global batch, each rank
    computing on its slice.  compress_bits=0 -> plain mean all-reduce;
    8 -> int8 error-feedback compression (the state carries the residual)."""
    loss_fn = make_loss_fn(spec, NULL_PLAN, cfg)
    group = mesh.get_group(axis)
    n_shards = mesh.size(mesh.mesh_dim_names.index(axis))
    me = mesh.get_local_rank(axis)

    def train_step(state, batch):
        params = state["params"]
        ps = opt.leaves(params)
        bsz = len(batch["labels"])
        if bsz % n_shards:
            raise ValueError(f"batch {bsz} does not split over {n_shards} ranks of {axis!r}")
        mb = bsz // n_shards
        local = to_device({k: v[me * mb:(me + 1) * mb] for k, v in batch.items()}, ps[0].device)
        for p in ps:
            p.requires_grad_(True)
        loss, _ = loss_fn(params, local)
        grads = list(torch.autograd.grad(loss, ps))
        loss = loss.detach().clone()
        if compress_bits:
            grads, new_err = compressed_psum(grads, group, opt.leaves(state["grad_error"]),
                                             bits=compress_bits)
        else:
            for g in grads:
                dist.all_reduce(g, group=group)
            torch._foreach_div_(grads, float(n_shards))
        dist.all_reduce(loss, group=group)
        loss /= n_shards
        inner = {k: v for k, v in state.items() if k != "grad_error"}
        _, metrics = opt.apply_updates(inner, grads, cfg.opt)  # in place: state's tensors
        if compress_bits:
            for e, ne in zip(opt.leaves(state["grad_error"]), new_err):
                e.copy_(ne)
        return state, {"loss": loss, **metrics}

    def init_extra(state: dict[str, Any]) -> dict[str, Any]:
        if compress_bits:
            state = dict(state)
            state["grad_error"] = init_error_state(state["params"])
        return state

    return train_step, init_extra
