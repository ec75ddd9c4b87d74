"""Top-level LM: embeddings/frontend -> layer stack -> head.

Counterpart of the JAX package's ``models/model.py``, with its three entry
points:
  * ``forward``     — full-sequence logits (training; ``remat`` per layer)
  * ``prefill``     — prompt pass that also fills decode caches
  * ``decode_step`` — one token with caches
and ``forward_hidden`` / ``head_fn`` for chunked cross-entropy (:99-121).

Every entry point takes a ``ShardingPlan`` as the JAX ones do, and
constrains the residual stream and the logits at the JAX package's sites
(:76, :86, :119, :123-147); under a plan the parameters, the batch and the
caches are ``DTensor``s on its mesh (the caches placed by ``cache_axes``).
``forward`` returns ``(logits, aux)`` as the JAX one does: ``aux`` sums the
MoE layers' load-balance losses.

``abstract_params`` and ``abstract_caches`` are the JAX ones (:45-67): trees
of fake stand-ins (``layers.abstract_tree``) for the dry run.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchSpec
from repro_torch.models import blocks
from repro_torch.models.layers import (ParamDef, abstract_tree, axes_tree, fake_mode,
                                       head_product, init_tree, map_with_path, rmsnorm,
                                       take_embedding)
from repro_torch.parallel.local_shards import grad_as_input
from repro_torch.parallel.sharding import NULL_PLAN, ShardingPlan


def model_param_defs(spec: ArchSpec) -> dict[str, Any]:
    d, v = spec.d_model, spec.vocab_size
    defs: dict[str, Any] = {
        "stack": blocks.stack_param_defs(spec),
        "final_norm": ParamDef((d,), ("embed",), "zeros"),
    }
    if spec.frontend == "tokens":
        defs["embed"] = ParamDef((v, d), ("vocab", "embed"))
        if not spec.tie_embeddings:
            defs["lm_head"] = ParamDef((d, v), ("embed", "vocab"))
    else:
        defs["lm_head"] = ParamDef((d, v), ("embed", "vocab"))
    return defs


def init_params(spec: ArchSpec, seed: int = 0, *, device=None, dtype=torch.float32):
    """Random parameters drawn from ``torch.Generator(device).manual_seed(seed)``,
    on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_tree(model_param_defs(spec), gen, device=dev, dtype=dtype)


def abstract_params(spec: ArchSpec, dtype=torch.float32, *, device=None):
    """Fake stand-ins of every parameter (``layers.abstract_tree``)."""
    return abstract_tree(model_param_defs(spec), dtype, device=device)


def param_axes(spec: ArchSpec):
    """The logical axes of every parameter, in ``model_param_defs``' tree."""
    return axes_tree(model_param_defs(spec))


def cache_defs(spec: ArchSpec, batch: int, seq: int):
    return blocks.stack_cache_defs(spec, batch, seq)


def _cache_dtype(path, dtype):
    return torch.int32 if path[-1] == "kpos" else dtype


def init_caches(spec: ArchSpec, batch: int, seq: int, dtype=torch.bfloat16, *, device=None):
    """Zeroed per-layer caches; prefill and decode fill them in place.  Every
    leaf takes ``dtype`` but a ring cache's ``kpos``, which is int32 so that
    it holds positions exactly (the JAX package's takes the cache dtype)."""
    dev = resolve_device(device)
    return map_with_path(
        lambda path, d: torch.zeros(d.shape, dtype=_cache_dtype(path, dtype), device=dev),
        cache_defs(spec, batch, seq))


def abstract_caches(spec: ArchSpec, batch: int, seq: int, dtype=torch.bfloat16, *, device=None):
    """Fake stand-ins of ``init_caches``' tree (``kpos`` int32 as there)."""
    with fake_mode():
        return map_with_path(lambda path, d: abstract_tree(d, _cache_dtype(path, dtype),
                                                           device=device),
                             cache_defs(spec, batch, seq))


def cache_axes(spec: ArchSpec, batch: int, seq: int):
    """The logical axes of every cache leaf, in ``cache_defs``' tree."""
    return axes_tree(cache_defs(spec, batch, seq))


# ---------------------------------------------------------------------------

def _table(params, spec: ArchSpec):
    """The token table.  Tied to the head, it is used twice, and each use's
    gradient comes back in the table's own layout (``grad_as_input``), so the
    two add as they are: a gradient split over a mesh dim and one that is a
    partial sum over it would otherwise meet in the add, which torch 2.11's
    ``DTensor`` plans as a Shard-to-Partial redistribution it does not have
    (mamba2-130m's train_4k on the pod)."""
    return grad_as_input(params["embed"]) if spec.tie_embeddings else params["embed"]


def _embed_in(params, inputs, spec: ArchSpec, compute_dtype, plan: ShardingPlan = NULL_PLAN):
    """(B, S) tokens or (B, S, D) embeddings, or in decode (B,) or (B, D),
    constrained as the JAX package constrains each (:72, :144)."""
    if spec.frontend == "tokens":
        x = take_embedding(_table(params, spec), inputs).to(compute_dtype)
    else:
        x = inputs.to(compute_dtype)  # precomputed embeddings
    return plan.constrain(x, ("batch", "seq", "embed") if x.ndim == 3 else ("batch", "embed"))


def _project(params, h, spec: ArchSpec, plan: ShardingPlan = NULL_PLAN):
    if spec.frontend == "tokens" and spec.tie_embeddings:
        logits = head_product(h, _table(params, spec).T, plan)
    else:
        logits = head_product(h, params["lm_head"], plan)
    axes = ("batch", "seq", "vocab") if logits.ndim == 3 else ("batch", "vocab")
    return plan.constrain(logits, axes)


def _head(params, x, spec: ArchSpec, plan: ShardingPlan = NULL_PLAN):
    return _project(params, rmsnorm(x, params["final_norm"], spec.norm_eps), spec, plan)


def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)


def forward(params, inputs, spec: ArchSpec, plan: ShardingPlan = NULL_PLAN, *,
            compute_dtype=torch.float32, remat: str = "dots"):
    """inputs: (B, S) int tokens or (B, S, D) embeddings -> (logits (B, S, V),
    aux: the MoE layers' summed load-balance loss, f32 0 without MoE).
    ``remat``: the per-layer policy while autograd records
    (``blocks.REMAT_POLICIES``)."""
    x = _embed_in(params, inputs, spec, compute_dtype, plan)
    x, aux = blocks.stack_forward(params["stack"], x, _positions(x.shape[1], x.device), spec,
                                  remat, plan)
    return _head(params, x, spec, plan), aux


def forward_hidden(params, inputs, spec: ArchSpec, plan: ShardingPlan = NULL_PLAN, *,
                   compute_dtype=torch.float32, remat: str = "dots"):
    """Like ``forward`` but stops before the LM head: returns the final-normed
    hidden states (B, S, D) and aux.  Pair with ``head_fn`` for chunked
    cross-entropy, which never holds the (B, S, V) logits."""
    x = _embed_in(params, inputs, spec, compute_dtype, plan)
    x, aux = blocks.stack_forward(params["stack"], x, _positions(x.shape[1], x.device), spec,
                                  remat, plan)
    return rmsnorm(x, params["final_norm"], spec.norm_eps), aux


def head_fn(params, spec: ArchSpec, plan: ShardingPlan = NULL_PLAN):
    """Closure projecting (already final-normed) hidden chunks to logits."""
    return lambda h: _project(params, h, spec, plan)


def prefill(params, inputs, caches, spec: ArchSpec, plan: ShardingPlan = NULL_PLAN, *,
            compute_dtype=torch.bfloat16):
    """Prompt pass: returns (last-position logits (B, V), filled caches)."""
    x = _embed_in(params, inputs, spec, compute_dtype, plan)
    x, caches = blocks.stack_prefill(params["stack"], x, _positions(x.shape[1], x.device),
                                     spec, plan, caches)
    return _head(params, x[:, -1, :], spec, plan), caches


def decode_step(params, caches, inputs, pos: int, spec: ArchSpec,
                plan: ShardingPlan = NULL_PLAN, *, compute_dtype=torch.bfloat16):
    """One decode step.  inputs: (B,) token ids or (B, D) embeddings;
    pos: position of the new token."""
    x = _embed_in(params, inputs, spec, compute_dtype, plan)
    x, caches = blocks.stack_decode(params["stack"], x, int(pos), spec, plan, caches)
    return _head(params, x, spec, plan), caches
