"""Decoder layers + the layer-stack executor.

Counterpart of the JAX package's ``models/blocks.py``.  The JAX package
stacks the parameters of a repeating block pattern and runs it under
``jax.lax.scan``; the port keeps one parameter subtree per layer, in
execution order, and runs them in a Python loop (``convert.from_jax_params``
unstacks a JAX tree into this order).

Every layer kind of the JAX package: the ``attn_full`` / ``attn_local``
(sliding-window, with a ring-buffer cache) and ``mamba`` mixers, with the
``mlp`` or ``moe`` FFN or none (a layer with ``ffn == "none"`` has no
``norm2``/``ffn`` leaves).

Remat (``stack_forward(..., remat=)``): the JAX ``REMAT_POLICIES`` (:27-35)
applied per layer, as the JAX ``stack_train`` applies them per sublayer
(:139-169), through ``torch.utils.checkpoint``:
  * ``none``: nothing is recomputed;
  * ``full``: each layer saves only its input and recomputes the rest;
  * ``dots``: selective checkpointing that saves the outputs of 2-D matrix
    products (``mm``/``addmm``: every projection, the router) and recomputes
    the rest, batched products included, as the JAX
    ``dots_with_no_batch_dims_saveable`` does;
  * ``save_kv``: saves only the roped k and v that enter attention
    (``checkpoint_name(.., "attn_kv")``, as the JAX module names them).
Each kernel launch is an operator (``kernels/_library.py``), which the
dispatch mode of selective checkpointing sees as one op: no policy saves
it, so its recompute launches the kernel again.  That holds for the
autograd Functions' saved
intermediates too (flash attention's log-sum-exp, the SSD scan's y, final
state and scratch of entering states): every policy but ``none`` drops them
with the layer and the recompute launches the forward again, so a Mamba
layer keeps its 201 MB scratch (mamba2-130m, B=4, S=4096) only while its
own backward runs.  Remat only matters while autograd records: with grad
mode off, every policy runs the layers plainly.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ArchSpec, LayerDef
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import mlp as mlpm
from repro_torch.models import moe as moem
from repro_torch.models.layers import REMAT_NAMES, ParamDef, rmsnorm
from repro_torch.parallel.local_shards import lift
from repro_torch.parallel.sharding import NULL_PLAN, ShardingPlan

REMAT_POLICIES = ("none", "full", "dots", "save_kv")
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, func, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if func in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_kv_policy(ctx, func, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if getattr(REMAT_NAMES, "current", None) == "attn_kv"
            else CheckpointPolicy.PREFER_RECOMPUTE)


_CONTEXTS = {"dots": functools.partial(create_selective_checkpoint_contexts, _dots_policy),
             "save_kv": functools.partial(create_selective_checkpoint_contexts, _save_kv_policy)}


def _window(spec: ArchSpec, ld: LayerDef) -> int:
    return spec.sliding_window if ld.mixer == "attn_local" else 0


def layer_param_defs(spec: ArchSpec, ld: LayerDef) -> dict[str, Any]:
    d = spec.d_model
    defs: dict[str, Any] = {"norm1": ParamDef((d,), ("embed",), "zeros")}
    defs["mixer"] = mb.mamba_defs(spec) if ld.mixer == "mamba" else attn.attn_defs(spec)
    if ld.ffn != "none":
        defs["norm2"] = ParamDef((d,), ("embed",), "zeros")
        defs["ffn"] = moem.moe_defs(spec) if ld.ffn == "moe" else mlpm.mlp_defs(spec)
    return defs


def layer_cache_defs(spec: ArchSpec, ld: LayerDef, batch: int, seq: int) -> dict[str, Any]:
    if ld.mixer == "mamba":
        return mb.mamba_cache_defs(spec, batch)
    return attn.attn_cache_defs(spec, batch, seq, window=_window(spec, ld))


def _ffn(p, x, ld: LayerDef, spec: ArchSpec, plan: ShardingPlan = NULL_PLAN):
    """x + FFN(norm2(x)) and the layer's load-balance loss (None without MoE).
    x: (B, S, D), or (B, D) in decode, which the FFN takes as S = 1 (JAX
    :104-110)."""
    if ld.ffn == "none":
        return x, None
    h = rmsnorm(x, p["norm2"], spec.norm_eps)
    h3 = h if h.ndim == 3 else h[:, None, :]
    if ld.ffn == "mlp":
        y, aux = mlpm.mlp_apply(p["ffn"], h3, spec, plan), None
    else:
        y, aux = moem.moe_apply(p["ffn"], h3, spec, plan)
        aux = aux["lb_loss"]
    return x + (y if h.ndim == 3 else y[:, 0]), aux


def _apply_forward(p, x, positions, ld: LayerDef, spec: ArchSpec,
                   plan: ShardingPlan = NULL_PLAN):
    h = rmsnorm(x, p["norm1"], spec.norm_eps)
    if ld.mixer == "mamba":
        y = mb.mamba_fwd(p["mixer"], h, spec, plan)
    else:
        y = attn.attention_fwd(p["mixer"], h, positions, spec, plan, window=_window(spec, ld))
    x, aux = _ffn(p, x + y, ld, spec, plan)
    return plan.constrain(x, ("batch", "seq", "embed")), aux


def _apply_prefill(p, x, positions, ld: LayerDef, spec: ArchSpec, plan: ShardingPlan, cache):
    h = rmsnorm(x, p["norm1"], spec.norm_eps)
    if ld.mixer == "mamba":
        y, cache = mb.mamba_prefill(p["mixer"], h, spec, plan, cache)
    else:
        y, cache = attn.attn_prefill(p["mixer"], h, positions, spec, plan, cache,
                                     window=_window(spec, ld))
    return _ffn(p, x + y, ld, spec, plan)[0], cache


def _apply_decode(p, x, pos: int, ld: LayerDef, spec: ArchSpec, plan: ShardingPlan, cache):
    h = rmsnorm(x, p["norm1"], spec.norm_eps)
    if ld.mixer == "mamba":
        y, cache = mb.mamba_decode(p["mixer"], h, spec, plan, cache)
    else:
        y, cache = attn.attn_decode(p["mixer"], h, pos, spec, plan, cache,
                                    window=_window(spec, ld))
    return _ffn(p, x + y, ld, spec, plan)[0], cache


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------

def stack_param_defs(spec: ArchSpec) -> list[dict[str, Any]]:
    return [layer_param_defs(spec, ld) for ld in spec.layer_defs()]


def stack_cache_defs(spec: ArchSpec, batch: int, seq: int) -> list[dict[str, Any]]:
    return [layer_cache_defs(spec, ld, batch, seq) for ld in spec.layer_defs()]


def _apply_saving(names, p, x, positions, ld: LayerDef, spec: ArchSpec, plan: ShardingPlan):
    """``_apply_forward`` with ``checkpoint_name`` copying ``names``: the
    checkpointed function itself sets them, so its recompute in the backward
    makes the same ops as its forward."""
    saving = getattr(REMAT_NAMES, "saving", ())
    REMAT_NAMES.saving = names
    try:
        return _apply_forward(p, x, positions, ld, spec, plan)
    finally:
        REMAT_NAMES.saving = saving


def _remat_forward(p, x, positions, ld: LayerDef, spec: ArchSpec, remat: str,
                   plan: ShardingPlan):
    if remat == "full":
        return checkpoint(_apply_forward, p, x, positions, ld, spec, plan, use_reentrant=False,
                          preserve_rng_state=False)
    names = ("attn_kv",) if remat == "save_kv" else ()
    return checkpoint(_apply_saving, names, p, x, positions, ld, spec, plan,
                      use_reentrant=False, preserve_rng_state=False,
                      context_fn=_CONTEXTS[remat])


def stack_forward(params, x, positions, spec: ArchSpec, remat: str = "none",
                  plan: ShardingPlan = NULL_PLAN):
    """The JAX ``stack_train`` forward, each layer under the ``remat`` policy
    (``REMAT_POLICIES``) and its output constrained as the JAX one is
    (:146).  Returns (x, aux): aux sums ``lb_loss`` over the MoE layers (f32
    0 without any, replicated on x's mesh when x is a ``DTensor``), as the
    JAX ``_apply_train`` (:66-72) does."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, not {remat!r}")
    if not torch.is_grad_enabled():
        remat = "none"  # nothing is saved for a backward, so nothing to recompute
    aux = lift(torch.zeros((), dtype=torch.float32, device=x.device), x)
    for p, ld in zip(params, spec.layer_defs()):
        if remat == "none":
            x, lb = _apply_forward(p, x, positions, ld, spec, plan)
        else:
            x, lb = _remat_forward(p, x, positions, ld, spec, remat, plan)
        if lb is not None:
            aux = aux + lb
    return x, aux


def stack_prefill(params, x, positions, spec: ArchSpec, plan: ShardingPlan, caches):
    """Prompt pass over every layer, each layer's output constrained as the
    JAX ``stack_prefill`` constrains it (:180)."""
    for i, (p, ld) in enumerate(zip(params, spec.layer_defs())):
        x, caches[i] = _apply_prefill(p, x, positions, ld, spec, plan, caches[i])
        x = plan.constrain(x, ("batch", "seq", "embed"))
    return x, caches


def stack_decode(params, x, pos: int, spec: ArchSpec, plan: ShardingPlan, caches):
    for i, (p, ld) in enumerate(zip(params, spec.layer_defs())):
        x, caches[i] = _apply_decode(p, x, pos, ld, spec, plan, caches[i])
    return x, caches
