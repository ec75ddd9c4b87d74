"""Decoder layers + the layer-stack executor.

Counterpart of the JAX package's ``models/blocks.py``.  The JAX package
stacks the parameters of a repeating block pattern and runs it under
``jax.lax.scan``; the port keeps one parameter subtree per layer, in
execution order, and runs them in a Python loop (``convert.from_jax_params``
unstacks a JAX tree into this order).

Ported: the ``attn_full`` / ``attn_local`` and ``mamba`` mixers, with the
``mlp`` FFN or none (a layer with ``ffn == "none"`` has no ``norm2``/``ffn``
leaves).  The ``moe`` FFN raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import ArchSpec, LayerDef
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import mlp as mlpm
from repro_torch.models.layers import ParamDef, rmsnorm

MOE_TODO = "the MoE FFN is not ported yet (ROADMAP.md Queue 1, item 4: MoE)"


def _check_ported(ld: LayerDef) -> None:
    if ld.ffn == "moe":
        raise NotImplementedError(MOE_TODO)


def _window(spec: ArchSpec, ld: LayerDef) -> int:
    return spec.sliding_window if ld.mixer == "attn_local" else 0


def layer_param_defs(spec: ArchSpec, ld: LayerDef) -> dict[str, Any]:
    _check_ported(ld)
    d = spec.d_model
    defs: dict[str, Any] = {"norm1": ParamDef((d,), "zeros")}
    defs["mixer"] = mb.mamba_defs(spec) if ld.mixer == "mamba" else attn.attn_defs(spec)
    if ld.ffn != "none":
        defs["norm2"] = ParamDef((d,), "zeros")
        defs["ffn"] = mlpm.mlp_defs(spec)
    return defs


def layer_cache_defs(spec: ArchSpec, ld: LayerDef, batch: int, seq: int) -> dict[str, Any]:
    _check_ported(ld)
    if ld.mixer == "mamba":
        return mb.mamba_cache_defs(spec, batch)
    return attn.attn_cache_defs(spec, batch, seq, window=_window(spec, ld))


def _ffn(p, x, ld: LayerDef, spec: ArchSpec):
    if ld.ffn == "none":
        return x
    return x + mlpm.mlp_apply(p["ffn"], rmsnorm(x, p["norm2"], spec.norm_eps), spec)


def _apply_forward(p, x, positions, ld: LayerDef, spec: ArchSpec):
    h = rmsnorm(x, p["norm1"], spec.norm_eps)
    if ld.mixer == "mamba":
        y = mb.mamba_fwd(p["mixer"], h, spec)
    else:
        y = attn.attention_fwd(p["mixer"], h, positions, spec, window=_window(spec, ld))
    return _ffn(p, x + y, ld, spec)


def _apply_prefill(p, x, positions, ld: LayerDef, spec: ArchSpec, cache):
    h = rmsnorm(x, p["norm1"], spec.norm_eps)
    if ld.mixer == "mamba":
        y, cache = mb.mamba_prefill(p["mixer"], h, spec, cache)
    else:
        y, cache = attn.attn_prefill(p["mixer"], h, positions, spec, cache,
                                     window=_window(spec, ld))
    return _ffn(p, x + y, ld, spec), cache


def _apply_decode(p, x, pos: int, ld: LayerDef, spec: ArchSpec, cache):
    h = rmsnorm(x, p["norm1"], spec.norm_eps)
    if ld.mixer == "mamba":
        y, cache = mb.mamba_decode(p["mixer"], h, spec, cache)
    else:
        y, cache = attn.attn_decode(p["mixer"], h, pos, spec, cache, window=_window(spec, ld))
    return _ffn(p, x + y, ld, spec), cache


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------

def stack_param_defs(spec: ArchSpec) -> list[dict[str, Any]]:
    return [layer_param_defs(spec, ld) for ld in spec.layer_defs()]


def stack_cache_defs(spec: ArchSpec, batch: int, seq: int) -> list[dict[str, Any]]:
    return [layer_cache_defs(spec, ld, batch, seq) for ld in spec.layer_defs()]


def stack_forward(params, x, positions, spec: ArchSpec):
    """The JAX ``stack_train`` forward (no remat: the port does not train)."""
    for p, ld in zip(params, spec.layer_defs()):
        x = _apply_forward(p, x, positions, ld, spec)
    return x


def stack_prefill(params, x, positions, spec: ArchSpec, caches):
    for i, (p, ld) in enumerate(zip(params, spec.layer_defs())):
        x, caches[i] = _apply_prefill(p, x, positions, ld, spec, caches[i])
    return x, caches


def stack_decode(params, x, pos: int, spec: ArchSpec, caches):
    for i, (p, ld) in enumerate(zip(params, spec.layer_defs())):
        x, caches[i] = _apply_decode(p, x, pos, ld, spec, caches[i])
    return x, caches
