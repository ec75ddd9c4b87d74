"""Dense FFN: SwiGLU (llama-family) or GELU (gpt/gemma/musicgen-style).

Counterpart of the JAX package's ``models/mlp.py``.  ``jax.nn.gelu`` defaults
to the tanh approximation, and so does this module.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchSpec
from repro_torch.models.layers import ParamDef, linear


def mlp_defs(spec: ArchSpec) -> dict[str, ParamDef]:
    d, f = spec.d_model, spec.d_ff
    defs = {
        "w_up": ParamDef((d, f)),
        "w_down": ParamDef((f, d)),
    }
    if spec.act == "silu":
        defs["w_gate"] = ParamDef((d, f))
    return defs


def mlp_apply(p, x, spec: ArchSpec) -> torch.Tensor:
    up = linear(x, p["w_up"])
    if spec.act == "silu":
        h = F.silu(linear(x, p["w_gate"])) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return linear(h, p["w_down"])
