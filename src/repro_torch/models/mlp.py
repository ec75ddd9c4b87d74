"""Dense FFN: SwiGLU (llama-family) or GELU (gpt/gemma/musicgen-style).

Counterpart of the JAX package's ``models/mlp.py``.  ``jax.nn.gelu`` defaults
to the tanh approximation, and so does this module.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchSpec
from repro_torch.models.layers import ParamDef, linear, linears
from repro_torch.parallel.sharding import NULL_PLAN, ShardingPlan


def mlp_defs(spec: ArchSpec) -> dict[str, ParamDef]:
    d, f = spec.d_model, spec.d_ff
    defs = {
        "w_up": ParamDef((d, f), ("embed", "ff")),
        "w_down": ParamDef((f, d), ("ff", "embed")),
    }
    if spec.act == "silu":
        defs["w_gate"] = ParamDef((d, f), ("embed", "ff"))
    return defs


def mlp_apply(p, x, spec: ArchSpec, plan: ShardingPlan = NULL_PLAN) -> torch.Tensor:
    if spec.act == "silu":
        up, gate = linears(x, p["w_up"], p["w_gate"])
        h = F.silu(gate) * up
    else:
        h = F.gelu(linear(x, p["w_up"]), approximate="tanh")
    h = plan.constrain(h, ("batch", "seq", "ff"))
    return linear(h, p["w_down"])
