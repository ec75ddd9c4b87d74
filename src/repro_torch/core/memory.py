"""Per-NPU memory-footprint model — the validity gate of Section 5.4
("any parallelization strategy resulting in a memory footprint exceeding
24 GB per NPU is considered invalid and discarded")."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchSpec
from repro_torch.core.cache import switchable_lru_cache
from repro_torch.core.workload import Parallelism

BYTES_PARAM = 2            # bf16 weights
BYTES_OPT = 12             # fp32 master + Adam m/v
BYTES_ACT = 2


@dataclass(frozen=True)
class Footprint:
    params_gb: float
    optimizer_gb: float
    activations_gb: float
    kv_cache_gb: float

    @property
    def total_gb(self) -> float:
        return self.params_gb + self.optimizer_gb + self.activations_gb + self.kv_cache_gb


def footprint(spec: ArchSpec, par: Parallelism, *, batch: int, seq: int,
              mode: str = "train", act_factor: float = 4.0,
              remat: bool = True, microbatches: int = 8) -> Footprint:
    """Memoized on its (hashable) value-object arguments — the DSE loop
    re-gates the same (spec, parallelization) points constantly."""
    return _footprint_cached(spec, par, batch, seq, mode, act_factor,
                             remat, microbatches)


def _footprint_impl(spec: ArchSpec, par: Parallelism, batch: int, seq: int,
                    mode: str, act_factor: float, remat: bool,
                    microbatches: int) -> Footprint:
    p_total = spec.param_count()
    tp = par.tp
    shard = tp * par.pp * (par.dp if par.weight_sharded else 1)
    params = p_total * BYTES_PARAM / shard
    optimizer = p_total * BYTES_OPT / (tp * par.pp * par.dp) if mode == "train" else 0.0
    if not par.weight_sharded and mode == "train":
        optimizer = p_total * BYTES_OPT / (tp * par.pp)

    b = batch / par.dp / (microbatches if mode == "train" else 1)
    s = seq / par.sp
    layers_per_stage = max(1, spec.n_layers // par.pp)
    per_layer = b * s * spec.d_model * BYTES_ACT
    if mode == "train":
        # remat keeps ~the residual stream per layer; otherwise act_factor
        # intermediate tensors per layer survive to the backward pass
        acts = per_layer * layers_per_stage * (1.5 if remat else act_factor)
    else:
        acts = per_layer * 2

    kv = 0.0
    if mode != "train":
        kv = kv_cache_bytes(spec, batch=b, seq=seq, tp=tp)

    return Footprint(params / 1e9, optimizer / 1e9, acts / 1e9, kv / 1e9)


def kv_cache_bytes(spec: ArchSpec, *, batch: float, seq: int,
                   tp: int = 1) -> float:
    """K+V cache bytes for ``batch`` requests at ``seq`` tokens, per TP
    shard — the single source of truth for both the footprint gate and the
    disaggregated-serving KV transfer size."""
    hd = spec.resolved_head_dim
    n_attn = sum(1 for ld in spec.layer_defs() if ld.mixer.startswith("attn"))
    return n_attn * batch * seq * spec.n_kv_heads * hd * 2 * BYTES_ACT / tp


_footprint_cached = switchable_lru_cache(maxsize=16384)(_footprint_impl)


def fits(spec: ArchSpec, par: Parallelism, *, batch: int, seq: int,
         capacity_gb: float = 24.0, mode: str = "train") -> bool:
    return footprint(spec, par, batch=batch, seq=seq, mode=mode).total_gb <= capacity_gb
