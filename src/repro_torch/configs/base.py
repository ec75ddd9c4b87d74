"""Architecture specifications (the PyTorch port's own copy).

A pure-Python copy of the JAX package's ``configs/base.py``, kept textually
close to it so the two stay easy to compare.  The port imports nothing of the
JAX package, so it carries this copy instead of importing the original.
``repro_torch.configs.registry`` maps ``--arch <id>`` to an ``ArchSpec``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Literal, Sequence

Family = Literal["dense", "ssm", "moe", "hybrid", "vlm", "audio"]
MixerKind = Literal["attn_full", "attn_local", "mamba"]
FFNKind = Literal["mlp", "moe", "none"]


@dataclass(frozen=True)
class LayerDef:
    """One decoder layer = a token mixer + an FFN."""

    mixer: MixerKind
    ffn: FFNKind


@dataclass(frozen=True)
class ArchSpec:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    act: str = "silu"  # mlp activation: silu (SwiGLU) | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    max_seq: int = 32_768

    # -- attention pattern -----------------------------------------------
    sliding_window: int = 0        # >0 enables local attention layers
    local_global_pattern: int = 0  # N -> N local layers then 1 global layer

    # -- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1             # MoE FFN every k-th layer (jamba: 2)

    # -- Mamba2 / SSD -------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1
    attn_every: int = 0            # hybrid: 1 attention layer per k layers

    # -- modality frontend ---------------------------------------------------
    # 'tokens' -> int32 token ids; 'embeddings' -> precomputed (B, S, D)
    # frame/patch embeddings supplied by the (stubbed) modality frontend.
    frontend: str = "tokens"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    # ------------------------------------------------------------------
    def layer_defs(self) -> list[LayerDef]:
        """Fully materialized per-layer plan (length == n_layers)."""
        out: list[LayerDef] = []
        for i in range(self.n_layers):
            # mixer
            if self.family == "ssm":
                mixer: MixerKind = "mamba"
            elif self.attn_every:  # hybrid: 1 attention per attn_every layers
                mixer = "attn_full" if (i % self.attn_every) == (self.attn_every // 2) else "mamba"
            elif self.local_global_pattern:
                p = self.local_global_pattern
                mixer = "attn_full" if (i % (p + 1)) == p else "attn_local"
            elif self.sliding_window:
                mixer = "attn_local"
            else:
                mixer = "attn_full"
            # ffn
            if self.family == "ssm":
                ffn: FFNKind = "none"
            elif self.n_experts and ((i % self.moe_every) == (self.moe_every - 1)):
                ffn = "moe"
            else:
                ffn = "mlp"
            out.append(LayerDef(mixer, ffn))
        return out

    def block_pattern(self) -> tuple[list[LayerDef], int, list[LayerDef]]:
        """(repeating pattern, n_repeats, remainder) for scan-over-blocks.

        The stack is executed as ``scan`` over ``n_repeats`` copies of
        ``pattern`` followed by the unscanned ``remainder`` layers.  This
        keeps the HLO size O(len(pattern)) instead of O(n_layers), which is
        what makes 512-device compiles tractable.
        """
        defs = self.layer_defs()
        # find the smallest repeating unit
        for plen in range(1, len(defs) + 1):
            reps = len(defs) // plen
            if reps >= 1 and defs[: plen * reps] == defs[:plen] * reps:
                # require the remainder (if any) to be a prefix of the pattern
                rem = defs[plen * reps:]
                if rem == defs[: len(rem)]:
                    return defs[:plen], reps, rem
        return defs, 1, []

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Exact parameter count of the realized model (embedding included)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        total += d  # final norm
        for ld in self.layer_defs():
            total += d  # pre-mixer norm
            if ld.mixer.startswith("attn"):
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                total += q + kv + o
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * hd
            else:  # mamba2
                din, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
                zxbcdt = d * (2 * din + 2 * self.ssm_groups * ds + nh)
                conv = (din + 2 * self.ssm_groups * ds) * self.ssm_conv
                total += zxbcdt + conv + nh + nh + din * d  # +A_log +D +out_proj
                total += din  # gate norm
            if ld.ffn != "none":
                total += d  # pre-ffn norm
            if ld.ffn == "mlp":
                total += 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
            elif ld.ffn == "moe":
                total += d * self.n_experts  # router
                total += self.n_experts * 3 * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if not self.n_experts:
            return self.param_count()
        total = self.param_count()
        for ld in self.layer_defs():
            if ld.ffn == "moe":
                total -= (self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff
        return total


@dataclass(frozen=True)
class ShapeSpec:
    """One (input shape × step kind) cell of the evaluation grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPE_GRID: tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPES = {s.name: s for s in SHAPE_GRID}

# Archs for which the 500k-decode cell is runnable (sub-quadratic mixers).
LONG_CONTEXT_ARCHS = frozenset({"mamba2-130m", "jamba-v0.1-52b", "gemma3-1b"})


def cell_is_runnable(arch: "ArchSpec", shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return arch.name in LONG_CONTEXT_ARCHS
    return True


def reduced(spec: ArchSpec, **overrides) -> ArchSpec:
    """A tiny same-family config for CPU smoke tests."""
    pattern, _, rem = spec.block_pattern()
    n_small = max(len(pattern) * min(2, max(1, spec.n_layers // len(pattern))), 1)
    base = dict(
        n_layers=min(spec.n_layers, n_small + len(rem)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(spec.n_kv_heads, 4) if spec.n_kv_heads else 0,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        max_seq=128,
    )
    if spec.sliding_window:
        base["sliding_window"] = 16
    if spec.n_experts:
        base["n_experts"] = min(spec.n_experts, 4)
        base["top_k"] = min(spec.top_k, 2)
    if spec.ssm_state:
        base["ssm_state"] = 16
        base["ssm_head_dim"] = 16
    base.update(overrides)
    return dataclasses.replace(spec, name=spec.name + "-reduced", **base)
