"""--arch <id> registry: 10 assigned architectures + the paper's 4 workloads.

The port's own copy of the JAX package's ``configs/registry.py``."""
from __future__ import annotations

from repro_torch.configs.base import ArchSpec

# ---------------------------------------------------------------------------
# Assigned architectures (LM family; exact configs from the task sheet).
# ---------------------------------------------------------------------------

MAMBA2_130M = ArchSpec(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=50_280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    tie_embeddings=True, max_seq=1_048_576,
)

YI_9B = ArchSpec(
    name="yi-9b", family="dense", n_layers=48, d_model=4_096,
    n_heads=32, n_kv_heads=4, d_ff=11_008, vocab_size=64_000,
    rope_theta=5_000_000.0,
)

DEEPSEEK_67B = ArchSpec(
    name="deepseek-67b", family="dense", n_layers=95, d_model=8_192,
    n_heads=64, n_kv_heads=8, d_ff=22_016, vocab_size=102_400,
)

GEMMA3_1B = ArchSpec(
    name="gemma3-1b", family="dense", n_layers=26, d_model=1_152,
    n_heads=4, n_kv_heads=1, d_ff=6_912, vocab_size=262_144,
    head_dim=256, act="gelu", tie_embeddings=True,
    sliding_window=512, local_global_pattern=5, max_seq=1_048_576,
)

QWEN2_1_5B = ArchSpec(
    name="qwen2-1.5b", family="dense", n_layers=28, d_model=1_536,
    n_heads=12, n_kv_heads=2, d_ff=8_960, vocab_size=151_936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
)

PHI3_VISION_4_2B = ArchSpec(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3_072,
    n_heads=32, n_kv_heads=32, d_ff=8_192, vocab_size=32_064,
    frontend="embeddings",
)

MOONSHOT_16B_A3B = ArchSpec(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2_048,
    n_heads=16, n_kv_heads=16, d_ff=1_408, vocab_size=163_840,
    n_experts=64, top_k=6,
)

GRANITE_MOE_3B = ArchSpec(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1_536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab_size=49_155,
    n_experts=40, top_k=8,
)

MUSICGEN_MEDIUM = ArchSpec(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1_536,
    n_heads=24, n_kv_heads=24, d_ff=6_144, vocab_size=2_048,
    act="gelu", frontend="embeddings",
)

JAMBA_52B = ArchSpec(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4_096,
    n_heads=32, n_kv_heads=8, d_ff=14_336, vocab_size=65_536,
    n_experts=16, top_k=2, moe_every=2,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    attn_every=8, max_seq=1_048_576,
)

ASSIGNED: dict[str, ArchSpec] = {
    s.name: s
    for s in (
        MAMBA2_130M, YI_9B, DEEPSEEK_67B, GEMMA3_1B, QWEN2_1_5B,
        PHI3_VISION_4_2B, MOONSHOT_16B_A3B, GRANITE_MOE_3B,
        MUSICGEN_MEDIUM, JAMBA_52B,
    )
}

# ---------------------------------------------------------------------------
# The paper's own evaluation workloads (Table 2) — targets for the COSMIC
# Workload Trace Generator and the figure benchmarks.
# ---------------------------------------------------------------------------

GPT3_175B = ArchSpec(
    name="gpt3-175b", family="dense", n_layers=96, d_model=12_288,
    n_heads=96, n_kv_heads=96, d_ff=49_152, vocab_size=50_257,
    act="gelu", max_seq=2_048,
)

GPT3_13B = ArchSpec(
    name="gpt3-13b", family="dense", n_layers=40, d_model=5_140,
    n_heads=40, n_kv_heads=40, d_ff=20_560, vocab_size=50_257,
    act="gelu", max_seq=2_048,
)

VIT_BASE = ArchSpec(
    name="vit-base", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3_072, vocab_size=1_000,
    act="gelu", max_seq=256, frontend="embeddings",
)

VIT_LARGE = ArchSpec(
    name="vit-large", family="dense", n_layers=24, d_model=1_024,
    n_heads=16, n_kv_heads=16, d_ff=4_096, vocab_size=1_000,
    act="gelu", max_seq=256, frontend="embeddings",
)

PAPER_WORKLOADS: dict[str, ArchSpec] = {
    s.name: s for s in (GPT3_175B, GPT3_13B, VIT_BASE, VIT_LARGE)
}

ARCHS: dict[str, ArchSpec] = {**ASSIGNED, **PAPER_WORKLOADS}


def get_arch(name: str) -> ArchSpec:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}") from None
