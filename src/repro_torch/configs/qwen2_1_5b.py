"""Config module for --arch; exact spec lives in registry."""
from repro_torch.configs.registry import QWEN2_1_5B as SPEC

__all__ = ["SPEC"]
