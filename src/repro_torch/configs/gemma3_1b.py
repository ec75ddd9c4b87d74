"""Config module for --arch; exact spec lives in registry."""
from repro_torch.configs.registry import GEMMA3_1B as SPEC

__all__ = ["SPEC"]
