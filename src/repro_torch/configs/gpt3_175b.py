"""Config module for --arch; exact spec lives in registry."""
from repro_torch.configs.registry import GPT3_175B as SPEC

__all__ = ["SPEC"]
