"""Config module for --arch; exact spec lives in registry."""
from repro_torch.configs.registry import DEEPSEEK_67B as SPEC

__all__ = ["SPEC"]
