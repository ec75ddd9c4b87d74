"""Config module for --arch; exact spec lives in registry."""
from repro_torch.configs.registry import YI_9B as SPEC

__all__ = ["SPEC"]
