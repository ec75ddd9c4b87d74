"""Config module for --arch; exact spec lives in registry."""
from repro_torch.configs.registry import VIT_BASE as SPEC

__all__ = ["SPEC"]
