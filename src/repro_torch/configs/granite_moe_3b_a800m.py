"""Config module for --arch; exact spec lives in registry."""
from repro_torch.configs.registry import GRANITE_MOE_3B as SPEC

__all__ = ["SPEC"]
