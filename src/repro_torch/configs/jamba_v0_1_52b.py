"""Config module for --arch; exact spec lives in registry."""
from repro_torch.configs.registry import JAMBA_52B as SPEC

__all__ = ["SPEC"]
