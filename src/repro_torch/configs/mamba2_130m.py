"""Config module for --arch; exact spec lives in registry."""
from repro_torch.configs.registry import MAMBA2_130M as SPEC

__all__ = ["SPEC"]
