"""Config module for --arch; exact spec lives in registry."""
from repro_torch.configs.registry import MOONSHOT_16B_A3B as SPEC

__all__ = ["SPEC"]
