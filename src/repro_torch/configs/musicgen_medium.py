"""Config module for --arch; exact spec lives in registry."""
from repro_torch.configs.registry import MUSICGEN_MEDIUM as SPEC

__all__ = ["SPEC"]
