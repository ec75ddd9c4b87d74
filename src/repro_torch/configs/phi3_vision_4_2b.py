"""Config module for --arch; exact spec lives in registry."""
from repro_torch.configs.registry import PHI3_VISION_4_2B as SPEC

__all__ = ["SPEC"]
