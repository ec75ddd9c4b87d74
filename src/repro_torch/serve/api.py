"""Serving entry points: prefill_step / serve_step factories.

Counterpart of the JAX package's ``serve/api.py``.  Its ``*_abstract``
helpers describe shapes for the dry run, which is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models import model as M


def make_prefill_step(spec: ArchSpec, compute_dtype=torch.bfloat16):
    def prefill_step(params, inputs, caches):
        return M.prefill(params, inputs, caches, spec, compute_dtype=compute_dtype)
    return prefill_step


def make_serve_step(spec: ArchSpec, compute_dtype=torch.bfloat16):
    def serve_step(params, caches, inputs, pos):
        return M.decode_step(params, caches, inputs, pos, spec, compute_dtype=compute_dtype)
    return serve_step
