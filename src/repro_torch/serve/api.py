"""Serving entry points: prefill_step / serve_step factories.

Counterpart of the JAX package's ``serve/api.py``: the functions the dry run
(``launch/dryrun.py``) runs for the inference cells (``prefill_32k`` runs
prefill_step; ``decode_32k``/``long_500k`` run serve_step, one new token
against a seq_len cache), and ``Engine`` serves through.  The
``*_abstract`` helpers give their inputs as fake stand-ins.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models import model as M
from repro_torch.models.layers import fake_mode
from repro_torch.parallel.sharding import NULL_PLAN, ShardingPlan


def make_prefill_step(spec: ArchSpec, plan: ShardingPlan = NULL_PLAN,
                      compute_dtype=torch.bfloat16):
    def prefill_step(params, inputs, caches):
        return M.prefill(params, inputs, caches, spec, plan, compute_dtype=compute_dtype)
    return prefill_step


def make_serve_step(spec: ArchSpec, plan: ShardingPlan = NULL_PLAN,
                    compute_dtype=torch.bfloat16):
    def serve_step(params, caches, inputs, pos):
        return M.decode_step(params, caches, inputs, pos, spec, plan,
                             compute_dtype=compute_dtype)
    return serve_step


def decode_inputs_abstract(spec: ArchSpec, batch: int, compute_dtype=torch.bfloat16, *,
                           device=None):
    """Fake stand-ins of one decode step's new-token inputs and its int32
    position (``serve_step`` takes the position as a Python int; the
    stand-in gives its bytes)."""
    dev = torch.device(device or "cuda")
    with fake_mode():
        if spec.frontend == "tokens":
            tok = torch.empty((batch,), dtype=torch.int32, device=dev)
        else:
            tok = torch.empty((batch, spec.d_model), dtype=compute_dtype, device=dev)
        return tok, torch.empty((), dtype=torch.int32, device=dev)


def prefill_inputs_abstract(spec: ArchSpec, batch: int, seq: int, compute_dtype=torch.bfloat16,
                            *, device=None):
    dev = torch.device(device or "cuda")
    with fake_mode():
        if spec.frontend == "tokens":
            return torch.empty((batch, seq), dtype=torch.int32, device=dev)
        return torch.empty((batch, seq, spec.d_model), dtype=compute_dtype, device=dev)
