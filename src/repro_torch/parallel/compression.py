"""Gradient compression for data-parallel reductions.

Counterpart of the JAX package's ``parallel/compression.py``: int8
quantization with error feedback around the data-parallel all-reduce, with
the quantization residual carried into the next step so the compression
bias vanishes over time (Seide et al. / 1-bit Adam lineage).  The same
semantics (JAX :19-61): one scale for all ranks, from an all-reduce of each
rank's max |g| (``MAX``); ``round`` half to even, as ``jnp.round`` does,
then clip to the integer range; the integer payloads summed; the residual
``g - q * scale`` carried; the mean taken over the group's size.

On the wire each rank's payload is int8 (for ``bits`` <= 8): the ranks
all-gather them and each adds them up exactly in int32, so every rank gets
the same sum.  ``wire_bytes`` counts that payload and one f32 scale per
tensor.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models.layers import map_with_path
from repro_torch.train.optimizer import leaves


def _rebuild(tree, values: list):
    it = iter(values)
    return map_with_path(lambda _, __: next(it), tree)


def init_error_state(grads_like) -> Any:
    return map_with_path(lambda _, a: torch.zeros(a.shape, dtype=torch.float32, device=a.device),
                         grads_like)


def _quantize(g, bits: int):
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp_min(g.abs().max() / qmax, 1e-30)
    q = torch.clamp(torch.round(g / scale), -qmax, qmax)
    return q, scale


def _int_sum(q: torch.Tensor, bits: int, group) -> torch.Tensor:
    """The sum over the group of each rank's integer-valued ``q``, exactly."""
    wire = torch.int8 if bits <= 8 else torch.int32
    payload = q.to(wire)
    parts = [torch.empty_like(payload) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, payload, group=group)
    total = parts[0].to(torch.int32)
    for part in parts[1:]:
        total += part
    return total.to(torch.float32)


def compressed_psum(grads, group, error_state, *, bits: int = 8):
    """Error-feedback compressed all-reduce (mean) over ``group``.

    Returns (reduced grads, new error state).  Wire cost per tensor:
    n_elements * bits/8 + 4 bytes, vs n_elements * 4 uncompressed."""
    n = dist.get_world_size(group)
    qmax = 2.0 ** (bits - 1) - 1
    new_g, new_e = [], []
    for g, e in zip(leaves(grads), leaves(error_state)):
        g = g.to(torch.float32) + e
        # globally shared scale so the integer payloads sum losslessly
        top = g.abs().max()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp_min(top / qmax, 1e-30)
        q = torch.clamp(torch.round(g / scale), -qmax, qmax)
        new_e.append(g - q * scale)                       # residual -> next step
        new_g.append((_int_sum(q, bits, group) * scale) / n)
    return _rebuild(grads, new_g), _rebuild(grads, new_e)


def wire_bytes(grads, *, bits: int = 8) -> tuple[int, int]:
    """(compressed, uncompressed fp32) bytes per all-reduce round."""
    tensors = leaves(grads)
    n = sum(math.prod(a.shape) for a in tensors)
    return n * bits // 8 + 4 * len(tensors), n * 4
