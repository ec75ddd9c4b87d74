"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis.

Counterpart of the JAX package's ``parallel/pipeline.py`` (a ``shard_map``
with ``lax.ppermute`` there).  Stages live on a 'pipe' mesh axis, one per
rank; activations move to the next stage with ``batch_isend_irecv`` (each
rank's send and receive posted together: blocking sends in stage order
would deadlock), and the classic (n_micro + n_stages - 1) schedule,
bubble included, falls out of the loop.  Generic over the per-stage
function, so any layer stack can be cut into stages.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.layers import map_with_path


def pipeline_forward(stage_fn: Callable, mesh, axis: str = "pipe"):
    """Build a pipelined forward over ``n_stages`` = the size of ``axis``.

    stage_fn(stage_params, x) -> y : one stage's computation.
    Returns f(stage_params_stacked, microbatches) -> outputs where
      stage_params_stacked : tree of tensors with leading dim n_stages
                             (each rank uses its own stage's slice),
      microbatches         : (n_micro, mb, ...) input microbatches, the same
                             on every rank,
      outputs              : (n_micro, mb, ...) final-stage outputs, on every
                             rank (as the JAX ``psum`` of :81 returns them).
    """
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    my_stage = mesh.get_local_rank(axis)
    nxt = dist.get_global_rank(group, (my_stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (my_stage - 1) % n_stages)

    def pipelined(stage_params_stacked, microbatches):
        sp = map_with_path(lambda _, a: a[my_stage], stage_params_stacked)
        n_micro = microbatches.shape[0]
        carry_in = torch.zeros_like(microbatches[0])
        outputs = torch.zeros_like(microbatches)
        for t in range(n_micro + n_stages - 1):
            # stage 0 ingests microbatch t (the last one again once none
            # remains); other stages take the activation handed on to them
            x_in = microbatches[min(t, n_micro - 1)] if my_stage == 0 else carry_in
            y = stage_fn(sp, x_in)
            # the last stage emits a finished microbatch (t - n_stages + 1)
            if my_stage == n_stages - 1 and t >= n_stages - 1:
                outputs[t - n_stages + 1] = y
            if n_stages > 1:  # the ring (i -> i + 1 mod n), as the JAX perm
                y = y.contiguous()
                carry_in = torch.empty_like(y)
                for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, y, nxt, group),
                                                   dist.P2POp(dist.irecv, carry_in, prv, group)]):
                    req.wait()
        # only the last stage wrote outputs (the others hold zeros)
        dist.all_reduce(outputs, group=group)
        return outputs

    return pipelined


def pipeline_bubble_fraction(n_micro: int, n_stages: int) -> float:
    """The GPipe bubble: (S-1) / (M + S - 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
