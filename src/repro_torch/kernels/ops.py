"""Public wrappers around the kernels, in the JAX package's layouts.

Counterparts of ``kernels/ops.py``: ``mha_flash`` (:24), ``ssd`` (:43) and
``fused_rmsnorm`` (:63).  A CUDA tensor goes to the Hopper kernel (or the
call raises), a CPU tensor to the kernel's plain version, a fake tensor (the
dry run's) to the kernel operator's fake implementation.  The models call
these at every length and every row count: there is no separate dense or
pure-torch model path.

Under a sharding plan the inputs are ``DTensor``s.  The kernels are
``ctypes`` calls on raw pointers, so a ``DTensor`` never reaches them: each
wrapper runs on local shards through ``parallel.local_shards``, keeping
whole the dims each kernel needs whole:
  * flash attention: batch and heads may be split (k/v's groups split as
    q's heads are), and q's sequence: each rank runs its own query rows at
    their offset in the sequence (``shard_extent``) against k/v held whole
    along it, and the keys' gradients are each rank's share, summed;
  * the SSD scan: batch and heads may be split (b/c's groups with them, or
    whole when there is one group), or head_dim where the heads do not
    divide the mesh axis: each rank scans its columns of every head with
    dt, a, b and c whole, and their gradients are each rank's share,
    summed; the final state keeps x's splits; the scan's sequence stays
    whole;
  * RMSNorm: rows may be split, and the normalised last dim too (mamba2's
    gated norm on its d_inner split over 'model', as XLA keeps it): each
    rank sums its columns' squares, the sums are all-reduced over the ranks
    that split the row, and each rank normalises its own columns
    (``rmsnorm_split``, the kernels' split-row mode); a row held whole takes
    the whole-row kernel.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_split
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.parallel.local_shards import (mesh_dims_along, on_local_shards, reduce_over,
                                               shard_extent, split_along)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: a local gradient goes
    back into ``DTensor`` ops (views) that need dense strides."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _local_ssd(x, dt, a, b, c):
    return ssd_scan(*(_ContiguousGrad.apply(t) for t in (x, dt, a, b, c)))


def mha_flash(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None):
    """q: (B, S, H, hd); k/v: (B, T, G, hd) (GQA groups).  Returns (B,S,H,hd).

    Any S and T.  Unlike the JAX wrapper, which hands block multiples to its
    kernel, the kernel here masks the ragged edge of its tiles itself and
    masks keys by the true T.  A q split over its sequence keeps that split
    (the JAX sequence-sharded attention): each rank's rows sit at their
    offset in the sequence, and k/v are whole along it.
    """
    offset = shard_extent(q, 1)[0] if split_along(q, 1) else 0
    fn = functools.partial(flash_attention, causal=causal, window=window, scale=scale,
                           q_offset=offset)
    return on_local_shards(fn, (q, k, v), (0, 1, 2), follow=(None, {0: 0, 2: 2}, {0: 0, 2: 2}))


def ssd(x, dt, a, b, c):
    """Model layout: x (B,S,H,P); dt (B,S,H) f32; a (H,) f32; b/c (B,S,G,N).
    Returns y (B,S,H,P) and the final state (B,H,P,N) in f32.

    Any S, and no ``chunk`` argument: the kernel picks its own chunk and
    masks the ragged last one.  Unlike the JAX wrapper, nothing is repeated
    over groups or transposed: the kernel reads the model layout.
    """
    groups = {0: 0} if b.shape[2] == 1 else {0: 0, 2: 2}  # one group: every head reads it
    return on_local_shards(_local_ssd, (x, dt, a, b, c), (0, 2, 3),
                           follow=(None, {0: 0, 2: 2}, {2: 0}, groups, groups),
                           out=(None, {0: 0, 2: 1, 3: 2}))


def _rmsnorm_rows(x, w, eps):
    shape = x.shape
    return rmsnorm(x.reshape(-1, shape[-1]), w, eps=eps).reshape(shape)


def _rmsnorm_split_rows(x, w, eps, d_full, groups):
    shape = x.shape
    reduce = functools.partial(reduce_over, op="sum", groups=groups)
    return rmsnorm_split(x.reshape(-1, shape[-1]), w, eps=eps, d_full=d_full,
                         reduce=reduce).reshape(shape)


def fused_rmsnorm(x, w, *, eps: float = 1e-5):
    """x: (..., d) any leading shape.  Where a plan splits d, the split stays
    (w and its gradient split as d is): the rows' sums of squares are
    all-reduced over the mesh dims that split it, in mesh-dim order."""
    last = x.ndim - 1
    dims = mesh_dims_along(x, last)
    if not dims or x.shape[-1] % math.prod(x.device_mesh.size(i) for i in dims):
        # whole rows (a ragged split of d is gathered, as ``on_local_shards`` does)
        fn = functools.partial(_rmsnorm_rows, eps=eps)
        return on_local_shards(fn, (x, w), range(last), follow=(None, {}))
    groups = tuple(x.device_mesh.get_group(i) for i in dims)
    fn = functools.partial(_rmsnorm_split_rows, eps=eps, d_full=x.shape[-1], groups=groups)
    return on_local_shards(fn, (x, w), range(x.ndim), follow=(None, {last: 0}))
