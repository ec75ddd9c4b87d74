"""Losses.  Cross-entropy upcasts to f32 at the logsumexp only.

Counterpart of the JAX package's ``train/loss.py``.  The JAX
``cross_entropy`` picks the gold logit with an iota-compare masked sum, so
that XLA's partitioner keeps vocab-sharded logits split.  On a plain tensor
the port gathers it, which selects the same value.  Sharded logits (a
``DTensor``) are summed on each rank's rows (``on_local_shards``) and the
per-rank sums added before the mean is taken.  Where the vocabulary is split
it stays split, with the JAX arithmetic (``VocabShardNLL``): the row max an
all-reduce of MAX over the ranks that split it, the sum of ``exp`` an
all-reduce of SUM, the gold logit picked on the shard that holds the label
(the masked sum's one term) and summed, and the backward
``softmax - onehot`` on each rank's shard.  No rank holds a row's whole
vocabulary.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed._functional_collectives as funcol
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel.local_shards import (mesh_dims_along, on_local_shards, replicate,
                                               shard_extent, split_along)


def _nll_sum(logits, labels, ignore_index: int):
    """Sum of -log p(label) over the valid positions, and their count (f32);
    replicated on the logits' mesh when they are a ``DTensor``."""
    v = logits.ndim - 1
    if split_along(logits, v):
        mesh, dims = logits.device_mesh, mesh_dims_along(logits, v)
        fn = functools.partial(_vocab_shard_nll_sum, ignore_index=ignore_index,
                               start=shard_extent(logits, v)[0],
                               groups=tuple(mesh.get_group(i) for i in dims),
                               first=all(mesh.get_coordinate()[i] == 0 for i in dims))
        tot, cnt = on_local_shards(fn, (logits, labels), range(logits.ndim),
                                   follow=(None, {d: d for d in range(v)}), out=({}, {}))
    else:
        tot, cnt = on_local_shards(functools.partial(_local_nll_sum, ignore_index=ignore_index),
                                   (logits, labels), range(v), out=({}, {}))
    return replicate(tot), replicate(cnt)


def _local_nll_sum(logits, labels, ignore_index: int):
    """The masked nll sum and count of rows whose whole vocabulary this rank
    holds: ``VocabShardNLL`` with no group to reduce over."""
    return _vocab_shard_nll_sum(logits, labels, ignore_index, start=0, groups=(), first=True)


def _all_reduce(t, op: str, groups):
    """``t`` reduced over each group in turn (mesh-dim order: the same bits
    on every rank)."""
    for g in groups:
        t = funcol.all_reduce(t, op, g)
        t = t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t
    return t


# rows of bf16 logits whose f32 gradient the backward works on at once: at
# most this many elements (64 MiB), the result cast into the one buffer
NLL_BLOCK = 1 << 24


class VocabShardNLL(torch.autograd.Function):
    """The masked nll sum of the rows of this rank's vocabulary shard
    (columns from ``start``) of its logits, reduced over ``groups``, the
    ranks that split the vocabulary (none where the rank holds the whole
    vocabulary): every rank gets each row's log-sum-exp and gold logit, and
    the ``first`` rank alone returns the sum, so that the sum over the ranks
    is the rows' sum.  The forward's arithmetic is ``torch.logsumexp``'s
    (the max, the sum of ``exp`` of the shifted row, its log plus the max).
    The backward is the gradient of that total on this rank's shard,
    ``(softmax - onehot) * mask * g``, from the saved logits and log-sum-exp,
    written into one buffer of the logits' dtype (computed in f32, by
    blocks of rows for bf16 logits): no collective, and no f32 copy of the
    logits held, where autograd of the plain version keeps several."""

    @staticmethod
    def forward(ctx, logits, labels, mask, start: int, groups, first: bool):
        lf = logits.float()
        m = _all_reduce(lf.amax(dim=-1), "max", groups)
        sumexp = _all_reduce((lf - m[..., None]).exp_().sum(dim=-1), "sum", groups)
        lse = m + torch.log(sumexp)
        col = labels.long() - start
        mine = (col >= 0) & (col < lf.shape[-1])
        col = col.clamp(0, lf.shape[-1] - 1)
        gold = _all_reduce(lf.gather(-1, col[..., None])[..., 0] * mine, "sum", groups)
        ctx.save_for_backward(logits, lse, col, mine, mask)
        return ((lse - gold) * mask).sum() * float(first)

    @staticmethod
    def backward(ctx, g):
        logits, lse, col, mine, mask = ctx.saved_tensors
        scale, onehot = mask * g, -mine.float()
        grad = torch.empty_like(logits, memory_format=torch.contiguous_format)
        if logits.dtype == torch.float32:
            _nll_grad(torch.sub(logits, lse[..., None], out=grad), col, onehot, scale)
        else:
            v = logits.shape[-1]
            flat, out = logits.reshape(-1, v), grad.view(-1, v)
            lse, col, onehot, scale = (t.reshape(-1) for t in (lse, col, onehot, scale))
            step = max(1, NLL_BLOCK // v)
            for i in range(0, flat.shape[0], step):
                rows = slice(i, i + step)
                out[rows] = _nll_grad(flat[rows].float().sub_(lse[rows, None]), col[rows],
                                      onehot[rows], scale[rows])
        return grad, None, None, None, None, None


def _nll_grad(shifted, col, onehot, scale):
    """``(exp(shifted) - onehot) * scale``, in place in ``shifted`` (the
    logits minus their log-sum-exp): the nll's gradient."""
    shifted.exp_().scatter_add_(-1, col[..., None], onehot[..., None])
    return shifted.mul_(scale[..., None])


def _vocab_shard_nll_sum(logits, labels, ignore_index: int, start: int, groups, first: bool):
    """``_local_nll_sum`` on a vocabulary shard (``VocabShardNLL``); the count
    is the first rank's, as the sum is."""
    mask = (labels != ignore_index).float()
    nll = VocabShardNLL.apply(logits, labels.clamp_min(0), mask, start, groups, first)
    return nll, mask.sum() * float(first)


def cross_entropy(logits, labels, ignore_index: int = -1):
    """logits: (B, S, V); labels: (B, S) int.  Returns the mean nll over the
    positions whose label is not ``ignore_index``."""
    tot, cnt = _nll_sum(logits, labels, ignore_index)
    return tot / cnt.clamp_min(1.0)


def chunked_cross_entropy(hidden, head_fn, labels, *, chunk: int = 512,
                          ignore_index: int = -1):
    """CE without ever holding the full (B, S, V) logits.

    hidden: (B, S, D); head_fn(hidden_chunk) -> (B, c, V) logits.  Walks the
    sequence in chunks (``chunk``, halved until it divides S, as the JAX
    version does), each chunk's head projection and logsumexp under
    ``torch.utils.checkpoint``, so the backward recomputes each chunk's
    logits too and never stacks them.
    """
    b, s, d = hidden.shape
    c = min(chunk, s)
    while s % c:
        c //= 2
    tot = cnt = None

    def body(h, lab):
        return _nll_sum(head_fn(h), lab, ignore_index)

    for i in range(0, s, c):
        t, n = checkpoint(body, hidden[:, i:i + c], labels[:, i:i + c], use_reentrant=False,
                          preserve_rng_state=False)
        tot, cnt = (t, n) if tot is None else (tot + t, cnt + n)
    return tot / cnt.clamp_min(1.0)
