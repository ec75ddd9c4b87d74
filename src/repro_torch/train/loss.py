"""Losses.  Cross-entropy upcasts to f32 at the logsumexp only.

Counterpart of the JAX package's ``train/loss.py``.  The JAX
``cross_entropy`` picks the gold logit with an iota-compare masked sum, for
the sake of XLA's partitioner on vocab-sharded logits; the port gathers it,
which selects the same value.  Sharded logits (a ``DTensor``) are summed on
each rank's rows with the vocabulary gathered (``on_local_shards``), and the
per-rank sums added before the mean is taken.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel.local_shards import on_local_shards, replicate


def _nll_sum(logits, labels, ignore_index: int):
    """Sum of -log p(label) over the valid positions, and their count (f32);
    replicated on the logits' mesh when they are a ``DTensor``."""
    tot, cnt = on_local_shards(functools.partial(_local_nll_sum, ignore_index=ignore_index),
                               (logits, labels), range(logits.ndim - 1), out=({}, {}))
    return replicate(tot), replicate(cnt)


def _local_nll_sum(logits, labels, ignore_index: int):
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels != ignore_index).float()
    return ((lse - gold) * mask).sum(), mask.sum()


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
