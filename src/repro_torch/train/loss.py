"""Losses.  Cross-entropy upcasts to f32 at the logsumexp only.

Counterpart of the JAX package's ``train/loss.py``.  The JAX
``cross_entropy`` picks the gold logit with an iota-compare masked sum, for
the sake of XLA's partitioner on vocab-sharded logits; the port shards
nothing and gathers it, which selects the same value.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _nll_sum(logits, labels, ignore_index: int):
    """Sum of -log p(label) over the valid positions, and their count (f32)."""
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
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)

    def body(h, lab):
        return _nll_sum(head_fn(h), lab, ignore_index)

    for i in range(0, s, c):
        t, n = checkpoint(body, hidden[:, i:i + c], labels[:, i:i + c], use_reentrant=False,
                          preserve_rng_state=False)
        tot, cnt = tot + t, cnt + n
    return tot / cnt.clamp_min(1.0)
