"""Plain-PyTorch oracles for the ported kernels (the correctness ground truth).

Counterparts of the JAX package's ``kernels/ref.py``: ``attention_ref`` (:12)
and ``rmsnorm_ref`` (:59).  ``ssd_ref`` comes with the Mamba slice.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """Dense masked softmax attention.  q/k/v: (BH, S, hd)."""
    bh, s, hd = q.shape
    t = k.shape[1]
    scale = scale or 1.0 / math.sqrt(hd)
    sc = torch.einsum("bqk,btk->bqt", q.float(), k.float()) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    sc = torch.where(mask[None], sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bqt,btk->bqk", p, v.float()).to(q.dtype)


def rmsnorm_ref(x, w, *, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)
