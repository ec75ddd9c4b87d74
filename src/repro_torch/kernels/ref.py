"""Plain-PyTorch oracles for the ported kernels (the correctness ground truth).

Counterparts of the JAX package's ``kernels/ref.py``: ``attention_ref`` (:12),
``ssd_ref`` (:32) and ``rmsnorm_ref`` (:59).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None, q_offset: int = 0):
    """Dense masked softmax attention.  q/k/v: (BH, S, hd); query row i at
    position ``q_offset + i`` and key j at j (the JAX ``flash_attention_ref``
    with ``positions = q_offset + arange(S)``)."""
    bh, s, hd = q.shape
    t = k.shape[1]
    scale = scale or 1.0 / math.sqrt(hd)
    sc = torch.einsum("bqk,btk->bqt", q.float(), k.float()) * scale
    qpos = q_offset + torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    sc = torch.where(mask[None], sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bqt,btk->bqk", p, v.float()).to(q.dtype)


def ssd_ref(x, dt, a, b, c):
    """Naive sequential SSM recurrence (the mathematical definition).

    x: (BH,S,hd); dt: (BH,S); a: (BH,); b,c: (BH,S,ds).  Returns y (BH,S,hd)
    of x.dtype and the final f32 state (BH,ds,hd).
    h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t (outer) b_t ;  y_t = h_t c_t
    """
    bh, s, hd = x.shape
    ds = b.shape[-1]
    xf, dtf, af, bf, cf = (t.float() for t in (x, dt, a, b, c))
    h = torch.zeros((bh, ds, hd), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * af)
        h = decay[:, None, None] * h + bf[:, t, :, None] * (dtf[:, t, None] * xf[:, t])[:, None, :]
        ys.append(torch.einsum("bnh,bn->bh", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def rmsnorm_ref(x, w, *, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def rmsnorm_part_ref(x, w=None, g=None):
    """A row's sum over the columns ``x`` holds (rows, d), in f32: of ``x^2``,
    or with ``w`` and ``g`` of ``g * (1 + w) * x`` (the split-row mode's
    partial sums, S forward and T backward)."""
    xf = x.float()
    if g is None:
        return (xf * xf).sum(dim=-1)
    return (g.float() * (1.0 + w.float()) * xf).sum(dim=-1)


def rmsnorm_apply_ref(x, w, ss, *, d_full: int, eps: float = 1e-5):
    """``rmsnorm_ref`` of a row's columns from its sum of squares over the
    whole row ``ss`` (rows,), ``d_full`` wide."""
    r = torch.rsqrt(ss / d_full + eps)[:, None]
    return (x.float() * r * (1.0 + w.float())).to(x.dtype)


def rmsnorm_split_bwd_ref(x, w, g, ss, st, *, d_full: int, eps: float = 1e-5):
    """The gradient of ``rmsnorm_apply_ref`` on a row's columns, from the
    whole row's sums ``ss`` (of x^2) and ``st`` (of g * (1 + w) * x):
    dx = r g (1 + w) - x r^3 st / d_full with r = rsqrt(ss / d_full + eps),
    and dw summed over these rows.  Returns dx (x.dtype), dw (w.dtype)."""
    xf, gf, w1 = x.float(), g.float(), 1.0 + w.float()
    r = torch.rsqrt(ss / d_full + eps)[:, None]
    coef = r * r * r * (st / d_full)[:, None]
    dx = r * (gf * w1) - xf * coef
    dw = (gf * xf * r).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)
