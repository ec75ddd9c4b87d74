"""What every plain reference shares: the seeded initial weights, RMSNorm,
the loss and AdamW, in plain PyTorch (float32, no kernels).

``init_leaves`` draws the weights as the port's configuration states them:
one ``torch.Generator`` on the device, seeded with the run's seed, each leaf
in tree order (``normal`` leaves scaled by 1 / sqrt(fan-in), the SSM's
``a_log`` and ``dt_bias`` by their published ranges, norms at zero under the
``1 + w`` scale).  A reference lists its leaves as ``(path, shape, init)``.
"""
from __future__ import annotations

import math
from typing import Iterator

import torch
import torch.nn.functional as F


def draw(shape, init: str, gen: torch.Generator, device) -> torch.Tensor:
    """One leaf, drawn from ``gen`` as the configuration's init kind says."""
    if init == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if init == "ssm_a_log":  # A = -exp(a_log) uniform in [-16, -1]
        u = torch.empty(shape, dtype=torch.float32, device=device)
        return u.uniform_(1.0, 16.0, generator=gen).log_()
    if init == "ssm_dt_bias":  # softplus(dt_bias) log-uniform in [1e-3, 1e-1]
        u = torch.empty(shape, dtype=torch.float32, device=device).uniform_(generator=gen)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))
    if init != "normal":
        raise ValueError(f"unknown init kind {init!r}")
    fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
    x = torch.empty(shape, dtype=torch.float32, device=device)
    return x.normal_(generator=gen).mul_(1.0 / math.sqrt(fan_in))


def init_leaves(defs, seed: int, device, *, nudge: bool = False
                ) -> Iterator[tuple[str, torch.Tensor]]:
    """(path, leaf) for each of ``defs``' (path, shape, init), drawn in order
    from one generator on ``device`` seeded with ``seed``: one leaf at a
    time, so a caller that compares leaf by leaf holds one.  ``nudge``:
    every weight one float32 step up (the witness of how far rounding alone
    carries the reference)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for path, shape, init in defs:
        leaf = draw(shape, init, gen, device)
        yield path, torch.nextafter(leaf, torch.full_like(leaf, math.inf)) if nudge else leaf


def init_params(defs, seed: int, device, *, nudge: bool = False) -> dict[str, torch.Tensor]:
    return dict(init_leaves(defs, seed, device, nudge=nudge))


def rmsnorm(x, w, eps: float):
    """x / rms(x) * (1 + w), in float32."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + w)


def cross_entropy(logits, labels):
    """Mean negative log-likelihood over every position."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           labels.reshape(-1).long())


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_ratio`` of the rate."""
    lr, warm = opt["lr"], opt["warmup_steps"]
    if step < warm:
        return lr * step / max(warm, 1)
    frac = min(max((step - warm) / max(opt["decay_steps"] - warm, 1), 0.0), 1.0)
    lo = opt["min_lr_ratio"] * lr
    return lo + 0.5 * (lr - lo) * (1 + math.cos(math.pi * frac))


class AdamW:
    """AdamW with global-norm clipping and decoupled weight decay, one leaf
    at a time (``opt``: the configuration's ``adamw`` settings)."""

    def __init__(self, params: dict[str, torch.Tensor], opt: dict):
        self.opt, self.step = opt, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]):
        """Clips ``grads`` in place and updates ``params``; returns the
        clipped gradients' norms by leaf."""
        o = self.opt
        gnorm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        clip = min(1.0, o["grad_clip"] / (gnorm + 1e-9)) if o["grad_clip"] else 1.0
        self.step += 1
        lr = lr_at(o, self.step)
        bc1, bc2 = 1 - o["b1"] ** self.step, 1 - o["b2"] ** self.step
        norms = {}
        for k, p in params.items():
            g = grads[k] * clip
            norms[k] = float(g.double().norm())
            self.m[k].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            self.v[k].mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
            upd = (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + o["eps"]) \
                + o["weight_decay"] * p
            p.sub_(lr * upd)
        return norms


def checkpointed(fn, *args):
    """``fn(*args)`` saving only its inputs for the backward, which runs it
    again: one layer's activations held at a time."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)
