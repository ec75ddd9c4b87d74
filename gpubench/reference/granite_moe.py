"""Plain reference of the GraniteMoe decoder (``granite-moe-3b-a800m``):
pre-norm layers of grouped-query attention with RoPE (half-split rotation)
and a top-k routed mixture of SwiGLU experts, a final RMSNorm and an
untied head.  Departures from the published model are the configuration
file's ``assumed`` list (no muP multipliers, an untied head, capacity
drops).

Routing: softmax over the experts, the top k renormalised over the k.  An
expert takes at most ``capacity`` assignments of a group of tokens (the
``moe`` settings of the configuration: ``group_size`` tokens of one row,
halved until it divides the row's length; capacity ``group * k * factor /
E`` rounded up to a multiple of 8, at least 8); within a group an
assignment's place counts the expert's assignments of earlier routing slots
first, then those of earlier tokens in the same slot, and an assignment
whose place is past the capacity is dropped.  Serving routes the prompt so
and each decoded token alone (a group of one, which drops nothing).  The
load-balance loss is the Switch loss over the top-1 choice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpubench.reference import common


def dims(cfg: dict) -> dict:
    hd = cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]
    return dict(d=cfg["d_model"], h=cfg["n_heads"], g=cfg["n_kv_heads"], hd=hd,
                f=cfg["d_ff"], e=cfg["n_experts"], k=cfg["top_k"], v=cfg["vocab_size"])


def param_defs(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(path, shape, init) of every weight, in the configuration's order."""
    k = dims(cfg)
    d, h, g, hd, f, e = k["d"], k["h"], k["g"], k["hd"], k["f"], k["e"]
    out = []
    for i in range(cfg["n_layers"]):
        pre = f"stack.{i}."
        out += [(pre + "norm1", (d,), "zeros"),
                (pre + "mixer.wq", (d, h, hd), "normal"), (pre + "mixer.wk", (d, g, hd), "normal"),
                (pre + "mixer.wv", (d, g, hd), "normal"), (pre + "mixer.wo", (h, hd, d), "normal"),
                (pre + "norm2", (d,), "zeros"),
                (pre + "ffn.router", (d, e), "normal"), (pre + "ffn.w_gate", (e, d, f), "normal"),
                (pre + "ffn.w_up", (e, d, f), "normal"), (pre + "ffn.w_down", (e, f, d), "normal")]
    return out + [("final_norm", (d,), "zeros"), ("embed", (k["v"], d), "normal"),
                  ("lm_head", (d, k["v"]), "normal")]


def rope(x, theta: float):
    """x (B, S, H, hd) at positions 0..S-1, halves rotated."""
    s, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, pre: str, x, cfg: dict):
    k = dims(cfg)
    b, s, d = x.shape
    q = (x @ p[pre + "wq"].reshape(d, -1)).view(b, s, k["h"], k["hd"])
    kk = (x @ p[pre + "wk"].reshape(d, -1)).view(b, s, k["g"], k["hd"])
    v = (x @ p[pre + "wv"].reshape(d, -1)).view(b, s, k["g"], k["hd"])
    q, kk = rope(q, cfg["rope_theta"]), rope(kk, cfg["rope_theta"])
    rep = k["h"] // k["g"]
    kk, v = kk.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, kk) / math.sqrt(k["hd"])
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -torch.inf), dim=-1)
    o = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, -1)
    return o @ p[pre + "wo"].reshape(-1, d)


def group_size(s: int, largest: int) -> int:
    tg = min(largest, s) if s > 1 else 1
    while s % tg:
        tg //= 2
    return tg


def capacity(tg: int, cfg: dict) -> int:
    cap = int(tg * cfg["top_k"] * cfg["moe"]["capacity_factor"] / cfg["n_experts"])
    return max(8, -(-cap // 8) * 8)


def kept(top_i, e: int, tg: int, cap: int):
    """Which of a row's assignments (B, S, k) an expert takes, groups of
    ``tg`` tokens along S each counted apart."""
    b, s, k = top_i.shape
    grp = top_i.view(b, s // tg, tg, k).transpose(2, 3).reshape(b, s // tg, k * tg)
    onehot = F.one_hot(grp, e)                                    # slot-major order
    place = (torch.cumsum(onehot, dim=2) - onehot).gather(3, grp[..., None])[..., 0]
    return (place < cap).view(b, s // tg, k, tg).transpose(2, 3).reshape(b, s, k)


def moe(p: dict, pre: str, x, cfg: dict, n_grouped: int):
    """(y, load-balance loss).  The first ``n_grouped`` positions of each row
    are routed in capacity groups, the rest one token at a time."""
    k = dims(cfg)
    b, s, d = x.shape
    probs = torch.softmax(x @ p[pre + "router"], dim=-1)
    top_w, top_i = torch.topk(probs, k["k"], dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    keep = torch.ones_like(top_i, dtype=torch.bool)
    if n_grouped:
        tg = group_size(n_grouped, cfg["moe"]["group_size"])
        keep[:, :n_grouped] = kept(top_i[:, :n_grouped], k["e"], tg, capacity(tg, cfg))
    n = b * s
    top1 = F.one_hot(top_i[..., 0], k["e"]).float().sum(dim=(0, 1))
    lb = k["e"] * torch.sum((top1 / n) * (probs.sum(dim=(0, 1)) / n))
    flat, y = x.reshape(n, d), torch.zeros(n, d, dtype=x.dtype, device=x.device)
    weight = (top_w * keep).reshape(n, k["k"])
    ids = top_i.reshape(n, k["k"])
    for e in range(k["e"]):
        tok, slot = torch.nonzero((ids == e) & keep.reshape(n, k["k"]), as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = flat[tok]
        he = F.silu(xe @ p[pre + "w_gate"][e]) * (xe @ p[pre + "w_up"][e])
        y = y.index_add(0, tok, (he @ p[pre + "w_down"][e]) * weight[tok, slot, None])
    return y.view(b, s, d), lb


def layer(p: dict, i: int, x, cfg: dict, n_grouped: int):
    pre, eps = f"stack.{i}.", cfg["norm_eps"]
    x = x + attention(p, pre + "mixer.", common.rmsnorm(x, p[pre + "norm1"], eps), cfg)
    y, lb = moe(p, pre + "ffn.", common.rmsnorm(x, p[pre + "norm2"], eps), cfg, n_grouped)
    return x + y, lb


def hidden(p: dict, tokens, cfg: dict, n_grouped: int):
    """(final-normed hidden states (B, S, D), summed load-balance loss)."""
    x = p["embed"][tokens.long()]
    aux = x.new_zeros(())
    for i in range(cfg["n_layers"]):
        x, lb = common.checkpointed(lambda x, i=i: layer(p, i, x, cfg, n_grouped), x)
        aux = aux + lb
    return common.rmsnorm(x, p["final_norm"], cfg["norm_eps"]), aux


def head(p: dict, h, cfg: dict):
    return h @ p["lm_head"]


def loss(p: dict, batch: dict, cfg: dict):
    """The training loss: mean next-token NLL plus the load-balance term."""
    tokens = batch["inputs"]
    h, aux = hidden(p, tokens, cfg, tokens.shape[1])
    return common.cross_entropy(head(p, h, cfg), batch["labels"]) + cfg["lb_weight"] * aux


def served_logits(p: dict, tokens, n_prompt: int, positions, cfg: dict):
    """Logits at ``positions`` of the causal pass over ``tokens`` (B, S):
    the first ``n_prompt`` routed as the prompt's prefill routes them, the
    rest one token at a time, as decode does."""
    h, _ = hidden(p, tokens, cfg, n_prompt)
    return head(p, h[:, positions], cfg)
