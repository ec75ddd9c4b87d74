"""Plain reference of Mamba2 (``mamba2-130m``): the published block
(in-projection to z, x, B, C and dt; a depthwise causal conv with SiLU over
x, B and C; the SSD scan with the D skip; RMSNorm of y * SiLU(z); the out
projection), pre-norm residual layers, a final RMSNorm and the head tied to
the embedding.  Departures from the published model are the configuration
file's ``assumed`` list (no conv bias).

The scan is the chunked SSD form (chunks of ``CHUNK`` positions, the last
one ragged), in float32: inside a chunk the quadratic dual form, across
chunks the state.  Every function takes the parameters as the flat
``{path: tensor}`` of ``param_defs``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from gpubench.reference import common

CHUNK = 256


def dims(cfg: dict) -> dict:
    d = cfg["d_model"]
    din = cfg["ssm_expand"] * d
    return dict(d=d, din=din, g=cfg["ssm_groups"], n=cfg["ssm_state"], p=cfg["ssm_head_dim"],
                h=din // cfg["ssm_head_dim"], cw=cfg["ssm_conv"], v=cfg["vocab_size"])


def param_defs(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(path, shape, init) of every weight, in the order the configuration
    draws them: the layers, the final norm, the embedding."""
    k = dims(cfg)
    d, din, gn, h, cw = k["d"], k["din"], k["g"] * k["n"], k["h"], k["cw"]
    out = []
    for i in range(cfg["n_layers"]):
        pre = f"stack.{i}."
        out += [(pre + "norm1", (d,), "zeros")]
        out += [(pre + "mixer." + name, shape, init) for name, shape, init in (
            ("w_z", (d, din), "normal"), ("w_x", (d, din), "normal"),
            ("w_b", (d, gn), "normal"), ("w_c", (d, gn), "normal"),
            ("w_dt", (d, h), "normal"), ("conv_x", (cw, din), "normal"),
            ("conv_b", (cw, gn), "normal"), ("conv_c", (cw, gn), "normal"),
            ("a_log", (h,), "ssm_a_log"), ("dt_bias", (h,), "ssm_dt_bias"),
            ("d_skip", (h,), "ones"), ("norm", (din,), "zeros"), ("w_out", (din, d), "normal"))]
    return out + [("final_norm", (d,), "zeros"), ("embed", (k["v"], d), "normal")]


def causal_conv(x, w):
    """Depthwise causal conv along the sequence, then SiLU.  x (B, S, C),
    w (cw, C): output t sums w[j] x[t - cw + 1 + j]."""
    cw, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    return F.silu(sum(pad[:, j:j + s] * w[j] for j in range(cw)))


def ssd(x, dt, a, b, c):
    """y_t = C_t h_t with h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T, in
    chunks.  x (B, S, H, P), dt (B, S, H), a (H,), b/c (B, S, G, N)."""
    bsz, s, h, p = x.shape
    rep = h // b.shape[2]
    state = x.new_zeros((bsz, h, p, b.shape[3]))
    ys = []
    for c0 in range(0, s, CHUNK):
        sl = slice(c0, min(c0 + CHUNK, s))
        xi, dti = x[:, sl], dt[:, sl]
        bi = b[:, sl].repeat_interleave(rep, dim=2)
        ci = c[:, sl].repeat_interleave(rep, dim=2)
        cum = torch.cumsum(dti * a, dim=1)                            # (B, L, H)
        ln = xi.shape[1]
        seg = cum[:, :, None, :] - cum[:, None, :, :]                 # (B, L, L, H): t, u
        causal = torch.ones(ln, ln, dtype=torch.bool, device=x.device).tril()
        decay = torch.where(causal[None, :, :, None], seg, -torch.inf).exp()
        scores = torch.einsum("bthn,buhn->btuh", ci, bi) * decay
        xdt = xi * dti[..., None]
        y = torch.einsum("btuh,buhp->bthp", scores, xdt)
        y = y + torch.einsum("bthn,bhpn->bthp", ci * cum.exp()[..., None], state)
        to_end = (cum[:, -1:] - cum).exp()                            # (B, L, H)
        state = state * cum[:, -1].exp()[..., None, None] + torch.einsum(
            "buhn,buhp->bhpn", bi * (dti * to_end)[..., None], xi)
        ys.append(y)
    return torch.cat(ys, dim=1)


def mixer(p: dict, pre: str, h, cfg: dict):
    k = dims(cfg)
    bsz, s, _ = h.shape
    w = lambda name: p[pre + name]
    z = h @ w("w_z")
    x = causal_conv(h @ w("w_x"), w("conv_x"))
    b = causal_conv(h @ w("w_b"), w("conv_b"))
    c = causal_conv(h @ w("w_c"), w("conv_c"))
    dt = F.softplus(h @ w("w_dt") + w("dt_bias"))
    xh = x.view(bsz, s, k["h"], k["p"])
    y = ssd(xh, dt, -torch.exp(w("a_log")), b.view(bsz, s, k["g"], k["n"]),
            c.view(bsz, s, k["g"], k["n"]))
    y = (y + xh * w("d_skip")[:, None]).reshape(bsz, s, k["din"])
    return common.rmsnorm(y * F.silu(z), w("norm"), cfg["norm_eps"]) @ w("w_out")


def layer(p: dict, i: int, x, cfg: dict):
    pre = f"stack.{i}."
    return x + mixer(p, pre + "mixer.", common.rmsnorm(x, p[pre + "norm1"], cfg["norm_eps"]),
                     cfg)


def hidden(p: dict, tokens, cfg: dict):
    """Final-normed hidden states (B, S, D) of token ids (B, S); each layer
    checkpointed under autograd."""
    x = p["embed"][tokens.long()]
    for i in range(cfg["n_layers"]):
        x = common.checkpointed(lambda x, i=i: layer(p, i, x, cfg), x)
    return common.rmsnorm(x, p["final_norm"], cfg["norm_eps"])


def head(p: dict, h, cfg: dict):
    return h @ p["embed"].T


def loss(p: dict, batch: dict, cfg: dict):
    """The training loss: mean next-token NLL (no auxiliary term)."""
    return common.cross_entropy(head(p, hidden(p, batch["inputs"], cfg), cfg), batch["labels"])


def served_logits(p: dict, tokens, n_prompt: int, positions, cfg: dict):
    """Logits (B, len(positions), V) at ``positions`` of the full causal pass
    over ``tokens`` (B, S): a recurrent model's prefill and decode are the
    one scan, whatever ``n_prompt`` is."""
    h = hidden(p, tokens, cfg)
    return head(p, h[:, positions], cfg)
