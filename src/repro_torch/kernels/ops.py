"""Public wrappers around the kernels, in the JAX package's layouts.

Counterparts of ``kernels/ops.py``: ``mha_flash`` (:24) and
``fused_rmsnorm`` (:63); ``ssd`` comes with the Mamba slice.  A CUDA tensor
goes to the Hopper kernel (or the call raises), a CPU tensor to the kernel's
plain version.  The models call these at every length and every row count:
there is no separate dense or pure-torch model path.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm


def mha_flash(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None):
    """q: (B, S, H, hd); k/v: (B, T, G, hd) (GQA groups).  Returns (B,S,H,hd).

    Any S and T.  Unlike the JAX wrapper, which hands block multiples to its
    kernel, the kernel here masks the ragged edge of its tiles itself and
    masks keys by the true T.
    """
    return flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def fused_rmsnorm(x, w, *, eps: float = 1e-5):
    """x: (..., d) any leading shape."""
    shape = x.shape
    return rmsnorm(x.reshape(-1, shape[-1]), w, eps=eps).reshape(shape)
