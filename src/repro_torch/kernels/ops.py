"""Public wrappers around the kernels, in the JAX package's layouts.

Counterparts of ``kernels/ops.py``: ``mha_flash`` (:24), ``ssd`` (:43) and
``fused_rmsnorm`` (:63).  A CUDA tensor goes to the Hopper kernel (or the
call raises), a CPU tensor to the kernel's plain version.  The models call
these at every length and every row count: there is no separate dense or
pure-torch model path.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan


def mha_flash(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None):
    """q: (B, S, H, hd); k/v: (B, T, G, hd) (GQA groups).  Returns (B,S,H,hd).

    Any S and T.  Unlike the JAX wrapper, which hands block multiples to its
    kernel, the kernel here masks the ragged edge of its tiles itself and
    masks keys by the true T.
    """
    return flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def ssd(x, dt, a, b, c):
    """Model layout: x (B,S,H,P); dt (B,S,H) f32; a (H,) f32; b/c (B,S,G,N).
    Returns y (B,S,H,P) and the final state (B,H,P,N) in f32.

    Any S, and no ``chunk`` argument: the kernel picks its own chunk and
    masks the ragged last one.  Unlike the JAX wrapper, nothing is repeated
    over groups or transposed: the kernel reads the model layout.
    """
    return ssd_scan(x, dt, a, b, c)


def fused_rmsnorm(x, w, *, eps: float = 1e-5):
    """x: (..., d) any leading shape."""
    shape = x.shape
    return rmsnorm(x.reshape(-1, shape[-1]), w, eps=eps).reshape(shape)
