"""PyTorch/CUDA port of the ``repro`` model stack, for NVIDIA Hopper.

Beside the JAX package and held against it by the ``tests/test_torch_*.py``
suites.  It imports ``torch`` and numpy only: never ``jax`` and nothing of
``repro``.  Where the JAX package has a Pallas TPU kernel, the port has a
kernel written for ``sm_90a`` (``repro_torch.kernels``) with a plain-PyTorch
twin that CPU tensors take.

Entry points (``init_params``, ``init_caches``, ``Engine``,
``python -m repro_torch.launch.serve``, and the DSE's ``torch`` simulation
backends behind ``python -m repro_torch.dse``) run on the card unless the
caller passes ``device="cpu"`` (``--device cpu``); without CUDA a
default-device call raises.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the card unless told otherwise.

    Raises when CUDA is asked for (explicitly or by default) on a host that
    has none: the port never falls back to the CPU on its own.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and CUDA is not available; "
            "pass device='cpu' to run the plain-PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
