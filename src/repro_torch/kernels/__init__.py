"""Hopper kernels of the port, each with its plain-PyTorch twin and a launch
counter, all CUDA C++ under ``csrc/``: ``flash_attention`` (forward, and its
backward ``flash_attention_bwd``), ``rmsnorm`` (forward and ``rmsnorm_bwd``)
and ``ssd_scan`` (forward only).  Callers use ``repro_torch.kernels.ops``."""
