"""Hopper kernels of the port, each with its plain-PyTorch twin and a launch
counter: ``flash_attention`` (CUDA C++, ``csrc/flash_attention.cu``) and
``rmsnorm`` (Triton).  Callers use ``repro_torch.kernels.ops``."""
