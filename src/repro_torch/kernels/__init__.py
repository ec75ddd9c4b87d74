"""Hopper kernels of the port, each with its plain-PyTorch twin and a launch
counter, all CUDA C++ under ``csrc/``: ``flash_attention`` (forward, and its
backward ``flash_attention_bwd``), ``rmsnorm`` (forward and ``rmsnorm_bwd``)
and ``ssd_scan`` (forward and ``ssd_scan_bwd``), which the models call
through ``repro_torch.kernels.ops``; and ``dse_sim`` (``dse_class_times``,
``dse_sweep``), which the DSE's ``torch`` simulation backend calls."""
