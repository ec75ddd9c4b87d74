"""Compute-device roofline model (the paper's Compute knob: peak-perf,
local-mem-bw, memory-capacity)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Device:
    name: str
    peak_tflops: float       # TFLOP/s (bf16)
    mem_bw_gbps: float       # GB/s HBM
    mem_capacity_gb: float   # GB

    def op_time_us(self, flops: float, bytes_accessed: float) -> float:
        """max(compute, memory) — the roofline."""
        t_c = flops / (self.peak_tflops * 1e12)
        t_m = bytes_accessed / (self.mem_bw_gbps * 1e9)
        return max(t_c, t_m) * 1e6

    def op_times_us(self, flops: np.ndarray, bytes_accessed: np.ndarray) -> np.ndarray:
        """Vectorized roofline over whole traces; float64 arithmetic matches
        the scalar path bit for bit."""
        t_c = np.asarray(flops, dtype=np.float64) / (self.peak_tflops * 1e12)
        t_m = np.asarray(bytes_accessed, dtype=np.float64) / (self.mem_bw_gbps * 1e9)
        return np.maximum(t_c, t_m) * 1e6

    def ridge_intensity(self) -> float:
        """FLOP/byte at which the device turns compute-bound."""
        return (self.peak_tflops * 1e12) / (self.mem_bw_gbps * 1e9)


# Paper Table 3 compute knobs (perf in TFLOPS, BW in GB/s; 24 GB validity cap
# comes from Section 5.4 and is enforced by the memory model).
SYSTEM_1_DEVICE = Device("system1-tpu-v5p", 459.0, 2765.0, 24.0)
SYSTEM_2_DEVICE = Device("system2-npu", 10.0, 50.0, 24.0)
SYSTEM_3_DEVICE = Device("system3-h100", 900.0, 3000.0, 24.0)

# Our dry-run/roofline target (per task sheet): TPU v5e-like.
TPU_V5E = Device("tpu-v5e", 197.0, 819.0, 16.0)

DEVICES = {d.name: d for d in (SYSTEM_1_DEVICE, SYSTEM_2_DEVICE, SYSTEM_3_DEVICE, TPU_V5E)}
