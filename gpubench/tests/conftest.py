"""The benchmark's own tests (run them by path: ``pytest gpubench/tests``).
Tests that need the card are marked ``cuda`` and decide inside the test."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the reduced shapes the CPU tests run each configuration at
SMALL = {
    "mamba2-130m": {"n_layers": 2, "d_model": 64, "vocab_size": 256, "ssm_state": 16,
                    "ssm_head_dim": 16},
    "granite-moe-3b-a800m": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
                             "d_ff": 32, "vocab_size": 256, "n_experts": 8, "top_k": 2},
}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
