"""The port's serving path vs the JAX package's, and the port's boundaries:
no JAX and nothing of ``repro`` inside it, no silent fall-back to the CPU."""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import from_jax_params
from repro_torch.models import model as M
from repro_torch.serve.engine import Engine
from test_torch_models import seeded_jax_params

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], env=env, capture_output=True, text=True,
                          timeout=120, **kw)


def test_greedy_generate_matches_jax_engine():
    _greedy_matches_jax("qwen2-1.5b")


def test_greedy_generate_of_mamba2_matches_jax_engine():
    """Prefill through the SSD scan's plain version, decode through the
    recurrence, token for token against the JAX Engine."""
    _greedy_matches_jax("mamba2-130m")


def test_greedy_generate_of_gemma3_matches_jax_engine():
    """Sliding-window layers with ring caches (window 16): a 40-token prompt,
    then 24 tokens that wrap the ring, token for token."""
    _greedy_matches_jax("gemma3-1b", prompt=40, new=24)


def test_greedy_generate_of_granite_moe_matches_jax_engine():
    """MoE FFNs: prefill routes groups of 16 tokens, decode groups of one."""
    _greedy_matches_jax("granite-moe-3b-a800m")


def test_greedy_generate_of_jamba_matches_jax_engine():
    """The hybrid: attention, Mamba and MoE layers in one stack, with a
    full-cache attention layer and Mamba conv/SSM caches."""
    _greedy_matches_jax("jamba-v0.1-52b")


def _greedy_matches_jax(arch, prompt=16, new=8):
    jspec, spec = jreduced(JARCHS[arch]), reduced(ARCHS[arch])
    jp = seeded_jax_params(jspec)
    prompts = np.random.default_rng(7).integers(0, spec.vocab_size, (2, prompt)).astype(np.int32)
    expect, _ = JEngine(jspec, jp).generate(prompts, max_new=new)
    eng = Engine(spec, from_jax_params(jp, spec, device="cpu"), device="cpu")
    got, stats = eng.generate(prompts, max_new=new)
    np.testing.assert_array_equal(got, expect)
    assert stats.tokens_out == 2 * new and stats.prefill_s > 0 and stats.decode_s > 0


def test_sampling_is_seeded():
    spec = reduced(ARCHS["qwen2-1.5b"])
    eng = Engine(spec, M.init_params(spec, 0, device="cpu"), device="cpu")
    prompts = np.zeros((2, 4), np.int32)
    a, _ = eng.generate(prompts, max_new=6, temperature=1.0, seed=1)
    b, _ = eng.generate(prompts, max_new=6, temperature=1.0, seed=1)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < spec.vocab_size
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(np.zeros((1, 250), np.int32), max_new=8)


def test_serve_cli_runs_on_cpu():
    r = _run(["-m", "repro_torch.launch.serve", "--reduced", "--device", "cpu",
              "--batch", "2", "--new", "4"])
    assert r.returncode == 0, r.stderr
    assert "[serve] cpu" in r.stdout and "request 1:" in r.stdout


def test_serve_cli_runs_mamba2_on_cpu():
    r = _run(["-m", "repro_torch.launch.serve", "--arch", "mamba2-130m", "--reduced",
              "--device", "cpu", "--batch", "2", "--prompt-len", "70", "--new", "4"])
    assert r.returncode == 0, r.stderr
    assert "[serve] cpu" in r.stdout and "request 1:" in r.stdout


@pytest.mark.parametrize("arch,prompt", [
    ("gemma3-1b", 40),             # past the reduced window of 16
    ("granite-moe-3b-a800m", 16),
], ids=["gemma3-1b", "granite-moe-3b-a800m"])
def test_serve_cli_runs_on_cpu_per_arch(arch, prompt):
    r = _run(["-m", "repro_torch.launch.serve", "--arch", arch, "--reduced",
              "--device", "cpu", "--batch", "2", "--prompt-len", str(prompt), "--new", "4"])
    assert r.returncode == 0, r.stderr
    assert "[serve] cpu" in r.stdout and "request 1:" in r.stdout


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = reduced(ARCHS["qwen2-1.5b"])
    params = M.init_params(spec, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(spec, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_params(spec, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_caches(spec, 1, 8)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    r = _run([str(ROOT / "chip_smoke.py")])
    assert r.returncode != 0 and "CUDA is not available" in r.stderr
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        yield ".".join(p for p in rel.parts if p != "__init__")


def test_every_module_imports_without_jax_or_repro():
    mods = list(_modules())
    assert {"repro_torch.kernels.ssd_scan", "repro_torch.models.mamba",
            "repro_torch.models.moe", "repro_torch.train.train_step", "repro_torch.train.loss",
            "repro_torch.train.optimizer", "repro_torch.ckpt.checkpoint",
            "repro_torch.data.pipeline", "repro_torch.runtime.fault",
            "repro_torch.launch.train", "repro_torch.core.env",
            "repro_torch.core.backends.torch_backend", "repro_torch.dse",
            "repro_torch.kernels.dse_sim", "repro_torch.launch.dryrun",
            "repro_torch.core.bridge", "repro_torch.core.hlo_analysis"} <= set(mods)
    assert "repro_torch.kernels.flash_attention" in mods and len(mods) >= 22
    code = ("import sys\nsys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "assert not any(n == 'jax' or n.startswith(('jax.', 'repro.')) "
            "for n, v in sys.modules.items() if v is not None)\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr


def test_no_port_file_imports_jax_or_repro():
    pat = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders


def test_no_port_module_imports_triton():
    """Every kernel of the port is CUDA C++: no module imports ``triton``, at
    the top or inside a function, and each imports with it blocked."""
    pat = re.compile(r"^\s*(from|import)\s+triton(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert not [str(f) for f in files if pat.search(f.read_text())]
    code = ("import sys\nsys.modules['triton'] = None\nimport importlib\n"
            f"for m in {list(_modules())!r}:\n    importlib.import_module(m)\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
