#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:
  build        compile the port's kernels from the sources in this checkout
  kernels      hold each kernel against its plain version on the card, at the
               serving path's shapes plus a windowed and a ragged case, in
               float32 and bfloat16; time kernel, plain version and one
               PyTorch library call (a yardstick the port never calls)
  serve        qwen2-1.5b at full width (random weights from a seed) through
               repro_torch.serve.engine.Engine: batch 4, prompt 1000, 32 new
               tokens, fp32; counts the kernel launches of that run
  consistency  last-position logits of prefill over S tokens vs prefill over
               S-1 tokens plus one decode step (the flash kernel vs plain
               decode attention), and reduced qwen2 on the card vs the CPU
Then the card's name and power limit, one JSON line with every kernel's
numbers, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero without that last line, as does a host without CUDA or a directory
that holds this script and nothing else of the repository.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet: HBM3 rate; dense peaks of f32 on the CUDA
# cores and of bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}
ARCH, BATCH, PROMPT, NEW, SEED = "qwen2-1.5b", 4, 1000, 32, 0
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # allclose atol = rtol, per dtype
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CONSISTENCY_TOL = 1e-3  # fp32 logits; two paths summing in other orders over 28 layers


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float | None:
    """Device time per call of the kernels ``fn`` launches, summed from a
    torch.profiler trace (None if the trace holds no device time).  Unlike
    ``cuda_ms`` it leaves out the gaps where the card waits for the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters if us else None


def dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_flash(torch, F, fa, b, s, t, h, g, hd, window, dtype, iters):
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((b, n, heads, hd), generator=gen, device="cuda").to(dtype)
               for n, heads in ((s, h), (t, g), (t, g)))
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    name = dtype_name(dtype)
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=TOL[name], rtol=TOL[name])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    qpos = torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(t, device="cuda")[None, :]
    band = (kpos <= qpos) & ((kpos > qpos - window) if window else True)
    mask = dict(attn_mask=band) if window else dict(is_causal=True)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **mask)
    kernel = lambda: fa.flash_attention(q, k, v, causal=True, window=window)
    lib_err = (lib().transpose(1, 2).float() - want.float()).abs().max().item()
    pairs = int(band.sum().item())
    nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) * q.element_size()
    bound_ms, bound_by = bound(nbytes, 4.0 * hd * pairs * b * h, name)
    row = dict(
        case=f"flash_attention {name} B={b} S={s} T={t} H={h} G={g} hd={hd} causal window={window}",
        max_abs_err=err, tol=TOL[name], ok=bool(ok),
        ms=cuda_ms(kernel, iters), device_ms=device_ms(kernel, iters),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True, window=window),
                         iters),
        library_ms=cuda_ms(lib, iters), library_device_ms=device_ms(lib, iters),
        library_max_abs_err=lib_err,
        bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernels] {json.dumps(row)}")
    return row


def check_rmsnorm(torch, F, rn, ref, rows, d, dtype, iters):
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = (torch.randn((rows, d), generator=gen, device="cuda") * 3).to(dtype)
    w = (torch.randn((d,), generator=gen, device="cuda") * 0.1).to(dtype)
    got = rn.rmsnorm(x, w)
    want = ref.rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    name = dtype_name(dtype)
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=RMS_TOL[name], rtol=RMS_TOL[name])
    w1 = 1.0 + w
    kernel = lambda: rn.rmsnorm(x, w)
    lib = lambda: F.rms_norm(x, (d,), weight=w1, eps=1e-5)
    nbytes = (2 * x.numel() + w.numel()) * x.element_size()
    bound_ms, bound_by = bound(nbytes, 4.0 * rows * d, name)
    row = dict(
        case=f"rmsnorm {name} rows={rows} d={d}", max_abs_err=err, tol=RMS_TOL[name],
        ok=bool(ok), ms=cuda_ms(kernel, iters), device_ms=device_ms(kernel, iters),
        plain_ms=cuda_ms(lambda: ref.rmsnorm_ref(x, w), iters),
        library_ms=cuda_ms(lib, iters), library_device_ms=device_ms(lib, iters),
        bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernels] {json.dumps(row)}")
    return row


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import _build, flash_attention as fa, ref, rmsnorm as rn
    from repro_torch.models import model as M
    from repro_torch.models.layers import map_with_path, param_count
    from repro_torch.serve.engine import Engine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]  # card 0, the one this run uses

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[build] torch {torch.__version__} cuda {torch.version.cuda} "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    for name in _build.sources():
        if not _build.library_path(name).exists():
            fail(f"csrc/{name}.cu did not build")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {name}: {line.strip()}")
    x = torch.ones((2, 8), device="cuda")
    rn.rmsnorm(x, torch.zeros(8, device="cuda"))  # Triton compiles on first launch
    torch.cuda.synchronize()
    print(f"[build] nvcc {sorted(logs) or 'cached'} + triton rmsnorm: "
          f"{time.perf_counter() - t0:.3f} s")

    # -- kernels ---------------------------------------------------------------
    spec = get_arch(ARCH)
    h, g, hd, d = spec.n_heads, spec.n_kv_heads, spec.resolved_head_dim, spec.d_model
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(check_flash(torch, F, fa, BATCH, PROMPT, PROMPT, h, g, hd, 0, dtype, 10))
        rows.append(check_flash(torch, F, fa, BATCH, PROMPT, PROMPT, h, g, hd, 256, dtype, 10))
        rows.append(check_flash(torch, F, fa, BATCH, 200, 200, h, g, hd, 0, dtype, 20))
        rows.append(check_rmsnorm(torch, F, rn, ref, BATCH * PROMPT, d, dtype, 100))
        rows.append(check_rmsnorm(torch, F, rn, ref, BATCH, d, dtype, 200))
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    print(f"[kernels] all {len(rows)} cases within tolerance")

    # -- serve -----------------------------------------------------------------
    t0 = time.perf_counter()
    params = M.init_params(spec, SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = param_count(params)
    if n_params != spec.param_count():
        fail(f"{n_params} parameters, the spec says {spec.param_count()}")
    print(f"[serve] {ARCH} full width: {n_params} parameters (fp32) initialised on the card "
          f"in {time.perf_counter() - t0:.3f} s")
    eng = Engine(spec, params, max_len=PROMPT + NEW, dtype=torch.float32, device="cuda")
    prompts = np.random.default_rng(SEED).integers(
        0, spec.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    eng.generate(prompts, max_new=2)  # warm-up: cuBLAS handles, allocator
    fa.flash_attention.launches = 0
    rn.rmsnorm.launches = 0
    out, stats = eng.generate(prompts, max_new=NEW)
    launches = {"flash_attention": fa.flash_attention.launches, "rmsnorm": rn.rmsnorm.launches}
    want = {"flash_attention": spec.n_layers, "rmsnorm": (2 * spec.n_layers + 1) * (1 + NEW)}
    if launches != want:
        fail(f"kernel launches in one generate: {launches}, expected {want}")
    if out.shape != (BATCH, NEW) or out.min() < 0 or out.max() >= spec.vocab_size:
        fail(f"generated tokens out of range: shape {out.shape}, [{out.min()}, {out.max()}]")
    print(f"[serve] {card} | generate B={BATCH} prompt={PROMPT} new={NEW} fp32: "
          f"prefill {stats.prefill_s * 1e3:.3f} ms, decode {stats.decode_tok_per_s:.3f} tok/s "
          f"({stats.decode_s * 1e3 / NEW:.3f} ms/step); launches {launches} (expected {want}); "
          f"first tokens {out[0, :8].tolist()}")
    tok = torch.as_tensor(prompts, device="cuda")
    f32 = torch.float32
    caches = M.init_caches(spec, BATCH, PROMPT + NEW, dtype=f32, device="cuda")
    pre_dev = device_ms(lambda: M.prefill(params, tok, caches, spec, compute_dtype=f32), 2)
    step_dev = device_ms(lambda: M.decode_step(params, caches, tok[:, -1], PROMPT, spec,
                                               compute_dtype=f32), 8)

    def share(dev, wall_ms):
        return "not measured" if dev is None else f"{dev:.3f} ms = {dev / wall_ms:.3f} of its wall"
    print(f"[serve] device busy (torch.profiler): prefill {share(pre_dev, stats.prefill_s * 1e3)}; "
          f"decode step {share(step_dev, stats.decode_s * 1e3 / NEW)}")

    # -- consistency -------------------------------------------------------------
    caches = M.init_caches(spec, BATCH, PROMPT, dtype=f32, device="cuda")
    full, _ = M.prefill(params, tok, caches, spec, compute_dtype=f32)
    caches = M.init_caches(spec, BATCH, PROMPT, dtype=f32, device="cuda")
    _, caches = M.prefill(params, tok[:, :-1], caches, spec, compute_dtype=f32)
    step, _ = M.decode_step(params, caches, tok[:, -1], PROMPT - 1, spec, compute_dtype=f32)
    if full.shape != (BATCH, spec.vocab_size) or not bool(torch.isfinite(full).all()):
        fail(f"prefill logits: shape {tuple(full.shape)}, finite {bool(torch.isfinite(full).all())}")
    err = (full - step).abs().max().item()
    print(f"[consistency] {ARCH} prefill(S={PROMPT}) vs prefill(S-1)+decode_step: "
          f"max_abs_err {err:.3e} (tol {CONSISTENCY_TOL}), max |logit| {full.abs().max().item():.3e}")
    if not err <= CONSISTENCY_TOL:
        fail("prefill and decode disagree")
    small = reduced(spec)
    cpu_params = M.init_params(small, SEED, device="cpu")
    gpu_params = map_with_path(lambda _, t: t.cuda(), cpu_params)
    small_tok = torch.as_tensor(prompts[:2, :200] % small.vocab_size)
    on_cpu = M.forward(cpu_params, small_tok, small)
    on_gpu = M.forward(gpu_params, small_tok.cuda(), small).cpu()
    err_small = (on_cpu - on_gpu).abs().max().item()
    print(f"[consistency] reduced {ARCH} forward B=2 S=200 hd={small.resolved_head_dim}: "
          f"card vs CPU plain path max_abs_err {err_small:.3e} (tol 1e-4)")
    if not err_small <= 1e-4:
        fail("the card's forward disagrees with the CPU's")

    # -- report ------------------------------------------------------------------
    print(f"[device] {card}")
    main_flash, main_rms = rows[0], rows[3]
    kernels = [
        dict(name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:76", case=main_flash["case"]),
        dict(name="rmsnorm", route="triton", source="src/repro_torch/kernels/rmsnorm.py",
             replaces="src/repro/kernels/rmsnorm.py:23", case=main_rms["case"]),
    ]
    for k, r in zip(kernels, (main_flash, main_rms)):
        k.update(launches=launches[k["name"]], max_abs_err=r["max_abs_err"], ms=r["ms"],
                 device_ms=r["device_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                 library_ms=r["library_ms"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
