#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:
  build        compile the port's three CUDA sources (flash attention,
               RMSNorm, the SSD scan) from this checkout, one nvcc each, in
               parallel
  kernels      hold each kernel against its plain version on the card, at the
               serving paths' shapes plus windowed, ragged and grouped cases,
               in float32 and bfloat16 (flash attention also at gemma3's
               head_dim 256, global and at its window of 512, and at
               granite's shape; RMSNorm at each path's widths; the SSD scan
               also with the model's dt
               and a ranges); time kernel, plain version and one PyTorch
               library call where one exists (a yardstick the port never
               calls; kernel and library events times are medians of five
               runs taken in turns).  Flash attention's f32 rows carry two
               bounds: f32 on the CUDA cores, and 3xTF32 on the tensor cores
               (three TF32 products per f32 one, the least the card needs at
               f32 accuracy).  The SSD scan is three launches per call, each row
               split by kernel name: ssd_scan_chunk_state (each chunk's
               state contribution and decay into a scratch buffer, whose
               bytes the row gives), ssd_scan_state_pass (the chain over
               chunks: the state entering each chunk, and the final state)
               and ssd_scan_output_f32 or _bf16 (y from the chunk's scores
               and its entering state)
  serve        each model at full width and depth (random weights from a seed)
               through repro_torch.serve.engine.Engine, fp32, greedy, batch 4,
               32 new tokens: qwen2-1.5b (prompt 1000), mamba2-130m (4096),
               gemma3-1b (2040: past its 512-token window, ragged against the
               128-row tile, decode crossing ring slot 0 at 2048) and
               granite-moe-3b-a800m (1024: four routing groups of 256 per
               sequence); counts each run's kernel launches, every count set
               to 0 just before it
  consistency  per model, last-position logits of prefill over S tokens vs
               prefill over S-1 tokens plus one decode step (the prefill
               kernels vs plain decode), and the reduced model on the card vs
               the CPU.  MoE models compare prefill and decode at capacity
               factor 8, as tests/test_archs.py does: with capacity drops the
               two compute different functions by design (a 1024-token
               prefill routes groups of 256 that can overflow an expert, the
               1023-token one groups of 1 that cannot), and that gap is
               printed beside the check
Then the card's name and power limit, one JSON line with every kernel's
numbers, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero without that last line, as does a host without CUDA or a directory
that holds this script and nothing else of the repository.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet: HBM3 rate; dense peaks of f32 on the CUDA
# cores and of bf16 and TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
ARCH, BATCH, PROMPT, NEW, SEED = "qwen2-1.5b", 4, 1000, 32, 0
MAMBA, M_PROMPT = "mamba2-130m", 4096
GEMMA, G_PROMPT = "gemma3-1b", 2040
GRANITE, R_PROMPT = "granite-moe-3b-a800m", 1024
NO_DROP_CAPACITY = 8.0  # capacity factor at which no group can overflow an expert
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # allclose atol = rtol, per dtype
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# SSD scan: max |got - want| / max |want| of y per dtype; the f32 state at 1e-4
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CONSISTENCY_TOL = 1e-3  # fp32 logits; two paths summing in other orders over 24-28 layers


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


def paired_ms(kernel, lib, iters: int, rounds: int = 5) -> tuple[float, float]:
    """CUDA-events ms of ``kernel`` and ``lib``, each the median of ``rounds``
    runs taken in turns (kernel, lib, lib, kernel, ...): a host-bound call's
    events time drifts with the host between runs, so the two are compared
    only side by side."""
    got: tuple[list[float], list[float]] = ([], [])
    for r in range(rounds):
        for which in ((0, 1) if r % 2 == 0 else (1, 0)):
            got[which].append(cuda_ms((kernel, lib)[which], iters))
    return sorted(got[0])[rounds // 2], sorted(got[1])[rounds // 2]


def device_by_kernel(fn, iters: int) -> dict[str, float]:
    """Device ms per call of ``fn``, by kernel name, from a torch.profiler
    trace (empty if the trace holds no device time).  Unlike ``cuda_ms`` it
    leaves out the gaps where the card waits for the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.device_time_total:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3 / iters
    return by_name


def device_ms(fn, iters: int) -> float | None:
    """Device time per call of the kernels ``fn`` launches (None if not measured)."""
    return sum(device_by_kernel(fn, iters).values()) or None


KERNEL_CLASSES = {"gemm": ("gemm", "xmma", "cutlass"), "ssd_scan": ("ssd_scan",),
                  "flash_attention": ("flash_fwd",), "rmsnorm": ("rmsnorm",),
                  # gathers, scatters, top-k and running sums: the MoE's routing
                  # and dispatch, the embedding's gather, mamba2's cumsums
                  "index_scan": ("index", "gather", "scatter", "topk", "sort", "scan")}


def by_class(by_name: dict[str, float]) -> dict[str, float]:
    """Device ms by kernel class; whatever matches no class is ``other``."""
    out = dict.fromkeys([*KERNEL_CLASSES, "other"], 0.0)
    for name, ms in by_name.items():
        low = name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES.items() if any(k in low for k in keys)),
                   "other")
        out[cls] += ms
    return out


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
    flops = 4.0 * hd * pairs * b * h
    bound_ms, bound_by = bound(nbytes, flops, name)
    extra = {}
    if name == "float32":  # the kernel runs f32 as three TF32 products on the tensor cores
        extra["bound_3xtf32_ms"], extra["bound_3xtf32_by"] = bound(nbytes, 3 * flops, "tf32")
    ms, library_ms = paired_ms(kernel, lib, iters)
    row = dict(
        case=f"flash_attention {name} B={b} S={s} T={t} H={h} G={g} hd={hd} causal window={window}",
        max_abs_err=err, tol=TOL[name], ok=bool(ok),
        ms=ms, device_ms=device_ms(kernel, iters),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True, window=window),
                         iters),
        library_ms=library_ms, library_device_ms=device_ms(lib, iters),
        library_max_abs_err=lib_err,
        bound_ms=bound_ms, bound_by=bound_by, **extra)
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
    ms, library_ms = paired_ms(kernel, lib, iters)
    row = dict(
        case=f"rmsnorm {name} rows={rows} d={d}", max_abs_err=err, tol=RMS_TOL[name],
        ok=bool(ok), ms=ms, device_ms=device_ms(kernel, iters),
        plain_ms=cuda_ms(lambda: ref.rmsnorm_ref(x, w), iters),
        library_ms=library_ms, library_device_ms=device_ms(lib, iters),
        bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernels] {json.dumps(row)}")
    return row


def ssd_inputs(torch, b, s, h, g, p, n, dtype, ranges):
    """``model``: dt in [1e-3, 1e-1] and a in [-16, -1], the init kinds'
    ranges, whose memory spans many chunks.  ``random``: the JAX tests' dt =
    softplus(randn) and a = -exp(randn), which forget within a few steps."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    if ranges == "model":
        u = torch.rand((b, s, h), generator=gen, device="cuda")
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        a = -(1.0 + 15.0 * torch.rand((h,), generator=gen, device="cuda"))
    else:
        dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
        a = -torch.exp(torch.randn((h,), generator=gen, device="cuda"))
    bb = torch.randn((b, s, g, n), generator=gen, device="cuda").to(dtype)
    cc = torch.randn((b, s, g, n), generator=gen, device="cuda").to(dtype)
    return x, dt, a, bb, cc


def check_ssd(torch, ss, b, s, h, g, p, n, dtype, ranges, iters):
    args = ssd_inputs(torch, b, s, h, g, p, n, dtype, ranges)
    y, st = ss.ssd_scan(*args)
    want_y, want_st = ss.ssd_scan_plain(*args)
    torch.cuda.synchronize()
    name = dtype_name(dtype)
    err = (y.float() - want_y.float()).abs().max().item()
    rel = err / want_y.float().abs().max().item()
    rel_state = ((st - want_st).abs().max() / want_st.abs().max()).item()
    x, dt, a, bb, cc = args
    esize = x.element_size()
    nbytes = ((x.numel() + y.numel() + bb.numel() + cc.numel()) * esize
              + (dt.numel() + a.numel() + st.numel()) * 4)
    # the least work of the function, the sequential recurrence: per token and
    # (batch, head), a multiply-add per state element to add B (x dt) into the
    # state and one to read y = C h out; the decay's multiply is left out, so
    # this stays a lower bound.  The chunked form's score tiles do more.
    flops = 4.0 * s * n * p * b * h
    bound_ms, bound_by = bound(nbytes, flops, name)
    kernel = lambda: ss.ssd_scan(*args)
    # the three launches of one call, by kernel name (without namespace and
    # template arguments)
    phases: dict[str, float] = {}
    for kname, ms in device_by_kernel(kernel, iters).items():
        short = re.search(r"ssd_scan\w*", kname)
        kname = short.group(0) if short else kname
        phases[kname] = phases.get(kname, 0.0) + ms
    row = dict(
        case=f"ssd_scan {name} {ranges} ranges B={b} S={s} H={h} G={g} P={p} N={n}",
        max_abs_err=err, rel_err=rel, rel_err_state=rel_state, tol=SSD_TOL[name],
        ok=bool(rel <= SSD_TOL[name] and rel_state <= SSD_TOL["float32"]),
        ms=cuda_ms(kernel, iters), device_ms=sum(phases.values()) or None,
        device_ms_by_kernel=phases,
        scratch_bytes=4 * ss.scratch_floats(b, s, h, p, n),
        plain_ms=cuda_ms(lambda: ss.ssd_scan_plain(*args), 1, warmup=0),
        library_ms=None, library_note="no single PyTorch call computes the SSD scan",
        bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernels] {json.dumps(row)}")
    return row


def serve(torch, np, M, Engine, counted, param_count, card, spec, prompt, want):
    """One full-width ``Engine.generate`` (B=BATCH, NEW new tokens, fp32,
    greedy) with every launch count set to 0 just before it; fails unless the
    counts are ``want``.  Returns (params, prompts, launches)."""
    t0 = time.perf_counter()
    params = M.init_params(spec, SEED, device="cuda")
    torch.cuda.synchronize()
    n_params, n_defs = param_count(params), param_count(M.model_param_defs(spec))
    if n_params != n_defs:
        fail(f"{n_params} parameters initialised, the defs declare {n_defs}")
    # ArchSpec.param_count() leaves out dt_bias: the reference's formula
    # (JAX configs/base.py:154) counts two per-head vectors per Mamba layer,
    # A_log and D, where the defs have three; the gap is n_layers x ssm_heads
    n_mamba = sum(ld.mixer == "mamba" for ld in spec.layer_defs())
    if n_params - spec.param_count() != n_mamba * spec.ssm_heads:
        fail(f"{n_params} parameters, the spec says {spec.param_count()}")
    print(f"[serve] {spec.name} full width: {n_params} parameters (fp32) initialised on the "
          f"card in {time.perf_counter() - t0:.3f} s; spec.param_count() {spec.param_count()}")
    eng = Engine(spec, params, max_len=prompt + NEW, dtype=torch.float32, device="cuda")
    prompts = np.random.default_rng(SEED).integers(
        0, spec.vocab_size, (BATCH, prompt)).astype(np.int32)
    eng.generate(prompts, max_new=2)  # warm-up: cuBLAS handles, allocator
    for fn in counted.values():
        fn.launches = 0
    out, stats = eng.generate(prompts, max_new=NEW)
    launches = {name: fn.launches for name, fn in counted.items()}
    if launches != want:
        fail(f"{spec.name}: kernel launches in one generate: {launches}, expected {want}")
    if out.shape != (BATCH, NEW) or out.min() < 0 or out.max() >= spec.vocab_size:
        fail(f"generated tokens out of range: shape {out.shape}, [{out.min()}, {out.max()}]")
    print(f"[serve] {card} | {spec.name} generate B={BATCH} prompt={prompt} new={NEW} fp32: "
          f"prefill {stats.prefill_s * 1e3:.3f} ms, decode {stats.decode_tok_per_s:.3f} tok/s "
          f"({stats.decode_s * 1e3 / NEW:.3f} ms/step); launches {launches} (expected {want}); "
          f"first tokens {out[0, :8].tolist()}")
    tok = torch.as_tensor(prompts, device="cuda")
    f32 = torch.float32
    caches = M.init_caches(spec, BATCH, prompt + NEW, dtype=f32, device="cuda")
    pre = device_by_kernel(lambda: M.prefill(params, tok, caches, spec, compute_dtype=f32), 2)
    step = device_by_kernel(lambda: M.decode_step(params, caches, tok[:, -1], prompt, spec,
                                                  compute_dtype=f32), 8)

    def share(by_name, wall_ms):
        if not by_name:
            return "not measured"
        dev = sum(by_name.values())
        classes = ", ".join(f"{c} {ms:.3f}" for c, ms in by_class(by_name).items())
        return f"{dev:.3f} ms = {dev / wall_ms:.3f} of its wall ({classes} ms)"
    print(f"[serve] {spec.name} device busy (torch.profiler): prefill "
          f"{share(pre, stats.prefill_s * 1e3)}; decode step "
          f"{share(step, stats.decode_s * 1e3 / NEW)}")
    top = sorted(pre.items(), key=lambda kv: -kv[1])[:6]
    print(f"[serve] {spec.name} prefill's largest device kernels (ms): "
          + "; ".join(f"{name[:80]} {ms:.3f}" for name, ms in top))
    return params, prompts, launches


def prefill_vs_decode(torch, M, spec, params, tok):
    """Max |logits| gap of prefill over S tokens and prefill over S-1 plus one
    decode step, and the former's logits."""
    s, f32 = tok.shape[1], torch.float32
    caches = M.init_caches(spec, BATCH, s, dtype=f32, device="cuda")
    full, _ = M.prefill(params, tok, caches, spec, compute_dtype=f32)
    caches = M.init_caches(spec, BATCH, s, dtype=f32, device="cuda")
    _, caches = M.prefill(params, tok[:, :-1], caches, spec, compute_dtype=f32)
    step, _ = M.decode_step(params, caches, tok[:, -1], s - 1, spec, compute_dtype=f32)
    return (full - step).abs().max().item(), full


def consistency(torch, M, moem, map_with_path, reduced, spec, params, prompts):
    """Prefill(S) vs prefill(S-1) + one decode step at full width (an MoE at
    a capacity that drops nothing), then the reduced model on the card vs the
    CPU's plain path."""
    tok = torch.as_tensor(prompts, device="cuda")
    s = tok.shape[1]
    at = ""
    if spec.n_experts:
        gap, _ = prefill_vs_decode(torch, M, spec, params, tok)
        print(f"[consistency] {spec.name} at capacity factor {moem.CAPACITY_FACTOR} (drops): "
              f"prefill(S={s}) vs prefill(S-1)+decode_step differ by {gap:.3e}, by design")
        default, moem.CAPACITY_FACTOR = moem.CAPACITY_FACTOR, NO_DROP_CAPACITY
        at = f" at capacity factor {NO_DROP_CAPACITY} (no drops)"
        try:
            err, full = prefill_vs_decode(torch, M, spec, params, tok)
        finally:
            moem.CAPACITY_FACTOR = default
    else:
        err, full = prefill_vs_decode(torch, M, spec, params, tok)
    if full.shape != (BATCH, spec.vocab_size) or not bool(torch.isfinite(full).all()):
        fail(f"prefill logits: shape {tuple(full.shape)}, finite {bool(torch.isfinite(full).all())}")
    print(f"[consistency] {spec.name}{at} prefill(S={s}) vs prefill(S-1)+decode_step: "
          f"max_abs_err {err:.3e} (tol {CONSISTENCY_TOL}), max |logit| {full.abs().max().item():.3e}")
    if not err <= CONSISTENCY_TOL:
        fail(f"{spec.name}: prefill and decode disagree")
    small = reduced(spec)
    cpu_params = M.init_params(small, SEED, device="cpu")
    gpu_params = map_with_path(lambda _, t: t.cuda(), cpu_params)
    small_tok = torch.as_tensor(prompts[:2, :200] % small.vocab_size)
    on_cpu, aux_cpu = M.forward(cpu_params, small_tok, small)
    on_gpu, aux_gpu = M.forward(gpu_params, small_tok.cuda(), small)
    err_small = (on_cpu - on_gpu.cpu()).abs().max().item()
    err_aux = abs(aux_cpu.item() - aux_gpu.item())
    print(f"[consistency] reduced {spec.name} forward B=2 S=200: "
          f"card vs CPU plain path max_abs_err {err_small:.3e} (tol 1e-4), "
          f"aux {aux_gpu.item():.6f} vs {aux_cpu.item():.6f}")
    if not (err_small <= 1e-4 and err_aux <= 1e-4):
        fail(f"{spec.name}: the card's forward disagrees with the CPU's")


def nvidia_smi() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]  # card 0, the one this run uses


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
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import model as M
    from repro_torch.models import moe as moem
    from repro_torch.models.layers import map_with_path, param_count
    from repro_torch.serve.engine import Engine

    card = nvidia_smi()
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
    print(f"[build] nvcc {sorted(logs) or 'cached'}: {time.perf_counter() - t0:.3f} s")

    # -- kernels ---------------------------------------------------------------
    spec, mspec, gspec, rspec = get_arch(ARCH), get_arch(MAMBA), get_arch(GEMMA), get_arch(GRANITE)
    h, g, hd, d = spec.n_heads, spec.n_kv_heads, spec.resolved_head_dim, spec.d_model
    mh, mg, mp, mn = mspec.ssm_heads, mspec.ssm_groups, mspec.ssm_head_dim, mspec.ssm_state
    gh, gg, ghd, gw = gspec.n_heads, gspec.n_kv_heads, gspec.resolved_head_dim, gspec.sliding_window
    small = reduced(mspec)
    rows, ssd_rows = [], []
    named = {}  # (dtype, case) -> row, for the report
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        for key, args, iters in (
                ("qwen2", (BATCH, PROMPT, PROMPT, h, g, hd, 0), 10),
                ("qwen2 window 256", (BATCH, PROMPT, PROMPT, h, g, hd, 256), 10),
                ("qwen2 ragged 200", (BATCH, 200, 200, h, g, hd, 0), 20),
                # gemma3's prefill: 4 global layers and 22 at its window
                ("gemma3 global", (BATCH, G_PROMPT, G_PROMPT, gh, gg, ghd, 0), 10),
                (f"gemma3 window {gw}", (BATCH, G_PROMPT, G_PROMPT, gh, gg, ghd, gw), 10),
                ("hd256 ragged 200", (BATCH, 200, 200, gh, gg, ghd, 0), 20),
                ("granite", (BATCH, R_PROMPT, R_PROMPT, rspec.n_heads, rspec.n_kv_heads,
                             rspec.resolved_head_dim, 0), 10)):
            named[name, key] = check_flash(torch, F, fa, *args, dtype, iters)
            rows.append(named[name, key])
        for key, (n_rows, width), iters in (
                ("qwen2 prefill", (BATCH * PROMPT, d), 100), ("qwen2 decode", (BATCH, d), 200),
                ("gemma3 prefill", (BATCH * G_PROMPT, gspec.d_model), 100),
                ("gemma3 decode", (BATCH, gspec.d_model), 200),
                ("granite prefill", (BATCH * R_PROMPT, rspec.d_model), 100)):
            named[name, key] = check_rmsnorm(torch, F, rn, ref, n_rows, width, dtype, iters)
            rows.append(named[name, key])
        for ranges in ("model", "random"):
            for b, s, sh, sg, sp, sn, iters in (
                    (BATCH, M_PROMPT, mh, mg, mp, mn, 10),   # mamba2-130m prefill
                    (BATCH, 1000, mh, mg, mp, mn, 20),       # ragged S
                    (BATCH, 2048, 8, 2, 64, 16, 20),         # grouped, jamba's widths
                    (2, 1000, small.ssm_heads, 1, small.ssm_head_dim, small.ssm_state, 20)):
                ssd_rows.append(check_ssd(torch, ss, b, s, sh, sg, sp, sn, dtype, ranges, iters))
    bad = [r["case"] for r in rows + ssd_rows if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    print(f"[kernels] all {len(rows) + len(ssd_rows)} cases within tolerance")

    # -- serve, then consistency, per model ------------------------------------
    counted = {"flash_attention": fa.flash_attention, "rmsnorm": rn.rmsnorm,
               "ssd_scan": ss.ssd_scan}

    def attention_counts(model_spec):
        # per layer: flash once in prefill; norm1 and norm2 in prefill and in
        # each decode step, and the final norm
        return {"flash_attention": model_spec.n_layers, "ssd_scan": 0,
                "rmsnorm": (2 * model_spec.n_layers + 1) * (1 + NEW)}

    by_path = {}
    for model_spec, prompt, want in (
            (spec, PROMPT, attention_counts(spec)),
            # per layer: norm1 and the mixer's gated norm; no FFN, no attention
            (mspec, M_PROMPT, {"flash_attention": 0, "ssd_scan": mspec.n_layers,
                               "rmsnorm": (2 * mspec.n_layers + 1) * (1 + NEW)}),
            (gspec, G_PROMPT, attention_counts(gspec)),
            (rspec, R_PROMPT, attention_counts(rspec))):
        params, prompts, by_path[model_spec.name] = serve(
            torch, np, M, Engine, counted, param_count, card, model_spec, prompt, want)
        consistency(torch, M, moem, map_with_path, reduced, model_spec, params, prompts)
        del params
        torch.cuda.empty_cache()

    # -- report ------------------------------------------------------------------
    print(f"[device] {card}")
    case_keys = ("case", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                 "bound_3xtf32_ms", "library_ms")

    def numbers(r):
        return {key: r[key] for key in case_keys if key in r}

    # more: the kernel at the other shapes of its paths, and bf16 flash
    flash_more = [("bfloat16", "qwen2")] + [
        (name, key) for key in ("gemma3 global", f"gemma3 window {gw}", "hd256 ragged 200")
        for name in ("float32", "bfloat16")] + [("float32", "granite")]
    norm_more = [("float32", key) for key in ("qwen2 decode", "gemma3 prefill", "gemma3 decode",
                                              "granite prefill")]
    kernels = [
        dict(name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:76",
             case=named["float32", "qwen2"], more=[named[k] for k in flash_more]),
        dict(name="rmsnorm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:23",
             case=named["float32", "qwen2 prefill"], more=[named[k] for k in norm_more]),
        dict(name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:71", case=ssd_rows[0], more=[]),
    ]
    for k in kernels:
        r, more = k.pop("case"), k.pop("more")
        per_path = {path: counts[k["name"]] for path, counts in by_path.items()}
        k.update(launches=sum(per_path.values()), launches_by_path=per_path, **numbers(r))
        if more:
            k["more_cases"] = [numbers(m) for m in more]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
