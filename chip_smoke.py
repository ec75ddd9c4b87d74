#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines each:
  build        compile the port's six CUDA sources (flash attention forward
               and backward, RMSNorm forward and backward, the SSD scan
               forward and backward, the DSE's simulation kernels) from this
               checkout, one nvcc each, in parallel
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
               and its entering state).  Flash attention at head_dim 96
               (phi-3-vision-4.2b, 32 heads).  The backward kernels: flash
               attention's (up to four launches, each row's device ms split
               by kernel: flash_bwd_delta, D = rowsum(dO o O) and the padded
               log-sum-exp; flash_bwd_dkdv, keys as rows; flash_bwd_dq; and
               under GQA flash_bwd_group_sum, each group's heads added) at
               qwen2's, gemma3's (global and window 512), granite's and
               phi-3's shapes against autograd through the plain version,
               timed beside SDPA's backward (torch.autograd.grad), with a
               bound of 10 hd flops per unmasked pair (f32 as 3xTF32);
               RMSNorm's (rmsnorm_bwd_rows_kernel, dx with each block's dw
               column sums, then rmsnorm_bwd_dw) at the train paths' rows
               (qwen2's; mamba2-130m's at d_model and at the mixer's gated
               norm's d_inner) against autograd through the plain version
               and through F.rms_norm, and its time at the train shape with its grid
               capped at several block counts; the SSD scan's (five
               launches on the tensor cores, each row's device ms split by
               kernel: ssd_bwd_chunk_grad, each chunk's share of the state
               gradient; ssd_bwd_state_pass, the chain over chunks in
               reverse; ssd_bwd_dxbc, dx, ddt and da per chunk and head and
               dB and dC per head-block; ssd_bwd_group_sum and ssd_bwd_da)
               at mamba2-130m's train shape and at a ragged grouped shape
               against autograd through the plain version, with a bound of
               8 S N P flops per (batch, head) (f32 as 3xTF32, then on the
               CUDA cores) and the scratch's bytes; every backward row also run twice on
               the same inputs, which must give the same gradients bit for
               bit; and ops.ssd under grad on the card: one forward and one
               backward call, gradients against the plain version's
  dse          the design-space explorer's main path: the JAX package's
               backend benchmark population (benchmarks/fig10_agents.py:
               49-107, rebuilt here: 32 seeded collective/network design
               points, qwen2-1.5b on system2 under a pinned request stream of
               256 requests, a 25,872-op trace) through CosmicEnv.step_batch
               on the reference backend (one generation, the oracle),
               torch-unfused and torch (three generations each; pts/s, ms a
               generation, the last_timings split, each kernel's device ms
               and the copies' by torch.profiler), every member's reward and
               latency within 1e-9 of the oracle; the launch counts of the
               torch generations, every count set to 0 just before them;
               dse_class_times and dse_sweep at these shapes against their
               plain twins on the card and numpy's batched duration pass, bit
               for bit, twice for the same bits, with bytes and float64
               bounds and the sweep's chain of dependency levels; then 256
               members on torch, 32 of them held against the oracle; then
               python -m repro_torch.dse run examples/studies/smoke.json on
               torch against reference
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
  train        qwen2-1.5b at full width and depth (random weights from a
               seed), f32, B=4, S=1024, SyntheticLM batches, remat "dots",
               AdamW with warmup 2, through repro_torch.train: 6 steps with
               the launch counts set to 0 just before them; each step's loss
               finite and every parameter's gradient finite and not all zero;
               step ms (median of the last 4), tokens/s, peak memory, device
               busy share and device ms by kernel class (torch.profiler, one
               step); from one state and batch, loss and grad norm under
               remat "none" and "full" against "dots" (rtol 1e-5); the
               trained full-width state (params, m, v, step: 18.5 GB)
               through repro_torch.ckpt save and restore, exactly; then a
               reduced qwen2 step on the card against the CPU, and a reduced
               bf16 state's round trip (bf16 params with their f32 master);
               then all of that again for mamba2-130m at B=4, S=4096 (the
               SSD scan forward and backward; launch counts by layer kind)
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
# NVIDIA H100 SXM data sheet: HBM3 rate; dense peaks of f32 and f64 on the
# CUDA cores and of bf16 and TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12,
                   "float64": 34e12}  # float64 on the CUDA cores
ARCH, BATCH, PROMPT, NEW, SEED = "qwen2-1.5b", 4, 1000, 32, 0
MAMBA, M_PROMPT = "mamba2-130m", 4096
GEMMA, G_PROMPT = "gemma3-1b", 2040
GRANITE, R_PROMPT = "granite-moe-3b-a800m", 1024
NO_DROP_CAPACITY = 8.0  # capacity factor at which no group can overflow an expert
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # allclose atol = rtol, per dtype
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# SSD scan: max |got - want| / max |want| of y per dtype; the f32 state at 1e-4
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRACE_TRIES = 3  # torch.profiler traces taken before a device time counts as not measured
TRACES = {"taken": 0, "empty": 0}  # traces taken, and those without device events
CONSISTENCY_TOL = 1e-3  # fp32 logits; two paths summing in other orders over 24-28 layers
PHI3 = "phi-3-vision-4.2b"  # head_dim 96
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 4, 1024, 6, 2
M_TRAIN_SEQ = 4096  # mamba2-130m's train sequence
REMAT_TOL = 1e-5  # loss and grad norm of remat none/full vs dots, relative
# the reduced train step, card vs CPU: loss rtol, grads rtol / atol
STEP_TOL = {"loss": 1e-4, "grad_rtol": 1e-3, "grad_atol": 1e-5}
# the DSE: the backend benchmark's population (benchmarks/fig10_agents.py:
# 49-107) of DSE_POINTS members over a request stream of DSE_REQUESTS,
# then DSE_BIG members of which DSE_CHECKED are held against the oracle
DSE_ARCH, DSE_SYSTEM, DSE_REQUESTS = "qwen2-1.5b", "system2", 256
DSE_POINTS, DSE_BIG, DSE_CHECKED, DSE_REPEATS = 32, 256, 32, 3
DSE_RTOL = 1e-9  # the issue-order sweep vs the event loop, as the JAX backend's parity tests
# the sweep's chain estimate: an fp64 max or add issues FP64_DEP_CYCLES after
# the one it depends on (an assumed latency), at the H100 SXM's boost clock
FP64_DEP_CYCLES, SM_CLOCK_HZ = 8, 1.98e9


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
    by_name: dict[str, float] = {}
    for _ in range(TRACE_TRIES):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and e.device_time_total:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3 / iters
        TRACES["taken"] += 1
        if by_name:
            break
        TRACES["empty"] += 1
    return by_name


def device_ms(fn, iters: int) -> float | None:
    """Device time per call of the kernels ``fn`` launches (None if not measured)."""
    return sum(device_by_kernel(fn, iters).values()) or None


def device_ms_split(fn, iters: int, prefix: str) -> dict[str, float]:
    """Device ms per call of ``fn``'s kernels by short name: the first
    ``prefix``... identifier of each kernel's name (without namespace and
    template arguments)."""
    phases: dict[str, float] = {}
    for kname, ms in device_by_kernel(fn, iters).items():
        short = re.search(prefix + r"\w*", kname)
        kname = short.group(0) if short else kname
        phases[kname] = phases.get(kname, 0.0) + ms
    return phases


def same_bits(torch, a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


KERNEL_CLASSES = {"gemm": ("gemm", "xmma", "cutlass"), "ssd_scan": ("ssd_scan",),
                  "ssd_scan_bwd": ("ssd_bwd",),
                  "flash_attention": ("flash_fwd",), "flash_attention_bwd": ("flash_bwd",),
                  "rmsnorm": ("rmsnorm_rows", "rmsnorm_wide"), "rmsnorm_bwd": ("rmsnorm_bwd",),
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


def rel_close(torch, got, want, tol: float) -> tuple[float, float, bool]:
    """(max |got - want|, that over max |want|, allclose at rtol = tol and
    atol = tol * max |want|): a gradient's element sums products that
    cancel, so rounding shows against the tensor's scale."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    return err, err / max(scale, 1e-30), bool(torch.allclose(got, want, rtol=tol,
                                                              atol=tol * scale + 1e-6))


def check_flash_bwd(torch, F, fa, b, s, t, h, g, hd, window, dtype, iters):
    """The backward kernels (dq, dk, dv from q, k, v, o, lse, dO) vs autograd
    through the plain version; timed beside SDPA's backward."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do = (torch.randn((b, n, heads, hd), generator=gen, device="cuda").to(dtype)
                   for n, heads in ((s, h), (t, g), (t, g), (s, h)))
    scale = hd ** -0.5
    o, lse = fa._launch(q, k, v, True, window, scale, with_lse=True)
    kernel = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=window,
                                            scale=scale)
    got = kernel()
    deterministic = same_bits(torch, got, kernel())
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention_plain(*leaves, causal=True, window=window)
    plain = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
    want = plain()
    torch.cuda.synchronize()
    name = dtype_name(dtype)
    errs = [rel_close(torch, x, y, TOL[name]) for x, y in zip(got, want)]
    lib_leaves = [x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    qpos = torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(t, device="cuda")[None, :]
    band = (kpos <= qpos) & ((kpos > qpos - window) if window else True)
    mask = dict(attn_mask=band) if window else dict(is_causal=True)
    lib_out = F.scaled_dot_product_attention(*lib_leaves, enable_gqa=True, **mask)
    do_t = do.transpose(1, 2)
    lib = lambda: torch.autograd.grad(lib_out, lib_leaves, do_t, retain_graph=True)
    pairs = int(band.sum().item())
    esize = q.element_size()
    nbytes = (2 * (q.numel() + k.numel() + v.numel()) + 2 * o.numel()) * esize + lse.numel() * 4
    flops = 10.0 * hd * pairs * b * h  # Q K^T, dO V^T, P^T dO, dS^T Q, dS K
    if name == "float32":  # the least at f32 accuracy: three TF32 products per f32 one
        bound_ms, bound_by = bound(nbytes, 3 * flops, "tf32")
        extra = dict(zip(("bound_f32_cores_ms", "bound_f32_cores_by"), bound(nbytes, flops, name)))
    else:
        bound_ms, bound_by = bound(nbytes, flops, name)
        extra = {}
    ms, library_ms = paired_ms(kernel, lib, iters)
    phases = device_ms_split(kernel, iters, "flash_bwd")
    row = dict(
        case=f"flash_attention_bwd {name} B={b} S={s} T={t} H={h} G={g} hd={hd} causal "
             f"window={window}",
        max_abs_err=max(e[0] for e in errs), rel_err_by_grad=[e[1] for e in errs],
        tol=TOL[name], deterministic=deterministic,
        ok=all(e[2] for e in errs) and deterministic,
        ms=ms, device_ms=sum(phases.values()) or None, device_ms_by_kernel=phases,
        plain_ms=cuda_ms(plain, iters),
        library_ms=library_ms, library_device_ms=device_ms(lib, iters),
        bound_ms=bound_ms, bound_by=bound_by, **extra)
    print(f"[kernels] {json.dumps(row)}")
    return row


def check_rmsnorm_bwd(torch, F, rn, ref, rows, d, dtype, iters):
    """dx and dw of the backward kernels vs autograd through the plain
    version; timed beside autograd of F.rms_norm."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = (torch.randn((rows, d), generator=gen, device="cuda") * 3).to(dtype)
    w = (torch.randn((d,), generator=gen, device="cuda") * 0.1).to(dtype)
    g = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    kernel = lambda: rn.rmsnorm_bwd(x, w, g)
    got = kernel()
    deterministic = same_bits(torch, got, kernel())
    leaves = [x.detach().requires_grad_(), w.detach().requires_grad_()]
    out = ref.rmsnorm_ref(*leaves)
    plain = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)
    want = plain()
    torch.cuda.synchronize()
    name = dtype_name(dtype)
    errs = [rel_close(torch, a, b, RMS_TOL[name]) for a, b in zip(got, want)]
    lx, lw = x.detach().requires_grad_(), w.detach().requires_grad_()
    lib_out = F.rms_norm(lx, (d,), weight=1.0 + lw, eps=1e-5)
    lib = lambda: torch.autograd.grad(lib_out, (lx, lw), g, retain_graph=True)
    nbytes = (3 * x.numel() + 2 * w.numel()) * x.element_size()  # x, g, dx; w, dw
    bound_ms, bound_by = bound(nbytes, 8.0 * rows * d, name)
    ms, library_ms = paired_ms(kernel, lib, iters)
    phases = device_ms_split(kernel, iters, "rmsnorm_bwd")
    row = dict(
        case=f"rmsnorm_bwd {name} rows={rows} d={d}", max_abs_err=max(e[0] for e in errs),
        rel_err_dx_dw=[e[1] for e in errs], tol=RMS_TOL[name], deterministic=deterministic,
        ok=all(e[2] for e in errs) and deterministic,
        ms=ms, device_ms=sum(phases.values()) or None, device_ms_by_kernel=phases,
        plain_ms=cuda_ms(plain, iters),
        library_ms=library_ms, library_device_ms=device_ms(lib, iters),
        bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernels] {json.dumps(row)}")
    return row


def rmsnorm_bwd_blocks(torch, rn, rows, d, dtype, iters):
    """Device ms of the RMSNorm backward at (rows, d) with its grid capped at
    several block counts (``rn.BWD_BLOCKS``; uncapped, it takes one wave at
    its occupancy), the cap restored after."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    x, g = (torch.randn((rows, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    w = torch.randn((d,), generator=gen, device="cuda").to(dtype)
    chosen, out = rn.BWD_BLOCKS, {}
    try:
        for blocks in (132, 264, 528, 792, 1056):
            rn.BWD_BLOCKS = blocks
            out[blocks] = device_ms(lambda: rn.rmsnorm_bwd(x, w, g), iters)
    finally:
        rn.BWD_BLOCKS = chosen
    print(f"[kernels] rmsnorm_bwd {dtype_name(dtype)} rows={rows} d={d} device ms with the "
          f"grid capped at N blocks (the default cap, BWD_BLOCKS = {chosen}, leaves it one wave "
          f"at its occupancy): {json.dumps(out)}")


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
    # the three launches of one call, by kernel name
    phases = device_ms_split(kernel, iters, "ssd_scan")
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


def check_ssd_bwd(torch, ss, b, s, h, g, p, n, dtype, iters):
    """The backward kernels (dx, ddt, da, db, dc from the forward's inputs and
    scratch, dy and a nonzero dstate) against autograd through the plain
    version, ``ssd_scan_plain``, on the same inputs; plain_ms is that one
    backward through its graph (at mamba2-130m's shape it keeps 4096 steps
    of states, 13 GB).  Two calls must give the same bits."""
    x, dt, a, bb, cc = ssd_inputs(torch, b, s, h, g, p, n, dtype, "model")
    gen = torch.Generator(device="cuda").manual_seed(7)
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    dstate = torch.randn((b, h, p, n), generator=gen, device="cuda")
    _, _, scratch = ss._launch(x, dt, a, bb, cc)
    kernel = lambda: ss.ssd_scan_bwd(x, dt, a, bb, cc, scratch, dy, dstate)
    got = kernel()
    deterministic = same_bits(torch, got, kernel())
    leaves = [t.detach().requires_grad_() for t in (x, dt, a, bb, cc)]
    plain_out = ss.ssd_scan_plain(*leaves)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = torch.autograd.grad(plain_out, leaves, (dy, dstate))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    del plain_out, leaves
    name = dtype_name(dtype)
    errs = [rel_close(torch, u, w, TOL[name]) for u, w in zip(got, want)]
    del want
    torch.cuda.empty_cache()
    esize = x.element_size()
    # each input read once, each gradient written once: x, dy, dx; b, c, db, dc;
    # dt, ddt, a, da and dstate in f32
    nbytes = ((3 * x.numel() + 4 * bb.numel()) * esize
              + (2 * dt.numel() + 2 * a.numel() + dstate.numel()) * 4)
    # the least work of the gradient of the sequential recurrence: per token
    # and (batch, head), a multiply-add per state element for each of the
    # state gradient's C dY term, dC = h dY, dx = dt dh B and dB = dt dh x
    # (the forward's 4 S N P convention: decays and the recompute of h left out)
    flops = 8.0 * s * n * p * b * h
    if name == "float32":  # products in 3xTF32; the CUDA cores' bound beside it
        bound_ms, bound_by = bound(nbytes, 3 * flops, "tf32")
        extra = dict(zip(("bound_f32_cores_ms", "bound_f32_cores_by"), bound(nbytes, flops, name)))
    else:
        bound_ms, bound_by = bound(nbytes, flops, name)
        extra = {}
    phases = device_ms_split(kernel, iters, "ssd_bwd")
    row = dict(
        case=f"ssd_scan_bwd {name} model ranges B={b} S={s} H={h} G={g} P={p} N={n}",
        reference="autograd through ssd_scan_plain",
        max_abs_err=max(e[0] for e in errs), rel_err_by_grad=[e[1] for e in errs],
        tol=TOL[name], deterministic=deterministic,
        ok=all(e[2] for e in errs) and deterministic,
        ms=cuda_ms(kernel, iters), device_ms=sum(phases.values()) or None,
        device_ms_by_kernel=phases,
        scratch_bytes=4 * ss._bwd_scratch_entry()(b, s, h, g, p, n),
        heads_per_block=ss.heads_per_block(h // g, b * h * -(-s // ss.CHUNK)),
        plain_ms=plain_ms,
        library_ms=None, library_note="no single PyTorch call computes the SSD scan's gradient",
        bound_ms=bound_ms, bound_by=bound_by, **extra)
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


def train_counts(spec, remat: str) -> dict[str, int]:
    """Launches of one train step, by layer kind: an attention layer calls
    flash once, a Mamba layer the SSD scan once; each layer calls RMSNorm for
    norm1, for norm2 if it has an FFN and, if Mamba, for the mixer's gated
    norm; the final norm once.  Under a remat policy each layer's forward
    calls run again in the backward (the recompute); one backward per
    forward call."""
    again = 2 if remat != "none" else 1
    lds = spec.layer_defs()
    n_mamba = sum(ld.mixer == "mamba" for ld in lds)
    n_attn = len(lds) - n_mamba
    norms = sum(1 + (ld.ffn != "none") + (ld.mixer == "mamba") for ld in lds)
    return {"flash_attention": again * n_attn, "flash_attention_bwd": n_attn,
            "rmsnorm": again * norms + 1, "rmsnorm_bwd": norms + 1,
            "ssd_scan": again * n_mamba, "ssd_scan_bwd": n_mamba,
            "dse_class_times": 0, "dse_sweep": 0}


def train(torch, counted, card, spec, seq):
    """``spec`` at full width, batches of TRAIN_BATCH x ``seq``: TRAIN_STEPS
    steps of f32 AdamW under remat "dots" with the launch counts set to 0
    just before them, then the remat policies against each other from one
    state and batch.  Returns the launches of the counted steps."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (RunConfig, init_train_state, make_loss_fn,
                                              make_train_step, to_device)
    cfg = RunConfig(remat="dots", opt=opt.OptConfig(lr=1e-3, warmup_steps=TRAIN_WARMUP))
    t0 = time.perf_counter()
    state = init_train_state(spec, cfg, seed=SEED, device="cuda")
    data = SyntheticLM(spec, DataConfig(TRAIN_BATCH, seq, seed=SEED))
    batches = [to_device(data.batch_at(i), "cuda") for i in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    print(f"[train] {spec.name} full width f32 state (params, m, v) and {TRAIN_STEPS + 1} "
          f"SyntheticLM batches of B={TRAIN_BATCH} S={seq} on the card in "
          f"{time.perf_counter() - t0:.3f} s")
    step_fn = make_train_step(spec, cfg)
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[i])
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if not math.isfinite(loss):
            fail(f"train step {i}: loss {loss}")
    launches = {name: fn.launches for name, fn in counted.items()}
    want = {k: TRAIN_STEPS * v for k, v in train_counts(spec, cfg.remat).items()}
    if launches != want:
        fail(f"train: kernel launches in {TRAIN_STEPS} steps {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    ms = sorted(step_ms[-4:])
    median = (ms[1] + ms[2]) / 2
    tokens = TRAIN_BATCH * seq
    print(f"[train] {card} | {spec.name} B={TRAIN_BATCH} S={seq} f32 remat=dots: losses "
          f"{[round(x, 4) for x in losses]}; step ms {[round(x, 3) for x in step_ms]}, median of "
          f"the last 4 {median:.3f} ms, {tokens / median * 1e3:.1f} tokens/s; peak memory "
          f"{peak / 2**30:.3f} GiB; launches per step "
          f"{ {k: v // TRAIN_STEPS for k, v in launches.items()} } (expected "
          f"{train_counts(spec, cfg.remat)})")
    by_name = device_by_kernel(lambda: step_fn(state, batches[TRAIN_STEPS]), 1)
    if by_name:
        dev = sum(by_name.values())
        classes = ", ".join(f"{c} {v:.3f}" for c, v in by_class(by_name).items())
        busy = f"{dev:.3f} ms = {dev / median:.3f} of the step's wall ({classes} ms)"
    else:
        busy = "not measured"
    print(f"[train] {spec.name} device busy (torch.profiler, one step): {busy}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[train] {spec.name} step's largest device kernels (ms): "
          + "; ".join(f"{name[:80]} {v:.3f}" for name, v in top))
    other = sorted(((n, v) for n, v in by_name.items() if by_class({n: v})["other"]),
                   key=lambda kv: -kv[1])[:8]
    print(f"[train] {spec.name} step's largest kernels of class other (ms): "
          + "; ".join(f"{name[:80]} {v:.3f}" for name, v in other))

    # -- remat policies: loss and grad norm from one state and batch
    batch, params = batches[TRAIN_STEPS], state["params"]
    leaves = opt.leaves(params)
    got = {}
    for remat in ("dots", "none", "full"):
        loss, _ = make_loss_fn(spec, cfg.with_(remat=remat))(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        bad = [i for i, g in enumerate(grads)
               if not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
        if bad:
            fail(f"train remat={remat}: {len(bad)} of {len(grads)} parameters have a gradient "
                 f"that is not finite or all zero (leaves {bad[:8]})")
        got[remat] = (loss.item(), opt.global_norm(grads).item())
        del grads, loss
    (l0, n0) = got["dots"]
    for remat in ("none", "full"):
        l1, n1 = got[remat]
        if not (abs(l1 - l0) <= REMAT_TOL * abs(l0) and abs(n1 - n0) <= REMAT_TOL * abs(n0)):
            fail(f"train: remat={remat} gives loss {l1} and grad norm {n1}, dots {l0} and {n0}")
    print(f"[train] {spec.name} remat policies from one state and batch: (loss, grad norm) "
          f"{got}; every one of {len(leaves)} parameters has a finite gradient that is not all "
          f"zero; none and full within {REMAT_TOL} of dots")
    round_trip(torch, state, f"{spec.name} full-width trained f32")
    return launches


def round_trip(torch, state, name: str) -> None:
    """``state`` saved with repro_torch.ckpt.checkpoint and restored onto the
    card, bit for bit, in a temporary directory under TMPDIR or, if that has
    less room than the state, under this checkout's (git-ignored) build
    directory."""
    import shutil
    import tempfile

    from repro_torch.ckpt.checkpoint import flatten, restore, save
    from repro_torch.kernels import _build
    flat = flatten(state)
    nbytes = sum(t.numel() * t.element_size() for t in flat.values())
    where = None
    if shutil.disk_usage(tempfile.gettempdir()).free < 1.5 * nbytes:
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        where = _build.BUILD_DIR
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=where) as tmp:
        save(tmp, state, step=int(state["step"]))
        t1 = time.perf_counter()
        back, step = restore(tmp, state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    got = flatten(back)
    same = sorted(flat) == sorted(got) and all(
        flat[k].dtype == got[k].dtype and flat[k].device == got[k].device
        and torch.equal(flat[k], got[k]) for k in flat)
    parts = sorted({key.split("]")[0] + "]" for key in flat})
    print(f"[train] {name} train state ({len(flat)} tensors, {nbytes / 1e9:.3f} GB: "
          f"{parts}) saved at step {step} in "
          f"{t1 - t0:.3f} s and restored on the card in {t2 - t1:.3f} s: exact {same}")
    if not same:
        fail(f"the {name} train state did not survive save/restore exactly")


def train_consistency(torch, map_with_path, reduced, spec):
    """A reduced train step on the card vs the CPU, and the exact save/restore
    round trip of a bf16 train state with its f32 master."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (BF16_RUN, RunConfig, init_train_state,
                                              make_loss_fn, make_train_step)
    small = reduced(spec)
    cfg = RunConfig(remat="dots", opt=opt.OptConfig(lr=1e-3, warmup_steps=TRAIN_WARMUP))
    batch = SyntheticLM(small, DataConfig(4, 128, seed=SEED)).batch_at(0)
    cpu = init_train_state(small, cfg, seed=SEED, device="cpu")
    states = {"cpu": cpu, "cuda": map_with_path(lambda _, t: t.detach().cuda(), cpu)}
    out = {}
    for dev, st in states.items():
        for t in opt.leaves(st["params"]):
            t.requires_grad_(True)
        loss, _ = make_loss_fn(small, cfg)(st["params"], {k: torch.as_tensor(v, device=dev)
                                                           for k, v in batch.items()})
        grads = torch.autograd.grad(loss, opt.leaves(st["params"]))
        _, metrics = make_train_step(small, cfg)(st, batch)
        out[dev] = (loss.item(), [g.cpu() for g in grads], metrics["loss"].item())
    (lc, gc, mc), (lg, gg, mg) = out["cpu"], out["cuda"]
    worst = max(((a - b).abs() - STEP_TOL["grad_rtol"] * b.abs()).max().item()
                for a, b in zip(gg, gc))
    rel_scale = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(gg, gc))
    ok = (abs(lg - lc) <= STEP_TOL["loss"] * abs(lc) and abs(mg - mc) <= STEP_TOL["loss"] * abs(mc)
          and all(torch.allclose(a, b, rtol=STEP_TOL["grad_rtol"], atol=STEP_TOL["grad_atol"])
                  for a, b in zip(gg, gc)))
    print(f"[train] reduced {spec.name} train step B=4 S=128, card vs CPU: loss {lg:.6f} vs "
          f"{lc:.6f}, step loss {mg:.6f} vs {mc:.6f}; grads: largest |diff| - rtol*|want| "
          f"{worst:.3e} (atol {STEP_TOL['grad_atol']}), largest |diff| / max |want| per tensor "
          f"{rel_scale:.3e}")
    if not ok:
        fail(f"{spec.name}: the card's reduced train step disagrees with the CPU's")
    # a bf16 train state (bf16 params, their f32 master) through a checkpoint
    bf16 = init_train_state(small, BF16_RUN, seed=SEED, device="cuda")
    make_train_step(small, BF16_RUN.with_(remat="dots"))(bf16, batch)
    round_trip(torch, bf16, f"reduced {spec.name} bf16 + f32 master")


# -- the design-space explorer ---------------------------------------------------

def dse_population(np, points: int) -> list[dict]:
    """The agent population of the JAX package's backend benchmark
    (benchmarks/fig10_agents.py:66-87): design points differing in their
    collective and network knobs, the trace-shaping knobs pinned so the
    whole population shares one scheduling plan, drawn from seed SEED."""
    pinned = dict(dp=8, sp=1, pp=1, weight_sharded=0, topology=("ring", "fc", "ring", "switch"),
                  npus_per_dim=(4, 8, 4, 8), prefill_frac=0.5, decode_batch=8,
                  batch_window_ms=50.0, max_inflight=2)
    rng = np.random.default_rng(SEED)
    algos = ("ring", "direct", "rhd", "dbt")
    return [dict(pinned, coll_algo=tuple(rng.choice(algos) for _ in range(4)),
                 chunks=int(rng.choice((2, 4, 8, 16))),
                 sched_policy=str(rng.choice(("fifo", "lifo"))),
                 multidim_coll=str(rng.choice(("baseline", "blueconnect"))),
                 bw_per_dim=tuple(int(b) for b in rng.choice(range(50, 501, 50), size=4)))
            for _ in range(points)]


def dse_env(backend: str):
    """The benchmark's CosmicEnv: qwen2-1.5b on system2 under the pinned
    request stream (DSE_REQUESTS Poisson requests, seq 2048, 64 decode
    tokens, 32 requests/s, seed 0), goodput objective."""
    from repro_torch.core.scenario import RequestStreamScenario
    from repro_torch.core.systems import system_env
    scenario = RequestStreamScenario(n_requests=DSE_REQUESTS, seq=2048, decode_tokens=64,
                                     rate_rps=32.0, seed=0)
    return system_env(DSE_ARCH, DSE_SYSTEM, scenario=scenario, objective="goodput",
                      backend=backend)


def dse_generation(torch, env, cfgs):
    """One generation through CosmicEnv.step_batch with the env's memo
    cleared: (evaluations, wall seconds)."""
    env.clear_memo()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evs = env.step_batch(cfgs)
    torch.cuda.synchronize()
    return evs, time.perf_counter() - t0


def dse_agree(want, got) -> tuple[float, bool]:
    """Max relative gap of reward and latency over the members, and whether
    every member is within DSE_RTOL (and valid exactly where want is)."""
    worst, ok = 0.0, len(want) == len(got)
    for w, g in zip(want, got):
        ok &= w.valid == g.valid
        for a, b in ((g.reward, w.reward), (g.latency_ms, w.latency_ms)):
            if w.valid:
                rel = abs(a - b) / max(abs(b), 1e-300)
                worst = max(worst, rel)
                ok &= rel <= DSE_RTOL
    return worst, bool(ok)


def check_dse(torch, np, trace, calls, iters):
    """dse_class_times and dse_sweep at the main path's shapes against
    their plain twins on the card (bit for bit) and numpy's batched
    duration pass (bit for bit), each run twice for the same bits; events
    ms, device ms, the plain twins' ms and the bounds.  Returns the two
    rows."""
    from repro_torch.core.backends.torch_backend import TorchBackend
    from repro_torch.core.simulator import batch_op_durations, plan_duration_tables
    from repro_torch.kernels import dse_sim
    be = TorchBackend(device="cuda")
    plan, tables = plan_duration_tables(trace, calls)
    st, tab = be._static(trace, plan), be._class_tables(tables)
    args = [st["kind"], st["size"], st["is_xfer"]] + [tab[k] for k in (
        "npus", "bw", "lat", "scale", "topo", "algo", "chunks", "blue", "xfer_bw", "xfer_lat")]
    src, parents = st["sources"], st["parents"]
    gather = dict(sources=src, peak=tab["peak"], membw=tab["membw"])
    class_t = dse_sim.dse_class_times(*args)
    dur, finish = dse_sim.dse_sweep(parents, class_t=class_t, **gather)
    again = (dse_sim.dse_class_times(*args),) + dse_sim.dse_sweep(parents, class_t=class_t,
                                                                  **gather)
    torch.cuda.synchronize()
    plain_c = dse_sim.class_times_plain(*args)
    plain_dur = dse_sim.op_durations_plain(src, class_t, tab["peak"], tab["membw"])
    levels = dse_sim.sweep_levels(parents)
    plain_fin = dse_sim.sweep_plain(parents, plain_dur, levels)
    numpy_dur = batch_op_durations(plan, tables, op_major=True)
    twice = same_bits(torch, (class_t, dur, finish), again)
    P, C = class_t.shape
    D = tab["npus"].shape[2]
    n_ops, W = parents.shape
    n_comp, n_coll, n_delay = (src.comp_flops.numel(), src.coll_class.numel(),
                               src.delay_us.numel())
    active = int((tab["npus"] > 1.0).sum().item())
    rows = []
    # the class table: per active dim entry 22 float64 operations (the
    # phase's 18, the reduction's 4), per padded one 5, per (member, class) 4
    c_bytes = P * C * D * (4 * 8 + 2 * 4) + C * (4 + 8 + 1) + P * (4 * 8 + 1) + P * C * 8
    c_ops = 22 * active + 5 * (P * C * D - active) + 4 * P * C
    # the sweep: per (op, member) W - 1 maxes and one add, plus the roofline's
    # two divisions, max and product per compute op and one product per comm op
    s_bytes = (n_ops * W * 4 + n_ops * 4 + n_comp * 16 + n_coll * 12 + n_delay * 8 + P * C * 8
               + P * 16 + n_ops * P * 8 + (n_ops + 1) * P * 8)
    s_ops = n_ops * P * W + n_comp * P * 4 + n_coll * P
    for name, got, want, nbytes, flops, kernel, plain, plain_iters in (
            ("dse_class_times", class_t, plain_c, c_bytes, c_ops,
             lambda: dse_sim.dse_class_times(*args),
             lambda: dse_sim.class_times_plain(*args), iters),
            ("dse_sweep", finish, plain_fin, s_bytes, s_ops,
             lambda: dse_sim.dse_sweep(parents, class_t=class_t, **gather),
             lambda: dse_sim.sweep_plain(parents, dse_sim.op_durations_plain(
                 src, class_t, tab["peak"], tab["membw"]), levels), 1)):
        exact = torch.equal(got, want)
        if name == "dse_sweep":
            exact &= torch.equal(dur, plain_dur) and np.array_equal(dur.cpu().numpy(), numpy_dur)
        bound_ms, bound_by = bound(nbytes, flops, "float64")
        phases = device_ms_split(kernel, iters, "dse_")
        row = dict(case=f"{name} P={P} C={C} D={D} n_ops={n_ops} W={W}",
                   max_abs_err=(got - want).abs().max().item(), tol="bit-identical",
                   ok=bool(exact and twice), deterministic=twice, ms=cuda_ms(kernel, iters),
                   device_ms=sum(phases.values()) or None, device_ms_by_kernel=phases,
                   plain_ms=cuda_ms(plain, plain_iters, warmup=1), bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None, bytes=nbytes, flops=flops)
        if name == "dse_sweep":
            # its true limit: one dependent fp64 max and add per level; and
            # how far back the parents sit (what a window of recent finish
            # rows would catch)
            back = (torch.arange(n_ops, device=parents.device)[:, None] - parents.long())[
                parents.long() != n_ops]
            row.update(levels=len(levels), parents_within_2=(back <= 2).double().mean().item(),
                       max_parent_distance=int(back.max().item()),
                       chain_estimate_ms=len(levels) * 2 * FP64_DEP_CYCLES / SM_CLOCK_HZ * 1e3,
                       durations_bit_identical_to_numpy=bool(
                           np.array_equal(dur.cpu().numpy(), numpy_dur)))
        print(f"[dse] {json.dumps(row)}")
        rows.append(row)
    return rows


def dse(torch, np, counted, card):
    """The DSE's main path on the card: the backend benchmark's population
    through CosmicEnv.step_batch on ``reference`` (one generation, the
    oracle), ``torch-unfused`` and ``torch`` (DSE_REPEATS generations each,
    every member within DSE_RTOL of the oracle), the launch counts of the
    ``torch`` generations (set to 0 just before them), each kernel's device
    ms; the kernels at these shapes against their plain twins; then
    DSE_BIG members on ``torch`` (DSE_CHECKED of them against the oracle),
    and the study CLI on ``torch`` against ``reference``.  Returns (kernel
    rows by name, launches, more rows)."""
    from repro_torch.core.backends import get_backend
    cfgs = dse_population(np, DSE_POINTS)
    envs = {b: dse_env(b) for b in ("reference", "torch-unfused", "torch")}
    t0 = time.perf_counter()
    job = envs["reference"].scenario.sim_job(envs["reference"].context(cfgs[0]))
    trace = job.calls[0].trace
    want, ref_s = dse_generation(torch, envs["reference"], cfgs)
    print(f"[dse] {card} | {DSE_ARCH} on {DSE_SYSTEM}, request stream of {DSE_REQUESTS}: "
          f"{len(trace.ops)} ops on {len(trace._sim_plan.res_names)} resources, "
          f"{len(job.calls)} simulator call(s) a point; trace built in "
          f"{time.perf_counter() - t0 - ref_s:.3f} s; reference: {len(cfgs)} points in "
          f"{ref_s * 1e3:.3f} ms = {len(cfgs) / ref_s:.3f} pts/s; "
          f"{sum(w.valid for w in want)} valid")
    launches = None
    for backend in ("torch-unfused", "torch"):
        env = envs[backend]
        env.step_batch(cfgs)  # warm: the plan's tables on the card, the kernels loaded
        if backend == "torch":
            for fn in counted.values():
                fn.launches = 0
        gens = []
        for _ in range(DSE_REPEATS):
            got, s = dse_generation(torch, env, cfgs)
            gens.append((s, dict(get_backend(backend).last_timings)))
            worst, ok = dse_agree(want, got)
            if not ok:
                fail(f"dse: {backend} disagrees with reference: max relative gap {worst}")
        if backend == "torch":
            launches = {name: fn.launches for name, fn in counted.items()}
        s, timings = min(gens, key=lambda g: g[0])
        by_name = device_by_kernel(lambda: dse_generation(torch, env, cfgs), 2)
        kern = {k: v for k, v in by_name.items() if "dse_" in k}
        copies = sum(v for k, v in by_name.items() if "memcpy" in k.lower())
        print(f"[dse] {card} | {backend} P={len(cfgs)}: {len(cfgs) / s:.3f} pts/s, "
              f"{s * 1e3:.3f} ms/gen (best of {DSE_REPEATS}: "
              f"{[round(g[0] * 1e3, 3) for g in gens]}); last_timings durations "
              f"{timings['durations_s'] * 1e3:.3f} ms, sweep {timings['sweep_s'] * 1e3:.3f} ms, "
              f"rest (scenario jobs, busy sums, finalize) "
              f"{(s - timings['durations_s'] - timings['sweep_s']) * 1e3:.3f} ms; device ms a "
              f"generation (torch.profiler): kernels "
              f"{ {k[:60]: round(v, 4) for k, v in kern.items()} }, copies {copies:.4f}, all "
              f"{sum(by_name.values()):.4f}; members within {DSE_RTOL} of reference (max gap "
              f"{worst:.3e})")
    want_counts = {name: 0 for name in counted}
    want_counts.update(dse_class_times=DSE_REPEATS, dse_sweep=DSE_REPEATS)
    if launches != want_counts:
        fail(f"dse: kernel launches in {DSE_REPEATS} torch generations {launches}, "
             f"expected {want_counts}")
    print(f"[dse] launches in {DSE_REPEATS} torch generations: {launches}")
    rows = check_dse(torch, np, trace, [envs["torch"].scenario.sim_job(
        envs["torch"].context(c)).calls[0] for c in cfgs], 20)

    # a larger population: the members run in parallel on the card
    big = dse_population(np, DSE_BIG)
    env = envs["torch"]
    env.step_batch(big)
    gens = [dse_generation(torch, env, big) for _ in range(DSE_REPEATS)]
    s = min(g[1] for g in gens)
    timings = get_backend("torch").last_timings
    picked = big[::DSE_BIG // DSE_CHECKED]
    worst, ok = dse_agree([envs["reference"].evaluate_config(c) for c in picked],
                          [gens[-1][0][i] for i in range(0, DSE_BIG, DSE_BIG // DSE_CHECKED)])
    if not ok:
        fail(f"dse: torch at P={DSE_BIG} disagrees with reference: max relative gap {worst}")
    by_name = device_by_kernel(lambda: dse_generation(torch, env, big), 2)
    kern = {k: v for k, v in by_name.items() if "dse_" in k}
    print(f"[dse] {card} | torch P={DSE_BIG}: {DSE_BIG / s:.3f} pts/s, {s * 1e3:.3f} ms/gen "
          f"(best of {DSE_REPEATS}); last_timings durations {timings['durations_s'] * 1e3:.3f} "
          f"ms, sweep {timings['sweep_s'] * 1e3:.3f} ms; device ms a generation: kernels "
          f"{ {k[:60]: round(v, 4) for k, v in kern.items()} }, all "
          f"{sum(by_name.values()):.4f}; {len(picked)} members within {DSE_RTOL} of reference "
          f"(max gap {worst:.3e})")
    more = check_dse(torch, np, trace, [env.scenario.sim_job(env.context(c)).calls[0]
                                        for c in big], 10)
    bad = [r["case"] for r in rows + more if not r["ok"]]
    if bad:
        fail(f"dse kernels disagree with their plain twins or numpy: {bad}")
    dse_cli()
    return {r["case"].split()[0]: r for r in rows}, launches, more


def dse_cli() -> None:
    """``python -m repro_torch.dse run examples/studies/smoke.json`` on the
    ``torch`` backend (the card) and on ``reference``: every cell's best
    reward within DSE_RTOL."""
    import os
    import tempfile
    best = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("reference", "torch"):
            out = Path(tmp) / f"{backend}.jsonl"
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.dse", "run",
                 str(ROOT / "examples" / "studies" / "smoke.json"), "--backend", backend,
                 "--out", str(out), "--quiet"], capture_output=True, text=True, timeout=600,
                env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
            if r.returncode:
                fail(f"python -m repro_torch.dse run --backend {backend}: {r.stderr[-2000:]}")
            cells = [json.loads(line) for line in out.read_text().splitlines()]
            best[backend] = {c["cell_id"]: c["result"]["best_reward"] for c in cells
                             if c.get("record") == "cell"}
            print(f"[dse] python -m repro_torch.dse run examples/studies/smoke.json --backend "
                  f"{backend}: {time.perf_counter() - t0:.3f} s, best rewards {best[backend]}; "
                  f"{r.stdout.strip().splitlines()[-1][:160]}")
    if not best["torch"] or best["torch"].keys() != best["reference"].keys() or any(
            abs(v - best["reference"][k]) > DSE_RTOL * abs(best["reference"][k])
            for k, v in best["torch"].items()):
        fail(f"dse CLI: torch {best['torch']} vs reference {best['reference']}")


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
    from repro_torch.kernels import _build, flash_attention as fa, ops, ref, rmsnorm as rn
    from repro_torch.kernels import dse_sim, ssd_scan as ss
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
    pspec = get_arch(PHI3)
    h, g, hd, d = spec.n_heads, spec.n_kv_heads, spec.resolved_head_dim, spec.d_model
    mh, mg, mp, mn = mspec.ssm_heads, mspec.ssm_groups, mspec.ssm_head_dim, mspec.ssm_state
    m_rows = TRAIN_BATCH * M_TRAIN_SEQ  # mamba2's train rows, as many as its prefill's
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
                             rspec.resolved_head_dim, 0), 10),
                ("phi3 hd96", (BATCH, 1024, 1024, pspec.n_heads, pspec.n_kv_heads,
                               pspec.resolved_head_dim, 0), 10)):
            named[name, key] = check_flash(torch, F, fa, *args, dtype, iters)
            rows.append(named[name, key])
        # the backward kernels, at the train path's shape first
        for key, args, iters in (
                ("bwd qwen2", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, h, g, hd, 0), 5),
                ("bwd qwen2 ragged 1000", (BATCH, PROMPT, PROMPT, h, g, hd, 0), 5),
                ("bwd gemma3 global", (BATCH, G_PROMPT, G_PROMPT, gh, gg, ghd, 0), 3),
                (f"bwd gemma3 window {gw}", (BATCH, G_PROMPT, G_PROMPT, gh, gg, ghd, gw), 3),
                ("bwd granite", (BATCH, R_PROMPT, R_PROMPT, rspec.n_heads, rspec.n_kv_heads,
                                 rspec.resolved_head_dim, 0), 5),
                ("bwd phi3 hd96", (BATCH, 1024, 1024, pspec.n_heads, pspec.n_kv_heads,
                                   pspec.resolved_head_dim, 0), 3)):
            named[name, key] = check_flash_bwd(torch, F, fa, *args, dtype, iters)
            rows.append(named[name, key])
        for key, (n_rows, width), iters in (
                ("bwd qwen2 train", (TRAIN_BATCH * TRAIN_SEQ, d), 50),
                ("bwd 4000x1536", (4000, d), 50),
                ("bwd gemma3 8160x1152", (BATCH * G_PROMPT, gspec.d_model), 50),
                # mamba2-130m training: norm1 and the final norm, the gated norm
                ("bwd mamba2 train", (m_rows, mspec.d_model), 50),
                ("bwd mamba2 train gated", (m_rows, mspec.d_inner), 50)):
            named[name, key] = check_rmsnorm_bwd(torch, F, rn, ref, n_rows, width, dtype, iters)
            rows.append(named[name, key])
        rmsnorm_bwd_blocks(torch, rn, TRAIN_BATCH * TRAIN_SEQ, d, dtype, 50)
        for key, (n_rows, width), iters in (
                ("qwen2 prefill", (BATCH * PROMPT, d), 100), ("qwen2 decode", (BATCH, d), 200),
                ("gemma3 prefill", (BATCH * G_PROMPT, gspec.d_model), 100),
                ("gemma3 decode", (BATCH, gspec.d_model), 200),
                ("granite prefill", (BATCH * R_PROMPT, rspec.d_model), 100),
                # mamba2-130m's prefill and training rows, and its decode
                ("mamba2 prefill", (m_rows, mspec.d_model), 100),
                ("mamba2 prefill gated", (m_rows, mspec.d_inner), 100),
                ("mamba2 decode", (BATCH, mspec.d_model), 200)):
            named[name, key] = check_rmsnorm(torch, F, rn, ref, n_rows, width, dtype, iters)
            rows.append(named[name, key])
        for ranges in ("model", "random"):
            for b, s, sh, sg, sp, sn, iters in (
                    (BATCH, M_PROMPT, mh, mg, mp, mn, 10),   # mamba2-130m prefill
                    (BATCH, 1000, mh, mg, mp, mn, 20),       # ragged S
                    (BATCH, 2048, 8, 2, 64, 16, 20),         # grouped, jamba's widths
                    (2, 1000, small.ssm_heads, 1, small.ssm_head_dim, small.ssm_state, 20)):
                ssd_rows.append(check_ssd(torch, ss, b, s, sh, sg, sp, sn, dtype, ranges, iters))
        # the SSD backward: mamba2-130m's train shape, then ragged and grouped
        for key, args, iters in (
                ("bwd mamba2 train", (TRAIN_BATCH, M_TRAIN_SEQ, mh, mg, mp, mn), 5),
                ("bwd ragged grouped", (2, 1000, 8, 2, 64, 16), 10)):
            named[name, key] = check_ssd_bwd(torch, ss, *args, dtype, iters)
            rows.append(named[name, key])
    bad = [r["case"] for r in rows + ssd_rows if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    print(f"[kernels] all {len(rows) + len(ssd_rows)} cases within tolerance")
    # under grad mode ops.ssd goes through SSDScanFn: one forward call, and
    # one backward call that matches autograd through the plain version
    args = [t.requires_grad_() for t in ssd_inputs(torch, 2, 200, 4, 2, 16, 16, torch.float32,
                                                    "model")]
    before = (ss.ssd_scan.launches, ss.ssd_scan_bwd.launches)
    y, st = ops.ssd(*args)
    grads = torch.autograd.grad((y.square().sum() + st.sum()), args)
    calls = (ss.ssd_scan.launches - before[0], ss.ssd_scan_bwd.launches - before[1])
    y_p, st_p = ss.ssd_scan_plain(*args)
    want = torch.autograd.grad((y_p.square().sum() + st_p.sum()), args)
    errs = [rel_close(torch, u, w, TOL["float32"]) for u, w in zip(grads, want)]
    print(f"[kernels] ops.ssd under grad on the card: {calls[0]} forward and {calls[1]} backward "
          f"call(s); gradients vs autograd through the plain version, max |diff| / max |want| "
          f"{[e[1] for e in errs]} (tol {TOL['float32']})")
    if calls != (1, 1) or not all(e[2] for e in errs):
        fail("ops.ssd under grad did not differentiate through the SSD backward kernels")

    counted = {"flash_attention": fa.flash_attention, "rmsnorm": rn.rmsnorm,
               "ssd_scan": ss.ssd_scan, "flash_attention_bwd": fa.flash_attention_bwd,
               "rmsnorm_bwd": rn.rmsnorm_bwd, "ssd_scan_bwd": ss.ssd_scan_bwd,
               "dse_class_times": dse_sim.dse_class_times, "dse_sweep": dse_sim.dse_sweep}
    no_dse = {"dse_class_times": 0, "dse_sweep": 0}  # the model paths launch no DSE kernel

    # -- dse -----------------------------------------------------------------------
    by_path = {}
    dse_rows, by_path["dse"], dse_more = dse(torch, np, counted, card)

    # -- serve, then consistency, per model ------------------------------------
    def attention_counts(model_spec):
        # per layer: flash once in prefill; norm1 and norm2 in prefill and in
        # each decode step, and the final norm; serving launches no backward
        return {"flash_attention": model_spec.n_layers, "ssd_scan": 0,
                "rmsnorm": (2 * model_spec.n_layers + 1) * (1 + NEW),
                "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan_bwd": 0, **no_dse}

    for model_spec, prompt, want in (
            (spec, PROMPT, attention_counts(spec)),
            # per layer: norm1 and the mixer's gated norm; no FFN, no attention
            (mspec, M_PROMPT, {"flash_attention": 0, "ssd_scan": mspec.n_layers,
                               "rmsnorm": (2 * mspec.n_layers + 1) * (1 + NEW),
                               "flash_attention_bwd": 0, "rmsnorm_bwd": 0,
                               "ssd_scan_bwd": 0, **no_dse}),
            (gspec, G_PROMPT, attention_counts(gspec)),
            (rspec, R_PROMPT, attention_counts(rspec))):
        params, prompts, by_path[model_spec.name] = serve(
            torch, np, M, Engine, counted, param_count, card, model_spec, prompt, want)
        consistency(torch, M, moem, map_with_path, reduced, model_spec, params, prompts)
        del params
        torch.cuda.empty_cache()

    # -- train ---------------------------------------------------------------------
    for train_spec, seq in ((spec, TRAIN_SEQ), (mspec, M_TRAIN_SEQ)):
        by_path[f"{train_spec.name} train"] = train(torch, counted, card, train_spec, seq)
        torch.cuda.empty_cache()
        train_consistency(torch, map_with_path, reduced, train_spec)
        torch.cuda.empty_cache()

    # -- report ------------------------------------------------------------------
    print(f"[device] {card}")
    print(f"[device] torch.profiler traces: {TRACES['empty']} of {TRACES['taken']} came back "
          f"without device events, each taken again (up to {TRACE_TRIES} tries)")
    case_keys = ("case", "max_abs_err", "ms", "device_ms", "device_ms_by_kernel", "deterministic",
                 "plain_ms", "bound_ms", "bound_by", "library_ms")

    def numbers(r):
        return {key: r[key] for key in case_keys if key in r}

    # more: the kernel at the other shapes of its paths, and bf16 flash
    flash_more = [("bfloat16", "qwen2")] + [
        (name, key) for key in ("gemma3 global", f"gemma3 window {gw}", "hd256 ragged 200")
        for name in ("float32", "bfloat16")] + [("float32", "granite")] + [
        (name, "phi3 hd96") for name in ("float32", "bfloat16")]
    bwd_more = [("bfloat16", "bwd qwen2")] + [
        (name, key) for key in ("bwd qwen2 ragged 1000", "bwd gemma3 global",
                                f"bwd gemma3 window {gw}", "bwd granite", "bwd phi3 hd96")
        for name in ("float32", "bfloat16")]
    norm_bwd_more = [("bfloat16", "bwd qwen2 train")] + [
        (name, key) for key in ("bwd 4000x1536", "bwd gemma3 8160x1152", "bwd mamba2 train",
                                "bwd mamba2 train gated")
        for name in ("float32", "bfloat16")]
    norm_more = [("float32", key) for key in ("qwen2 decode", "gemma3 prefill", "gemma3 decode",
                                              "granite prefill", "mamba2 prefill",
                                              "mamba2 prefill gated", "mamba2 decode")] + [
        ("bfloat16", key) for key in ("mamba2 prefill", "mamba2 prefill gated")]
    kernels = [
        dict(name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:76",
             case=named["float32", "qwen2"], more=[named[k] for k in flash_more]),
        dict(name="rmsnorm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:23",
             case=named["float32", "qwen2 prefill"], more=[named[k] for k in norm_more]),
        dict(name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:71", case=ssd_rows[0], more=[]),
        # the gradients of the first two: the JAX package differentiates jnp
        # attention and normalisation, and has no Pallas backward
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:76",
             case=named["float32", "bwd qwen2"], more=[named[k] for k in bwd_more]),
        dict(name="rmsnorm_bwd", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:23",
             case=named["float32", "bwd qwen2 train"], more=[named[k] for k in norm_bwd_more]),
        # the SSD scan's gradient: the JAX package differentiates its jnp
        # ssd_chunked, and has no Pallas backward
        dict(name="ssd_scan_bwd", route="cuda", source="src/repro_torch/csrc/ssd_scan_bwd.cu",
             replaces="src/repro/kernels/ssd_scan.py:71",
             case=named["float32", "bwd mamba2 train"],
             more=[named["bfloat16", "bwd mamba2 train"]] + [
                 named[dt_name, "bwd ragged grouped"] for dt_name in ("float32", "bfloat16")]),
        # the DSE's population evaluation: the JAX package runs it as
        # XLA-jitted jnp (_fused_eval and _sweep_population), not Pallas
        dict(name="dse_class_times", route="cuda", source="src/repro_torch/csrc/dse_sim.cu",
             replaces="src/repro/core/backends/jax_backend.py:129",
             case=dse_rows["dse_class_times"], more=dse_more[:1]),
        dict(name="dse_sweep", route="cuda", source="src/repro_torch/csrc/dse_sim.cu",
             replaces="src/repro/core/backends/jax_backend.py:66",
             case=dse_rows["dse_sweep"], more=dse_more[1:]),
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
