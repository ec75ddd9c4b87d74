#!/usr/bin/env python3
"""Compare this checkout with another on one NVIDIA GPU: the flash, SSD and
whole-row RMSNorm kernels' outputs bit for bit, the unsharded serving
path's times, and the unsharded train steps' losses, gradients, peak
memory and times.

    python3 chip_ab.py LABEL OUT [AGAINST] [--bits]

Builds the flash attention (forward and backward), RMSNorm and SSD scan
(forward and backward) kernels of the checkout it sits in, then:
  * flash: ``_launch`` (with the log-sum-exp) and ``flash_attention_bwd``
    at the smoke run's shapes (qwen2, gemma3 global and window 512,
    granite, phi-3's head_dim 96, ragged and windowed cases), f32 and
    bf16, causal at offset 0, inputs from seed 5; o, lse, dq, dk and dv are
    saved to OUT (``torch.save``) and, with AGAINST (another checkout's
    OUT), compared with its bit for bit: the line says which cases differ,
    and any difference exits 1;
  * the SSD scan: ``_launch`` (y, the final state) at the smoke run's
    forward shapes (mamba2-130m's prefill, ragged, grouped at jamba's
    widths, reduced mamba2's) and ``ssd_scan_bwd`` (dx, ddt, da, db, dc) at
    its backward shapes (mamba2-130m's train shape, ragged and grouped),
    all at head dims of 16 and more, f32 and bf16, inputs from seed 5,
    compared as flash's are;
  * whole-row RMSNorm: the forward launch (``rmsnorm._forward``) and
    ``rmsnorm_bwd`` (dx, dw) at the smoke run's rows and widths (qwen2's,
    gemma3's, mamba2-130m's d_model and gated d_inner, a decode step's 4
    rows), f32 and bf16, compared as flash's are;
  * serving: qwen2-1.5b (prompt 1000), gemma3-1b (2040),
    granite-moe-3b-a800m (1024) and mamba2-130m (4096) at full width and
    depth, random weights
    from seed 0, fp32, greedy, batch 4, through ``Engine.generate``: one
    warm-up call, then three of 32 new tokens; decode ms a step (decode
    seconds over the 32 steps, as ``chip_smoke.py`` takes it) of each and
    their median, and the prefill ms median;
  * training: qwen2-1.5b (B=4, S=1024) and mamba2-130m (B=4, S=4096) at full
    width and depth, f32, remat "dots", AdamW, SyntheticLM batches from seed
    0: the first batch's gradients from the fresh state (every leaf of
    mamba2's; qwen2's tied table, first and last layers and final norm),
    then ``TRAIN_STEPS`` steps, with each step's loss, ms and the peak memory
    (``max_memory_allocated`` over the steps); with AGAINST, the losses
    compared bit for bit and each saved gradient within ``GRAD_RTOL`` of
    the other's (max |diff| over the leaf's max |value|).
``--bits`` stops after the kernels' bits and the train steps' comparison
(no serving times).  To compare two commits, copy this script into an
unpacked checkout of the other (``git archive``) and run both in one chip
call in turns: A, B, B, A.
Decode is host-bound, so its wall moves with the host: compare medians
only within one call.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (B, S, H, G, head_dim, window): S = T, causal
FLASH_CASES = ((4, 1000, 12, 2, 128, 0), (4, 1000, 12, 2, 128, 256), (4, 200, 12, 2, 128, 0),
               (4, 2040, 4, 1, 256, 0), (4, 2040, 4, 1, 256, 512), (4, 1024, 24, 8, 64, 0),
               (4, 1024, 32, 32, 96, 0), (2, 333, 6, 6, 64, 37))
# (B, S, H, G, P, N), forward only and forward with the backward
SSD_CASES = ((4, 4096, 24, 1, 64, 128), (4, 1000, 24, 1, 64, 128), (4, 2048, 8, 2, 64, 16),
             (2, 1000, 8, 1, 16, 16))
SSD_BWD_CASES = ((4, 4096, 24, 1, 64, 128), (2, 1000, 8, 2, 64, 16))
MODELS = (("qwen2-1.5b", 1000), ("gemma3-1b", 2040), ("granite-moe-3b-a800m", 1024),
          ("mamba2-130m", 4096))
BATCH, NEW, CALLS = 4, 32, 3
# (rows, d): whole-row RMSNorm forward and backward
RMSNORM_CASES = ((4000, 1536), (4096, 1536), (8160, 1152), (16384, 768), (16384, 1536),
                 (4, 1536))
TRAINS = (("qwen2-1.5b", 1024), ("mamba2-130m", 4096))  # (arch, S) at B = 4
TRAIN_STEPS = 4
GRAD_RTOL = 1e-3  # the card-vs-CPU gradient tolerance of chip_smoke.py


def flash_outputs(torch, fa) -> dict:
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, g, hd, window in FLASH_CASES:
            gen = torch.Generator(device="cuda").manual_seed(5)
            q, do = (torch.randn((b, s, h, hd), generator=gen, device="cuda").to(dtype)
                     for _ in range(2))
            k, v = (torch.randn((b, s, g, hd), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            o, lse = fa._launch(q, k, v, True, window, hd ** -0.5, with_lse=True)
            grads = fa.flash_attention_bwd(q, k, v, o, lse, do, window=window)
            out[str(dtype).removeprefix("torch."), b, s, h, g, hd, window] = [
                x.cpu() for x in (o, lse, *grads)]
    return out


def ssd_outputs(torch, ss) -> dict:
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in SSD_CASES + SSD_BWD_CASES:
            b, s, h, g, p, n = case
            gen = torch.Generator(device="cuda").manual_seed(5)
            x, dy = (torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
                     for _ in range(2))
            u = torch.rand((b, s, h), generator=gen, device="cuda")
            dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))  # the init's
            a = -(1.0 + 15.0 * torch.rand((h,), generator=gen, device="cuda"))
            bb, cc = (torch.randn((b, s, g, n), generator=gen, device="cuda").to(dtype)
                      for _ in range(2))
            y, state, scratch = ss._launch(x, dt, a, bb, cc)
            key = ("ssd", str(dtype).removeprefix("torch."), *case)
            if case in SSD_BWD_CASES:
                dstate = torch.randn((b, h, p, n), generator=gen, device="cuda")
                grads = ss.ssd_scan_bwd(x, dt, a, bb, cc, scratch, dy, dstate)
                out[key + ("bwd",)] = [t.cpu() for t in (y, state, *grads)]
            else:
                out[key] = [t.cpu() for t in (y, state)]
            del scratch
    return out


def rmsnorm_outputs(torch, rn) -> dict:
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for rows, d in RMSNORM_CASES:
            gen = torch.Generator(device="cuda").manual_seed(5)
            x, g = ((torch.randn((rows, d), generator=gen, device="cuda") * 3).to(dtype)
                    for _ in range(2))
            w = (torch.randn((d,), generator=gen, device="cuda") * 0.1).to(dtype)
            y = rn._forward(x, w, 1e-5)
            dx, dw = rn.rmsnorm_bwd(x, w, g)
            out[("rmsnorm", str(dtype).removeprefix("torch."), rows, d)] = [
                t.cpu() for t in (y, dx, dw)]
    return out


def train_outputs(torch, label, card) -> dict:
    """Per TRAINS path: the fresh state's gradients on the first batch (kept
    leaves), the losses and step ms of TRAIN_STEPS steps, and their peak."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (RunConfig, init_train_state, make_loss_fn,
                                              make_train_step, to_device)
    out = {}
    for arch, seq in TRAINS:
        spec = get_arch(arch)
        cfg = RunConfig(remat="dots", opt=opt.OptConfig(lr=1e-3, warmup_steps=2))
        state = init_train_state(spec, cfg, seed=0, device="cuda")
        data = SyntheticLM(spec, DataConfig(BATCH, seq, seed=0))
        batches = [to_device(data.batch_at(i), "cuda") for i in range(TRAIN_STEPS)]
        leaves = opt.leaves(state["params"])
        n = len(leaves)
        keep = range(n) if arch.startswith("mamba2") else sorted(
            {0, 1, 2, n - 1} | {i for i, t in enumerate(leaves) if t.shape[0] > 1e5})
        for t in leaves:
            t.requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = make_loss_fn(spec, cfg=cfg)(state["params"], batches[0])
        grads = torch.autograd.grad(loss, leaves)
        grad_peak = torch.cuda.max_memory_allocated()
        kept = {i: grads[i].cpu() for i in keep}
        del grads, loss
        step = make_train_step(spec, cfg=cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for b in batches:
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(m["loss"].item())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        print(f"[ab] {label} {card} train {arch} B={BATCH} S={seq} f32 remat=dots: losses "
              f"{losses}; step ms {[round(x, 3) for x in ms]}; peak memory {peak / 2**30:.3f} "
              f"GiB over the steps, {grad_peak / 2**30:.3f} GiB in the first batch's gradient",
              flush=True)
        out[arch] = dict(losses=losses, ms=ms, peak=peak, grads=kept)
        del state, step, batches
        torch.cuda.empty_cache()
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("[ab] CUDA is not available: this needs an NVIDIA GPU")
    args = [a for a in sys.argv[1:] if a != "--bits"]
    if len(args) < 2:
        sys.exit(__doc__)
    label, out_path = args[0], Path(args[1])
    against = Path(args[2]) if len(args) > 2 else None
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build, flash_attention as fa, rmsnorm as rn, ssd_scan as ss
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine
    card = torch.cuda.get_device_name(0)
    import subprocess
    limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    print(f"[ab] {label}: {limit}", flush=True)
    t0 = time.perf_counter()
    _build.build(["flash_attention", "flash_attention_bwd", "rmsnorm", "ssd_scan",
                  "ssd_scan_bwd"])
    print(f"[ab] {label}: kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    got = {**flash_outputs(torch, fa), **ssd_outputs(torch, ss), **rmsnorm_outputs(torch, rn)}
    train = train_outputs(torch, label, card)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"bits": got, "train": train}, out_path)
    if against is not None:
        other = torch.load(against)
        want = other["bits"]
        differ = [key for key in got if not all(torch.equal(x, y) for x, y in
                                                zip(got[key], want[key]))]
        print(f"[ab] {label} {card}: flash o, lse, dq, dk, dv, SSD y, state, dx, ddt, da, db, "
              f"dc and RMSNorm y, dx, dw in {len(got)} cases against {against.name}: bit for "
              f"bit {not differ}; cases that differ {differ}", flush=True)
        bad = bool(differ)
        for arch, r in train.items():
            o = other["train"][arch]
            rel = {i: ((g - o["grads"][i]).abs().max() / o["grads"][i].abs().max()
                       .clamp_min(1e-30)).item() for i, g in r["grads"].items()}
            worst = max(rel, key=rel.get)
            same_loss = r["losses"] == o["losses"]
            print(f"[ab] {label} train {arch} against {against.name}: losses bit for bit "
                  f"{same_loss}; first batch's gradients, {len(rel)} leaves: largest max |diff| "
                  f"/ max |value| {rel[worst]:.3e} (leaf {worst}; tol {GRAD_RTOL}), "
                  f"{sum(v == 0 for v in rel.values())} leaves bit for bit; peak "
                  f"{r['peak'] / 2**30:.3f} GiB against {o['peak'] / 2**30:.3f}", flush=True)
            bad |= not same_loss or rel[worst] > GRAD_RTOL
        if bad:
            sys.exit(1)
    if "--bits" in sys.argv:
        return

    for arch, prompt in MODELS:
        spec = get_arch(arch)
        params = M.init_params(spec, 0, device="cuda")
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, spec.vocab_size, (BATCH, prompt)).astype(np.int32)
        engine = Engine(spec, params, max_len=prompt + NEW, device="cuda")
        engine.generate(prompts, 4)  # warm-up
        decode, prefill = [], []
        for _ in range(CALLS):
            _, stats = engine.generate(prompts, NEW)
            decode.append(stats.decode_s / NEW * 1e3)
            prefill.append(stats.prefill_s * 1e3)
        print(f"[ab] {label} {card} {arch} B={BATCH} prompt={prompt} new={NEW} fp32: decode ms "
              f"a step {[round(x, 3) for x in decode]} median {statistics.median(decode):.3f}; "
              f"prefill ms median {statistics.median(prefill):.3f}", flush=True)
        del params, engine
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
