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
               and its entering state); also at mamba2-130m's train shape as
               one rank of a 16-way 'model' axis scans it, its head_dim
               split to P = 4, forward and backward, against the plain
               version; and at P = 1, 2, 4 and 8 (a group's heads packed
               into tiles of 16 columns: ssd_scan_chunk_state_narrow,
               ssd_scan_state_pass, ssd_scan_output_narrow; backward
               ssd_bwd_chunk_grad_narrow, ssd_bwd_state_pass,
               ssd_bwd_dx_narrow, ssd_bwd_dbc_narrow, ssd_bwd_da), f32 and
               bf16, against the plain version and the P = 16 launch on the
               same heads' x and dy padded with zeros to 16 columns, two calls
               bit for bit, with the 16-rank split's device ms against the
               unsplit scan's.  The SSD rows whose f32 products run in 3xTF32
               on the tensor cores (the backward, every launch below P = 16)
               take the 3xTF32 bound, the CUDA cores' beside it.  Flash attention at head_dim 96
               (phi-3-vision-4.2b, 32 heads).  Flash attention at a query
               offset, forward and backward: qwen2's train shape as the last
               of four 'model' ranks of a sequence-split attention sees it
               (S = 1024 rows at offset 3072 of T = 4096 keys; SDPA with the
               band as its mask), the forward's rows also bit for bit
               against the whole sequence's launch.  The backward kernels: flash
               attention's (up to four launches, each row's device ms split
               by kernel: flash_bwd_delta, D = rowsum(dO o O) and the padded
               log-sum-exp; flash_bwd_dkdv, keys as rows; flash_bwd_dq; and
               under GQA flash_bwd_group_sum, each group's heads added) at
               qwen2's, gemma3's train shape (S = 2048, global and window
               512), granite's and phi-3's shapes against autograd through
               the plain version,
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
               backward call, gradients against the plain version's.  The
               RMSNorm kernels' split-row mode (a row whose columns several
               ranks hold: mamba2-130m's gated norm on one of 16 'model'
               ranks, 96 of its 1536 columns, at its train rows and at
               decode's 4, and a ragged piece of 40): rmsnorm_part_kernel
               (a row's partial sum), rmsnorm_apply_kernel (the scale from
               the reduced sum), and backward the partial sum of
               g (1 + w) x and rmsnorm_split_bwd_kernel with rmsnorm_bwd_dw,
               the other 15 ranks' sums standing in as fixed tensors the
               all-reduce would add; against the plain twins, the backward
               twice for the same bits, and through RMSNormSplitFn on the
               card (no library call computes a split row)
  dse          the design-space explorer's main path: the JAX package's
               backend benchmark population (benchmarks/fig10_agents.py:
               49-107, rebuilt here: 32 seeded collective/network design
               points, qwen2-1.5b on system2 under a pinned request stream of
               256 requests, a 25,872-op trace) through CosmicEnv.step_batch
               on the reference backend (one generation, the oracle),
               torch-unfused and torch (five generations each; pts/s, ms a
               generation, the last_timings split and the host's rest as
               medians with their ranges, each kernel's device ms and the
               copies' by torch.profiler), every member's reward and latency
               within 1e-9 of the oracle; the launch counts of the torch
               generations, every count set to 0 just before them; an fp64
               latency probe (a one-thread chain of dependent fmax and add
               timed by clock64, and the SM clock it implies);
               dse_class_times and dse_sweep at these shapes against their
               plain twins on the card and numpy's batched duration pass, bit
               for bit, twice for the same bits, with bytes and float64
               bounds, the sweep's chain of dependency levels at the probe's
               latency, its cycles per op and where its parent reads are
               served (registers, the ring in shared memory, the finish
               table); then 256 members on torch, 32 of them held against
               the oracle; the sweep at the first 32, 64, 128 and 256 of
               them; the sweep on synthetic parent tables reaching 5,000 ops
               back, against its plain twin and a numpy max-plus; then
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
               trained state's first 2 layers at full width (params, m, v,
               step: 3.9 GB of the 18.5) through repro_torch.ckpt save and
               restore, exactly; then a
               reduced qwen2 step on the card against the CPU, and a reduced
               bf16 state's round trip (bf16 params with their f32 master);
               then all of that again for mamba2-130m at B=4, S=4096 (the
               SSD scan forward and backward; launch counts by layer kind)
  train_bf16   launch/train.py --bf16's configuration (BF16_RUN: bf16
               parameters and compute, f32 master and moments), remat
               "dots", 6 steps of qwen2-1.5b at B=4, S=1024 and of
               mamba2-130m at B=4, S=4096 from the train phase's seed and
               batches, and (after train_more) of gemma3-1b at B=4, S=2048
               (granite's BF16_RUN state, 28 bytes a parameter, does not
               fit the card): launches a step equal to the f32 phase's, step ms,
               tokens/s, peak memory, device busy; every first-step gradient
               finite and not all zero, the first loss within 2e-2 of the
               f32 first step's, and every parameter its master rounded to
               bf16 after the last step; the first step's grad norm and
               the losses of steps 2 to 6 within 5e-3 of the f32 run's
  train_more   f32 training of gemma3-1b (B=4, S=2048: 22 of its 26 layers
               take the window-512 backward) and granite-moe-3b-a800m (B=4,
               S=1024), remat "dots", 6 steps each, the train phase's
               figures and checks (launches, finite and non-zero first-step
               gradients), then each reduced arch's step on the card against
               the CPU (after the dryrun phase, which frees the card of its
               subprocesses' contexts)
  serve_embeddings
               phi-3-vision-4.2b at full width through the embeddings
               frontend (serve/api.py's prefill and serve steps), f32 and
               then bf16: prefill on seeded (4, 1024, 3072) embeddings and
               32 decode steps on seeded (4, 3072) ones, launches (flash at
               head_dim 96 once a layer), prefill ms, decode ms a step, KV
               cache bytes, device busy; the bf16 prefill logits within 0.1
               of the f32 ones' scale; prefill(S) against prefill(S-1) and
               one decode step within 1e-3; the reduced arch's forward on
               embeddings, card against CPU, within 1e-4
  mesh         the multi-device runtime on a mesh of one card (a world-1 NCCL
               group): qwen2-1.5b at full width and depth, f32, B=4, S=1024,
               remat "dots", 6 steps unsharded and 6 under plan_for_mesh of a
               (1, 1) ("data", "model") mesh from the same seed and batches,
               every parameter and optimizer leaf a DTensor and the kernels
               reached through local_map; losses and every parameter bit for
               bit (else within 1e-6 relative, the leaves that differ
               printed), launches per step equal to the train phase's, step
               ms (the median of steps 2 to 6: the first warms DTensor's
               sharding cache), peak memory and device busy share of both;
               mamba2-130m the
               same at 4 of its 24 layers, B=4, S=4096 (the SSD kernels
               through local_map), its losses held and its parameters'
               difference printed; one make_dp_train_step step with int8
               compression on a world-1 data mesh (qwen2 at 2 layers), whose
               loss equals the unsharded step's, compressed_psum on card
               tensors against its formula, and pipeline_forward with one
               stage against the sequential stage
  serve_bf16   (after each model's serve_mesh lines) the same full-width
               model served in bf16 through Engine(dtype=torch.bfloat16),
               its weights the serve phase's cast to bf16: launches of one
               generate equal to the f32 path's (counts set to 0 just before
               it), prefill ms, decode ms a step and tok/s, device busy and
               device ms by kernel class, and prefill's last-position logits
               finite and within 0.1 of the scale of the f32 weights' f32
               prefill logits.  granite runs both at capacity factor 8, each
               bf16 token routed to the experts the f32 run chose; since its
               random weights amplify a rounding with depth (the f32 prefill
               of its bf16-rounded weights lies 0.075 of the scale from the
               f32 weights' at 32 layers), each of its layers and its head
               run in bf16 on the f32 prefill's input to them, the update
               within 0.1 of f32's, and the whole prefill's gap is printed
  serve_mesh   (after each model's serve and consistency lines) the same
               full-width model served under plan_for_mesh of a (1, 1)
               ("data", "model") mesh of the world-1 NCCL group: parameters
               and caches DTensors, the kernels reached through local_map;
               Engine(plan=) from the same weights and prompts generates
               the serve phase's first 4 tokens (MESH_NEW: DTensor's host
               dispatch makes each step slow) with its launch counts a
               token (counts set to 0 just before it), prefill logits bit
               for bit against the unsharded prefill and MESH_DECODE_STEPS
               greedy decode steps' logits within 1e-5 relative, the steps
               that differ printed (on a mesh of one the caches' kv_seq is
               whole, so decode reads the slice the unsharded path reads;
               the masked read of a split kv_seq is held on gloo ranks by
               tests/test_torch_serve_plan.py); prefill ms, decode ms a
               step and device busy
               share of both; and rmsnorm's host cost a call at the decode
               shape through its operator (torch.ops.repro_torch) against
               the bare launch
  dryrun       (collected before train_more) python -m repro_torch.launch.dryrun
               in subprocesses started after the build, beside the card's
               phases at the lowest CPU priority and one thread each (each
               holds a CUDA context of about 0.5 GiB until it ends), on a
               fake world, at full size with fake tensors labelled cuda:
               deepseek-67b train_4k pod (95 layers, 8 microbatches: minutes
               on one core; each weight's gradient reduce-scattered as
               autograd makes it), mamba2-130m prefill_32k pod (d_inner kept
               split through the gated norm and the head view), qwen2-1.5b
               train_4k pod, gemma3-1b decode_32k multipod, mamba2-130m
               long_500k pod, granite-moe-3b-a800m and moonshot-v1-16b-a3b
               train_4k pod (the MoE with its ff columns, and its experts,
               split over 'model'), mamba2-130m train_4k and decode_32k pod
               (the SSD scan split over head_dim, the head's vocabulary over
               an idle 'model'), jamba-v0.1-52b long_500k pod (batch 1: the
               experts on their FSDP shards), musicgen-medium decode_32k and
               gemma3-1b long_500k pod (decode's softmax on each rank's own
               kv_seq slots), granite-moe-3b-a800m prefill_32k pod (its ff
               columns gathered, its token groups split) and yi-9b train_4k
               pod (microbatches on their rows), each ok with its peak a
               device within the card's memory, with its peak GiB a device,
               FLOPs a device against model_flops / n_chips, collective
               bytes by kind and seconds (seven also their all-gather bytes
               and peak beside the CPU host's counts before the byte repairs
               of the last two changes); and reduced qwen2-1.5b train_4k pod
               under --device cpu and --device cuda, whose records agree key
               for key but lower_s
Then the card's name and power limit, one JSON line with every kernel's
numbers, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero without that last line, as does a host without CUDA or a directory
that holds this script and nothing else of the repository.
"""
from __future__ import annotations

import dataclasses
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
M_MODEL_RANKS = 16  # the pod's 'model' axis: mamba2's 24 heads do not divide it, its head_dim does
NARROW_DIMS = (1, 2, 4, 8)  # the SSD kernels' head dims below 16: a group's heads packed in a tile
SPLIT_RAGGED = 40  # a ragged width of the RMSNorm kernels' split-row mode (mamba2's piece: 96)
# flash attention at a query offset: qwen2's train_4k sequence as the last of
# four 'model' ranks sees it under sequence-split attention (its rows
# 3072..4095 against all 4096 keys)
OFFSET_S, OFFSET_T, OFFSET = 1024, 4096, 3072
REMAT_TOL = 1e-5  # loss and grad norm of remat none/full vs dots, relative
# bf16 serving: prefill's last-position logits against the f32 prefill's,
# max |diff| over the largest |f32 logit| (tests/test_torch_bf16_serve.py's
# tolerance against the JAX package)
BF16_SERVE_TOL = 0.1
BF16_LOSS_RTOL = 2e-2  # BF16_RUN's first loss against the f32 step's (test_torch_train.py)
# BF16_RUN against the f32 run from the same seed and batches, relative: the
# first step's grad norm (read at 1.6e-4 to 3.5e-4 over qwen2, mamba2 and
# gemma3), and the losses of the later steps, after updates (2.8e-5 to 8.8e-4)
BF16_GRAD_RTOL, BF16_STEP_RTOL = 5e-3, 5e-3
# f32 training of the other two serving archs: gemma3-1b at a sequence where
# 22 of its 26 layers run the window-512 backward, granite-moe-3b-a800m at
# qwen2's; (arch, batch, sequence)
G_TRAIN_B, G_TRAIN_SEQ = 4, 2048
MORE_TRAIN = ((GEMMA, G_TRAIN_B, G_TRAIN_SEQ), (GRANITE, TRAIN_BATCH, TRAIN_SEQ))
EMB_PROMPT = 1024  # phi-3-vision-4.2b's prompt through the embeddings frontend
EMB_SCALE = 0.1  # its seeded embeddings' standard deviation
MESH_STEPS = 6  # train steps of the mesh phase, unsharded and under a (1, 1) plan
MESH_RTOL = 1e-6  # the (1, 1) plan vs unsharded, where some op breaks bit equality
MESH_MAMBA_LAYERS = 4  # mamba2-130m's depth in the mesh phase (of 24)
MESH_DECODE_STEPS = 2  # greedy decode steps whose logits serve_mesh holds
MESH_DECODE_PROFILED = 3  # decode steps serve_mesh traces for its device time
# serve_mesh's new tokens, the serve phase's first MESH_NEW: a decode step
# under the (1, 1) plan costs about 27x the unsharded one in host dispatch
MESH_NEW = 4
ROUND_TRIP_LAYERS = 2  # layers of the trained full-width state saved and restored
MESH_DECODE_RTOL = 1e-5  # their logits under the (1, 1) plan vs unsharded, relative
# the dry run's full-size cells (each must fit the card's memory), and the
# reduced one run under both labels; all started after the build, beside
# the card's phases
DRYRUN_CELLS = (("deepseek-67b", "train_4k", "pod"), ("mamba2-130m", "prefill_32k", "pod"),
                ("qwen2-1.5b", "train_4k", "pod"), ("gemma3-1b", "decode_32k", "multipod"),
                ("mamba2-130m", "long_500k", "pod"), ("granite-moe-3b-a800m", "train_4k", "pod"),
                ("moonshot-v1-16b-a3b", "train_4k", "pod"), ("mamba2-130m", "train_4k", "pod"),
                ("mamba2-130m", "decode_32k", "pod"), ("jamba-v0.1-52b", "long_500k", "pod"),
                ("musicgen-medium", "decode_32k", "pod"), ("gemma3-1b", "long_500k", "pod"),
                ("granite-moe-3b-a800m", "prefill_32k", "pod"), ("yi-9b", "train_4k", "pod"))
# all-gather bytes a device of those cells before decode's softmax ran on
# each rank's own kv_seq slots, the ff-split MoE kept its token groups split
# and a microbatch kept its rows split: the CPU host's count, labels cpu;
# and (all-gather bytes, peak GiB) before mamba2's gated norm and head view
# kept d_inner split, the unsplit vocabulary's loss took the fused NLL and
# each gradient was reduce-scattered as autograd made it
DRYRUN_GATHER_BEFORE = {("musicgen-medium", "decode_32k"): 1.232e9,
                        ("gemma3-1b", "long_500k"): 3.609e7,
                        ("granite-moe-3b-a800m", "prefill_32k"): 3.727e10,
                        ("yi-9b", "train_4k"): 3.900e11}
DRYRUN_BEFORE = {("mamba2-130m", "prefill_32k"): (1.3279e10, 0.6675),
                 ("mamba2-130m", "train_4k"): (3.8659e10, 4.1173),
                 ("deepseek-67b", "train_4k"): (1.0774e12, 13.7661)}
DRYRUN_REDUCED = ("qwen2-1.5b", "train_4k", "pod")
DRYRUN_TIMEOUT = 600  # seconds, per subprocess
# the reduced train step, card vs CPU: loss rtol, grads rtol / atol
STEP_TOL = {"loss": 1e-4, "grad_rtol": 1e-3, "grad_atol": 1e-5}
# the DSE: the backend benchmark's population (benchmarks/fig10_agents.py:
# 49-107) of DSE_POINTS members over a request stream of DSE_REQUESTS,
# then DSE_BIG members of which DSE_CHECKED are held against the oracle
DSE_ARCH, DSE_SYSTEM, DSE_REQUESTS = "qwen2-1.5b", "system2", 256
DSE_POINTS, DSE_BIG, DSE_CHECKED, DSE_REPEATS = 32, 256, 32, 5
DSE_RTOL = 1e-9  # the issue-order sweep vs the event loop, as the JAX backend's parity tests
DSE_SCAN = (32, 64, 128, 256)  # the sweep at the first P members of the DSE_BIG population
# the sweep on synthetic parent tables (dse_sim.synthetic_sweep_case: parents
# up to 5,000 ops back, past the ring): (n_ops, W, P)
DSE_WINDOW_CASES = ((20011, 8, 257), (20011, 3, 33))
PROBE_LINKS = 1 << 22  # dependent (fmax, add) pairs the fp64 latency probe times


T_START = time.perf_counter()


def elapsed(phase: str) -> None:
    """The run's seconds so far, as ``phase`` starts."""
    print(f"[time] {phase} starts at {time.perf_counter() - T_START:.1f} s", flush=True)


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


KERNEL_CLASSES = {"gemm": ("gemm", "xmma", "cutlass", "nvjet"), "ssd_scan": ("ssd_scan",),
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


def ssd_bound(nbytes: float, flops: float, name: str, tensor_cores: bool) -> tuple[float, str, dict]:
    """An SSD kernel's bound: where its f32 products run in 3xTF32 on the
    tensor cores (the backward, and every launch below head dim 16), three
    TF32 products a product, with the CUDA cores' bound beside it."""
    if name == "float32" and tensor_cores:
        cores = bound(nbytes, flops, name)
        return (*bound(nbytes, 3 * flops, "tf32"),
                dict(bound_f32_cores_ms=cores[0], bound_f32_cores_by=cores[1]))
    return (*bound(nbytes, flops, name), {})


def band_mask(torch, s, t, window, q_offset):
    """Query row i (at position q_offset + i) sees key j: j <= q_offset + i
    and, with a window, j > q_offset + i - window; SDPA's mask for the
    library call (``is_causal`` where it is the plain causal mask)."""
    qpos = q_offset + torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(t, device="cuda")[None, :]
    band = (kpos <= qpos) & ((kpos > qpos - window) if window else True)
    return band, (dict(attn_mask=band) if window or q_offset else dict(is_causal=True))


def check_flash(torch, F, fa, b, s, t, h, g, hd, window, dtype, iters, q_offset=0):
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((b, n, heads, hd), generator=gen, device="cuda").to(dtype)
               for n, heads in ((s, h), (t, g), (t, g)))
    got = fa.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    name = dtype_name(dtype)
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=TOL[name], rtol=TOL[name])
    extra = {}
    if q_offset:  # the rows of the whole sequence's launch (q_offset a multiple of its tiles)
        whole_q = torch.randn((b, t, h, hd), generator=gen, device="cuda").to(dtype)
        whole_q[:, q_offset:q_offset + s] = q
        whole = fa.flash_attention(whole_q, k, v, causal=True, window=window)
        extra["same_bits_as_whole_rows"] = bool(torch.equal(got, whole[:, q_offset:q_offset + s]))
        ok = ok and extra["same_bits_as_whole_rows"]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    band, mask = band_mask(torch, s, t, window, q_offset)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **mask)
    kernel = lambda: fa.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    lib_err = (lib().transpose(1, 2).float() - want.float()).abs().max().item()
    pairs = int(band.sum().item())
    nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) * q.element_size()
    flops = 4.0 * hd * pairs * b * h
    bound_ms, bound_by = bound(nbytes, flops, name)
    if name == "float32":  # the kernel runs f32 as three TF32 products on the tensor cores
        extra["bound_3xtf32_ms"], extra["bound_3xtf32_by"] = bound(nbytes, 3 * flops, "tf32")
    ms, library_ms = paired_ms(kernel, lib, iters)
    row = dict(
        case=f"flash_attention {name} B={b} S={s} T={t} H={h} G={g} hd={hd} causal window={window}"
             + (f" q_offset={q_offset}" if q_offset else ""),
        max_abs_err=err, tol=TOL[name], ok=bool(ok),
        ms=ms, device_ms=device_ms(kernel, iters),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True, window=window,
                                                          q_offset=q_offset), iters),
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


def check_flash_bwd(torch, F, fa, b, s, t, h, g, hd, window, dtype, iters, q_offset=0):
    """The backward kernels (dq, dk, dv from q, k, v, o, lse, dO) vs autograd
    through the plain version; timed beside SDPA's backward."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do = (torch.randn((b, n, heads, hd), generator=gen, device="cuda").to(dtype)
                   for n, heads in ((s, h), (t, g), (t, g), (s, h)))
    scale = hd ** -0.5
    o, lse = fa._launch(q, k, v, True, window, scale, with_lse=True, q_offset=q_offset)
    kernel = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=window,
                                            scale=scale, q_offset=q_offset)
    got = kernel()
    deterministic = same_bits(torch, got, kernel())
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention_plain(*leaves, causal=True, window=window, q_offset=q_offset)
    plain = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
    want = plain()
    torch.cuda.synchronize()
    name = dtype_name(dtype)
    errs = [rel_close(torch, x, y, TOL[name]) for x, y in zip(got, want)]
    lib_leaves = [x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    band, mask = band_mask(torch, s, t, window, q_offset)
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
             f"window={window}" + (f" q_offset={q_offset}" if q_offset else ""),
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


class PieceSums:
    """The split-row mode's ``reduce`` on one card: a rank's partial sums
    plus the other ranks' (fixed tensors), as the all-reduce over the ranks
    that split the row adds them: the sum of squares first, then the sum of
    g (1 + w) x."""

    def __init__(self, others):
        self.others, self.calls = others, 0

    def __call__(self, t):
        self.calls += 1
        return t + self.others[self.calls - 1]


def check_rmsnorm_split(torch, rn, ref, rows, d, d_full, dtype, iters):
    """The RMSNorm kernels' split-row mode on one rank's ``d`` columns of rows
    ``d_full`` wide, the other ranks' sums (of squares, and of g (1 + w) x)
    standing in as fixed tensors: each launch against its plain twin on the
    same inputs (the partial sums; the apply and the backward from the same
    reduced sums), the backward twice for the same bits, and forward and
    backward through ``rmsnorm_split`` (RMSNormSplitFn) against the plain
    chain.  Returns the forward's row (the partial sum and the apply) and
    the backward's (the partial sum of g (1 + w) x, then the gradient:
    rows, then dw).  No PyTorch call computes a split row (F.rms_norm takes
    the whole row), so neither has a library time."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = (torch.randn((rows, d), generator=gen, device="cuda") * 3).to(dtype)
    w = (torch.randn((d,), generator=gen, device="cuda") * 0.1).to(dtype)
    g = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    rest = d_full - d
    others = [(torch.randn((rows, rest), generator=gen, device="cuda") * 3).square().sum(-1),
              torch.randn((rows,), generator=gen, device="cuda") * rest ** 0.5]
    name = dtype_name(dtype)
    ss_p = ref.rmsnorm_part_ref(x) + others[0]
    st_p = ref.rmsnorm_part_ref(x, w, g) + others[1]
    sums = [rel_close(torch, rn.rmsnorm_part(x) + others[0], ss_p, 1e-5),
            rel_close(torch, rn.rmsnorm_part(x, w, g) + others[1], st_p, 1e-5)]
    y = rn.rmsnorm_apply(x, w, ss_p, d_full=d_full)
    y_p = ref.rmsnorm_apply_ref(x, w, ss_p, d_full=d_full)
    bwd = lambda: rn.rmsnorm_split_bwd(x, w, g, ss_p, st_p, d_full=d_full)
    got = bwd()
    deterministic = same_bits(torch, got, bwd())
    want = ref.rmsnorm_split_bwd_ref(x, w, g, ss_p, st_p, d_full=d_full)
    leaves = [x.detach().requires_grad_(), w.detach().requires_grad_()]
    fn_y = rn.rmsnorm_split(*leaves, d_full=d_full, reduce=PieceSums(others))
    fn_grads = torch.autograd.grad(fn_y, leaves, g)
    torch.cuda.synchronize()
    tol = RMS_TOL[name]
    fwd_errs = sums[:1] + [rel_close(torch, y, y_p, tol), rel_close(torch, fn_y, y_p, tol)]
    bwd_errs = sums[1:] + [rel_close(torch, a, b, tol) for a, b in zip(got, want)] + [
        rel_close(torch, a, b, tol) for a, b in zip(fn_grads, want)]
    elt = x.element_size()
    out = []
    for case, errs, kernel, plain, nbytes, flops, extra in (
            (f"rmsnorm_split {name} rows={rows} d={d} of {d_full}", fwd_errs,
             lambda: rn.rmsnorm_apply(x, w, rn.rmsnorm_part(x) + others[0], d_full=d_full),
             lambda: ref.rmsnorm_apply_ref(x, w, ref.rmsnorm_part_ref(x) + others[0],
                                           d_full=d_full),
             # x read, y written, w; the f32 row sums written and read
             (2 * x.numel() + w.numel()) * elt + 2 * rows * 4, 4.0 * rows * d, {}),
            (f"rmsnorm_split_bwd {name} rows={rows} d={d} of {d_full}", bwd_errs,
             lambda: rn.rmsnorm_split_bwd(x, w, g, ss_p, rn.rmsnorm_part(x, w, g) + others[1],
                                          d_full=d_full),
             lambda: ref.rmsnorm_split_bwd_ref(x, w, g, ss_p, ref.rmsnorm_part_ref(x, w, g)
                                               + others[1], d_full=d_full),
             # x, g read, dx written; w, dw; the two row sums read, T written
             (3 * x.numel() + 2 * w.numel()) * elt + 3 * rows * 4, 8.0 * rows * d,
             {"deterministic": deterministic})):
        phases = {k: v for k, v in device_ms_split(kernel, iters, "rmsnorm").items()
                  if k.startswith("rmsnorm")}
        bound_ms, bound_by = bound(nbytes, flops, name)
        row = dict(case=case, max_abs_err=max(e[0] for e in errs),
                   rel_err=[e[1] for e in errs], tol=tol,
                   ok=all(e[2] for e in errs) and extra.get("deterministic", True),
                   ms=cuda_ms(kernel, iters), device_ms=sum(phases.values()) or None,
                   device_ms_by_kernel=phases, plain_ms=cuda_ms(plain, iters),
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by, **extra)
        print(f"[kernels] {json.dumps(row)}")
        out.append(row)
    return out


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
    bound_ms, bound_by, extra = ssd_bound(nbytes, flops, name, p < 16)
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
        bound_ms=bound_ms, bound_by=bound_by, **extra)
    print(f"[kernels] {json.dumps(row)}")
    return row


def ssd_plain_grads(torch, ss, inputs, dy, dstate):
    """Autograd through ``ssd_scan_plain`` on inputs (x, dt, a, b, c) with
    the output gradients (dy, dstate): the gradients and that backward's ms."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    plain_out = ss.ssd_scan_plain(*leaves)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = torch.autograd.grad(plain_out, leaves, (dy, dstate))
    torch.cuda.synchronize()
    return want, (time.perf_counter() - t0) * 1e3


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
    want, plain_ms = ssd_plain_grads(torch, ss, (x, dt, a, bb, cc), dy, dstate)
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
    bound_ms, bound_by, extra = ssd_bound(nbytes, flops, name, True)
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
        **(dict(zip(("heads_per_tile", "tiles_per_group", "tiles_per_block"),
                    ss.narrow_blocks(b, s, h, g, p))) if p < 16 else
           dict(heads_per_block=ss.heads_per_block(h // g, b * h * -(-s // ss.CHUNK)))),
        plain_ms=plain_ms,
        library_ms=None, library_note="no single PyTorch call computes the SSD scan's gradient",
        bound_ms=bound_ms, bound_by=bound_by, **extra)
    print(f"[kernels] {json.dumps(row)}")
    return row


def check_ssd_narrow(torch, ss, b, s, h, g, q, n, dtype, iters):
    """The SSD kernels at a head dim q below 16 (a group's heads packed into
    tiles of 16 columns), forward and backward, against the plain version
    (``ssd_scan_plain`` and autograd through it; plain_ms is its time) and
    against the Q = 16 launch on the same heads' x and dy padded with zeros
    to 16 columns (whose extra columns add nothing): y and the final state
    within SSD_TOL, every gradient within TOL; two calls of each must give
    the same bits.  Returns the forward's and the backward's rows."""
    x, dt, a, bb, cc = ssd_inputs(torch, b, s, h, g, q, n, dtype, "model")
    gen = torch.Generator(device="cuda").manual_seed(7)
    dy = torch.randn((b, s, h, q), generator=gen, device="cuda").to(dtype)
    dstate = torch.randn((b, h, q, n), generator=gen, device="cuda")
    fwd = lambda: ss._launch(x, dt, a, bb, cc)
    y, st, scratch = fwd()
    bwd = lambda: ss.ssd_scan_bwd(x, dt, a, bb, cc, scratch, dy, dstate)
    grads = bwd()
    y2, st2, _ = fwd()
    same_fwd = same_bits(torch, (y, st), (y2, st2))
    same_bwd = same_bits(torch, grads, bwd())
    del y2, st2
    pad = lambda t: torch.nn.functional.pad(t, (0, 16 - q))
    x16, dy16 = pad(x), pad(dy)
    ref_fwd = lambda: ss._launch(x16, dt, a, bb, cc)
    y16, st16, sc16 = ref_fwd()
    ref_bwd = lambda: ss.ssd_scan_bwd(x16, dt, a, bb, cc, sc16, dy16,
                                      torch.nn.functional.pad(dstate, (0, 0, 0, 16 - q)))
    g16 = ref_bwd()
    inputs = (x, dt, a, bb, cc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_y, plain_st = ss.ssd_scan_plain(*inputs)
    torch.cuda.synchronize()
    plain_fwd_ms = (time.perf_counter() - t0) * 1e3
    plain_g, plain_bwd_ms = ssd_plain_grads(torch, ss, inputs, dy, dstate)
    name = dtype_name(dtype)
    fwd_errs = [rel_close(torch, y, y16[..., :q], SSD_TOL[name]),
                rel_close(torch, st, st16[:, :, :q], SSD_TOL["float32"]),
                rel_close(torch, y, plain_y, SSD_TOL[name]),
                rel_close(torch, st, plain_st, SSD_TOL["float32"])]
    bwd_errs = [rel_close(torch, u, w, TOL[name])
                for u, w in zip(grads + grads, (g16[0][..., :q], *g16[1:], *plain_g))]
    del plain_y, plain_st, plain_g
    torch.cuda.empty_cache()
    esize = x.element_size()
    k, tiles, kt = ss.narrow_blocks(b, s, h, g, q)
    layout = dict(heads_per_tile=k, tiles_per_group=tiles, tiles_per_block=kt)
    rows = []
    for case, errs, kernel, reference, prefix, nbytes, flops, same, scr, plain_ms in (
            (f"ssd_scan {name} narrow B={b} S={s} H={h} G={g} P={q} N={n}", fwd_errs, fwd,
             ref_fwd, "ssd_scan",
             (2 * x.numel() + bb.numel() + cc.numel()) * esize
             + (dt.numel() + a.numel() + st.numel()) * 4,
             4.0 * s * n * q * b * h, same_fwd, ss.scratch_floats(b, s, h, q, n), plain_fwd_ms),
            (f"ssd_scan_bwd {name} narrow B={b} S={s} H={h} G={g} P={q} N={n}", bwd_errs, bwd,
             ref_bwd, "ssd_bwd",
             (3 * x.numel() + 4 * bb.numel()) * esize
             + (2 * dt.numel() + 2 * a.numel() + dstate.numel()) * 4,
             8.0 * s * n * q * b * h, same_bwd, ss.bwd_scratch_floats(b, s, h, g, q, n),
             plain_bwd_ms)):
        bound_ms, bound_by, extra = ssd_bound(nbytes, flops, name, True)
        phases = device_ms_split(kernel, iters, prefix)
        rows.append(dict(
            case=case, reference="the P = 16 launch on x and dy padded with zeros to 16 columns, "
                                 "then the plain version (autograd through it backward)",
            max_abs_err=max(e[0] for e in errs), rel_err=[e[1] for e in errs],
            tol=SSD_TOL[name] if prefix == "ssd_scan" else TOL[name], deterministic=same,
            ok=all(e[2] for e in errs) and same, ms=cuda_ms(kernel, iters),
            device_ms=sum(phases.values()) or None, device_ms_by_kernel=phases,
            reference_ms=cuda_ms(reference, iters), plain_ms=plain_ms, library_ms=None,
            library_note="no single PyTorch call computes the SSD scan or its gradient",
            scratch_bytes=4 * scr, bound_ms=bound_ms, bound_by=bound_by, **layout, **extra))
        print(f"[kernels] {json.dumps(rows[-1])}")
    return rows


def serve(torch, np, M, Engine, counted, param_count, card, spec, prompt, want):
    """One full-width ``Engine.generate`` (B=BATCH, NEW new tokens, fp32,
    greedy) with every launch count set to 0 just before it; fails unless the
    counts are ``want``.  Returns (params, prompts, launches, the generated
    tokens, their ServeStats, device ms of prefill and of a decode step)."""
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
    pre, step = serve_device_time(torch, M, spec, params, prompts, NEW, torch.float32)
    print(f"[serve] {spec.name} device busy (torch.profiler): prefill "
          f"{busy_share(pre, stats.prefill_s * 1e3)}; decode step "
          f"{busy_share(step, stats.decode_s * 1e3 / NEW)}")
    top = sorted(pre.items(), key=lambda kv: -kv[1])[:6]
    print(f"[serve] {spec.name} prefill's largest device kernels (ms): "
          + "; ".join(f"{name[:80]} {ms:.3f}" for name, ms in top))
    return params, prompts, launches, out, stats, (sum(pre.values()), sum(step.values()))


def serve_device_time(torch, M, spec, params, prompts, new, dtype):
    """Device ms by kernel name of one prefill of ``prompts`` and of one
    decode step after it, in ``dtype`` (torch.profiler)."""
    tok = torch.as_tensor(prompts, device="cuda")
    b, s = prompts.shape
    caches = M.init_caches(spec, b, s + new, dtype=dtype, device="cuda")
    pre = device_by_kernel(lambda: M.prefill(params, tok, caches, spec, compute_dtype=dtype), 2)
    step = device_by_kernel(lambda: M.decode_step(params, caches, tok[:, -1], s, spec,
                                                  compute_dtype=dtype), 8)
    return pre, step


def busy_share(by_name, wall_ms) -> str:
    """Device ms of a traced call against its wall ms, and by kernel class."""
    if not by_name:
        return "not measured"
    dev = sum(by_name.values())
    classes = ", ".join(f"{c} {ms:.3f}" for c, ms in by_class(by_name).items())
    return f"{dev:.3f} ms = {dev / wall_ms:.3f} of its wall ({classes} ms)"


def serve_bf16(torch, np, M, Engine, moem, map_with_path, counted, card, spec, params, prompts,
               want):
    """``spec`` served in bf16 from the serve phase's weights and prompts: the
    weights cast to bf16 (the values ``init_params(dtype=torch.bfloat16)``
    draws), ``Engine(dtype=torch.bfloat16)`` for NEW tokens with every
    launch count set to 0 just before it, which must be ``want`` (the f32
    path's); prefill ms, decode ms a step and tok/s, device busy and device
    ms by kernel class; prefill's last-position logits finite and within
    BF16_SERVE_TOL of the scale of the f32 prefill's from the f32 weights.
    An MoE runs both prefills at NO_DROP_CAPACITY, and each token of the
    bf16 one goes to the experts the f32 one chose for it, with bf16's
    weights over them: random weights route almost uniformly, so bf16's
    rounding of near-tied router probabilities would hand tokens other
    expert sets, more with each layer.  Returns the launches."""
    from repro_torch.train.optimizer import leaves
    bf16, f32 = torch.bfloat16, torch.float32
    p16 = map_with_path(lambda _, t: t.to(bf16), params)
    weights = sum(t.numel() * t.element_size() for t in leaves(p16))
    b, s = prompts.shape
    eng = Engine(spec, p16, max_len=s + NEW, dtype=bf16, device="cuda")
    eng.generate(prompts, max_new=2)  # warm-up: the bf16 GEMMs' handles
    for fn in counted.values():
        fn.launches = 0
    out, stats = eng.generate(prompts, max_new=NEW)
    launches = {name: fn.launches for name, fn in counted.items()}
    if launches != want:
        fail(f"serve_bf16 {spec.name}: kernel launches in one generate: {launches}, expected "
             f"{want}")
    if out.shape != (b, NEW) or out.min() < 0 or out.max() >= spec.vocab_size:
        fail(f"serve_bf16 {spec.name}: tokens out of range: shape {out.shape}")
    pre, step = serve_device_time(torch, M, spec, p16, prompts, NEW, bf16)
    tok = torch.as_tensor(prompts, device="cuda")
    chosen, flips, route, default = [], [], moem.route, moem.CAPACITY_FACTOR

    def recording(logits, k, cap):  # an f32 run: each MoE call's experts a token
        out = route(logits, k, cap)
        chosen.append(out[0])
        return out

    def replaying(logits, k, cap):  # the matching call: f32's experts, its own weights over them
        want = chosen[len(flips)]
        own = torch.topk(logits, k, dim=-1).indices.sort(-1).values
        flips.append(int((own != want.sort(-1).values).any(-1).sum()))
        keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(-1, want, True)
        return route(logits.masked_fill(~keep, float("-inf")), k, cap)

    def last_logits(p, dt):
        with torch.inference_mode():
            return M.prefill(p, tok, M.init_caches(spec, b, s, dtype=dt, device="cuda"), spec,
                             compute_dtype=dt)[0].float()

    rel = lambda a, b: ((a.float() - b).abs().max() / b.abs().max()).item()
    moem.CAPACITY_FACTOR = NO_DROP_CAPACITY if spec.n_experts else default
    try:
        moem.route = recording if spec.n_experts else route
        ref = last_logits(params, f32)
        moem.route = replaying if spec.n_experts else route
        got = last_logits(p16, bf16)
        if spec.n_experts:
            own_sets = list(flips)
            flips.clear()
            rounded = rel(last_logits(map_with_path(lambda _, t: t.float(), p16), f32), ref)
            chosen.clear(), flips.clear()
            moem.route = lambda *a: (recording if len(chosen) == len(flips) else replaying)(*a)
            by_layer = layer_by_layer(torch, M, spec, params, p16, tok)
    finally:
        moem.CAPACITY_FACTOR, moem.route = default, route
    finite = bool(torch.isfinite(got).all())
    err = rel(got, ref)
    print(f"[serve_bf16] {card} | {spec.name} Engine(dtype=bfloat16) B={b} prompt={s} new={NEW}, "
          f"bf16 weights {weights / 1e9:.3f} GB: prefill {stats.prefill_s * 1e3:.3f} ms, decode "
          f"{stats.decode_tok_per_s:.3f} tok/s ({stats.decode_s * 1e3 / NEW:.3f} ms/step); "
          f"launches {launches} (the f32 path's); first tokens {out[0, :8].tolist()}")
    print(f"[serve_bf16] {spec.name} device busy (torch.profiler): prefill "
          f"{busy_share(pre, stats.prefill_s * 1e3)}; decode step "
          f"{busy_share(step, stats.decode_s * 1e3 / NEW)}")
    if not spec.n_experts:
        print(f"[serve_bf16] {spec.name} bf16 prefill's last-position logits against the f32 "
              f"weights' f32 prefill: max |diff| / max |f32 logit| {err:.4e} (tol "
              f"{BF16_SERVE_TOL}), finite {finite}, max |logit| {ref.abs().max().item():.3e}")
        if not finite or not err <= BF16_SERVE_TOL:
            fail(f"serve_bf16 {spec.name}: bf16 prefill logits off the f32 ones")
    else:
        worst = max(by_layer)
        print(f"[serve_bf16] {spec.name} at capacity factor {NO_DROP_CAPACITY}, each bf16 token "
              f"routed to the f32 run's experts (bf16's own top-{spec.top_k} would differ for "
              f"{own_sets[0]} of {b * s} tokens in the first layer, {min(own_sets)} to "
              f"{max(own_sets)} a layer): every layer and the head in bf16 on the f32 prefill's "
              f"input to it, its update (output less input) against f32's, max |diff| / max "
              f"|f32 update| by layer {[round(e, 4) for e in by_layer[:-1]]}, head "
              f"{by_layer[-1]:.4e}, worst {worst:.4e} (tol {BF16_SERVE_TOL}); the whole bf16 "
              f"prefill's last-position logits {err:.4e} of the f32 ones' scale, finite {finite} "
              f"(not held: the f32 prefill of the bf16-rounded weights already lies {rounded:.4e} "
              f"from them, this arch's random weights amplifying a rounding with depth)")
        if not finite or not worst <= BF16_SERVE_TOL:
            fail(f"serve_bf16 {spec.name}: a bf16 layer's update is off the f32 one")
    del eng, p16
    return launches


def layer_by_layer(torch, M, spec, params, p16, tok) -> list[float]:
    """Each layer of ``spec``'s prefill run in f32 on the f32 prefill's input
    to it, and in bf16 (weights ``p16``) on that input rounded to bf16; then
    the head the same way on the last layer's output.  Per layer, max |bf16
    - f32| of its update (its output less its input) over max |f32
    update|; last, the head's logits the same way."""
    from repro_torch.models import blocks
    from repro_torch.parallel.sharding import NULL_PLAN
    bf16, f32 = torch.bfloat16, torch.float32
    b, s = tok.shape
    pos = M._positions(s, tok.device)
    caches = {dt: M.init_caches(spec, b, s, dtype=dt, device="cuda") for dt in (f32, bf16)}
    errs = []
    with torch.inference_mode():
        x = M._embed_in(params, tok, spec, f32)
        for i, ld in enumerate(spec.layer_defs()):
            y, x16 = {}, x.to(bf16)
            for dt, p, xin in ((f32, params, x), (bf16, p16, x16)):
                y[dt], caches[dt][i] = blocks._apply_prefill(p["stack"][i], xin, pos, ld, spec,
                                                             NULL_PLAN, caches[dt][i])
            want = y[f32] - x
            errs.append(((y[bf16].float() - x16.float() - want).abs().max()
                         / want.abs().max()).item())
            x = y[f32]
        want = M._head(params, x[:, -1], spec)
        errs.append(((M._head(p16, x[:, -1].to(bf16), spec).float() - want).abs().max()
                     / want.abs().max()).item())
    return errs


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


def serve_mesh(torch, np, M, Engine, counted, card, spec, params, prompts, want, base):
    """``spec`` served under plan_for_mesh of a (1, 1) ("data", "model") mesh
    of the world-1 NCCL group, from the serve phase's weights and prompts:
    ``Engine(plan=)`` for MESH_NEW new tokens, every launch count set to 0
    just before it, must give the serve phase's launches a token (``want``
    is theirs for NEW) and its first MESH_NEW tokens (``base``: tokens,
    stats and device ms); prefill logits bit for bit and MESH_DECODE_STEPS
    greedy decode steps' logits within MESH_DECODE_RTOL of the unsharded
    ones.  Returns the launches."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import NULL_PLAN, distribute_tree, placements, plan_for_mesh
    base_out, base_stats, (base_pre_ms, base_step_ms) = base
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    plan = plan_for_mesh(mesh)
    dparams = distribute_tree(params, M.param_axes(spec), plan, mesh)
    b, s = prompts.shape
    max_len, f32 = s + NEW, torch.float32
    eng = Engine(spec, dparams, plan=plan, max_len=max_len, dtype=f32, device="cuda")
    eng.generate(prompts, max_new=2)  # warm-up: DTensor's sharding cache
    # the RMSNorm launches of prefill and of each decode step, for MESH_NEW steps
    want = {**want, "rmsnorm": want["rmsnorm"] // (1 + NEW) * (1 + MESH_NEW)}
    for fn in counted.values():
        fn.launches = 0
    out, stats = eng.generate(prompts, max_new=MESH_NEW)
    launches = {name: fn.launches for name, fn in counted.items()}
    if launches != want:
        fail(f"serve_mesh {spec.name}: launches {launches}, the serve phase's {want}")
    if not np.array_equal(out, base_out[:, :MESH_NEW]):
        fail(f"serve_mesh {spec.name}: tokens differ from the unsharded Engine's at "
             f"{np.argwhere(out != base_out[:, :MESH_NEW])[:8].tolist()}")

    def inputs(sharded):
        caches = M.init_caches(spec, b, max_len, dtype=f32, device="cuda")
        tok = torch.as_tensor(prompts, device="cuda")
        if sharded:
            caches = distribute_tree(caches, M.cache_axes(spec, b, max_len), plan, mesh)
            tok = distribute_tensor(tok, mesh, placements(plan.spec(("batch", None),
                                                                    tuple(tok.shape)), mesh),
                                    src_data_rank=None)
        return caches, tok

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    @torch.inference_mode()
    def logits(p, sharded):
        caches, tok = inputs(sharded)
        pl = plan if sharded else NULL_PLAN
        lg, caches = M.prefill(p, tok, caches, spec, pl, compute_dtype=f32)
        got = [whole(lg).clone()]
        for i in range(MESH_DECODE_STEPS):
            lg, caches = M.decode_step(p, caches, got[-1].argmax(-1), s + i, spec, pl,
                                       compute_dtype=f32)
            got.append(whole(lg).clone())
        return got

    want_lg, have_lg = logits(params, False), logits(dparams, True)
    prefill_same = same_bits(torch, (have_lg[0],), (want_lg[0],))
    rel = [((h - w).abs().max() / w.abs().max()).item() for h, w in zip(have_lg, want_lg)]
    differ = [i for i, (h, w) in enumerate(zip(have_lg[1:], want_lg[1:]), 1)
              if not torch.equal(h, w)]
    caches, tok = inputs(True)
    pre = device_by_kernel(lambda: M.prefill(dparams, tok, caches, spec, plan,
                                             compute_dtype=f32), 2)
    step = device_by_kernel(lambda: M.decode_step(dparams, caches, tok.full_tensor()[:, -1], s,
                                                  spec, plan, compute_dtype=f32),
                            MESH_DECODE_PROFILED)
    pre_ms, step_ms = sum(pre.values()) or None, sum(step.values()) or None

    def busy(dev_ms, wall_ms):
        return "not measured" if not dev_ms else f"{dev_ms:.3f} device ms = {dev_ms / wall_ms:.3f}"
    wall = (stats.prefill_s * 1e3, stats.decode_s * 1e3 / MESH_NEW)
    base_wall = (base_stats.prefill_s * 1e3, base_stats.decode_s * 1e3 / NEW)
    print(f"[serve_mesh] {card} | {spec.name} B={b} prompt={s} new={MESH_NEW} fp32 under a (1, 1) "
          f"plan: prefill {wall[0]:.3f} ms (unsharded {base_wall[0]:.3f}), decode "
          f"{wall[1]:.3f} ms/step (unsharded {base_wall[1]:.3f}); device busy (torch.profiler) "
          f"prefill {busy(pre_ms, wall[0])} (unsharded {busy(base_pre_ms, base_wall[0])}), "
          f"decode step {busy(step_ms, wall[1])} (unsharded {busy(base_step_ms, base_wall[1])}); "
          f"launches {launches} (the serve phase's a token); the unsharded Engine's first "
          f"{MESH_NEW} tokens")
    print(f"[serve_mesh] {spec.name} logits under the plan vs unsharded: prefill bit for bit "
          f"{prefill_same}; max |diff| / max |logit| by step (0: prefill) {rel}; decode steps "
          f"that differ in any bit {differ} (tol {MESH_DECODE_RTOL})")
    if not prefill_same or max(rel) > MESH_DECODE_RTOL:
        fail(f"serve_mesh {spec.name}: logits differ from the unsharded ones")
    del eng, dparams, caches, tok
    return launches


def rmsnorm_dispatch_cost(torch, rn, d):
    """Host microseconds a call of RMSNorm at the decode shape (BATCH, d) f32:
    through rmsnorm (its operator, torch.ops.repro_torch.rmsnorm_fwd) and
    through the bare launch (rmsnorm._forward), medians of five runs of 2000
    calls taken in turns, each run closed by a synchronise."""
    x = torch.randn((BATCH, d), device="cuda")
    w = torch.randn((d,), device="cuda")
    runs = {"op": [], "bare": []}
    with torch.inference_mode():
        for _ in range(5):
            for name, fn in (("op", lambda: rn.rmsnorm(x, w)), ("bare", lambda: rn._forward(x, w,
                                                                                         1e-5))):
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2000):
                    fn()
                torch.cuda.synchronize()
                runs[name].append((time.perf_counter() - t0) / 2000 * 1e6)
    med = {k: sorted(v)[2] for k, v in runs.items()}
    print(f"[serve_mesh] rmsnorm f32 ({BATCH}, {d}) host us a call: through its operator "
          f"{med['op']:.3f}, bare launch {med['bare']:.3f} (medians of 5 runs of 2000, in "
          f"turns): the operator's dispatch costs {med['op'] - med['bare']:.3f} us a call")
    return med


def dryrun_start(cells, out: Path, *extra) -> list:
    """One ``python -m repro_torch.launch.dryrun`` subprocess per cell, writing
    its record and its output under ``out``: one intra-op thread each, at
    the lowest CPU priority, so that they run on the cores the card's phases
    leave idle."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for arch, shape, mesh in cells:
        with open(out / f"{arch}__{shape}__{mesh}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                 shape, "--mesh", mesh, "--out", str(out), *extra], env=env, stdout=log,
                stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(19)))
            procs[-1].log = Path(log.name)
    return procs


def dryrun_launch(tmp: Path) -> dict[str, list]:
    """Every dry-run subprocess at once (``dryrun_start``): DRYRUN_CELLS at
    full size, and DRYRUN_REDUCED labelled cpu and cuda."""
    return {"full": dryrun_start(DRYRUN_CELLS, tmp / "full"),
            "reduced": [p for dev in ("cpu", "cuda") for p in dryrun_start(
                [DRYRUN_REDUCED], tmp / dev, "--reduced", "--device", dev)]}


def dryrun_finish(procs, timeout: float) -> list[str]:
    """The subprocesses' output, each waited for at most ``timeout`` seconds;
    every one is stopped before this returns."""
    logs = []
    try:
        for p in procs:
            p.wait(timeout=timeout)
            logs.append(p.log.read_text())
    finally:
        dryrun_stop(procs)
    return logs


def dryrun_stop(procs) -> None:
    """Stop every subprocess of ``procs`` still running (at exit too: a failed
    phase leaves the cells running)."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def dryrun_phase(card, total_memory: int, procs: dict, tmp: Path) -> None:
    """The dry run's subprocesses on fake worlds (``dryrun_launch``, started
    after the build): DRYRUN_CELLS at full size (fake tensors labelled
    cuda), each ok with a peak a device within the card's
    ``total_memory``; the reduced DRYRUN_REDUCED cell labelled cpu and cuda,
    whose records agree key for key but lower_s.  Every process is stopped
    before it returns, and ``tmp`` removed."""
    import shutil
    try:
        def record(out, arch, shape, mesh):
            path = out / f"{arch}__{shape}__{mesh}.json"
            return json.loads(path.read_text()) if path.exists() else None

        t0 = time.perf_counter()
        logs = dryrun_finish(procs["full"], DRYRUN_TIMEOUT)
        dryrun_finish(procs["reduced"], DRYRUN_TIMEOUT)
        print(f"[dryrun] waited {time.perf_counter() - t0:.3f} s for the {len(DRYRUN_CELLS)} "
              f"full-size cells and the reduced pair, started after the build")
        for cell, log in zip(DRYRUN_CELLS, logs):
            rec = record(tmp / "full", *cell)
            if rec is None or rec["status"] != "ok":
                fail(f"dryrun {':'.join(cell)}: {(rec or {}).get('error') or log[-2000:]}")
            hlo, mem = rec["hlo"], rec["memory"]
            per_chip = rec["model_flops"] / rec["n_chips"]
            print(f"[dryrun] {card} host | {':'.join(cell)} (fake world of {rec['n_chips']}, "
                  f"labels cuda): ok; peak {mem['peak_bytes_per_device'] / 2**30:.3f} GiB a "
                  f"device, arguments {mem['argument_bytes'] / 2**30:.3f} GiB"
                  + (f", caches {mem['kv_cache_bytes_per_device'] / 2**30:.3f} GiB"
                     if "kv_cache_bytes_per_device" in mem else "")
                  + f"; FLOPs a device {hlo['flops_per_device']:.4e} against model_flops / "
                  f"n_chips {per_chip:.4e} ({hlo['flops_per_device'] / per_chip:.3f}x); bytes "
                  f"a device {hlo['bytes_per_device']:.4e}; collective bytes "
                  f"{ {k: f'{v:.4e}' for k, v in hlo['collective_bytes'].items()} } by group "
                  f"{ {k: f'{v:.4e}' for k, v in hlo['collective_by_group'].items()} }; "
                  f"{rec['lower_s']} s")
            gathered = hlo["collective_bytes"].get("all-gather", 0)
            if cell[:2] in DRYRUN_GATHER_BEFORE:
                print(f"[dryrun] {':'.join(cell)} all-gather bytes a device {gathered:.4e}, "
                      f"before {DRYRUN_GATHER_BEFORE[cell[:2]]:.4e} (the CPU host's count)")
            if cell[:2] in DRYRUN_BEFORE:
                g0, p0 = DRYRUN_BEFORE[cell[:2]]
                print(f"[dryrun] {':'.join(cell)} all-gather bytes a device {gathered:.4e} and "
                      f"peak {mem['peak_bytes_per_device'] / 2**30:.4f} GiB, before the split "
                      f"gated norm and head view, the fused NLL and the hooked gradients "
                      f"{g0:.4e} and {p0:.4f} GiB (the CPU host's counts)")
            keys = ("arch", "shape", "mesh", "n_chips", "model_flops", "memory", "hlo", "lower_s")
            print(f"[dryrun] record {json.dumps({k: rec[k] for k in keys})}")
            if mem["peak_bytes_per_device"] > total_memory:
                fail(f"dryrun {':'.join(cell)}: a device's peak {mem['peak_bytes_per_device']} "
                     f"bytes exceeds the card's {total_memory}")
        print(f"[dryrun] {len(DRYRUN_CELLS)} full-size cells, each peak "
              f"within the card's {total_memory / 2**30:.3f} GiB")
        arch, shape, mesh = DRYRUN_REDUCED
        cpu, cuda = (record(tmp / dev, arch, shape, mesh) for dev in ("cpu", "cuda"))
        if not cpu or not cuda or cpu["status"] != "ok" or cuda["status"] != "ok":
            fail(f"dryrun reduced {arch}:{shape}: {(cpu or {}).get('error')} / "
                 f"{(cuda or {}).get('error')}")
        strip = lambda r: {k: v for k, v in r.items() if k != "lower_s"}
        differ = sorted(k for k in set(cpu) | set(cuda) if k != "lower_s"
                        and cpu.get(k) != cuda.get(k))
        print(f"[dryrun] reduced {arch}:{shape}:{mesh} labelled cpu and cuda: records equal key "
              f"for key but lower_s: {strip(cpu) == strip(cuda)} ({cpu['lower_s']} s and "
              f"{cuda['lower_s']} s)" + (f"; keys that differ {differ}" if differ else ""))
        if strip(cpu) != strip(cuda):
            fail(f"dryrun: the cpu- and cuda-labelled records differ: "
                 + "; ".join(f"{k}: {cpu.get(k)} against {cuda.get(k)}" for k in differ))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
            "dse_class_times": 0, "dse_sweep": 0, "rmsnorm_split": 0, "rmsnorm_split_bwd": 0}


def train_steps(torch, counted, card, spec, seq, cfg, batch=TRAIN_BATCH, tag="train"):
    """``spec`` at full width, batches of ``batch`` x ``seq``: TRAIN_STEPS steps
    of ``cfg`` (AdamW) with the launch counts set to 0 just before them,
    which must be ``train_counts``' a step; every loss finite, and every
    parameter's gradient of the first step finite and not all zero (a hook
    on each leaf, which the step's autograd.grad calls); step ms (median of
    the last 4), tokens/s, peak memory, device busy and device ms by kernel
    class of one more step.  Returns (state, batches, launches, the run's
    losses and grad norms by step)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import init_train_state, make_train_step, to_device
    dt = "f32" if cfg.param_dtype == torch.float32 else "bf16"
    t0 = time.perf_counter()
    state = init_train_state(spec, cfg, seed=SEED, device="cuda")
    data = SyntheticLM(spec, DataConfig(batch, seq, seed=SEED))
    batches = [to_device(data.batch_at(i), "cuda") for i in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    print(f"[{tag}] {spec.name} full width {dt} state ({sorted(state)}) and {TRAIN_STEPS + 1} "
          f"SyntheticLM batches of B={batch} S={seq} on the card in "
          f"{time.perf_counter() - t0:.3f} s")
    step_fn = make_train_step(spec, cfg=cfg)
    leaves = opt.leaves(state["params"])
    seen = [None] * len(leaves)
    hooks = [p.requires_grad_(True).register_hook(
        lambda g, i=i: seen.__setitem__(i, torch.stack([torch.isfinite(g).all(), (g != 0).any()])))
        for i, p in enumerate(leaves)]
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    losses, norms, step_ms = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[i])
        loss = metrics["loss"].item()
        norms.append(metrics["grad_norm"].item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if not math.isfinite(loss):
            fail(f"{tag} {spec.name} step {i}: loss {loss}")
        if i == 0:
            for h in hooks:
                h.remove()
            bad = [j for j, ok in enumerate(seen) if ok is None or not bool(ok.all())]
            if bad:
                fail(f"{tag} {spec.name}: {len(bad)} of {len(leaves)} parameters have a first-step "
                     f"gradient that is not finite or all zero (leaves {bad[:8]})")
    launches = {name: fn.launches for name, fn in counted.items()}
    want = {k: TRAIN_STEPS * v for k, v in train_counts(spec, cfg.remat).items()}
    if launches != want:
        fail(f"{tag} {spec.name}: kernel launches in {TRAIN_STEPS} steps {launches}, expected "
             f"{want}")
    peak = torch.cuda.max_memory_allocated()
    ms = sorted(step_ms[-4:])
    median = (ms[1] + ms[2]) / 2
    tokens = batch * seq
    print(f"[{tag}] {card} | {spec.name} B={batch} S={seq} {dt} remat={cfg.remat}: losses "
          f"{[round(x, 4) for x in losses]}; step ms {[round(x, 3) for x in step_ms]}, median of "
          f"the last 4 {median:.3f} ms, {tokens / median * 1e3:.1f} tokens/s; peak memory "
          f"{peak / 2**30:.3f} GiB; launches per step "
          f"{ {k: v // TRAIN_STEPS for k, v in launches.items()} } (expected "
          f"{train_counts(spec, cfg.remat)}); every one of {len(leaves)} parameters' first-step "
          f"gradient finite and not all zero")
    by_name = device_by_kernel(lambda: step_fn(state, batches[TRAIN_STEPS]), 1)
    if by_name:
        dev = sum(by_name.values())
        classes = ", ".join(f"{c} {v:.3f}" for c, v in by_class(by_name).items())
        busy = f"{dev:.3f} ms = {dev / median:.3f} of the step's wall ({classes} ms)"
    else:
        busy = "not measured"
    print(f"[{tag}] {spec.name} device busy (torch.profiler, one step): {busy}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[{tag}] {spec.name} step's largest device kernels (ms): "
          + "; ".join(f"{name[:80]} {v:.3f}" for name, v in top))
    other = sorted(((n, v) for n, v in by_name.items() if by_class({n: v})["other"]),
                   key=lambda kv: -kv[1])[:8]
    print(f"[{tag}] {spec.name} step's largest kernels of class other (ms): "
          + "; ".join(f"{name[:80]} {v:.3f}" for name, v in other))
    return state, batches, launches, {"loss": losses, "grad_norm": norms}


def f32_run(remat: str = "dots"):
    """The f32 run of the train paths here: AdamW at lr 1e-3 after
    TRAIN_WARMUP warm-up steps, under ``remat``."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import RunConfig
    return RunConfig(remat=remat, opt=opt.OptConfig(lr=1e-3, warmup_steps=TRAIN_WARMUP))


def train(torch, counted, card, spec, seq):
    """``spec`` at full width, batches of TRAIN_BATCH x ``seq``: TRAIN_STEPS
    steps of f32 AdamW under remat "dots" (``train_steps``), then the remat
    policies against each other from one state and batch.  Returns the
    launches of the counted steps and their losses and grad norms."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_loss_fn
    cfg = f32_run()
    state, batches, launches, run = train_steps(torch, counted, card, spec, seq, cfg)

    # -- remat policies: loss and grad norm from one state and batch
    batch, params = batches[TRAIN_STEPS], state["params"]
    leaves = opt.leaves(params)
    got = {}
    for remat in ("dots", "none", "full"):
        loss, _ = make_loss_fn(spec, cfg=cfg.with_(remat=remat))(params, batch)
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
    round_trip(torch, first_layers(state, ROUND_TRIP_LAYERS),
               f"{spec.name} full-width trained f32, first {ROUND_TRIP_LAYERS} layers,")
    return launches, run


def train_bf16(torch, counted, card, spec, seq, f32, batch=TRAIN_BATCH):
    """``launch/train.py --bf16``'s configuration (BF16_RUN: bf16 parameters
    and compute, f32 master and moments) under remat "dots", from the f32
    run's seed and batches (``train_steps``), against that run's losses and
    grad norms ``f32``: the first loss within BF16_LOSS_RTOL of the f32
    first step's, the first step's grad norm within BF16_GRAD_RTOL, every
    later loss (after updates) within BF16_STEP_RTOL, and after the last
    step every parameter equal to its master rounded to bf16.  Returns the
    launches."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import BF16_RUN
    cfg = BF16_RUN.with_(remat="dots", opt=f32_run().opt)
    state, _, launches, run = train_steps(torch, counted, card, spec, seq, cfg, batch=batch,
                                          tag="train_bf16")
    rel = lambda key, i: abs(run[key][i] - f32[key][i]) / abs(f32[key][i])
    first, norm = rel("loss", 0), rel("grad_norm", 0)
    later = max(rel("loss", i) for i in range(1, TRAIN_STEPS))
    ps, ms = opt.leaves(state["params"]), opt.leaves(state["master"])
    exact = all(p.dtype == torch.bfloat16 and m.dtype == torch.float32
                and torch.equal(p, m.to(torch.bfloat16)) for p, m in zip(ps, ms))
    print(f"[train_bf16] {spec.name} against the f32 run from the same seed and batches: first "
          f"loss {run['loss'][0]:.6f} against {f32['loss'][0]:.6f}, relative {first:.3e} (tol "
          f"{BF16_LOSS_RTOL}); first grad norm {run['grad_norm'][0]:.6e} against "
          f"{f32['grad_norm'][0]:.6e}, relative {norm:.3e} (tol {BF16_GRAD_RTOL}); grad norms "
          f"{[round(x, 6) for x in run['grad_norm']]} against "
          f"{[round(x, 6) for x in f32['grad_norm']]}; losses of steps 2 to {TRAIN_STEPS} "
          f"within {later:.3e} (tol {BF16_STEP_RTOL}); all {len(ps)} bf16 parameters equal "
          f"their f32 master rounded to bf16 after step {TRAIN_STEPS}: {exact}")
    if not (first <= BF16_LOSS_RTOL and norm <= BF16_GRAD_RTOL and later <= BF16_STEP_RTOL
            and exact):
        fail(f"train_bf16 {spec.name}: the bf16 run's losses, grad norm or parameters are off")
    return launches


def first_layers(tree, n: int):
    """``tree`` (a train state) with each layer stack cut to its first ``n``
    layers: the same tensors, trained values and all."""
    if isinstance(tree, dict):
        return {k: v[:n] if k == "stack" else first_layers(v, n) for k, v in tree.items()}
    return tree


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
    from repro_torch.train.train_step import (BF16_RUN, init_train_state, make_loss_fn,
                                              make_train_step)
    small = reduced(spec)
    cfg = f32_run()
    batch = SyntheticLM(small, DataConfig(4, 128, seed=SEED)).batch_at(0)
    cpu = init_train_state(small, cfg, seed=SEED, device="cpu")
    states = {"cpu": cpu, "cuda": map_with_path(lambda _, t: t.detach().cuda(), cpu)}
    out = {}
    for dev, st in states.items():
        for t in opt.leaves(st["params"]):
            t.requires_grad_(True)
        loss, _ = make_loss_fn(small, cfg=cfg)(st["params"], {k: torch.as_tensor(v, device=dev)
                                                           for k, v in batch.items()})
        grads = torch.autograd.grad(loss, opt.leaves(st["params"]))
        _, metrics = make_train_step(small, cfg=cfg)(st, batch)
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
    make_train_step(small, cfg=BF16_RUN.with_(remat="dots"))(bf16, batch)
    round_trip(torch, bf16, f"reduced {spec.name} bf16 + f32 master")


def serve_embeddings(torch, np, M, api, map_with_path, reduced, counted, card, spec):
    """``spec`` (an embeddings-frontend arch) at full width through the
    serving entry points (``serve/api.py``'s prefill and serve steps) on
    seeded embeddings, as the JAX package drives its model
    (tests/test_perf_features.py): prefill on (BATCH, EMB_PROMPT, D), then
    NEW decode steps on (BATCH, D), in f32 and then in bf16 (the weights
    and embeddings cast), every launch count set to 0 just before each
    (flash once a layer in prefill, RMSNorm twice a layer and the final
    norm in prefill and in each step); prefill ms, decode ms a step, device
    busy and device ms by kernel class; logits finite; f32 prefill over S
    against prefill over S - 1 and one decode step within CONSISTENCY_TOL,
    the bf16 prefill's logits within BF16_SERVE_TOL of the f32 ones' scale;
    and the reduced model's forward on the card against the CPU within
    1e-4.  Returns the launches of the f32 run and of the bf16 run."""
    from repro_torch.train.optimizer import leaves
    f32, bf16, d = torch.float32, torch.bfloat16, spec.d_model
    t0 = time.perf_counter()
    params = M.init_params(spec, SEED, device="cuda")
    rng = np.random.default_rng(SEED)
    prompt = torch.as_tensor((rng.standard_normal((BATCH, EMB_PROMPT, d)) * EMB_SCALE)
                             .astype(np.float32), device="cuda")
    steps = torch.as_tensor((rng.standard_normal((NEW, BATCH, d)) * EMB_SCALE)
                            .astype(np.float32), device="cuda")
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in leaves(params))
    print(f"[serve_embeddings] {spec.name} full width: {weights / 2**30:.3f} GiB of f32 weights "
          f"and seeded embeddings ({BATCH}, {EMB_PROMPT}, {d}) and {NEW} x ({BATCH}, {d}) on the "
          f"card in {time.perf_counter() - t0:.3f} s")
    max_len = EMB_PROMPT + NEW
    want = {name: 0 for name in counted}
    want.update(flash_attention=spec.n_layers, rmsnorm=(2 * spec.n_layers + 1) * (1 + NEW))
    out = {}
    for dtype in (f32, bf16):
        p = params if dtype == f32 else map_with_path(lambda _, t: t.to(bf16), params)
        x, xs = prompt.to(dtype), steps.to(dtype)
        prefill = api.make_prefill_step(spec, compute_dtype=dtype)
        decode = api.make_serve_step(spec, compute_dtype=dtype)

        @torch.inference_mode()
        def generate():
            caches = M.init_caches(spec, BATCH, max_len, dtype=dtype, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = prefill(p, x, caches)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            first, finite = logits.float(), [torch.isfinite(logits).all()]
            for i in range(NEW):
                logits, caches = decode(p, caches, xs[i], EMB_PROMPT + i)
                finite.append(torch.isfinite(logits).all())
            torch.cuda.synchronize()
            return t1 - t0, time.perf_counter() - t1, bool(torch.stack(finite).all()), caches, \
                first

        generate()  # warm-up
        for fn in counted.values():
            fn.launches = 0
        pre_s, dec_s, finite, caches, first = generate()
        launches = {name: fn.launches for name, fn in counted.items()}
        name = dtype_name(dtype)
        if launches != want or not finite:
            fail(f"serve_embeddings {spec.name} {name}: launches {launches} (expected {want}), "
                 f"logits finite {finite}")
        kv = sum(t.numel() * t.element_size() for t in leaves(caches))
        with torch.inference_mode():  # the caches are generate()'s
            pre = device_by_kernel(lambda: prefill(p, x, M.init_caches(
                spec, BATCH, max_len, dtype=dtype, device="cuda")), 2)
            step = device_by_kernel(lambda: decode(p, caches, xs[0], EMB_PROMPT), 8)
        print(f"[serve_embeddings] {card} | {spec.name} B={BATCH} prompt={EMB_PROMPT} embeddings "
              f"new={NEW} {name}: prefill {pre_s * 1e3:.3f} ms, decode {BATCH * NEW / dec_s:.3f} "
              f"tok/s ({dec_s * 1e3 / NEW:.3f} ms/step); KV cache {kv / 2**30:.3f} GiB; launches "
              f"{launches} (expected); logits finite")
        print(f"[serve_embeddings] {spec.name} {name} device busy (torch.profiler): prefill "
              f"{busy_share(pre, pre_s * 1e3)}; decode step {busy_share(step, dec_s * 1e3 / NEW)}")
        out[dtype] = launches, first
        del p, caches
    err16 = ((out[bf16][1] - out[f32][1]).abs().max() / out[f32][1].abs().max()).item()
    print(f"[serve_embeddings] {spec.name} bf16 prefill's last-position logits against the f32 "
          f"ones: max |diff| / max |f32 logit| {err16:.4e} (tol {BF16_SERVE_TOL})")
    if not err16 <= BF16_SERVE_TOL:
        fail(f"serve_embeddings {spec.name}: bf16 prefill logits off the f32 ones")
    with torch.inference_mode():
        full, _ = M.prefill(params, prompt, M.init_caches(spec, BATCH, EMB_PROMPT, dtype=f32,
                                                          device="cuda"), spec, compute_dtype=f32)
        _, c = M.prefill(params, prompt[:, :-1], M.init_caches(
            spec, BATCH, EMB_PROMPT, dtype=f32, device="cuda"), spec, compute_dtype=f32)
        last, _ = M.decode_step(params, c, prompt[:, -1], EMB_PROMPT - 1, spec, compute_dtype=f32)
    err = (full - last).abs().max().item()
    print(f"[serve_embeddings] {spec.name} prefill(S={EMB_PROMPT}) vs prefill(S-1)+decode_step: "
          f"max_abs_err {err:.3e} (tol {CONSISTENCY_TOL}), max |logit| "
          f"{full.abs().max().item():.3e}")
    if not err <= CONSISTENCY_TOL:
        fail(f"serve_embeddings {spec.name}: prefill and decode disagree")
    del params, c
    torch.cuda.empty_cache()
    small = reduced(spec)
    cpu_params = M.init_params(small, SEED, device="cpu")
    gpu_params = map_with_path(lambda _, t: t.cuda(), cpu_params)
    emb = torch.as_tensor((rng.standard_normal((2, 200, small.d_model)) * EMB_SCALE)
                          .astype(np.float32))
    on_cpu, _ = M.forward(cpu_params, emb, small)
    on_gpu, _ = M.forward(gpu_params, emb.cuda(), small)
    err_small = (on_cpu - on_gpu.cpu()).abs().max().item()
    print(f"[serve_embeddings] reduced {spec.name} forward on embeddings B=2 S=200: card vs CPU "
          f"plain path max_abs_err {err_small:.3e} (tol 1e-4)")
    if not err_small <= 1e-4:
        fail(f"serve_embeddings {spec.name}: the card's forward disagrees with the CPU's")
    return out[f32][0], out[bf16][0]


# -- the multi-device runtime on a mesh of one card ------------------------------

def mesh_train(torch, counted, card, spec, seq, steps):
    """``steps`` train steps of ``spec`` (B=TRAIN_BATCH, ``seq``) f32 under remat
    "dots", unsharded and then under plan_for_mesh of a (1, 1) ("data",
    "model") mesh, from one seed and the same batches: every parameter and
    optimizer leaf a DTensor, the kernels reached through local_map.  Losses
    and the final parameters held bit for bit or, failing that, within
    MESH_RTOL, with the leaves that differ printed; the
    sharded steps' launches, counts set to 0 just before them, equal to the
    train phase's per step.  Returns those launches."""
    from torch.distributed.tensor import DTensor

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import NULL_PLAN, plan_for_mesh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import init_train_state, make_train_step, to_device
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    plan = plan_for_mesh(mesh)
    cfg = f32_run()
    data = SyntheticLM(spec, DataConfig(TRAIN_BATCH, seq, seed=SEED))
    batches = [to_device(data.batch_at(i), "cuda") for i in range(steps + 1)]
    runs = {}
    for name in ("unsharded", "mesh (1, 1)"):
        sharded = name != "unsharded"
        state = init_train_state(spec, cfg, seed=SEED, device="cuda",
                                 plan=plan if sharded else None, mesh=mesh if sharded else None)
        if sharded:
            flat = opt.leaves(state)
            if not all(isinstance(t, DTensor) for t in flat):
                fail(f"mesh: {sum(not isinstance(t, DTensor) for t in flat)} of {len(flat)} "
                     f"state leaves are not DTensors")
        step_fn = make_train_step(spec, plan if sharded else NULL_PLAN, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
        losses, step_ms = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batches[i])
            losses.append(metrics["loss"].item())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {k: fn.launches for k, fn in counted.items()}
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in losses):
            fail(f"mesh {spec.name} {name}: losses {losses}")
        params = [(t.to_local() if sharded else t).detach().cpu()
                  for t in opt.leaves(state["params"])]
        by_name = device_by_kernel(lambda: step_fn(state, batches[steps]), 1)
        runs[name] = dict(losses=losses, step_ms=step_ms, launches=launches, peak=peak,
                          params=params, device_ms=sum(by_name.values()) or None)
        del state, step_fn, by_name
        torch.cuda.empty_cache()
    base, got = runs["unsharded"], runs["mesh (1, 1)"]
    want = {k: steps * v for k, v in train_counts(spec, cfg.remat).items()}
    if got["launches"] != want or base["launches"] != want:
        fail(f"mesh {spec.name}: launches in {steps} steps {got['launches']} (unsharded "
             f"{base['launches']}), expected {want}")
    same = got["losses"] == base["losses"] and all(
        torch.equal(a, b) for a, b in zip(got["params"], base["params"]))
    worst, differ = 0.0, []
    for i, (a, b) in enumerate(zip(got["params"], base["params"])):
        if not torch.equal(a, b):
            rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            worst = max(worst, rel)
            differ.append(i)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], base["losses"]))
    for name, r in runs.items():
        ms = sorted(r["step_ms"][1:])
        med = r["median"] = ms[len(ms) // 2]
        busy = (f"{r['device_ms']:.3f} device ms = {r['device_ms'] / med:.3f} of the step"
                if r["device_ms"] else "not measured")
        print(f"[mesh] {card} | {spec.name} ({spec.n_layers} layers) B={TRAIN_BATCH} S={seq} f32 "
              f"remat=dots {name}: "
              f"losses {r['losses']}; step ms {[round(x, 3) for x in r['step_ms']]} (median "
              f"of steps 2-{steps} {med:.3f}); peak memory {r['peak'] / 2**30:.3f} GiB; device "
              f"busy (torch.profiler, one step) {busy}")
    print(f"[mesh] {spec.name} launches per step under the plan "
          f"{ {k: v // steps for k, v in got['launches'].items()} } (the train phase's "
          f"{train_counts(spec, cfg.remat)}); step {got['median']:.3f} ms against "
          f"{base['median']:.3f} unsharded ({got['median'] / base['median'] - 1:+.2%}); "
          f"losses and all {len(got['params'])} parameters "
          f"bit for bit: {same}" + ("" if same else
                                   f"; largest relative difference: loss {loss_rel:.3e}, "
                                   f"parameters {worst:.3e} in leaves {differ[:16]}"))
    if not same and (loss_rel > MESH_RTOL or worst > MESH_RTOL):
        fail(f"mesh {spec.name}: the (1, 1) plan's steps differ from the unsharded ones by "
             f"more than {MESH_RTOL} relative")
    return got["launches"]


def mesh_dp_pipeline(torch, card):
    """One make_dp_train_step step with int8 compression on a world-1 "data"
    mesh of the card (reduced depth, full width), held bit for bit (else
    within MESH_RTOL) against a plain reference of the same step: the
    unsharded loss and gradients, each gradient quantized to
    round(g / scale) * scale, AdamW on those, and the residual
    g - round(g / scale) * scale as the new grad_error; compressed_psum on
    card tensors against its formula; pipeline_forward with one stage
    against the sequential stage."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.compression import compressed_psum, wire_bytes
    from repro_torch.parallel.dp_explicit import make_dp_train_step
    from repro_torch.parallel.pipeline import pipeline_forward
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import init_train_state, make_loss_fn, to_device
    spec = dataclasses.replace(get_arch(ARCH), n_layers=2)
    cfg = f32_run("none")
    batch = SyntheticLM(spec, DataConfig(TRAIN_BATCH, TRAIN_SEQ, seed=SEED)).batch_at(0)
    mesh = make_mesh((1,), ("data",), device="cuda")
    step, init_extra = make_dp_train_step(spec, mesh, cfg, compress_bits=8)
    state = init_extra(init_train_state(spec, cfg, seed=SEED, device="cuda"))
    _, m8 = step(state, batch)
    err = opt.leaves(state["grad_error"])
    # the plain reference: the same step written out without the mesh
    ref = init_train_state(spec, cfg, seed=SEED, device="cuda")
    ps = opt.leaves(ref["params"])
    for p in ps:
        p.requires_grad_(True)
    loss0, _ = make_loss_fn(spec, cfg=cfg)(ref["params"], to_device(batch, "cuda"))
    q_grads, ref_err = [], []
    for g in torch.autograd.grad(loss0, ps):
        scale = torch.clamp_min(g.abs().max() / 127.0, 1e-30)
        q = torch.clamp(torch.round(g / scale), -127.0, 127.0)
        q_grads.append(q * scale)
        ref_err.append(g - q * scale)
    with torch.no_grad():
        opt.apply_updates(ref, q_grads, cfg.opt)
    pairs = ([("loss", m8["loss"], loss0.detach())]
             + [(f"param {i}", a, b) for i, (a, b) in
                enumerate(zip(opt.leaves(state["params"]), ps))]
             + [(f"grad_error {i}", a, b) for i, (a, b) in enumerate(zip(err, ref_err))])
    same = all(torch.equal(a, b) for _, a, b in pairs)
    worst = max(((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30)).item() for _, a, b in pairs)
    comp, full = wire_bytes(state["params"])
    print(f"[mesh] make_dp_train_step int8 on a world-1 data mesh, {spec.name} at 2 layers, "
          f"B={TRAIN_BATCH} S={TRAIN_SEQ}: loss {m8['loss'].item()} (plain step "
          f"{loss0.item()}); residuals on the card {err[0].device}, largest "
          f"{max(e.abs().max().item() for e in err):.3e}; wire bytes {comp} vs {full} f32; "
          f"loss, all {len(ps)} parameters and all {len(err)} residuals against the plain "
          f"quantize-then-AdamW step bit for bit: {same}"
          + ("" if same else f" (largest relative difference {worst:.3e})"))
    if err[0].device.type != "cuda" or (not same and worst > MESH_RTOL):
        fail("mesh: the int8 data-parallel step differs from its plain reference")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    g = {"w": torch.randn(4096, 1536, device="cuda", generator=gen),
         "b": torch.randn(1536, device="cuda", generator=gen) * 1e-3}
    red, res = compressed_psum(g, mesh.get_group("data"), {k: torch.zeros_like(v)
                                                           for k, v in g.items()})
    ok = True
    for k, v in g.items():
        scale = torch.clamp_min(v.abs().max() / 127.0, 1e-30)
        q = torch.clamp(torch.round(v / scale), -127.0, 127.0)
        ok &= torch.equal(red[k], q * scale / 1) and torch.equal(res[k], v - q * scale)
    print(f"[mesh] compressed_psum on card tensors (int8 payload, world 1) equals "
          f"round(g / scale) * scale and its residual bit for bit: {ok}")
    if not ok:
        fail("mesh: compressed_psum on the card disagrees with its formula")
    pipe = make_mesh((1,), ("pipe",), device="cuda")
    w = torch.randn(1, 1536, 1536, device="cuda", generator=gen) * 0.02
    b = torch.zeros(1, 1536, device="cuda")
    mbs = torch.randn(8, 4, 1536, device="cuda", generator=gen)
    out = pipeline_forward(lambda p, x: torch.tanh(x @ p["w"] + p["b"]), pipe, "pipe")(
        {"w": w, "b": b}, mbs)
    ref = torch.tanh(mbs @ w[0] + b[0])
    err_p = (out - ref).abs().max().item()
    print(f"[mesh] pipeline_forward, one stage, 8 microbatches of (4, 1536) on the card: "
          f"max |out - sequential| {err_p:.3e}")
    if err_p > 1e-5:
        fail("mesh: pipeline_forward disagrees with the sequential stage")


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


def fp64_probe(torch, dse_sim) -> dict:
    """The sweep's chain link on this card: PROBE_LINKS dependent (fmax,
    add) pairs in float64 on one thread, in clock cycles (clock64) and in
    events ms; their ratio is the SM clock the run saw."""
    dse_sim.fp64_chain_probe(1 << 10)  # load and warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    cycles = dse_sim.fp64_chain_probe(PROBE_LINKS)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    out = dict(fmax_add_cycles=cycles / PROBE_LINKS, sm_clock_hz=cycles / (ms / 1e3),
               probe_ms=ms, links=PROBE_LINKS)
    print(f"[dse] fp64 latency probe: {json.dumps(out)}")
    return out


def served_shares(dse_sim, parents) -> dict:
    """Where the sweep kernel takes the table's real parent reads, as
    counts and shares."""
    counts = dse_sim.sweep_served_from(parents)
    total = sum(counts.values())
    return dict(counts, **{f"{k}_share": v / total for k, v in counts.items()},
                ring_depth=dse_sim.RING)


def sweep_device_ms(phases: dict) -> float | None:
    """The sweep launch's device ms among a dse_sweep call's kernels."""
    return next((ms for name, ms in phases.items() if name.startswith("dse_sweep")), None)


def check_dse(torch, np, trace, calls, iters, probe):
    """dse_class_times and dse_sweep at the main path's shapes against
    their plain twins on the card (bit for bit) and numpy's batched
    duration pass (bit for bit), each run twice for the same bits; events
    ms, device ms, the plain twins' ms and the bounds; for the sweep also
    its cycles per op at the probe's clock, the chain estimate at the
    probe's latency and where its parent reads are served.  Returns the
    two rows."""
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
            # its true limit: one dependent fp64 max and add per level, at
            # the probe's latency; how far back the parents sit, and where
            # the kernel serves them from
            back = (torch.arange(n_ops, device=parents.device)[:, None] - parents.long())[
                parents.long() != n_ops]
            sweep_ms = sweep_device_ms(phases)
            row.update(levels=len(levels), parents_within_2=(back <= 2).double().mean().item(),
                       max_parent_distance=int(back.max().item()),
                       chain_estimate_ms=len(levels) * probe["fmax_add_cycles"]
                       / probe["sm_clock_hz"] * 1e3,
                       cycles_per_op=(sweep_ms * 1e-3 * probe["sm_clock_hz"] / n_ops
                                      if sweep_ms else None),
                       served_from=served_shares(dse_sim, parents),
                       durations_bit_identical_to_numpy=bool(
                           np.array_equal(dur.cpu().numpy(), numpy_dur)))
        print(f"[dse] {json.dumps(row)}")
        rows.append(row)
    return rows


def sweep_p_scan(torch, env, trace, population, probe) -> list[dict]:
    """dse_sweep (gather and sweep) at the first P members of the
    population for each P in DSE_SCAN: events ms, device ms by launch and
    the sweep's cycles per op."""
    from repro_torch.core.backends.torch_backend import TorchBackend
    from repro_torch.core.simulator import plan_duration_tables
    from repro_torch.kernels import dse_sim
    be = TorchBackend(device="cuda")
    out = []
    for P in DSE_SCAN:
        plan, tables = plan_duration_tables(
            trace, [env.scenario.sim_job(env.context(c)).calls[0] for c in population[:P]])
        st, tab = be._static(trace, plan), be._class_tables(tables)
        class_t = dse_sim.dse_class_times(st["kind"], st["size"], st["is_xfer"], *[tab[k] for k in (
            "npus", "bw", "lat", "scale", "topo", "algo", "chunks", "blue", "xfer_bw", "xfer_lat")])

        def run():
            return dse_sim.dse_sweep(st["parents"], sources=st["sources"], class_t=class_t,
                                     peak=tab["peak"], membw=tab["membw"])
        phases = device_ms_split(run, 10, "dse_")
        sweep_ms = sweep_device_ms(phases)
        out.append(dict(P=P, ms=cuda_ms(run, 10), device_ms=sum(phases.values()) or None,
                        device_ms_by_kernel=phases,
                        cycles_per_op=(sweep_ms * 1e-3 * probe["sm_clock_hz"] / plan.n_ops
                                       if sweep_ms else None)))
    print(f"[dse] dse_sweep P scan (the first P of {len(population)} members): {json.dumps(out)}")
    return out


def numpy_max_plus(np, parents, dur):
    """finish[i] = dur[i] + max(finish[parents[i]]) in uid order, numpy."""
    n_ops, P = dur.shape
    fin = np.zeros((n_ops + 1, P))
    for i in range(n_ops):
        fin[i] = dur[i] + fin[parents[i]].max(axis=0)
    return fin


def check_sweep_window(torch, np, probe) -> list[dict]:
    """dse_sweep over given durations on synthetic parent tables that reach
    past the ring (DSE_WINDOW_CASES): the finish times against the plain
    twin and a numpy max-plus, bit for bit; times and bounds as the main
    path's rows."""
    from repro_torch.kernels import dse_sim
    rows = []
    for n_ops, W, P in DSE_WINDOW_CASES:
        parents_np, dur_np = dse_sim.synthetic_sweep_case(SEED, n_ops, W, P)
        parents, dur = torch.from_numpy(parents_np).cuda(), torch.from_numpy(dur_np).cuda()
        _, finish = dse_sim.dse_sweep(parents, dur=dur)
        torch.cuda.synchronize()
        levels = dse_sim.sweep_levels(parents)
        want = dse_sim.sweep_plain(parents, dur, levels)
        exact = torch.equal(finish, want) and np.array_equal(
            finish.cpu().numpy(), numpy_max_plus(np, parents_np, dur_np))
        nbytes = n_ops * W * 4 + n_ops * P * 8 + (n_ops + 1) * P * 8
        bound_ms, bound_by = bound(nbytes, n_ops * P * W, "float64")
        phases = device_ms_split(lambda: dse_sim.dse_sweep(parents, dur=dur), 5, "dse_")
        sweep_ms = sweep_device_ms(phases)
        row = dict(case=f"dse_sweep synthetic n_ops={n_ops} W={W} P={P}, parents up to 5000 back",
                   max_abs_err=(finish - want).abs().max().item(), tol="bit-identical",
                   ok=bool(exact), ms=cuda_ms(lambda: dse_sim.dse_sweep(parents, dur=dur), 5),
                   device_ms=sum(phases.values()) or None, device_ms_by_kernel=phases,
                   plain_ms=cuda_ms(lambda: dse_sim.sweep_plain(parents, dur, levels), 1, warmup=1),
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None, levels=len(levels),
                   cycles_per_op=(sweep_ms * 1e-3 * probe["sm_clock_hz"] / n_ops
                                  if sweep_ms else None),
                   served_from=served_shares(dse_sim, parents))
        print(f"[dse] {json.dumps(row)}")
        rows.append(row)
    return rows


def gen_summary(gens, points: int) -> dict:
    """Medians of DSE generations (wall seconds, last_timings) with their
    ranges: pts/s, ms a generation, the host's table packing, the device
    evaluation with its copies, and the rest (scenario jobs, busy sums,
    finalize)."""
    def med_range(xs):
        xs = sorted(xs)
        return [round(xs[len(xs) // 2], 3), round(xs[0], 3), round(xs[-1], 3)]
    return {"pts_per_s": med_range([points / g for g, _ in gens]),
            "ms_per_gen": med_range([g * 1e3 for g, _ in gens]),
            "durations_ms": med_range([t["durations_s"] * 1e3 for _, t in gens]),
            "sweep_ms": med_range([t["sweep_s"] * 1e3 for _, t in gens]),
            "rest_ms": med_range([(g - t["durations_s"] - t["sweep_s"]) * 1e3 for g, t in gens])}


def dse(torch, np, counted, card):
    """The DSE's main path on the card: the backend benchmark's population
    through CosmicEnv.step_batch on ``reference`` (one generation, the
    oracle), ``torch-unfused`` and ``torch`` (DSE_REPEATS generations each,
    every member within DSE_RTOL of the oracle; medians and ranges), the
    launch counts of the ``torch`` generations (set to 0 just before them),
    each kernel's device ms; the fp64 latency probe; the kernels at these
    shapes against their plain twins; then DSE_BIG members on ``torch``
    (DSE_CHECKED of them against the oracle), the sweep's P scan and its
    synthetic far-parent cases, and the study CLI on ``torch`` against
    ``reference``.  Returns (kernel rows by name, launches, more rows)."""
    from repro_torch.core.backends import get_backend
    from repro_torch.kernels import dse_sim
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
        by_name = device_by_kernel(lambda: dse_generation(torch, env, cfgs), 2)
        kern = {k: v for k, v in by_name.items() if "dse_" in k}
        copies = sum(v for k, v in by_name.items() if "memcpy" in k.lower())
        print(f"[dse] {card} | {backend} P={len(cfgs)}, median [min, max] of {DSE_REPEATS} "
              f"generations: {json.dumps(gen_summary(gens, len(cfgs)))}; device ms a "
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
    probe = fp64_probe(torch, dse_sim)
    rows = check_dse(torch, np, trace, [envs["torch"].scenario.sim_job(
        envs["torch"].context(c)).calls[0] for c in cfgs], 20, probe)

    # a larger population: the members run in parallel on the card
    big = dse_population(np, DSE_BIG)
    env = envs["torch"]
    env.step_batch(big)
    gens = []
    for _ in range(DSE_REPEATS):
        got, s = dse_generation(torch, env, big)
        gens.append((s, dict(get_backend("torch").last_timings)))
    picked = big[::DSE_BIG // DSE_CHECKED]
    worst, ok = dse_agree([envs["reference"].evaluate_config(c) for c in picked],
                          [got[i] for i in range(0, DSE_BIG, DSE_BIG // DSE_CHECKED)])
    if not ok:
        fail(f"dse: torch at P={DSE_BIG} disagrees with reference: max relative gap {worst}")
    by_name = device_by_kernel(lambda: dse_generation(torch, env, big), 2)
    kern = {k: v for k, v in by_name.items() if "dse_" in k}
    print(f"[dse] {card} | torch P={DSE_BIG}, median [min, max] of {DSE_REPEATS} generations: "
          f"{json.dumps(gen_summary(gens, DSE_BIG))}; device ms a generation: kernels "
          f"{ {k[:60]: round(v, 4) for k, v in kern.items()} }, all "
          f"{sum(by_name.values()):.4f}; {len(picked)} members within {DSE_RTOL} of reference "
          f"(max gap {worst:.3e})")
    more = check_dse(torch, np, trace, [env.scenario.sim_job(env.context(c)).calls[0]
                                        for c in big], 10, probe)
    rows[1]["p_scan"] = sweep_p_scan(torch, env, trace, big, probe)
    rows[1]["fp64_probe"] = probe
    more += check_sweep_window(torch, np, probe)
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

    # -- dryrun's cells, beside the card's phases until the train_more phase ------
    # (each holds a CUDA context, about 0.5 GiB of the card, until it ends)
    import atexit
    import tempfile
    dry_tmp = Path(tempfile.mkdtemp(prefix="dryrun_"))
    dry = dryrun_launch(dry_tmp)
    atexit.register(dryrun_stop, dry["full"] + dry["reduced"])

    # -- kernels ---------------------------------------------------------------
    elapsed("kernels")
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
                # gemma3's train shape (train_more)
                ("bwd gemma3 global", (G_TRAIN_B, G_TRAIN_SEQ, G_TRAIN_SEQ, gh, gg, ghd, 0), 3),
                (f"bwd gemma3 window {gw}",
                 (G_TRAIN_B, G_TRAIN_SEQ, G_TRAIN_SEQ, gh, gg, ghd, gw), 3),
                ("bwd granite", (BATCH, R_PROMPT, R_PROMPT, rspec.n_heads, rspec.n_kv_heads,
                                 rspec.resolved_head_dim, 0), 5),
                ("bwd phi3 hd96", (BATCH, 1024, 1024, pspec.n_heads, pspec.n_kv_heads,
                                   pspec.resolved_head_dim, 0), 3)):
            named[name, key] = check_flash_bwd(torch, F, fa, *args, dtype, iters)
            rows.append(named[name, key])
        # one 'model' rank of a sequence-split attention, forward and backward
        off_args = (TRAIN_BATCH, OFFSET_S, OFFSET_T, h, g, hd, 0, dtype)
        named[name, "qwen2 q_offset"] = check_flash(torch, F, fa, *off_args, 5, q_offset=OFFSET)
        named[name, "bwd qwen2 q_offset"] = check_flash_bwd(torch, F, fa, *off_args, 3,
                                                            q_offset=OFFSET)
        rows += [named[name, "qwen2 q_offset"], named[name, "bwd qwen2 q_offset"]]
        for key, (n_rows, width), iters in (
                # qwen2's train rows, and granite's (the same width)
                ("bwd qwen2 train", (TRAIN_BATCH * TRAIN_SEQ, d), 50),
                ("bwd 4000x1536", (4000, d), 50),
                ("bwd gemma3 train", (G_TRAIN_B * G_TRAIN_SEQ, gspec.d_model), 50),
                # mamba2-130m training: norm1 and the final norm, the gated norm
                ("bwd mamba2 train rows", (m_rows, mspec.d_model), 50),
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
        # the split-row mode: mamba2's gated norm on one of 16 'model' ranks, and a ragged piece
        for key, (n_rows, width), iters in (
                ("mamba2 train split", (m_rows, mspec.d_inner // M_MODEL_RANKS), 100),
                ("mamba2 decode split", (BATCH, mspec.d_inner // M_MODEL_RANKS), 200),
                ("ragged split", (m_rows, SPLIT_RAGGED), 100)):
            named[name, key], named[name, "bwd " + key] = check_rmsnorm_split(
                torch, rn, ref, n_rows, width, mspec.d_inner, dtype, iters)
            rows += [named[name, key], named[name, "bwd " + key]]
        for ranges in ("model", "random"):
            for b, s, sh, sg, sp, sn, iters in (
                    (BATCH, M_PROMPT, mh, mg, mp, mn, 10),   # mamba2-130m prefill
                    (BATCH, 1000, mh, mg, mp, mn, 20),       # ragged S
                    (BATCH, 2048, 8, 2, 64, 16, 20),         # grouped, jamba's widths
                    (2, 1000, small.ssm_heads, 1, small.ssm_head_dim, small.ssm_state, 20)):
                ssd_rows.append(check_ssd(torch, ss, b, s, sh, sg, sp, sn, dtype, ranges, iters))
                named.setdefault((name, f"mamba2 prefill {ranges}"), ssd_rows[-1])
            # mamba2-130m's train shape on one of 16 'model' ranks: P = 64 / 16
            named[name, f"mamba2 train P4 {ranges}"] = check_ssd(
                torch, ss, TRAIN_BATCH, M_TRAIN_SEQ, mh, mg, mp // M_MODEL_RANKS, mn, dtype,
                ranges, 10)
            ssd_rows.append(named[name, f"mamba2 train P4 {ranges}"])
        # the SSD backward: mamba2-130m's train shape, whole and on one of 16
        # 'model' ranks, then ragged and grouped
        for key, args, iters in (
                ("bwd mamba2 train", (TRAIN_BATCH, M_TRAIN_SEQ, mh, mg, mp, mn), 5),
                ("bwd mamba2 train P4",
                 (TRAIN_BATCH, M_TRAIN_SEQ, mh, mg, mp // M_MODEL_RANKS, mn), 5),
                ("bwd ragged grouped", (2, 1000, 8, 2, 64, 16), 10)):
            named[name, key] = check_ssd_bwd(torch, ss, *args, dtype, iters)
            rows.append(named[name, key])
        # the narrow head dims a 'model' split leaves a rank (mamba2's 64 on 16,
        # 32, 64 and 8 ranks; 1 where a smaller head_dim meets 16), packed tiles
        for q in NARROW_DIMS:
            named[name, f"narrow P{q}"], named[name, f"bwd narrow P{q}"] = check_ssd_narrow(
                torch, ss, TRAIN_BATCH, M_TRAIN_SEQ, mh, mg, q, mn, dtype, 10)
            ssd_rows.append(named[name, f"narrow P{q}"])
            rows.append(named[name, f"bwd narrow P{q}"])
        # the split's cost: M_MODEL_RANKS ranks each scanning P = 64 / 16 against the unsplit scan
        p4 = mp // M_MODEL_RANKS
        split = {}
        for label, key, whole in (("forward", f"narrow P{p4}", "mamba2 prefill model"),
                                  ("backward", f"bwd narrow P{p4}", "bwd mamba2 train")):
            part, full = named[name, key]["device_ms"], named[name, whole]["device_ms"]
            split[label] = dict(
                rank_device_ms=part, ranks=M_MODEL_RANKS,
                split_device_ms=None if part is None else M_MODEL_RANKS * part,
                unsplit_device_ms=full,
                ratio=None if part is None or not full else M_MODEL_RANKS * part / full)
        print(f"[kernels] {name} SSD scan split over head_dim on {M_MODEL_RANKS} ranks "
              f"(P = {p4} each) vs unsplit (P = {mp}), device ms: {json.dumps(split)}")
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
               "dse_class_times": dse_sim.dse_class_times, "dse_sweep": dse_sim.dse_sweep,
               "rmsnorm_split": rn.rmsnorm_split, "rmsnorm_split_bwd": rn.rmsnorm_split_bwd}
    # the model paths launch no DSE kernel, and on one card no plan splits a row
    no_dse = {"dse_class_times": 0, "dse_sweep": 0, "rmsnorm_split": 0, "rmsnorm_split_bwd": 0}

    # -- dse -----------------------------------------------------------------------
    elapsed("dse")
    by_path = {}
    dse_rows, by_path["dse"], dse_more = dse(torch, np, counted, card)

    # -- serve, consistency and serve_mesh, per model ---------------------------
    elapsed("serve")
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed
    init_distributed("cuda")  # a world of one, NCCL: serve_mesh's and the mesh phase's
    rmsnorm_dispatch_cost(torch, rn, spec.d_model)

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
        params, prompts, by_path[model_spec.name], *base = serve(
            torch, np, M, Engine, counted, param_count, card, model_spec, prompt, want)
        consistency(torch, M, moem, map_with_path, reduced, model_spec, params, prompts)
        by_path[f"serve_mesh {model_spec.name}"] = serve_mesh(
            torch, np, M, Engine, counted, card, model_spec, params, prompts, want, base)
        by_path[f"serve_bf16 {model_spec.name}"] = serve_bf16(
            torch, np, M, Engine, moem, map_with_path, counted, card, model_spec, params,
            prompts, want)
        del params
        torch.cuda.empty_cache()

    # -- train ---------------------------------------------------------------------
    elapsed("train")
    f32_runs = {}
    for train_spec, seq in ((spec, TRAIN_SEQ), (mspec, M_TRAIN_SEQ)):
        by_path[f"{train_spec.name} train"], f32_runs[train_spec.name] = train(
            torch, counted, card, train_spec, seq)
        torch.cuda.empty_cache()
        train_consistency(torch, map_with_path, reduced, train_spec)
        torch.cuda.empty_cache()

    # -- train_bf16: BF16_RUN at the f32 train paths' shapes ------------------------
    elapsed("train_bf16")
    for train_spec, seq in ((spec, TRAIN_SEQ), (mspec, M_TRAIN_SEQ)):
        by_path[f"{train_spec.name} train_bf16"] = train_bf16(
            torch, counted, card, train_spec, seq, f32_runs[train_spec.name])
        torch.cuda.empty_cache()

    # -- dryrun: the program on fake worlds of 256 and 512 ranks, collected ---------
    # before the phases that need most of the card's memory
    elapsed("dryrun")
    dryrun_phase(card, torch.cuda.get_device_properties(0).total_memory, dry, dry_tmp)

    # -- train_more: f32 training of gemma3-1b and granite-moe-3b-a800m -------------
    elapsed("train_more")
    for arch, batch, seq in MORE_TRAIN:
        more_spec = get_arch(arch)
        state, _, by_path[f"{arch} train_more"], f32_runs[arch] = train_steps(
            torch, counted, card, more_spec, seq, f32_run(), batch=batch, tag="train_more")
        del state, _
        torch.cuda.empty_cache()
        train_consistency(torch, map_with_path, reduced, more_spec)
        torch.cuda.empty_cache()
    # gemma3-1b's BF16_RUN too (granite's state, 28 bytes a parameter, does not fit the card)
    by_path[f"{GEMMA} train_bf16"] = train_bf16(torch, counted, card, gspec, G_TRAIN_SEQ,
                                                f32_runs[GEMMA], batch=G_TRAIN_B)
    torch.cuda.empty_cache()

    # -- serve_embeddings: phi-3-vision-4.2b through the embeddings frontend --------
    elapsed("serve_embeddings")
    from repro_torch.serve import api
    (by_path[f"serve_embeddings {pspec.name}"],
     by_path[f"serve_embeddings bf16 {pspec.name}"]) = serve_embeddings(
        torch, np, M, api, map_with_path, reduced, counted, card, pspec)
    torch.cuda.empty_cache()

    # -- mesh: the sharded train path on a mesh of one card ------------------------
    elapsed("mesh")
    by_path[f"mesh {spec.name} train"] = mesh_train(torch, counted, card, spec, TRAIN_SEQ,
                                                    MESH_STEPS)
    torch.cuda.empty_cache()
    m_small = dataclasses.replace(mspec, n_layers=MESH_MAMBA_LAYERS)
    by_path[f"mesh {mspec.name} train"] = mesh_train(torch, counted, card, m_small, M_TRAIN_SEQ,
                                                     MESH_STEPS)
    torch.cuda.empty_cache()
    mesh_dp_pipeline(torch, card)
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # -- report ------------------------------------------------------------------
    elapsed("report")
    print(f"[device] {card}")
    print(f"[device] torch.profiler traces: {TRACES['empty']} of {TRACES['taken']} came back "
          f"without device events, each taken again (up to {TRACE_TRIES} tries)")
    case_keys = ("case", "max_abs_err", "ms", "device_ms", "device_ms_by_kernel", "deterministic",
                 "same_bits_as_whole_rows", "reference_ms",
                 "plain_ms", "bound_ms", "bound_by", "library_ms",
                 # the DSE sweep's measured cycles an op, P scan and fp64 latency
                 # (its chain estimate and served-from shares, worked out rather
                 # than measured, stay in the [dse] lines)
                 "cycles_per_op", "p_scan", "fp64_probe")

    def numbers(r):
        return {key: r[key] for key in case_keys if key in r}

    # more: the kernel at the other shapes of its paths, and bf16 flash
    flash_more = [("bfloat16", "qwen2"), ("bfloat16", "granite")] + [
        (name, "qwen2 q_offset") for name in ("float32", "bfloat16")] + [
        (name, key) for key in ("gemma3 global", f"gemma3 window {gw}", "hd256 ragged 200")
        for name in ("float32", "bfloat16")] + [("float32", "granite")] + [
        (name, "phi3 hd96") for name in ("float32", "bfloat16")]
    bwd_more = [("bfloat16", "bwd qwen2")] + [
        (name, "bwd qwen2 q_offset") for name in ("float32", "bfloat16")] + [
        (name, key) for key in ("bwd qwen2 ragged 1000", "bwd gemma3 global",
                                f"bwd gemma3 window {gw}", "bwd granite", "bwd phi3 hd96")
        for name in ("float32", "bfloat16")]
    split_keys = ("mamba2 train split", "mamba2 decode split", "ragged split")
    norm_bwd_more = [("bfloat16", "bwd qwen2 train")] + [
        (name, key) for key in ("bwd 4000x1536", "bwd gemma3 train", "bwd mamba2 train rows",
                                "bwd mamba2 train gated") + tuple("bwd " + k for k in split_keys)
        for name in ("float32", "bfloat16")]
    norm_more = [("bfloat16", "qwen2 prefill")] + [
        (name, key) for key in ("qwen2 decode", "gemma3 prefill", "gemma3 decode",
                                "granite prefill", "mamba2 prefill", "mamba2 prefill gated",
                                "mamba2 decode") for name in ("float32", "bfloat16")] + [
        (name, key) for key in split_keys for name in ("float32", "bfloat16")]
    kernels = [
        dict(name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:76",
             case=named["float32", "qwen2"], more=[named[k] for k in flash_more]),
        dict(name="rmsnorm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:23",
             case=named["float32", "qwen2 prefill"], more=[named[k] for k in norm_more]),
        dict(name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:71", case=ssd_rows[0],
             more=[named["bfloat16", "mamba2 prefill model"]] + [
                 named[dt_name, f"mamba2 train P4 {ranges}"]
                 for dt_name in ("float32", "bfloat16") for ranges in ("model", "random")] + [
                 named[dt_name, f"narrow P{q}"]
                 for dt_name in ("float32", "bfloat16") for q in NARROW_DIMS]),
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
                 named[dt_name, key] for key in ("bwd mamba2 train P4", "bwd ragged grouped")
                 for dt_name in ("float32", "bfloat16")] + [
                 named[dt_name, f"bwd narrow P{q}"]
                 for dt_name in ("float32", "bfloat16") for q in NARROW_DIMS]),
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
