"""End-to-end training entry point, on the GPU.

Wires together: the config registry (--arch), the synthetic data pipeline
with prefetch, the train step (``repro_torch.train``: the flash-attention,
RMSNorm and SSD-scan kernels forward and backward on the card, so every layer
kind of the registry trains there), async atomic
checkpointing with auto-resume, heartbeats, straggler monitoring, and
failure injection for fault-tolerance drills.

    PYTHONPATH=src python -m repro_torch.launch.train --batch 4 --seq 1024 --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --batch 4 \\
        --seq 4096 --steps 6 --remat dots
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --reduced \\
        --device cpu --steps 4 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --steps 4 --batch 8 --seq 32 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --steps 6 --ckpt-dir /tmp/ckpt --ckpt-every 2 --fail-at 3   # restart drill

Counterpart of the JAX package's ``launch/train.py``, with its flags plus
``--device`` (``cuda`` by default; ``cpu`` runs the kernels' plain versions)
and ``--loss-chunk``.  ``--mesh RxC`` (or ``N``) trains on a ("data",
"model") mesh, one process per rank under ``torchrun`` (gloo with ``--device
cpu``, NCCL on the cards); the state is sharded by ``train_state_axes`` and
a checkpoint from another mesh is resharded onto this one (the elastic
path).  Rank 0 prints and writes the checkpoints.  With ``--fail-at``,
``main`` runs the loop under ``run_with_restarts``: the first attempt fails
at that step and the restart resumes from the latest checkpoint.

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
        --reduced --mesh 2x2 --device cpu

``--trace-out PATH`` turns the program's tracer on (``runtime/tracing.py``:
the train step's, the feed's and the MoE's spans and counters) and writes
them to PATH as Chrome trace JSON when the run ends (rank 0's).
"""
from __future__ import annotations

import argparse
import math
import os
import time
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.ckpt.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.parallel.sharding import plan_for_mesh
from repro_torch.runtime import tracing
from repro_torch.runtime.fault import Heartbeat, StragglerMonitor, run_with_restarts
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (RunConfig, init_train_state, make_train_step,
                                          train_state_axes)


def build(spec, mesh, cfg: RunConfig, seed: int = 0, device=None):
    """(plan, train step, initial state) on ``device`` (the card by default),
    sharded over ``mesh`` unless it is None."""
    plan = plan_for_mesh(mesh)
    return (plan, make_train_step(spec, plan, cfg),
            init_train_state(spec, cfg, seed=seed, device=device, plan=plan, mesh=mesh))


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def train_loop(args, spec, fail_at: int | None = None) -> int:
    device, mesh = resolve_device(args.device), None
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split("x"))
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if math.prod(shape) != world:
            raise ValueError(f"--mesh {args.mesh} needs {math.prod(shape)} ranks and this run has "
                             f"{world}: start one process per rank, e.g. torchrun "
                             f"--nproc-per-node {math.prod(shape)}")
        device = init_distributed(device)  # this rank's card
        mesh = make_mesh(shape, ("data", "model")[: len(shape)], device=device)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    cfg = RunConfig(
        compute_dtype=dtype, param_dtype=dtype,
        remat=args.remat, microbatches=args.microbatches, loss_chunk=args.loss_chunk,
        opt=opt.OptConfig(lr=args.lr, warmup_steps=args.warmup),
    )
    plan, step_fn, state = build(spec, mesh, cfg, args.seed, device)

    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=2) if args.ckpt_dir else None
    start = 0
    if ckpt and latest_step(args.ckpt_dir) is not None:
        # onto this run's mesh, whichever wrote it (the elastic path)
        state, start = restore(args.ckpt_dir, state, mesh=mesh, plan=plan,
                               axes=train_state_axes(spec, cfg))
        if rank0:
            print(f"[train] resumed from step {start}"
                  f"{f' onto mesh {args.mesh}' if mesh is not None else ''}", flush=True)

    data = SyntheticLM(spec, DataConfig(args.batch, args.seq, seed=args.seed))
    prefetch = Prefetcher(data, start_step=start, depth=2)
    hb = Heartbeat(Path(args.ckpt_dir) / "heartbeat.json") if args.ckpt_dir and rank0 else None
    straggler = StragglerMonitor(k_sigma=args.straggler_sigma)
    tokens = args.batch * args.seq

    losses = []
    step = start
    try:
        for step, batch in iter(prefetch):
            if step >= args.steps:
                break
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = _clock(device)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = _clock(device) - t0
            losses.append(loss)
            if straggler.observe(step, dt) and rank0:
                print(f"[straggler] step {step} took {dt:.3f}s "
                      f"(mean {straggler.mean:.3f}s) — mitigation hook fired", flush=True)
            if hb:
                hb.beat(step)
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(state, step + 1)
            if step % args.log_every == 0 and rank0:
                print(f"[train] {device.type} step {step} loss {loss:.4f} ({dt * 1e3:.1f} ms, "
                      f"{tokens / dt:.1f} tokens/s)", flush=True)
        final = min(args.steps, step + 1) if losses else start
    finally:
        prefetch.close()
    if ckpt:
        ckpt.save(state, final, block=True)
    if args.trace_out and rank0:
        tracing.export_chrome(args.trace_out)
    if losses and rank0:
        print(f"[train] done at step {final}; loss {losses[0]:.4f} -> {losses[-1]:.4f}",
              flush=True)
    return final


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full", "save_kv"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--loss-chunk", type=int, default=0,
                    help=">0: chunked cross-entropy over this many positions at a time")
    ap.add_argument("--mesh", default="",
                    help="RxC (data x model) or N: one rank per device, under torchrun")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--straggler-sigma", type=float, default=3.0)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (fault drill under run_with_restarts)")
    ap.add_argument("--trace-out", default="",
                    help="trace the run and write its spans and counters here (Chrome JSON)")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    if args.trace_out:
        tracing.enable()
    spec = get_arch(args.arch)
    if args.reduced:
        spec = reduced(spec)
    if args.fail_at is None:
        train_loop(args, spec)
        return
    attempts = []

    def loop(start: int) -> int:
        attempts.append(start)  # only the first attempt fails
        return train_loop(args, spec, fail_at=args.fail_at if len(attempts) == 1 else None)

    rep = run_with_restarts(loop, target_step=args.steps)
    print(f"[train] fault drill: completed {rep.completed_steps} steps after "
          f"{rep.restarts} restart(s): {rep.failures}", flush=True)


if __name__ == "__main__":
    main()
