"""The controls and faults of a cell's check, read at the cell's own size.

    python3 gpubench/controls.py --workload <cell> --seeds <n> <n> <n> [--seconds 5]

Prints one JSON line a seed: the numbers that the control (the plain
reference in the program's place, its float32 products in TF32: the
nearest precision below the configuration's) and each planted fault read
against the reference.  Training: the control, and half of each batch
left out (the mean over the rest) planted in the reference; a state left
unchanged reads 1 by the change's measure and needs no run.  Serving: the
program's own numbers over a short window at the cell's load, the
control's (the gap of the token TF32 puts first, and its logits against
the float32 reference's), and one served token a request altered (its
logits left as they were).  Both: the witness, the reference itself with
every initial weight one float32 step up, which shows how far rounding
alone carries the compared numbers.  The limits in
``workloads/<cell>.json`` are set from these readings and the program's
own.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def half_rows(batch):
    n = batch["labels"].shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}


def train_readings(ctx) -> dict:
    from repro_torch.configs.base import ArchSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    from gpubench import checks, harness
    drv = harness.driver("train_loop")
    t = ctx.traffic
    data = SyntheticLM(ArchSpec(**ctx.arch), DataConfig(t["batch"], t["seq"], seed=ctx.seed))
    batches = [data.batch_at(i) for i in range(t["checked_steps"])]
    t0 = time.perf_counter()
    ref = drv.reference_run(ctx, batches)
    ref_s = time.perf_counter() - t0
    return {"control": checks.train_numbers(drv.reference_run(ctx, batches, tf32=True), ref),
            "half_batch": checks.train_numbers(
                drv.reference_run(ctx, batches, fault=half_rows), ref),
            "state_unchanged": {"change_gap": 1.0, "grad_norm_gap": 1.0},
            "witness": checks.train_numbers(drv.reference_run(ctx, batches, nudge=True), ref),
            "reference_s": ref_s}


def serve_readings(ctx) -> dict:
    import numpy as np
    import torch

    from gpubench import checks, harness
    drv = harness.driver("serve_batches")
    got = drv.serve(ctx)
    t0 = time.perf_counter()
    ref = drv.reference_logits(ctx, got["checked"])
    ref_s = time.perf_counter() - t0
    ctl = drv.reference_logits(ctx, got["checked"], tf32=True)
    served = torch.as_tensor(np.concatenate([out for _, out in got["checked"]]),
                             device=ctx.device)
    p = served.shape[1]
    altered = served.clone()
    altered[:, -1] = (altered[:, -1] + 1) % ctx.arch["vocab_size"]
    return {"program": checks.serve_numbers(got["logits"], ref, served),
            "control": checks.serve_numbers(ctl, ref, ctl[:, :p].argmax(dim=-1)),
            "token_altered": checks.serve_numbers(got["logits"], ref, altered),
            "witness": checks.serve_numbers(
                drv.reference_logits(ctx, got["checked"], nudge=True), ref, served),
            "requests": got["requests"], "checked_requests": served.shape[0],
            "reference_s": ref_s}


def readings(cell: str, seed: int, seconds: float, device: str = "cuda",
             overrides: dict | None = None) -> dict:
    from gpubench import harness
    ctx = harness.context(cell, seed, seconds, False, device, time.perf_counter(), overrides)
    kind = ctx.traffic["kind"]
    return {"train_loop": train_readings, "serve_batches": serve_readings}[kind](ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(args.workload, seed, args.seconds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
