"""Serving entry point: batched generation through the Engine, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --batch 4 --prompt-len 1000 --new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --batch 4 --prompt-len 4096 --new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --batch 4 --prompt-len 2040 --new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \
        --batch 4 --prompt-len 1024 --new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Counterpart of the JAX package's ``launch/serve.py``, with ``--device``
(``cuda`` by default; ``cpu`` runs the kernels' plain versions),
``--batches`` (the batch served that many times, each call's times
printed: the first warms up) and ``--trace-out PATH`` (the program's tracer
on, ``runtime/tracing.py``; its spans and counters written to PATH as
Chrome trace JSON at the end).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.models import model as M
from repro_torch.runtime import tracing
from repro_torch.serve.engine import Engine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batches", type=int, default=1, help="serve the batch this many times")
    ap.add_argument("--trace-out", default="",
                    help="trace the run and write its spans and counters here (Chrome JSON)")
    args = ap.parse_args(argv)
    if args.trace_out:
        tracing.enable()

    spec = get_arch(args.arch)
    if args.reduced:
        spec = reduced(spec)
    if spec.frontend != "tokens":
        raise SystemExit(f"{args.arch} uses an embeddings frontend; "
                         "drive it via repro_torch.models.model.prefill/decode_step")
    params = M.init_params(spec, args.seed, device=args.device)
    eng = Engine(spec, params, max_len=args.prompt_len + args.new, device=args.device)
    prompts = np.random.default_rng(args.seed).integers(
        0, spec.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    for _ in range(args.batches):
        out, stats = eng.generate(prompts, max_new=args.new,
                                  temperature=args.temperature, seed=args.seed)
        print(f"[serve] {args.device} | prefill {stats.prefill_s*1e3:.0f} ms | "
              f"decode {stats.decode_tok_per_s:.1f} tok/s "
              f"({stats.decode_s * 1e3 / args.new:.2f} ms a step) | {stats.tokens_out} tokens")
    for i, row in enumerate(out[:4]):
        print(f"  request {i}: {row.tolist()[:16]}{'...' if args.new > 16 else ''}")
    if args.trace_out:
        tracing.export_chrome(args.trace_out)


if __name__ == "__main__":
    main()
