"""The port's benchmark: one run of one cell on the card it is started on.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the port's CUDA sources (or loads them from ``src/repro_torch/build/``),
makes the weights and the traffic on the card from ``--seed``, warms up the
cell's own shapes, measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON line last on
standard output (the checks, each beside its limit, also last on standard
error).  Without a card, with fewer cards than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits with a code other than 0.
"""
import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache of the program at a fixed place inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gpubench import harness
    chips = harness.cell(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations are float32
    torch.backends.cudnn.allow_tf32 = False
    line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0,
                       torch.cuda.get_device_name(0))
    bad = harness.forbidden_modules()
    if bad:
        print(f"gpubench: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
