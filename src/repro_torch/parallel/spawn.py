"""Run a function on N gloo ranks on the CPU of one host.

The port's counterpart of the JAX package's
``--xla_force_host_platform_device_count``: ``run(fn, n, *args)`` starts
``n`` processes (``spawn``: a fresh interpreter each, so ``fn`` and its
arguments must pickle), joins them into one gloo world through a file store
in a temporary directory (no TCP port, so concurrent runs never collide),
sets one intra-op thread per rank, calls ``fn(*args)`` on every rank and
returns the ranks' results in rank order.  A rank that raises, or a run that
outlasts ``timeout`` seconds, kills every rank and raises.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import tempfile
import time
import traceback
from pathlib import Path


def _rank_main(fn, rank: int, n: int, store_path: str, args, out) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, n), rank=rank,
                                world_size=n)
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def _failures(out, failed: dict[int, str], grace: float = 2.0) -> str:
    """Every failure reported within ``grace`` seconds of the first: a rank's
    error often makes its peers fail too, and the first report to arrive
    need not be the cause."""
    deadline = time.monotonic() + grace
    while (left := deadline - time.monotonic()) > 0:
        try:
            rank, ok, value = out.get(timeout=left)
        except queue.Empty:
            break
        if not ok:
            failed[rank] = value
    return "\n".join(f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items()))


def run(fn, n: int, *args, timeout: float = 60.0) -> list:
    """``fn(*args)`` on ``n`` gloo ranks; the results in rank order."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "store")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, n, store, args, out), daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        results: dict[int, object] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(results) < n:
                left = deadline - time.monotonic()
                try:
                    rank, ok, value = out.get(timeout=max(left, 0.01))
                except queue.Empty:
                    if left <= 0:
                        raise TimeoutError(f"{n} ranks of {getattr(fn, '__name__', fn)} did "
                                           f"not finish in {timeout} s") from None
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and not p.is_alive() and p.exitcode]
                    if dead:
                        raise RuntimeError(f"rank(s) {dead} died with exit code(s) "
                                           f"{[procs[r].exitcode for r in dead]}")
                    continue
                if not ok:
                    raise RuntimeError(_failures(out, {rank: value}))
                results[rank] = value
        finally:
            for p in procs:
                if p.is_alive() and len(results) < n:
                    p.kill()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(n)]
