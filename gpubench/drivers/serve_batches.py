"""Serving in a closed loop: one client sends static batches of seeded
prompts to the port's ``Engine.generate`` (greedy), the next batch once the
last has come back.

Set-up makes the weights on the card from the seed
(``models.model.init_params``), builds the engine and serves the warm-up
batches at the cell's shapes.  Each window batch's prompts are drawn from
(seed, batch index).  A request's time to first token is the wall time of
the call that serves it less the call's ``ServeStats.decode_s``; the tokens
served are each request's prompt and generated tokens.  The logits of a
sample of the batches, drawn from the seed, are copied aside as they are
made; once the window has closed and the engine is freed, the plain
reference runs over those batches, each prompt with its served tokens.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from gpubench import checks, harness, trace
from gpubench.reference import common


def prompts(ctx: harness.Context, stream: int, i: int) -> np.ndarray:
    t = ctx.traffic
    rng = np.random.default_rng((ctx.seed, stream, i))
    return rng.integers(0, ctx.arch["vocab_size"], size=(t["batch"], t["prompt_len"]),
                        dtype=np.int32)


def reference_logits(ctx: harness.Context, served: list[tuple[np.ndarray, np.ndarray]], *,
                     tf32: bool = False, nudge: bool = False) -> torch.Tensor:
    """The reference's logits (R, P + 1, V) at the positions that produced
    each request's P served tokens and the one after, from the seed's
    weights (``nudge``: each one float32 step up); ``served``: (prompts
    (B, S), tokens (B, P)) of each batch."""
    ref, cfg = harness.reference(ctx.config["reference"]), ctx.reference_cfg()
    params = common.init_params(ref.param_defs(cfg), ctx.seed, ctx.device, nudge=nudge)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    out = []
    try:
        with torch.no_grad():
            for p, toks in served:
                s, n = p.shape[1], toks.shape[1]
                seq = torch.as_tensor(np.concatenate([p, toks], axis=1), device=ctx.device)
                out.append(ref.served_logits(params, seq, s, list(range(s - 1, s + n)), cfg))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return torch.cat(out)


def serve(ctx: harness.Context) -> dict:
    """Set-up, the window and (``--trace 1``) the profiled batches; the
    engine freed.  Returns what was measured and what was served."""
    from repro_torch.configs.base import ArchSpec
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine

    t, dev = ctx.traffic, ctx.device
    spec = ArchSpec(**ctx.arch)
    s, new = t["prompt_len"], t["max_new"]
    params = M.init_params(spec, ctx.seed, device=dev)
    engine = Engine(spec, params, max_len=s + new, dtype=torch.float32, device=dev)
    # the logits of the batches the check samples (each batch with the mix's
    # ``check_share``, drawn from the seed, up to ``checked_batches``) go
    # into a buffer made in set-up, so the window allocates nothing for them
    keep = np.random.default_rng((ctx.seed, 2)).random(10**6) < t["check_share"]
    kept = torch.empty((t["checked_batches"], t["batch"], new + 1, spec.vocab_size),
                       dtype=torch.float32, device=dev)
    slot = [None, 0]  # the buffer row of the batch being served (None: not kept), its position

    def keeping(fn):
        def call(*a):
            out = fn(*a)
            if slot[0] is not None:
                kept[slot[0], :, slot[1]].copy_(out[0])
                slot[1] += 1
            return out
        return call

    engine._prefill = keeping(engine._prefill)
    engine._decode = keeping(engine._decode)
    for j in range(t["warm_batches"]):
        engine.generate(prompts(ctx, 0, j), max_new=new)
    if dev == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t0

    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    ttft, decode_s, served, checked = [], [], [], []
    t0 = time.perf_counter()
    while True:
        i = len(served)
        p = prompts(ctx, 1, i)
        slot[:] = [len(checked), 0] if keep[i] and len(checked) < len(kept) else [None, 0]
        c0 = time.perf_counter()
        out, stats = engine.generate(p, max_new=new)
        wall = time.perf_counter() - c0
        ttft += [wall - stats.decode_s] * p.shape[0]
        decode_s.append(stats.decode_s)
        served.append((p, out))
        if slot[0] is not None:
            checked.append((p, out))
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    slot[0] = None
    ctx.spans.update(decode_s=sum(decode_s), decode_steps=len(decode_s) * new,
                     window_s=window_s, steps=len(served))
    view = None
    if ctx.trace:
        extra = iter(range(10**9))
        view = trace.profiled(lambda: engine.generate(prompts(ctx, 3, next(extra)), max_new=new),
                              t["trace_device_steps"], t["trace_layer_steps"], ctx.ranges)
    peak = max(peak, torch.cuda.max_memory_allocated() if dev == "cuda" else 0)
    prog = kept[:len(checked)].reshape(-1, new + 1, spec.vocab_size).clone()
    del engine, params, kept
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    requests = len(served) * t["batch"]
    return {"end_to_end": {"setup_s": setup_s,
                           "serve_ttft_ms_p95": float(np.percentile(ttft, 95)) * 1e3,
                           "serve_tokens_per_s": requests * (s + new) / window_s},
            "requests": requests, "peak": peak, "view": view,
            "checked": checked, "logits": prog}


def run(ctx: harness.Context) -> harness.Outcome:
    got = serve(ctx)
    tokens = torch.as_tensor(np.concatenate([out for _, out in got["checked"]]),
                             device=ctx.device)
    numbers = checks.serve_numbers(got["logits"], reference_logits(ctx, got["checked"]), tokens)
    return harness.Outcome(end_to_end=got["end_to_end"], attempted=got["requests"], failed=0,
                           checks=checks.judged(numbers, ctx.limits),
                           memory_peak_bytes=got["peak"], view=got["view"])
