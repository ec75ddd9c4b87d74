"""Training in a closed loop: the port's train step over prefetched batches.

Set-up builds one train step with its state (``launch.train.build``), and
drives it through the checked steps on the window's own feed
(``SyntheticLM`` through ``Prefetcher``): the reference follows those.  The
window then runs the same step on the next batches until ``--seconds``
have passed, each step ending in a synchronise (its loss read back).
``train_tokens_per_s`` is the tokens of every step in the window over the
window's seconds; ``train_peak_mem_gib`` the allocator's peak over the
window.  Once the window has closed and the program's state is freed, the
plain reference trains from the same seed on the same batches.
"""
from __future__ import annotations

import gc
import math
import time

import torch

from gpubench import checks, harness, trace
from gpubench.reference import common


def _clock(device: str) -> float:
    if device == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def _norms(tensors) -> list[float]:
    return [float(x) for x in torch.stack(torch._foreach_norm([t.float() for t in tensors]))]


def change_norms(params: list[torch.Tensor], defs, seed: int, device, *,
                 nudge: bool = False) -> list[float]:
    """Per leaf, the norm of ``params`` less the initial weights, which the
    reference's init draws again from the seed one leaf at a time."""
    out = []
    for p, (path, init) in zip(params, common.init_leaves(defs, seed, device, nudge=nudge)):
        if p.shape != init.shape:
            raise ValueError(f"leaf {path}: the program's {tuple(p.shape)} against the "
                             f"configuration's {tuple(init.shape)}")
        out.append(float((p.detach().float() - init).norm()))
    return out


def reference_run(ctx: harness.Context, batches: list[dict], *, tf32: bool = False,
                  fault=None, nudge: bool = False) -> dict:
    """The plain reference over ``batches`` from the seed: each step's loss,
    the first step's clipped gradient norms and the change after the last,
    by leaf.  ``tf32``: its float32 products in TF32 (the control);
    ``fault(batch) -> batch``: a fault planted in the reference; ``nudge``:
    every initial weight one float32 step up (a witness of rounding)."""
    ref, cfg = harness.reference(ctx.config["reference"]), ctx.reference_cfg()
    defs = ref.param_defs(cfg)
    params = common.init_params(defs, ctx.seed, ctx.device, nudge=nudge)
    for p in params.values():
        p.requires_grad_(True)
    opt = common.AdamW(params, ctx.traffic["adamw"])
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    losses, first = [], None
    try:
        for batch in batches:
            b = {k: torch.as_tensor(v, device=ctx.device) for k, v in batch.items()}
            loss = ref.loss(params, fault(b) if fault else b, cfg)
            grads = torch.autograd.grad(loss, list(params.values()))
            norms = opt.update(params, dict(zip(params, grads)))
            del grads
            losses.append(float(loss.detach()))
            first = first or list(norms.values())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return {"losses": losses, "grad_norms": first,
            "change_norms": change_norms(list(params.values()), defs, ctx.seed, ctx.device,
                                         nudge=nudge)}


def train(ctx: harness.Context) -> dict:
    """Set-up with the checked steps, the window and (``--trace 1``) the
    profiled steps; the program's state freed.  Returns what was measured,
    the program's readings of the checked steps and their batches."""
    from repro_torch.configs.base import ArchSpec
    from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
    from repro_torch.launch.train import build
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import RunConfig

    t, dev = ctx.traffic, ctx.device
    spec = ArchSpec(**ctx.arch)
    cfg = RunConfig(remat=t["remat"], lb_weight=ctx.config["model"]["lb_weight"],
                    opt=opt.OptConfig(**t["adamw"]))
    _, step_fn, state = build(spec, None, cfg, ctx.seed, dev)
    feed = Prefetcher(SyntheticLM(spec, DataConfig(t["batch"], t["seq"], seed=ctx.seed)),
                      depth=t["prefetch"])
    batches = iter(feed)
    try:
        prog: dict = {"losses": []}
        checked = []
        for i in range(t["checked_steps"]):
            _, batch = next(batches)
            state, m = step_fn(state, batch)
            prog["losses"].append(float(m["loss"]))
            checked.append(batch)
            if i == 0:  # the gradient the optimizer got: its first moment / (1 - b1)
                prog["grad_norms"] = [x / (1 - t["adamw"]["b1"])
                                      for x in _norms(opt.leaves(state["m"]))]
        setup_s = _clock(dev) - ctx.t0  # what follows is the reference's, outside set-up
        ref = harness.reference(ctx.config["reference"])
        prog["change_norms"] = change_norms(opt.leaves(state["params"]),
                                            ref.param_defs(ctx.reference_cfg()), ctx.seed, dev)

        peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        steps = failed = 0
        t0 = _clock(dev)
        while True:
            _, batch = next(batches)
            state, m = step_fn(state, batch)
            failed += not math.isfinite(float(m["loss"]))
            steps += 1
            if _clock(dev) - t0 >= ctx.seconds:
                break
        window_s = _clock(dev) - t0
        ctx.spans.update(window_s=window_s, steps=steps)
        window_peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
        view = None
        if ctx.trace:
            def one():
                nonlocal state
                state, m = step_fn(state, next(batches)[1])
                float(m["loss"])
            view = trace.profiled(one, t["trace_device_steps"], t["trace_layer_steps"],
                                  ctx.ranges)
    finally:
        feed.close()
    del state, step_fn
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    tokens = steps * t["batch"] * t["seq"]
    return {"end_to_end": {"setup_s": setup_s, "train_tokens_per_s": tokens / window_s,
                           "train_peak_mem_gib": window_peak / 2**30},
            "steps": steps, "failed": failed, "peak": max(peak, window_peak), "view": view,
            "readings": prog, "checked": checked}


def run(ctx: harness.Context) -> harness.Outcome:
    got = train(ctx)
    numbers = checks.train_numbers(got["readings"], reference_run(ctx, got["checked"]))
    return harness.Outcome(end_to_end=got["end_to_end"], attempted=got["steps"],
                           failed=got["failed"], checks=checks.judged(numbers, ctx.limits),
                           memory_peak_bytes=got["peak"], view=got["view"])
