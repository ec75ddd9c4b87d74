"""The whole batch's model FLOPs (``counts.serve_batch_flops``: prefill and
every decode step) times the batches of the traced run's timed window,
over that window's seconds (host clock), as a percent of the card's peak.
The profiled batches after the window are not used: the profiler slows
them."""
from gpubench import counts


def read(ctx, view):
    t = ctx.traffic
    flops = ctx.spans["steps"] * counts.serve_batch_flops(ctx.arch, t["batch"], t["prompt_len"],
                                                          t["max_new"])
    return 100.0 * flops / ctx.spans["window_s"] / counts.peak_flops(ctx)
