"""The whole train step's model FLOPs (``counts.train_step_flops``) times
the steps of the traced run's timed window, over that window's seconds (host
clock, every step synchronised), as a percent of the card's peak.  The
profiled steps after the window are not used: the profiler slows them."""
from gpubench import counts


def read(ctx, view):
    t = ctx.traffic
    flops = ctx.spans["steps"] * counts.train_step_flops(ctx.arch, t["batch"], t["seq"])
    return 100.0 * flops / ctx.spans["window_s"] / counts.peak_flops(ctx)
