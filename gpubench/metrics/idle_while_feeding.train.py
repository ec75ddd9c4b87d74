"""Percent of the layered sub-window's device-idle time (no operation on the
card between its first step's start and its last step's end) during which
the feed's thread was making a batch (the program's ``data.make`` spans,
placed on the profiler's clock)."""
from gpubench import spans


def read(ctx, view):
    got = spans.placed(view, "data.make")
    if not got:
        return None
    idle = spans.gaps(view.union(view.layered, view.t0, view.t1), view.t0, view.t1)
    total = sum(e - s for s, e in idle)
    feeding = spans.merged(got, view.t0, view.t1)
    return 100.0 * spans.overlap(idle, feeding) / total if total else None
