"""Percent of the expert products' buffer rows that hold a token: the
program's MoE counters over the traced batches (``models/moe.py``: routed
assignments less those dropped over capacity, over the rows of the
(E, G, C, D) buffers the expert products ran on), prefill and decode
together."""
from gpubench import spans


def read(ctx, view):
    c = spans.counters() or {}
    if not c.get("moe.rows"):
        return None
    return 100.0 * (c["moe.assignments"] - c["moe.dropped"]) / c["moe.rows"]
