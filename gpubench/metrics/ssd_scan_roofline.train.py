"""Percent of the roofline of the SSD scan's calls, forward
(``repro_torch::ssd_fwd``, recomputes included) and backward
(``repro_torch::ssd_bwd``): the bound's seconds of every call over their
device seconds (``counts.ssd_fwd_bound``, ``counts.ssd_bwd_bound``)."""
from gpubench import counts


def read(ctx, view):
    return counts.roofline_pct((view.calls("repro_torch::ssd_fwd"), counts.ssd_fwd_bound(ctx)),
                               (view.calls("repro_torch::ssd_bwd"), counts.ssd_bwd_bound(ctx)))
