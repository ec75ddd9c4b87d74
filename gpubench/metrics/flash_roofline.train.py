"""Percent of the roofline of flash attention's calls, forward
(``repro_torch::flash_fwd``, recomputes included) and backward
(``repro_torch::flash_bwd``): the bound's seconds of every call over their
device seconds (``counts.flash_fwd_bound``, ``counts.flash_bwd_bound``)."""
from gpubench import counts


def read(ctx, view):
    return counts.roofline_pct((view.calls("repro_torch::flash_fwd"), counts.flash_fwd_bound(ctx)),
                               (view.calls("repro_torch::flash_bwd"), counts.flash_bwd_bound(ctx)))
