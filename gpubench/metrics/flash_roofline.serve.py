"""Percent of the roofline of flash attention's forward calls
(``repro_torch::flash_fwd``, prefill's; decode attends without the
kernel)."""
from gpubench import counts


def read(ctx, view):
    return counts.roofline_pct((view.calls("repro_torch::flash_fwd"), counts.flash_fwd_bound(ctx)))
