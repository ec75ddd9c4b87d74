"""Percent of the roofline of the SSD scan's forward calls
(``repro_torch::ssd_fwd``, prefill's; decode's recurrence bypasses the
kernel)."""
from gpubench import counts


def read(ctx, view):
    return counts.roofline_pct((view.calls("repro_torch::ssd_fwd"), counts.ssd_fwd_bound(ctx)))
