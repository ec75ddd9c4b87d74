"""Percent of the traced steps' wall time in which no operation ran on the
card: 1 less the union of the device's busy intervals over the window."""


def read(ctx, view):
    return 100.0 * (1.0 - view.busy_s / view.window_s)
