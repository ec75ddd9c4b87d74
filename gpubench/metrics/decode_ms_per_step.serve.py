"""Host-clock ms a decode step over the window's batches: the engine's own
``ServeStats.decode_s`` (synchronised at both ends, the whole decode loop)
summed, over the steps it took."""


def read(ctx, view):
    n = ctx.spans.get("decode_steps")
    return 1e3 * ctx.spans["decode_s"] / n if n else None
