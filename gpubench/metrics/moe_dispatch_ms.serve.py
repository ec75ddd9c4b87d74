"""Device ms a batch launched inside the MoE layers' routing, dispatch and
combine: the program's spans ``moe.route``, ``moe.dispatch`` and
``moe.combine`` (``models/moe.py`` ``_experts``: the router's product,
top-k and slots, the (E, G, C, D) buffer's gather, the gather back and the
weighted sum), prefill's and decode's.  What ``moe_ms.serve`` holds beside
the expert products."""
SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def read(ctx, view):
    s = sum(view.layer_s(name) for name in SPANS)
    return 1e3 * s / view.steps if s else None
