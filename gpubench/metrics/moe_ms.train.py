"""Device ms a step launched inside the MoE layers (``models/moe.py``
``moe_apply``: routing, dispatch, the experts), their backward and their
recompute included."""
RANGES = {"bench::moe": "repro_torch.models.moe:moe_apply"}


def read(ctx, view):
    s = view.layer_s("bench::moe")
    return 1e3 * s / view.steps if s else None
