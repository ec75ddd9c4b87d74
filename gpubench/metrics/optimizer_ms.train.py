"""Device ms a step launched inside the optimizer's update
(``train/optimizer.py`` ``apply_updates``)."""
RANGES = {"bench::optimizer": "repro_torch.train.optimizer:apply_updates"}


def read(ctx, view):
    s = view.layer_s("bench::optimizer")
    return 1e3 * s / view.steps if s else None
