"""Host ms a step that the train loop waited on the feed's queue: the
program's ``data.wait`` spans (``data/pipeline.py`` ``Prefetcher.__iter__``)
that start within the layered sub-window's steps, over those steps."""
from gpubench import spans


def read(ctx, view):
    got = spans.placed(view, "data.wait")
    inside = [e - s for s, e in got or () if view.t0 <= s <= view.t1]
    return sum(inside) / 1e3 / view.steps if inside else None
