"""Host ms a batch that the feed's thread took to make it: the program's
``data.make`` spans (``data/pipeline.py`` ``Prefetcher._run``, around
``SyntheticLM.batch_at``) that overlap the layered sub-window's steps,
their mean."""
from gpubench import spans


def read(ctx, view):
    got = spans.placed(view, "data.make")
    inside = [e - s for s, e in got or () if s < view.t1 and e > view.t0]
    return sum(inside) / len(inside) / 1e3 if inside else None
