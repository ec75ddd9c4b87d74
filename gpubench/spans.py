"""The program's own spans and counters (``repro_torch.runtime.tracing``) as
the per-layer metrics read them.

The tracer is on while the profiler records, so the traced run's profiled
steps leave records in it.  A span on a thread the profiler records is
also among the profiler's events; the feed's thread is not, so its records
are placed on the profiler's clock by an offset taken from the main
thread's spans found in both (``offset_us``).  A program without the tracer
(a checkout older than it) gives None throughout, and the metrics that
read it are left out of the line.
"""
from __future__ import annotations

import bisect
import math
import statistics
import threading

MATCH_US = 50.0  # a record and the profiler's event of one span start this close


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from repro_torch.runtime import tracing
    except ImportError:
        return None
    return tracing


def counters() -> dict | None:
    t = tracer()
    return None if t is None else t.counters()


def offset_us(events, records, thread: int | None = None) -> float | None:
    """Microseconds that place a record (``start_ns / 1e3``) on the
    profiler's clock, from the spans of ``thread`` (the main thread's OS id
    by default) among both ``events`` (the profiler's, of that thread) and
    ``records`` (the tracer's).  Each pairing of the name with the fewest
    pairs proposes an offset; the one under which most events find a record
    of their name that starts and ends within ``MATCH_US`` of them wins
    (steps alike in length could otherwise pair with the steps of another
    sub-window), ties going to the closer fit; then the median of its
    matches.  None where no name is in both."""
    thread = threading.main_thread().native_id if thread is None else thread
    mine: dict[str, list[tuple[float, float]]] = {}
    for r in records:
        if r.thread == thread:
            mine.setdefault(r.name, []).append((r.start_ns / 1e3, r.end_ns / 1e3))
    theirs: dict[str, list[tuple[float, float]]] = {}
    for e in events:
        if e.name in mine:
            theirs.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    if not theirs:
        return None
    for got in mine.values():
        got.sort()
    seed = min(theirs, key=lambda n: len(theirs[n]) * len(mine[n]))
    best, fit = [], math.inf
    for p, _ in theirs[seed]:
        for q, _ in mine[seed]:
            diffs, miss = _matched(theirs, mine, p - q)
            if len(diffs) > len(best) or (len(diffs) == len(best) and miss < fit):
                best, fit = diffs, miss
    return statistics.median(best) if best else None


def _matched(theirs, mine, off: float) -> tuple[list[float], float]:
    """For each event with a record of its name that starts and ends within
    ``MATCH_US`` of it under ``off``: event start less record start; and
    the matches' summed distance."""
    out, miss = [], 0.0
    for name, intervals in theirs.items():
        got = mine[name]
        starts = [s for s, _ in got]
        for p, pe in intervals:
            i = bisect.bisect_left(starts, p - off - MATCH_US)
            while i < len(got) and got[i][0] + off <= p + MATCH_US:
                d = abs(got[i][0] + off - p) + abs(got[i][1] + off - pe)
                if abs(got[i][1] + off - pe) <= MATCH_US:
                    out.append(p - got[i][0])
                    miss += d
                    break
                i += 1
    return out, miss


def placed(view, name: str) -> list[tuple[float, float]] | None:
    """(start, end) on the profiler's clock (us) of every record of span
    ``name``, on any thread; None without the tracer or a common span."""
    t = tracer()
    if t is None:
        return None
    records = t.spans()
    off = offset_us([e for e in view.cpu if e.thread == view.main], records)
    if off is None:
        return None
    return [(r.start_ns / 1e3 + off, r.end_ns / 1e3 + off) for r in records if r.name == name]


def merged(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of ``intervals`` clipped to [lo, hi], in order."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """[lo, hi] less the ordered, disjoint intervals ``busy``."""
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def overlap(a, b) -> float:
    """The length two ordered, disjoint interval lists share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
