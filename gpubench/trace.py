"""The traced run's profiled sub-windows, and what the per-layer metrics
read from them.

``profiled`` runs a few steps under a profiler that records the device
alone (the busy union, the idle share, the device operations), then a few
more under one that records the host's ops too, with their shapes, each
step inside a ``bench::step`` range and ``record_function`` ranges opened
around the module attributes that the cell's metrics name.  Device time is
attributed to a layer by the CPU range that launched it: a kernel belongs
to a range when the op that launched it lies inside that range, or inside
an autograd node whose forward op (the same ``sequence_nr`` on the forward
thread) lay inside it.  So a rewrite under new kernel names keeps its time
in its layer, and a recompute inside the backward counts where it runs.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import math
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

STEP = "bench::step"
BACKWARD = "autograd::engine::evaluate_function:"
# host-side records of the CUDA runtime and the profiler that the trace
# links to the kernels they delayed: no op of the program
RUNTIME = {"Command Buffer Full", "Activity Buffer Request"}


@contextlib.contextmanager
def ranges_around(ranges: dict[str, str]):
    """``record_function(label)`` around each ``"module:attr"`` of ``ranges``
    ({label: target}) while the block runs; the attributes come back after."""
    undo = []
    try:
        for label, target in ranges.items():
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)

            def wrapped(*a, _orig=orig, _label=label, **k):
                with record_function(_label):
                    return _orig(*a, **k)

            setattr(mod, attr, functools.wraps(orig)(wrapped))
            undo.append((mod, attr, orig))
        yield
    finally:
        for mod, attr, orig in reversed(undo):
            setattr(mod, attr, orig)


def _device_only(step, n: int):
    """``step()`` ``n`` times, each ending in a synchronise, under a profiler
    that records the device alone.  Returns the events and the host-clock
    seconds of the steps."""
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof.events(), wall


def _layered(step, n: int):
    """``step()`` once as the profiler's warm-up, then ``n`` times under a
    profiler that records the host's ops with their shapes too, each step
    inside a ``bench::step`` range and ending in a synchronise."""
    sched = torch.profiler.schedule(wait=0, warmup=1, active=n, repeat=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                 schedule=sched) as prof:
        for _ in range(n + 1):
            with record_function(STEP):
                step()
                torch.cuda.synchronize()
            prof.step()
    return prof.events()


def profiled(step, n_device: int, n_layers: int, ranges: dict[str, str]) -> "TraceView":
    """Two profiled sub-windows.  The first records the device alone
    (CUPTI: about 5 % on a mamba2 train step): the busy union, the idle
    share, the device operations.  The second records the host's ops too,
    with their shapes and the layer ranges (``ranges``) open, which slows
    the host by tens of percent: it gives each layer's device time and each
    kernel call's shapes, which the host's speed does not change, and the
    host ops that idle gaps fall in."""
    device, wall = _device_only(step, n_device)
    with ranges_around(ranges):
        events = _layered(step, n_layers)
    return TraceView(device, wall, events, n_layers)


class TraceView:
    """The device-only sub-window's device operations and host-clock
    seconds, and the events of the layered sub-window of ``steps`` steps."""

    def __init__(self, device_events, wall_s: float, events, steps: int):
        self.wall_s, self.steps = wall_s, steps
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        marks = [e for e in cpu if e.name == STEP]
        if not marks:
            raise RuntimeError("the profiler recorded no step")
        self.main = marks[0].thread
        self.t0 = min(e.time_range.start for e in marks)
        self.t1 = max(e.time_range.end for e in marks)
        self.cpu = cpu
        # the device's operations: kernels, copies and sets; the profiler also
        # marks each record_function range on the device's timeline (a user
        # annotation), which is no operation
        self.annotations = {e.name for e in cpu if e.name.startswith("bench::")} | {
            e.name for e in list(events) + list(device_events)
            if getattr(e, "is_user_annotation", False)}
        self.device = self._ops(device_events)
        self.layered = self._ops(events)

    def _ops(self, events):
        return sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                      if e.device_type == DeviceType.CUDA and e.name not in self.annotations
                      and not e.name.startswith(STEP))

    @property
    def window_s(self) -> float:
        """Host-clock seconds of the device-only sub-window's steps."""
        return self.wall_s

    @staticmethod
    def union(ops, lo: float = -math.inf, hi: float = math.inf) -> list[tuple[float, float]]:
        """The union of ``ops``' intervals (us), clipped to [lo, hi]."""
        out: list[list[float]] = []
        for s, e, _ in ops:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device, over the
        device-only sub-window."""
        return sum(e - s for s, e in self.union(self.device)) / 1e6

    def calls(self, name: str):
        """(input shapes, concrete inputs, device seconds) of each call of the
        CPU op ``name``: its own kernels and those of the ops inside it."""
        return [(e.input_shapes, getattr(e, "concrete_inputs", None) or [],
                 self._device_s(e)) for e in self.cpu if e.name == name]

    def _own_s(self, e) -> float:
        """Device seconds of the kernels ``e`` itself launched (an op; the
        runtime's own records, such as a full launch queue, launch none)."""
        if e.name in RUNTIME:
            return 0.0
        return sum(k.duration for k in e.kernels if k.name not in self.annotations) / 1e6

    def _device_s(self, e) -> float:
        """Device seconds of ``e``'s kernels and those of the ops inside it."""
        total, stack = 0.0, [e]
        while stack:
            x = stack.pop()
            total += self._own_s(x)
            stack.extend(x.cpu_children)
        return total

    def layer_s(self, label: str) -> float:
        """Device seconds launched inside ``label``'s ranges, their backward
        and recompute included (see the module's docstring).  Walking up
        from the op that launched a kernel: a ``label`` range claims it; a
        forward op recorded on the backward's thread (a recompute of code
        outside the range) or another autograd node stops the walk; the
        autograd node of an op of the range's forward claims it."""
        seqs: set[int] = set()
        for r in self.cpu:
            if r.name == label and r.thread == self.main and not _under(r, BACKWARD):
                stack = [r]
                while stack:
                    e = stack.pop()
                    if e.sequence_nr is not None and e.sequence_nr >= 0:
                        seqs.add(e.sequence_nr)
                    stack.extend(e.cpu_children)
        total = 0.0
        for e in self.cpu:
            own = self._own_s(e)
            if not own:
                continue
            a, recompute = e, False
            while a is not None:
                if a.name == label:
                    total += own
                    break
                if a.name.startswith(BACKWARD):
                    if not recompute and a.sequence_nr in seqs and \
                            getattr(a, "fwd_thread", self.main) == self.main:
                        total += own
                    break
                recompute = recompute or _forward_on_backward_thread(a, self.main)
                a = a.cpu_parent
        return total

    def breakdown(self) -> dict:
        """The device operations that took most time (device-only
        sub-window), and the longest idle gaps of the second sub-window by
        the innermost host op running through them (their lengths include
        the profiler's own cost on the host)."""
        by_name: dict[str, float] = {}
        for s, e, name in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        busy = self.union(self.layered, self.t0, self.t1)
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        main = [e for e in self.cpu if e.thread == self.main]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[self._host_at(main, (a + b) / 2), (b - a) / 1e6] for a, b in gaps]}

    @staticmethod
    def _host_at(main, t: float) -> str:
        inner = None
        for e in main:
            if e.time_range.start <= t <= e.time_range.end and (
                    inner is None or e.time_range.start >= inner.time_range.start):
                inner = e
        name = inner.name if inner is not None else "outside the steps"
        return "host code between ops" if name == STEP else name[:160]


def _under(e, prefix: str) -> bool:
    a = e.cpu_parent
    while a is not None:
        if a.name.startswith(prefix):
            return True
        a = a.cpu_parent
    return False


def _forward_on_backward_thread(e, main) -> bool:
    """``e`` is a forward op (one that autograd recorded) run off the main
    thread, as a recompute inside the backward runs: not the record of the
    autograd node being evaluated, which carries the node's number too."""
    if e.thread == main or e.sequence_nr is None or e.sequence_nr < 0:
        return False
    p = e.cpu_parent
    return not (p is not None and p.name.startswith(BACKWARD) and p.sequence_nr == e.sequence_nr)
