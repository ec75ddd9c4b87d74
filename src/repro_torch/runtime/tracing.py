"""The program's tracer: named spans and counters, off unless asked for.

    with tracing.span("train.forward", step=3, microbatch=0):
        ...
    tracing.count("moe.dropped", dropped)   # a host int or a device tensor

Tracing is on while ``enable()`` holds, or while a torch profiler records
(its process-wide flag, which every thread sees).  Off, a span reads that
state and returns one shared no-op context: it records nothing, launches
nothing and never waits for the device; ``count`` returns at once.

On, a span appends a ``Span`` (name, thread, start and end on
``time.perf_counter_ns``, the serial of the span that encloses it on its
thread, its ids, its own serial) to an in-memory buffer of at most ``CAP``
(2**18 = 262,144) records, the oldest dropped beyond it.  ``ids`` are the step number in
training (``step``, and ``microbatch``) and the number of the
``Engine.generate`` call in serving (``request``), so one step's or one
request's spans share an id.  While a profiler records, a live span also
opens a profiler range of its name, so its interval lands among the
profiler's events, on the device trace's clock; a range opened on a thread
the profiler does not record (the feed's) is not kept there.

Counters take host ints or device tensors.  A tensor is added on its
device, into a sum read back only by ``counters()``; nothing on the step's
path asks the device for a value.  Counts made while autograd runs a
backward (a remat recompute re-running a layer's forward) are skipped, so
each forward is counted once.  ``counters()`` also reports the kernel
wrappers' own ``.launches`` attributes (``repro_torch.kernels``, those
imported) as ``kernels.<wrapper>.launches``, read, never counted twice.

The spans and counters of the program, and who reads them:

  train/train_step.py ``train_step``
    train.step        (step)              the call; parent of the four below
    train.to_device   (step[, microbatch]) ``to_device`` and the batch's layout
    train.forward     (step, microbatch)  the loss function
    train.backward    (step, microbatch)  ``grads_laid_out`` (the backward's
                                          kernels run on autograd's thread)
    train.optimizer   (step)              ``optimizer.apply_updates``
  data/pipeline.py ``Prefetcher``
    data.wait         (step)              the loop waiting on the feed's queue
    data.make         (step)              ``batch_at`` on the feed's thread
  serve/engine.py ``Engine.generate``
    serve.generate    (request)           the call
    serve.prefill     (request)           caches, prompts to the device, prefill
    serve.sample      (request, step)     argmax or multinomial
    serve.to_host     (request, step)     the sampled tokens to the host
    serve.decode_step (request, step)     one decode step
  models/moe.py
    moe                                   ``moe_apply``, the whole layer
    moe.route                             the router's product and ``route``
    moe.dispatch                          the (E, G, C, D) buffer's gather and
                                          the outbound all-to-all
    moe.experts                           the expert products
    moe.combine                           the return all-to-all, the gather
                                          back and the weighted sum
    counters moe.assignments (host: tokens x top_k), moe.dropped (device:
    assignments over capacity), moe.rows (host: the buffer rows the expert
    products run on this rank); occupancy is (assignments - dropped) / rows.

``export_chrome(path)`` writes the records as a Chrome trace (one complete
event a span, a counter event a counter); ``launch/train.py`` and
``launch/serve.py`` take ``--trace-out PATH`` for it.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import sys
import threading
import time
import types
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

CAP = 1 << 18  # span records kept; beyond it the oldest are dropped

# a profiler range of the span's name: the cheaper C++ one where torch has it
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) or _profiler.record_function


class Span(NamedTuple):
    name: str
    thread: int      # the OS thread id (threading.get_native_id)
    start_ns: int    # time.perf_counter_ns
    end_ns: int
    parent: int      # serial of the enclosing span on the same thread, 0 for none
    ids: dict
    serial: int


_on = False
_records: collections.deque = collections.deque(maxlen=CAP)
_counts: dict[str, int | float] = {}
_sums: dict[str, torch.Tensor] = {}
_threads: dict[int, str] = {}
_lock = threading.Lock()
_serial = itertools.count(1)
_local = threading.local()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Live:
    __slots__ = ("name", "ids", "serial", "parent", "stack", "range", "start")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _threads[threading.get_native_id()] = threading.current_thread().name
        self.parent = stack[-1] if stack else 0
        self.serial = next(_serial)
        stack.append(self.serial)
        self.stack = stack
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _RANGE(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.stack.pop()
        _records.append(Span(self.name, threading.get_native_id(), self.start, end, self.parent,
                             self.ids, self.serial))
        return False


def span(name: str, **ids):
    """A context manager timing the block as ``name`` (module docstring)."""
    if not (_on or _profiler._is_profiler_enabled):
        return _OFF
    return _Live(name, ids)


def count(name: str, value) -> None:
    """Add ``value`` (a host number or a device tensor) to counter ``name``."""
    if not (_on or _profiler._is_profiler_enabled) or torch._C._current_graph_task_id() != -1:
        return
    with _lock:
        if isinstance(value, torch.Tensor):
            # out of place: a sum made under inference_mode stays usable outside it
            v = value.detach().to(torch.float64)
            prev = _sums.get(name)
            _sums[name] = v if prev is None else prev + v
        else:
            _counts[name] = _counts.get(name, 0) + value


def spans() -> list[Span]:
    """The records, in the order the spans ended."""
    return list(_records)


def _kernel_launches() -> dict[str, int]:
    """``kernels.<wrapper>.launches`` of every kernel wrapper imported."""
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if mod is None or not mod_name.startswith("repro_torch.kernels."):
            continue
        for attr, fn in vars(mod).items():
            if isinstance(fn, types.FunctionType) and fn.__module__ == mod_name \
                    and isinstance(fn.__dict__.get("launches"), int):
                out[f"kernels.{attr}.launches"] = fn.launches
    return out


def counters() -> dict[str, int | float]:
    """Every counter's total (device sums read back here), and the kernels'
    launches."""
    with _lock:
        out = dict(_counts)
        sums = dict(_sums)
    for name, t in sums.items():
        out[name] = out.get(name, 0) + t.item()
    out.update(_kernel_launches())
    return out


def reset() -> None:
    """Forget every record and counter (the kernels' attributes stay)."""
    with _lock:
        _records.clear()
        _counts.clear()
        _sums.clear()


def export_chrome(path) -> None:
    """The records and counters as Chrome trace JSON (``chrome://tracing``,
    Perfetto): a complete event a span, its ids and parent as args; a
    counter event a counter, at the last span's end."""
    recs, pid = spans(), os.getpid()
    events: list[dict] = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                           "args": {"name": name}} for tid, name in _threads.items()]
    events += [{"name": r.name, "ph": "X", "pid": pid, "tid": r.thread, "ts": r.start_ns / 1e3,
                "dur": (r.end_ns - r.start_ns) / 1e3,
                "args": {**r.ids, "serial": r.serial, "parent": r.parent}} for r in recs]
    end = max((r.end_ns for r in recs), default=time.perf_counter_ns()) / 1e3
    events += [{"name": name, "ph": "C", "pid": pid, "ts": end, "args": {"value": value}}
               for name, value in counters().items()]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
