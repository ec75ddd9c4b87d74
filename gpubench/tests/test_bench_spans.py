"""The readers of the program's spans and counters (``gpubench/spans.py``
and the metrics that use it): the clock alignment against synthetic events
with a known offset; each new metric reading a number at the ``SMALL``
shapes on the CPU from a real profile and the tracer's real records and
counters, or, where it needs the card's kernels, from synthetic events;
and every one of them leaving itself out for a program without the
tracer."""
from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from gpubench import harness, spans, trace
from gpubench.tests.conftest import SMALL

NEW = ("data_wait_ms.train", "data_make_ms.train", "idle_while_feeding.train",
       "moe_dispatch_ms.train", "moe_occupancy.train", "moe_dispatch_ms.serve",
       "moe_occupancy.serve", "decode_device_ms.serve")


@pytest.fixture
def tracer():
    from repro_torch.runtime import tracing
    tracing.disable()
    tracing.reset()
    yield tracing
    tracing.disable()
    tracing.reset()


def event(name, start, end, thread=1):
    return SimpleNamespace(name=name, thread=thread, time_range=SimpleNamespace(start=start,
                                                                                  end=end))


def test_offset_from_synthetic_events_with_a_known_offset(tracer):
    main, other = threading.main_thread().native_id, -7
    off = 123_456.75  # us: profiler clock less the tracer's
    records, events = [], []
    t = 5_000_000_000  # ns
    for i in range(6):  # the first three only in the tracer (a sub-window before)
        for name, a, b in (("train.step", 0, 900 + 37 * i), ("train.forward", 10, 400 + i),
                           ("moe.route", 20, 30), ("moe.route", 60, 70)):
            s, e = t + a * 1000, t + b * 1000
            records.append(tracer.Span(name, main, s, e, 0, {}, len(records) + 1))
            if i >= 3:
                jitter = (-1.5, 2.0, 0.5)[len(events) % 3]  # the profiler's own start
                events.append(event(name, s / 1e3 + off + jitter, e / 1e3 + off))
        # a recompute's spans on another thread, in the tracer only
        records.append(tracer.Span("moe.route", other, t + 500_000, t + 510_000, 0, {}, 0))
        t += 1_000_000
    got = spans.offset_us(events, records)
    assert got == pytest.approx(off, abs=2.5)
    assert spans.offset_us(events, [r for r in records if r.name != "moe.route"]) == \
        pytest.approx(off, abs=2.5)
    assert spans.offset_us(events, [r for r in records if r.thread == other]) is None
    assert spans.offset_us([], records) is None


def test_interval_helpers():
    assert spans.merged([(5, 9), (0, 2), (1, 3), (8, 12)], 1, 10) == [(1, 3), (5, 10)]
    assert spans.gaps([(1, 3), (5, 10)], 0, 12) == [(0, 1), (3, 5), (10, 12)]
    assert spans.overlap([(0, 4), (6, 10)], [(3, 7), (9, 20)]) == 1 + 1 + 1


def small_spec(config):
    from repro_torch.configs.base import ArchSpec
    return ArchSpec(**{**harness.config(config)["arch"], **SMALL[config]})


def test_train_metrics_read_a_profile_and_the_tracers_records(tracer):
    from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
    from repro_torch.launch.train import build
    from repro_torch.train.train_step import RunConfig

    spec = small_spec("granite-moe-3b-a800m")
    _, step_fn, state = build(spec, None, RunConfig(remat="dots"), 3, "cpu")
    feed = Prefetcher(SyntheticLM(spec, DataConfig(2, 64, seed=3)), depth=1)
    batches = iter(feed)
    try:
        state, _ = step_fn(state, next(batches)[1])  # set-up, untraced
        steps = 3
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(steps):
                with record_function(trace.STEP):
                    state, m = step_fn(state, next(batches)[1])
                    float(m["loss"])
                    time.sleep(0.01)  # the feed makes the next batch meanwhile
    finally:
        feed.close()
    events = prof.events()
    view = trace.TraceView(events, 1.0, events, steps)
    ctx = SimpleNamespace()
    read = {n: harness.metric(n).read(ctx, view) for n in NEW if n.endswith(".train")}
    assert read["data_wait_ms.train"] is not None and read["data_wait_ms.train"] >= 0
    assert read["data_make_ms.train"] > 0
    assert 0 < read["idle_while_feeding.train"] <= 100  # no device: every instant is idle
    c = tracer.counters()
    assert read["moe_occupancy.train"] == pytest.approx(
        100 * (c["moe.assignments"] - c["moe.dropped"]) / c["moe.rows"])
    layers = sum(ld.ffn == "moe" for ld in spec.layer_defs())
    assert c["moe.assignments"] == steps * layers * 2 * 64 * spec.top_k
    assert read["moe_dispatch_ms.train"] is None  # no kernels on the CPU
    # the wait and make spans read are those of the profiled steps
    wait = [e for e in events if e.name == "data.wait" and e.thread == view.main]
    assert read["data_wait_ms.train"] == pytest.approx(
        sum(e.time_range.end - e.time_range.start for e in wait) / 1e3 / steps, rel=0.05,
        abs=0.02)


def test_serve_occupancy_reads_the_counters_of_prefill_and_decode(tracer):
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine

    spec = small_spec("granite-moe-3b-a800m")
    engine = Engine(spec, M.init_params(spec, 5, device="cpu"), max_len=68, device="cpu")
    prompts = np.random.default_rng(5).integers(0, spec.vocab_size, (2, 64)).astype(np.int32)
    with profile(activities=[ProfilerActivity.CPU]):
        engine.generate(prompts, max_new=4)
    c = tracer.counters()
    layers = sum(ld.ffn == "moe" for ld in spec.layer_defs())
    assert c["moe.assignments"] == layers * (2 * 64 + 4 * 2) * spec.top_k
    got = harness.metric("moe_occupancy.serve").read(SimpleNamespace(), None)
    assert 0 < got <= 100
    assert got == pytest.approx(100 * (c["moe.assignments"] - c["moe.dropped"]) / c["moe.rows"])


class FakeView:
    """Synthetic events of a traced run on the card: device seconds by span."""

    def __init__(self, device_s: dict, cpu, steps: int):
        self.device_s, self.cpu, self.steps, self.main = device_s, cpu, steps, 1

    def layer_s(self, label):
        return self.device_s.get(label, 0.0)


def test_device_span_metrics_from_synthetic_events():
    cpu = [event("serve.decode_step", i, i + 1) for i in range(8)] + \
        [event("serve.decode_step", 0, 1, thread=2)]  # another thread's: not a step
    view = FakeView({"moe.route": 0.002, "moe.dispatch": 0.003, "moe.combine": 0.001,
                     "moe.experts": 0.5, "serve.decode_step": 0.016}, cpu, 2)
    ctx = SimpleNamespace()
    assert harness.metric("moe_dispatch_ms.train").read(ctx, view) == pytest.approx(3.0)
    assert harness.metric("moe_dispatch_ms.serve").read(ctx, view) == pytest.approx(3.0)
    assert harness.metric("decode_device_ms.serve").read(ctx, view) == pytest.approx(2.0)


def test_without_the_tracer_every_new_metric_leaves_itself_out(monkeypatch):
    monkeypatch.setattr(spans, "tracer", lambda: None)
    view = FakeView({}, [event("bench::step", 0, 10)], 1)
    view.t0, view.t1, view.layered = 0.0, 10.0, []
    view.union = trace.TraceView.union
    for name in NEW:
        assert harness.metric(name).read(SimpleNamespace(), view) is None, name


def test_the_new_metrics_are_declared_where_they_read():
    bench = harness.benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert callable(harness.metric(name).read)
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in harness.end_to_end(bench, cell)}
    assert declared["moe_occupancy.train"]["workloads"] == ["granite-moe-3b-a800m.train.b4s1024"]
    assert set(declared["decode_device_ms.serve"]["workloads"]) == \
        {w["name"] for w in bench["workloads"] if ".serve." in w["name"]}
