"""The program's tracer (``repro_torch.runtime.tracing``) on the CPU, at
reduced sizes: off it records nothing and changes no result; on, its span
tree (with ids) is both in its own records and among a torch profiler's
events; the MoE counters against a hand count from ``route``, under remat
``none`` and ``dots``; the feed's spans on their threads; serving and then
training in one process; the kernels' launch counters; the Chrome export of
``launch.train`` and ``launch.serve``; the feed handing its failure to the
loop."""
from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCHS, reduced
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.kernels import dse_sim, flash_attention, rmsnorm, ssd_scan
from repro_torch.models import model as M
from repro_torch.models import moe as moem
from repro_torch.runtime import tracing
from repro_torch.serve.engine import Engine
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import RunConfig, init_train_state, make_train_step

GRANITE = reduced(ARCHS["granite-moe-3b-a800m"])
B, S, PROMPT, NEW = 2, 32, 20, 3
TRAIN_SPANS = {"train.to_device", "train.forward", "train.backward", "train.optimizer"}
MOE_SPANS = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"}
SERVE_SPANS = {"serve.prefill", "serve.sample", "serve.to_host", "serve.decode_step"}


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def program_counters() -> dict:
    return {k: v for k, v in tracing.counters().items() if not k.startswith("kernels.")}


def train(spec=GRANITE, remat="dots", steps=2):
    """Losses and final parameters of ``steps`` train steps from seed 0."""
    cfg = RunConfig(remat=remat)
    state = init_train_state(spec, cfg, seed=0, device="cpu")
    step_fn = make_train_step(spec, cfg=cfg)
    source = SyntheticLM(spec, DataConfig(B, S, seed=0))
    losses = []
    for i in range(steps):
        state, m = step_fn(state, source.batch_at(i))
        losses.append(m["loss"].detach().clone())
    return losses, state["params"]


def serve(spec=GRANITE):
    engine = Engine(spec, M.init_params(spec, 0, device="cpu"), max_len=PROMPT + NEW,
                    device="cpu")
    prompts = np.random.default_rng(0).integers(0, spec.vocab_size, (B, PROMPT)).astype(np.int32)
    return engine.generate(prompts, max_new=NEW)[0]


def children(records, parent):
    return [r for r in records if r.parent == parent.serial]


def test_off_records_nothing_and_on_changes_no_result():
    losses, params = train(steps=1)
    tokens = serve()
    assert tracing.spans() == [] and program_counters() == {}
    tracing.enable()
    losses_on, params_on = train(steps=1)
    tokens_on = serve()
    assert tracing.spans() and program_counters()
    assert all(torch.equal(a, b) for a, b in zip(losses, losses_on))
    assert all(torch.equal(a, b) for a, b in zip(opt.leaves(params), opt.leaves(params_on)))
    np.testing.assert_array_equal(tokens, tokens_on)


def test_span_tree_is_in_the_records_and_the_profilers_events():
    train(steps=1)  # the first call's set-up outside the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train(steps=1)
        serve()
    records = tracing.spans()
    (step,) = [r for r in records if r.name == "train.step"]
    assert step.ids == {"step": 0} and step.parent == 0
    kids = children(records, step)
    assert {r.name for r in kids} == TRAIN_SPANS and all(r.ids["step"] == 0 for r in kids)
    (fwd,) = [r for r in kids if r.name == "train.forward"]
    assert fwd.ids == {"step": 0, "microbatch": 0}
    moes = [r for r in records if r.name == "moe"]
    layers = sum(ld.ffn == "moe" for ld in GRANITE.layer_defs())
    # the step's: its forward's and the remat recompute's in its backward
    assert sum(_under(records, m, fwd) for m in moes) == layers
    assert sum(_under(records, m, step) for m in moes) == 2 * layers
    (gen,) = [r for r in records if r.name == "serve.generate"]
    assert sum(_under(records, m, gen) for m in moes) == (1 + NEW) * layers
    for m in moes:
        assert [r.name for r in sorted(children(records, m), key=lambda r: r.start_ns)] == \
            ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
    assert gen.ids == {"request": 0}
    kids = children(records, gen)
    assert {r.name for r in kids} == SERVE_SPANS
    assert sorted(r.ids["step"] for r in kids if r.name == "serve.decode_step") == [0, 1, 2]
    assert all(r.ids["request"] == 0 for r in kids)

    events = [e for e in prof.events() if e.name.startswith(("train.", "serve.", "moe"))]
    named = lambda n: [e for e in events if e.name == n]  # noqa: E731
    assert len(named("train.step")) == 1 and len(named("serve.generate")) == 1
    assert TRAIN_SPANS <= {c.name for c in named("train.step")[0].cpu_children}
    assert SERVE_SPANS <= {c.name for c in named("serve.generate")[0].cpu_children}
    assert len(named("moe")) == (2 + 1 + NEW) * layers
    assert all(MOE_SPANS <= {c.name for c in e.cpu_children} for e in named("moe"))
    for name in TRAIN_SPANS | SERVE_SPANS | MOE_SPANS | {"moe"}:
        assert len(named(name)) == sum(r.name == name for r in records), name


def _under(records, r, ancestor) -> bool:
    by = {x.serial: x for x in records}
    while r.parent:
        r = by[r.parent]
        if r.serial == ancestor.serial:
            return True
    return False


def hand_count(spec, params, batch, monkeypatch) -> dict:
    """The MoE counters of one forward, by hand from what ``route`` returns."""
    seen = []
    real = moem.route

    def spy(logits, k, cap):
        out = real(logits, k, cap)
        seen.append((out[2], cap, logits.shape))
        return out

    monkeypatch.setattr(moem, "route", spy)
    with torch.no_grad():
        M.forward(params, torch.as_tensor(batch["inputs"]), spec)
    monkeypatch.setattr(moem, "route", real)
    return {"moe.assignments": sum(keep.numel() for keep, _, _ in seen),
            "moe.dropped": float(sum(int((~keep).sum()) for keep, _, _ in seen)),
            "moe.rows": sum(spec.n_experts * g * cap for _, cap, (g, _, _) in seen)}


def test_moe_counters_against_a_hand_count_under_remat_none_and_dots(monkeypatch):
    spec = GRANITE
    params = init_train_state(spec, RunConfig(), seed=0, device="cpu")["params"]
    want = hand_count(spec, params, SyntheticLM(spec, DataConfig(B, S, seed=0)).batch_at(0),
                      monkeypatch)
    layers = sum(ld.ffn == "moe" for ld in spec.layer_defs())
    assert want["moe.assignments"] == layers * B * S * spec.top_k
    assert want["moe.dropped"] > 0  # capacity drops show at this size
    got = {}
    for remat in ("none", "dots"):
        tracing.reset()
        tracing.enable()
        train(spec, remat=remat, steps=1)
        got[remat] = program_counters()
    assert got["none"] == got["dots"] == want


def test_feed_spans_come_from_their_threads():
    tracing.enable()
    feed = Prefetcher(SyntheticLM(GRANITE, DataConfig(B, S, seed=0)), start_step=5, depth=2)
    try:
        batches = iter(feed)
        steps = [next(batches)[0] for _ in range(3)]
    finally:
        feed.close()
    assert steps == [5, 6, 7] and not feed._thread.is_alive()
    records = tracing.spans()
    waits = [r for r in records if r.name == "data.wait"]
    makes = [r for r in records if r.name == "data.make"]
    assert [r.ids["step"] for r in waits] == [5, 6, 7]
    assert {r.thread for r in waits} == {threading.get_native_id()}
    assert {r.thread for r in makes} == {feed._thread.native_id}
    assert [r.ids["step"] for r in makes][:3] == [5, 6, 7]


def test_serving_then_training_in_one_process_keeps_its_counters():
    tracing.enable()
    serve()
    served = program_counters()
    tracing.reset()
    train(steps=1)
    trained = program_counters()
    tracing.reset()
    serve()  # under inference_mode: the sums it makes are then added to outside it
    train(steps=1)
    both = program_counters()
    assert served["moe.rows"] > 0 and trained["moe.rows"] > 0
    assert both == {k: served[k] + trained[k] for k in served}


def test_kernel_launches_are_the_wrappers_attributes(monkeypatch):
    wrappers = [flash_attention.flash_attention, flash_attention.flash_attention_bwd,
                rmsnorm.rmsnorm, rmsnorm.rmsnorm_bwd, rmsnorm.rmsnorm_split,
                rmsnorm.rmsnorm_split_bwd, ssd_scan.ssd_scan, ssd_scan.ssd_scan_bwd,
                dse_sim.dse_class_times, dse_sim.dse_sweep]
    for i, fn in enumerate(wrappers):
        monkeypatch.setattr(fn, "launches", 100 + i)
    got = tracing.counters()
    assert {k: v for k, v in got.items() if k.startswith("kernels.")} == \
        {f"kernels.{fn.__name__}.launches": 100 + i for i, fn in enumerate(wrappers)}


def test_spans_nest_per_thread_under_many_threads():
    tracing.enable()
    errors = []

    def work(i):
        try:
            for j in range(200):
                with tracing.span("outer", request=i, step=j):
                    with tracing.span("inner", request=i, step=j):
                        pass
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads)
    records = tracing.spans()
    by = {r.serial: r for r in records}
    inner = [r for r in records if r.name == "inner"]
    assert len(inner) == len(by) // 2 == 8 * 200
    for r in inner:
        p = by[r.parent]
        assert p.name == "outer" and p.ids == r.ids and p.thread == r.thread
        assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns


def _chrome(path) -> tuple[list, dict]:
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    return spans, {e["name"]: e["args"]["value"] for e in events if e["ph"] == "C"}


def test_launch_train_trace_out_writes_the_nested_spans(tmp_path):
    from repro_torch.launch.train import main
    out = tmp_path / "train.json"
    main(["--arch", "granite-moe-3b-a800m", "--reduced", "--device", "cpu", "--steps", "2",
          "--batch", str(B), "--seq", str(S), "--trace-out", str(out)])
    spans, counts = _chrome(out)
    steps = [e for e in spans if e["name"] == "train.step"]
    assert [e["args"]["step"] for e in steps] == [0, 1]
    for e in steps:
        kids = [c for c in spans if c["args"]["parent"] == e["args"]["serial"]]
        assert {c["name"] for c in kids} == TRAIN_SPANS
        assert all(e["ts"] <= c["ts"] and c["ts"] + c["dur"] <= e["ts"] + e["dur"] + 1e-3
                   for c in kids)
    assert {e["name"] for e in spans} >= {"data.make", "data.wait", "moe"} | MOE_SPANS
    layers = sum(ld.ffn == "moe" for ld in GRANITE.layer_defs())
    assert counts["moe.assignments"] == 2 * layers * B * S * GRANITE.top_k
    assert "kernels.rmsnorm.launches" in counts


def test_launch_serve_trace_out_writes_the_requests(tmp_path):
    from repro_torch.launch.serve import main
    out = tmp_path / "serve.json"
    main(["--arch", "granite-moe-3b-a800m", "--reduced", "--device", "cpu", "--batches", "2",
          "--new", str(NEW), "--trace-out", str(out)])
    spans, counts = _chrome(out)
    assert sorted(e["args"]["request"] for e in spans if e["name"] == "serve.generate") == [0, 1]
    assert sum(e["name"] == "serve.decode_step" for e in spans) == 2 * NEW
    assert counts["moe.rows"] > 0


def test_a_feed_that_raises_hands_its_error_to_the_loop():
    class Failing:
        def batch_at(self, step):
            if step == 2:
                raise ValueError(f"no batch {step}")
            return {"inputs": np.full((1, 4), step, np.int32)}

    feed = Prefetcher(Failing(), depth=2)
    got, errors = [], []

    def consume():
        try:
            for step, _ in feed:
                got.append(step)
        except ValueError as e:
            errors.append(e)
        try:  # and again, where the loop comes back for more
            next(iter(feed))
        except ValueError as e:
            errors.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=30)
    feed.close()
    assert not t.is_alive() and not feed._thread.is_alive()
    assert got == [0, 1] and [str(e) for e in errors] == ["no batch 2"] * 2
