"""The harness finds every cell, configuration, traffic mix, driver and
metric by name, and a new one without an edit; the counts against hand
work; nothing it runs loads JAX or the JAX package."""
import json
import shutil
import subprocess
import sys

import pytest

from gpubench import counts, harness


def test_every_named_file_is_found():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        c = harness.cell(w["name"])
        assert (c["config"], c["traffic"], c["chips"], c["why"]) == \
            (w["config"], w["traffic"], w["chips"], w["why"])
        assert callable(harness.driver(harness.traffic(c["traffic"])["kind"]).run)
        assert set(c["limits"])
    for cfg in bench["configs"]:
        data = harness.read_json(harness.ROOT / cfg["file"])
        assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
        assert set(data["reduced"]) <= set(data["published"])
        harness.reference(data["reference"])
    for m in bench["per_layer"]:
        assert callable(harness.metric(m["name"]).read)
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in harness.end_to_end(bench, w)}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        names = {m["name"] for m in harness.end_to_end(bench, w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert harness.per_layer(bench, w["name"])


def test_a_new_cell_config_traffic_and_metric_need_only_new_files(tmp_path, monkeypatch):
    bench = tmp_path / "gpubench"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((bench / "configs" / "mamba2-130m.json").read_text())
    cfg["arch"]["n_layers"] = 12
    (bench / "configs" / "mamba2-half.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "train.b2s512.json").write_text(json.dumps(
        {**json.loads((bench / "traffic" / "train.b4s4096.json").read_text()),
         "batch": 2, "seq": 512}))
    (bench / "workloads" / "mamba2-half.train.b2s512.json").write_text(json.dumps(
        {"config": "mamba2-half", "traffic": "train.b2s512", "chips": 1, "why": "a new cell",
         "limits": {"loss_gap": 1.0}}))
    (bench / "metrics" / "steps_seen.py").write_text("def read(ctx, view):\n    return 7.0\n")
    monkeypatch.setattr(harness, "BENCH", bench)
    ctx = harness.context("mamba2-half.train.b2s512", 1, 1.0, False, "cpu", 0.0)
    assert ctx.arch["n_layers"] == 12 and ctx.traffic["seq"] == 512
    assert harness.metric("steps_seen").read(ctx, None) == 7.0
    fake = {"end_to_end": [{"name": "setup_s"}, {"name": "x", "workloads": ["other"]}],
            "per_layer": [{"name": "steps_seen", "moves": "setup_s"}]}
    assert [m["name"] for m in harness.per_layer(fake, "mamba2-half.train.b2s512")] == \
        ["steps_seen"]
    with pytest.raises(KeyError):
        harness.cell("no-such-cell")


def test_counts_against_hand_work():
    # SSD forward, B=1, S=4, H=2, P=3, G=1, N=5, chunks of 2: pairs 3 + 3 = 6
    assert counts.chunk_pairs(4, 2) == 6
    assert counts.ssd_fwd_flops(1, 4, 2, 3, 1, 5, 2) == 2 * (4 * 4 * 5 * 3 + 2 * 3 * 6) + 2 * 5 * 6
    # bytes: x, y 24 elements each, b, c 20 each (f32); dt 8, a 2, state 30 (f32)
    assert counts.ssd_fwd_bytes(1, 4, 2, 3, 1, 5, 4) == 4 * (48 + 40) + 4 * (8 + 2 + 30)
    assert counts.ssd_bwd_bytes(1, 4, 2, 3, 1, 5, 2, False) == 2 * (72 + 80) + 4 * 2 * 10
    # causal attention, S = T = 3: 6 pairs; window 2: 5; offset 1 of T = 4: 2 + 3 + 4
    assert counts.causal_pairs(3) == 6 and counts.causal_pairs(3, window=2) == 5
    assert counts.causal_pairs(3, 4, offset=1) == 9
    assert counts.flash_fwd_flops(2, 3, 3, 4, 8, 6) == 4 * 8 * 2 * 4 * 6
    assert counts.flash_bwd_flops(2, 3, 3, 4, 8, 6) == 10 * 8 * 2 * 4 * 6
    assert counts.flash_fwd_bytes(2, 3, 3, 4, 2, 8, 4, True) == \
        4 * (2 * 2 * 3 * 4 * 8 + 2 * 2 * 3 * 2 * 8) + 4 * 2 * 4 * 3
    # the bound: 495 TFLOP over 495 TFLOP/s is 1 s; 3.35 TB at 3.35 TB/s is 1 s
    assert counts.bound_s(4.95e14, 1.0, "float32") == pytest.approx(1.0)
    assert counts.bound_s(1.0, 3.35e12, "float32") == pytest.approx(1.0)


def test_model_flops_against_hand_work():
    mamba = {"family": "ssm", "n_layers": 1, "d_model": 4, "vocab_size": 10, "ssm_expand": 2,
             "ssm_groups": 1, "ssm_state": 3, "ssm_head_dim": 4}
    # in-projection 4 x (8 + 8 + 3 + 3 + 2), out 8 x 4; head 4 x 10
    assert counts.matmul_weights(mamba) == (4 * 24 + 32, 40)
    moe = {"family": "moe", "n_layers": 1, "d_model": 4, "vocab_size": 10, "n_heads": 2,
           "n_kv_heads": 1, "d_ff": 3, "n_experts": 4, "top_k": 2}
    # q, k, v: 4 x (2 + 1 + 1) x 2, o: 4 x 4; router 4 x 4; 2 experts of 3 x 4 x 3
    layers = 4 * 4 * 2 + 16 + 16 + 2 * 36
    assert counts.matmul_weights(moe) == (layers, 40)
    attn = 4 * 2 * 1 * 2 * 3  # 4 hd B H pairs at S = 2: pairs 3
    assert counts.train_step_flops(moe, 1, 2) == 6 * (layers + 40) * 2 + 3 * attn
    # serving B = 1, S = 2, one new token: layers on 3 tokens, the head on 2, the
    # prompt's attention and one decode step against 3 keys
    assert counts.serve_batch_flops(moe, 1, 2, 1) == \
        2 * layers * 3 + 2 * 40 * 2 + attn + 4 * 2 * 2 * 3


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in harness.forbidden_modules()


def test_what_the_benchmark_runs_imports_no_jax():
    code = f"""
import sys
for name in ("jax", "jaxlib", "flax", "repro"):
    sys.modules[name] = None  # any import of them raises
sys.path[:0] = [{str(harness.ROOT)!r}, {str(harness.ROOT / "src")!r}]
import importlib.util
spec = importlib.util.spec_from_file_location("bench_run", {str(harness.BENCH / "run.py")!r})
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
from gpubench import harness, controls, counts, checks, trace
import repro_torch.launch.train, repro_torch.serve.engine, repro_torch.data.pipeline
for kind in ("train_loop", "serve_batches"):
    harness.driver(kind)
for m in harness.benchmark()["per_layer"]:
    harness.metric(m["name"])
for fam in ("mamba2", "granite_moe"):
    harness.reference(fam)
loaded = {{n.split(".", 1)[0] for n, m in sys.modules.items() if m is not None}}
assert not loaded & {{"jax", "jaxlib", "flax", "repro"}}, loaded
print("clean")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-3000:]


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        text = path.read_text()
        assert "repro_torch" not in text.replace("``repro_torch``", "") or path.name == \
            "__init__.py", path
        assert "import jax" not in text and "from repro" not in text
