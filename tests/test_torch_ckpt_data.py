"""The port's checkpoints, data pipeline and fault tolerance, on the CPU.

Counterparts of ``tests/test_ckpt_data.py`` (all 12 cases), held where
they meet to the JAX package: ``SyntheticLM`` batches equal the JAX
package's array for array, and train states cross-load in both directions
through ``to_jax_state`` / ``from_jax_state`` (the JAX checkpoint format on
both sides), bit for bit.  Also the training CLI on the CPU, its restart
drill, and its refusal of a ``--mesh`` larger than its world.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.data.pipeline import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM
from repro.train.train_step import RunConfig as JRunConfig, init_train_state as j_init_state
from repro_torch.ckpt.checkpoint import (AsyncCheckpointer, flatten, latest_step, load_arrays,
                                        restore, save, unflatten)
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import from_jax_state, to_jax_state
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.runtime.fault import Heartbeat, StragglerMonitor, run_with_restarts
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import BF16_RUN, RunConfig, init_train_state

ROOT = Path(__file__).resolve().parents[1]


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "n": {"b": torch.ones(4, dtype=torch.int32), "l": [torch.zeros(2), torch.full((1,), 7.0)]}}


def _equal_trees(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    for key, x in fa.items():
        y = fb[key]
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), key


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save(tmp_path, t, step=3, meta={"loss": 1.5})
    out, step = restore(tmp_path, t)
    assert step == 3
    _equal_trees(out, t)
    assert json.loads((tmp_path / "step_00000003" / "meta.json").read_text())["loss"] == 1.5


def test_latest_step_and_multiple(tmp_path):
    t = _tree()
    for s in (1, 5, 3):
        save(tmp_path, t, step=s)
    assert latest_step(tmp_path) == 5
    _, step = restore(tmp_path, t, step=3)
    assert step == 3


def test_restore_shape_mismatch_raises(tmp_path):
    save(tmp_path, _tree(), step=1)
    bad = _tree()
    bad["a"] = torch.zeros((3, 3))
    with pytest.raises(ValueError):
        restore(tmp_path, bad)


def test_no_partial_checkpoint_on_crash(tmp_path):
    """tmp dir left from a 'crash' must not shadow a real checkpoint."""
    (tmp_path / ".tmp_step_00000007").mkdir(parents=True)
    save(tmp_path, _tree(), step=7)
    assert latest_step(tmp_path) == 7


def test_async_checkpointer_and_gc(tmp_path):
    ck = AsyncCheckpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(_tree(), s)
    ck.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in Path(tmp_path).glob("step_*"))
    assert steps == [3, 4]


def test_run_with_restarts_recovers(tmp_path):
    calls = {"n": 0}

    def loop(start):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("injected")
        return 10

    rep = run_with_restarts(loop, target_step=10, max_restarts=5)
    assert rep.completed_steps == 10 and rep.restarts == 2


def test_run_with_restarts_gives_up():
    def loop(start):
        raise RuntimeError("always fails")
    with pytest.raises(RuntimeError, match="exceeded"):
        run_with_restarts(loop, target_step=1, max_restarts=2)


def test_heartbeat(tmp_path):
    hb = Heartbeat(tmp_path / "hb.json")
    assert not hb.is_alive()
    hb.beat(7)
    assert hb.is_alive(timeout_s=5)
    data = json.loads((tmp_path / "hb.json").read_text())
    assert data["step"] == 7


def test_straggler_monitor():
    mon = StragglerMonitor(k_sigma=3.0, min_samples=5)
    rng = np.random.default_rng(0)
    flags = [mon.observe(i, 0.1 + 1e-3 * rng.random()) for i in range(20)]
    assert not any(flags)
    assert mon.observe(20, 1.0)  # 10x step time -> straggler
    assert mon.events and mon.events[0]["step"] == 20
    # baseline stats unpoisoned by the outlier
    assert mon.mean < 0.15


def test_data_determinism_and_host_sharding():
    spec = reduced(ARCHS["qwen2-1.5b"])
    a = SyntheticLM(spec, DataConfig(8, 32, seed=1)).batch_at(5)
    b = SyntheticLM(spec, DataConfig(8, 32, seed=1)).batch_at(5)
    np.testing.assert_array_equal(a["inputs"], b["inputs"])
    c = SyntheticLM(spec, DataConfig(8, 32, seed=2)).batch_at(5)
    assert not np.array_equal(a["inputs"], c["inputs"])
    # host sharding: two hosts each get half the batch, different content
    h0 = SyntheticLM(spec, DataConfig(8, 32, seed=1, n_hosts=2, host_id=0)).batch_at(5)
    h1 = SyntheticLM(spec, DataConfig(8, 32, seed=1, n_hosts=2, host_id=1)).batch_at(5)
    assert h0["inputs"].shape == (4, 32)
    assert not np.array_equal(h0["inputs"], h1["inputs"])


def test_labels_are_next_tokens():
    spec = reduced(ARCHS["qwen2-1.5b"])
    b = SyntheticLM(spec, DataConfig(4, 16, seed=0)).batch_at(0)
    # inputs[t+1] == labels[t] by construction
    np.testing.assert_array_equal(b["inputs"][:, 1:], b["labels"][:, :-1])


def test_prefetcher_orders_and_closes():
    spec = reduced(ARCHS["qwen2-1.5b"])
    src = SyntheticLM(spec, DataConfig(2, 8, seed=0))
    pf = Prefetcher(src, start_step=3, depth=2)
    it = iter(pf)
    steps = [next(it)[0] for _ in range(4)]
    pf.close()
    assert steps == [3, 4, 5, 6]


# ---------------------------------------------------------------------------
# against the JAX package


@pytest.mark.parametrize("arch,full", [
    ("qwen2-1.5b", True),         # full width: vocab 151936 -> the 32768-token table
    ("mamba2-130m", False),
    ("musicgen-medium", False),   # embeddings frontend: the f32 inputs too
])
@pytest.mark.parametrize("cfg", [dict(global_batch=4, seq_len=64, seed=3),
                                 dict(global_batch=8, seq_len=16, seed=1, n_hosts=2, host_id=1)],
                         ids=["one-host", "host-1-of-2"])
def test_batches_equal_jax(arch, full, cfg):
    spec = ARCHS[arch] if full else reduced(ARCHS[arch])
    jspec = JARCHS[arch] if full else jreduced(JARCHS[arch])
    ours, theirs = SyntheticLM(spec, DataConfig(**cfg)), JSyntheticLM(jspec, JDataConfig(**cfg))
    for step in (0, 7):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def _jax_tree_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, path
        np.testing.assert_array_equal(x.astype(np.float32), y.astype(np.float32),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-1b"])  # gemma3: a tail of the pattern
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_checkpoint_crosses_jax_to_port(tmp_path, arch, bf16):
    """A JAX train state saved by the JAX ``save`` loads into the port, which
    reads the npz itself (``load_arrays`` + ``unflatten``: the JAX package's
    own ``restore`` cannot cast the bf16 arrays it wrote back) and converts it
    with ``from_jax_state``; the state crosses back unchanged."""
    jspec, spec = jreduced(JARCHS[arch]), reduced(ARCHS[arch])
    jcfg = JRunConfig(param_dtype=jnp.bfloat16) if bf16 else JRunConfig()
    jstate = j_init_state(jax.random.PRNGKey(2), jspec, jcfg)
    jstate["step"] = jnp.asarray(5, jnp.int32)
    jckpt.save(tmp_path, jstate, step=5)
    arrays, step = load_arrays(tmp_path)
    state = from_jax_state(unflatten(arrays), spec, device="cpu")
    assert step == 5 and int(state["step"]) == 5
    assert ("master" in state) == bf16
    assert opt.leaves(state["params"])[0].dtype == (torch.bfloat16 if bf16 else torch.float32)
    _jax_tree_equal(to_jax_state(state, spec), jax.tree.map(np.asarray, jstate))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-1b"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_checkpoint_crosses_port_to_jax(tmp_path, arch, bf16):
    """A port train state, saved by the port and restored by it exactly,
    crosses to the JAX layout (``to_jax_state``), which the JAX ``restore``
    loads into its own state's structure bit for bit."""
    jspec, spec = jreduced(JARCHS[arch]), reduced(ARCHS[arch])
    cfg = BF16_RUN if bf16 else RunConfig()
    state = init_train_state(spec, cfg, seed=4, device="cpu")
    with torch.no_grad():
        for i, t in enumerate(opt.leaves(state["m"])):
            t.add_(0.01 * (i + 1))  # moments that are not all zero
    state["step"] += 9
    save(tmp_path / "port", state, step=9)
    back, step = restore(tmp_path / "port", state)
    assert step == 9
    _equal_trees(back, state)
    jtree = to_jax_state(back, spec)
    jckpt.save(tmp_path / "jax", jtree, step=9)
    jcfg = JRunConfig(param_dtype=jnp.bfloat16) if bf16 else JRunConfig()
    like = j_init_state(jax.random.PRNGKey(0), jspec, jcfg)
    jstate, jstep = jckpt.restore(tmp_path / "jax", like)
    assert jstep == 9 and int(jstate["step"]) == 9
    assert jax.tree.leaves(jstate["params"])[0].dtype == (jnp.bfloat16 if bf16 else jnp.float32)
    _jax_tree_equal(jax.tree.map(np.asarray, jstate), jtree)
    _equal_trees(from_jax_state(jax.tree.map(np.asarray, jstate), spec, device="cpu"), state)


# ---------------------------------------------------------------------------
# the training CLI


def _run(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)


def test_train_cli_runs_on_cpu(tmp_path):
    r = _run(["--reduced", "--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "32",
              "--log-every", "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[train] cpu step")]
    assert len(lines) == 4 and all("tokens/s" in ln and " ms" in ln for ln in lines)
    assert "done at step 4" in r.stdout
    assert latest_step(tmp_path) == 4 and (tmp_path / "heartbeat.json").exists()


def test_train_cli_fault_drill_resumes_exactly(tmp_path):
    """--fail-at under run_with_restarts: the restart resumes from the last
    checkpoint, and every step's loss is the uninterrupted run's."""
    common = ["--reduced", "--device", "cpu", "--steps", "5", "--batch", "4", "--seq", "16",
              "--log-every", "1", "--ckpt-every", "2", "--remat", "dots"]
    clean = _run(common + ["--ckpt-dir", str(tmp_path / "clean")])
    drill = _run(common + ["--ckpt-dir", str(tmp_path / "drill"), "--fail-at", "3"])
    assert clean.returncode == 0 and drill.returncode == 0, drill.stderr

    def losses(out):
        return [(int(ln.split()[3]), ln.split()[5]) for ln in out.splitlines()
                if ln.startswith("[train] cpu step")]
    assert "resumed from step 2" in drill.stdout
    assert "completed 5 steps after 1 restart(s)" in drill.stdout
    assert set(losses(drill.stdout)) == set(losses(clean.stdout))
    assert [s for s, _ in losses(drill.stdout)] == [0, 1, 2, 2, 3, 4]


def test_train_cli_refuses_a_mesh():
    """A mesh needs one process per rank: one process refuses 2x2 before it
    starts any process group (tests/test_torch_parallel_train.py runs it
    under torchrun)."""
    args = train_cli.parser().parse_args(["--reduced", "--device", "cpu", "--mesh", "2x2"])
    with pytest.raises(ValueError, match="needs 4 ranks and this run has 1"):
        train_cli.train_loop(args, reduced(ARCHS["qwen2-1.5b"]))
    assert not torch.distributed.is_initialized()
