"""The sharded train step on four gloo ranks, checkpoint resharding and the
elastic rescale through the training CLI, on the CPU.

Counterparts of ``tests/test_parallel.py:72`` (sharded train step == one
device), ``:102`` (elastic checkpoint reshard) and ``:126`` (elastic rescale
end to end).  The ranks run through ``repro_torch.parallel.spawn`` (a file
store, a timeout per call); the JAX side runs on one device here, with
``NULL_PLAN``.

Sharded step.  Reduced qwen2, mamba2, gemma3 and granite on a (2, 2)
("data", "model") mesh, under remat ``none`` and ``dots`` and with FSDP on
and off; reduced qwen2 with 6 heads and 2 KV groups, and reduced gemma3
with 6 heads (its sliding window), on a (1, 4) mesh, where the heads do not
divide 'model', so q keeps its sequence split and each rank's flash call
takes its own rows at their offset; two microbatches; and the MoE with its
experts split over 'model' (reduced granite's 4) or their ff columns (6
experts on (1, 4), 3 on (2, 2)), at routing groups of 8 tokens, several a
rank; and reduced mamba2 at d_model 48 on (1, 4), whose 6 heads do not
divide 'model' and whose head_dim does: each rank's SSD calls scan 4 of
every head's 16 columns.  Every case starts from the port's
``init_train_state`` (seed 0; the ranks place it with ``mesh=``), which
``convert.to_jax_state`` hands to the JAX step, and takes two steps of a
(8, 32) batch.  (The JAX ``init_train_state`` draws a stacked layer
parameter with the repeat count as its fan-in, ``layers.py:42`` on the
stacked ``ParamDef``: std 1/sqrt(2) in the reduced models.  From there
reduced gemma3's first gradient norm is 269 and its 14 layers make the f32
sums ill-conditioned: the JAX step, the port's and the sharded one part at
1e-4 of the loss after one update, each from the others.)  Held against
the port's unsharded step: losses rtol 1e-5, every parameter rtol 1e-4 /
atol 1e-6 (the same f32 sums, some of them
partial sums added across ranks); against the JAX ``NULL_PLAN`` step at the
JAX test's tolerances (``tests/test_parallel.py:92-95``: loss rtol 1e-4,
parameters rtol 1e-3 / atol 1e-5), for every parameter.  Every rank reports
the same loss and grad norm bit for bit.

The steps take AdamW at lr 1e-3 from step 1 with eps 1e-2 (``OPT``).  At
the default eps of 1e-8 an element's first update is ``lr * sign(g)``, so
an element whose gradient is at the f32 rounding level of its leaf (the
sharded and unsharded gradients agree to about 1e-6 of each leaf's largest)
moves by ``lr`` either way, and the parameters would differ by up to twice
the step in any reduction order.  With eps 1e-2 the update is smooth in the
gradient there, and the parameters still move by up to 1e-3 a step, far
above the tolerances.

These tests import JAX only in the test process: the ranks import the port.
"""
from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro_torch.ckpt.checkpoint import flatten, to_host
from repro_torch.configs import ARCHS, reduced
from repro_torch.parallel import spawn

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
STEPS = 2
# seconds a spawned call may take per case it runs: gemma3's first case, whose
# call runs all four of its cases, took 27.3 s in a run of this file alone and
# 88.7 s in a full run beside five other xdist workers, their ranks and XLA's
# threads on 8 cores, and one deadline of 150 s for the four cases failed it
# in another full run
TIMEOUT = 150
SHARDED_ARCHS = ["qwen2-1.5b", "mamba2-130m", "gemma3-1b", "granite-moe-3b-a800m"]
PORT_TOL = dict(rtol=1e-4, atol=1e-6)
OPT = dict(lr=1e-3, warmup_steps=0, eps=1e-2)
JAX_TOL = dict(rtol=1e-3, atol=1e-5)


def _batches(vocab: int, n: int = STEPS, b: int = 8, s: int = 32):
    rng = np.random.default_rng(0)
    return [{"inputs": rng.integers(0, vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)} for _ in range(n)]


def _host(tree) -> dict[str, np.ndarray]:
    return {k: to_host(v) for k, v in flatten(tree).items()}


# -- on every rank -------------------------------------------------------------

def _sharded_rank(arch, kw, shape, cases, batches, group_size=None):
    """For each (remat, fsdp, microbatches): the initial state on the mesh,
    ``STEPS`` sharded steps; losses, grad norms, the final parameters
    (gathered; kept on rank 0), the count of parameters a mesh dim splits,
    the (rows, keys, offset) of each flash call, the x shape of each SSD
    scan call and the local shape of each MoE expert call's w_gate.  ``group_size``: the MoE's routing group
    (``moe.GROUP_SIZE``)."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import plan_for_mesh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import RunConfig, init_train_state, make_train_step
    spec = reduced(ARCHS[arch], **kw)
    mesh = make_mesh(shape, AXES[:len(shape)], device="cpu")
    moe.GROUP_SIZE = group_size or moe.GROUP_SIZE
    seen, kernel, ssd_seen, scan = set(), ops.flash_attention, set(), ops.ssd_scan
    ffn_seen, ffn = set(), moe._expert_ffn

    def recording_ffn(xe, w_gate, *args):
        ffn_seen.add(tuple(w_gate.shape))
        return ffn(xe, w_gate, *args)

    moe._expert_ffn = recording_ffn

    def recording(q, k, v, **kwargs):
        seen.add((q.shape[1], k.shape[1], kwargs["q_offset"]))
        return kernel(q, k, v, **kwargs)

    def recording_scan(x, *args):
        ssd_seen.add(tuple(x.shape))
        return scan(x, *args)

    ops.flash_attention, ops.ssd_scan = recording, recording_scan
    out = []
    for remat, fsdp, micro in cases:
        cfg = RunConfig(remat=remat, microbatches=micro, opt=opt.OptConfig(**OPT))
        plan = plan_for_mesh(mesh, fsdp=fsdp)
        state = init_train_state(spec, cfg, seed=0, device="cpu", plan=plan, mesh=mesh)
        step = make_train_step(spec, plan, cfg)
        losses, norms = [], []
        for b in batches:
            state, m = step(state, b)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
        params = _host(state["params"])
        n_split = sum(any(isinstance(p, Shard) for p in t.placements)
                      for t in opt.leaves(state["params"]))
        out.append(dict(losses=losses, norms=norms, n_split=n_split,
                        n_leaves=len(opt.leaves(state["params"])), flash_seen=sorted(seen),
                        ssd_seen=sorted(ssd_seen), ffn_seen=sorted(ffn_seen),
                        params=params if dist.get_rank() == 0 else None))
    return out


# -- in the test process -----------------------------------------------------------

_REFS: dict = {}


def _references(arch, kw, remat, micro, group_size=None):
    """(the batches, the JAX and the port's unsharded losses and final
    parameters, in the port's tree) for ``STEPS`` steps from the port's
    initial state; ``group_size``: both MoE modules' routing group."""
    key = (arch, tuple(sorted(kw.items())), remat, micro, group_size)
    if key in _REFS:
        return _REFS[key]
    import jax

    import repro.models.moe as jmoe
    import repro_torch.models.moe as moe
    saved = jmoe.GROUP_SIZE, moe.GROUP_SIZE
    jmoe.GROUP_SIZE = moe.GROUP_SIZE = group_size or moe.GROUP_SIZE
    try:
        _REFS[key] = _run_references(arch, kw, remat, micro)
    finally:
        jmoe.GROUP_SIZE, moe.GROUP_SIZE = saved
    return _REFS[key]


def _run_references(arch, kw, remat, micro):
    import jax

    from repro.configs import ARCHS as JARCHS, reduced as jreduced
    from repro.train.optimizer import OptConfig as JOptConfig
    from repro.train.train_step import RunConfig as JRunConfig, make_train_step as j_make_train_step
    from repro_torch.convert import from_jax_params, to_jax_state
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import RunConfig, init_train_state, make_train_step
    jspec, spec = jreduced(JARCHS[arch], **kw), reduced(ARCHS[arch], **kw)
    batches = _batches(spec.vocab_size)
    cfg = RunConfig(remat=remat, microbatches=micro, opt=OptConfig(**OPT))
    state = init_train_state(spec, cfg, seed=0, device="cpu")
    jcfg = JRunConfig(remat=remat, microbatches=micro, opt=JOptConfig(**OPT))
    jstep = jax.jit(j_make_train_step(jspec, cfg=jcfg))
    js, jl = copy.deepcopy(to_jax_state(state, spec)), []  # the port updates its state in place
    for b in batches:
        js, m = jstep(js, b)
        jl.append(float(m["loss"]))
    jparams = _host(from_jax_params(jax.tree.map(np.asarray, js["params"]), spec, "cpu"))
    step = make_train_step(spec, cfg=cfg)
    pl = []
    for b in batches:
        state, m = step(state, b)
        pl.append(m["loss"].item())
    return batches, (jl, jparams), (pl, _host(state["params"]))


_RUNS: dict = {}


def _sharded(arch, kw, shape, cases, group_size=None):
    """The ranks' results for ``cases`` (one spawned call per key)."""
    key = (arch, tuple(sorted(kw.items())), shape, tuple(cases), group_size)
    if key not in _RUNS:
        batches = _batches(reduced(ARCHS[arch], **kw).vocab_size)
        _RUNS[key] = spawn.run(_sharded_rank, math.prod(shape), arch, kw, shape, list(cases),
                               batches, group_size, timeout=TIMEOUT * len(cases))
    return _RUNS[key]


def _check(ranks, refs, i):
    _, (jl, jparams), (pl, pparams) = refs
    got = [r[i] for r in ranks]
    for r in got[1:]:  # every rank: the same loss and norm, bit for bit
        assert r["losses"] == got[0]["losses"] and r["norms"] == got[0]["norms"]
    res = got[0]
    assert res["n_split"] > 0  # the mesh does split parameters
    np.testing.assert_allclose(res["losses"], pl, rtol=1e-5)
    np.testing.assert_allclose(res["losses"], jl, rtol=1e-4)
    assert sorted(res["params"]) == sorted(pparams) == sorted(jparams)
    assert len(res["params"]) == res["n_leaves"]
    for key, got_p in res["params"].items():
        np.testing.assert_allclose(got_p, pparams[key], err_msg=key, **PORT_TOL)
        np.testing.assert_allclose(got_p, jparams[key], err_msg=key, **JAX_TOL)
    return res


CASES = [(remat, fsdp, 1) for remat in ("none", "dots") for fsdp in (True, False)]


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("arch", SHARDED_ARCHS)
def test_sharded_train_step_matches_unsharded_and_jax(arch, remat, fsdp):
    ranks = _sharded(arch, {}, (2, 2), CASES)  # one spawned call per arch
    _check(ranks, _references(arch, {}, remat, 1), CASES.index((remat, fsdp, 1)))


def _check_split_q(ranks, s=32, n=4):
    """Each rank's flash calls took its own s / n rows at its offset against
    all s keys."""
    for rank, r in enumerate(ranks):
        assert r[0]["flash_seen"] == [(s // n, s, rank * (s // n))]


def test_sharded_train_step_gathers_q_over_the_sequence():
    """6 heads do not divide a 'model' axis of 4: the JAX plan keeps q split
    over the sequence and gathers k and v along it.  Since the flash kernels
    take a query offset, q stays split (the test keeps the name it had when
    the port gathered q too): each rank's flash calls, forward and backward,
    take its own rows at their offset against the whole keys."""
    from repro_torch.parallel.sharding import ShardingPlan
    kw = {"n_heads": 6, "n_kv_heads": 2}
    plan = ShardingPlan(axis_sizes={"data": 1, "model": 4})
    assert not plan.can_shard("q_heads", 6)
    assert plan.spec(("batch", "seq", None, None), (8, 32, 6, 16)) == (None, "model")
    ranks = _sharded("qwen2-1.5b", kw, (1, 4), [("none", True, 1)])
    _check(ranks, _references("qwen2-1.5b", kw, "none", 1), 0)
    _check_split_q(ranks)


def test_sharded_train_step_splits_q_over_the_sequence():
    """Reduced gemma3 with 6 heads on 1 KV group on (1, 4): q split over the
    sequence under its sliding window (16), remat ``dots``; every rank's
    rows at their offset, the window's edge crossing the ranks' rows."""
    kw = {"n_heads": 6}
    ranks = _sharded("gemma3-1b", kw, (1, 4), [("dots", True, 1)])
    _check(ranks, _references("gemma3-1b", kw, "dots", 1), 0)
    _check_split_q(ranks)


def test_sharded_train_step_splits_the_ssd_scan_over_head_dim():
    """Reduced mamba2 at d_model 48: 6 heads of 16 do not divide a 'model'
    axis of 4, their head_dim does, so each rank scans 4 of every head's 16
    columns (the SSD kernels at P = 4 on the card) with dt, a, B and C
    whole, and their gradients are each rank's share, summed; the final
    state keeps the split, and y moves to the sequence before d_inner."""
    from repro_torch.parallel.sharding import ShardingPlan
    kw = {"d_model": 48}
    spec = reduced(ARCHS["mamba2-130m"], **kw)
    plan = ShardingPlan(axis_sizes={"data": 1, "model": 4})
    assert (spec.ssm_heads, spec.ssm_head_dim) == (6, 16)
    assert not plan.can_shard("ssm_heads", 6) and plan.can_shard("ssm_head_dim", 16)
    ranks = _sharded("mamba2-130m", kw, (1, 4), [("dots", True, 1)])
    _check(ranks, _references("mamba2-130m", kw, "dots", 1), 0)
    for r in ranks:  # every call on the rank's 4 columns of the 6 heads
        assert r[0]["ssd_seen"] == [(8, 32, 6, 4)]


MOE_GROUP = 8  # tokens a routing group: a (8, 32) batch makes 32 groups
MOE_MESHES = [((2, 2), {}), ((1, 4), {}), ((1, 4), {"n_experts": 6}), ((2, 2), {"n_experts": 3})]


@pytest.mark.parametrize("shape,kw", MOE_MESHES, ids=lambda c: str(c).replace(" ", ""))
def test_sharded_moe_train_step_matches_unsharded_and_jax(shape, kw):
    """Reduced granite with its experts split over 'model' (4 experts: the
    capacity rows exchanged by all-to-all where each rank holds a chunk of
    the sequence) or their ff columns (6 on a 4-way axis, 3 on a 2-way one:
    each rank's columns, w_down's partial sum reduced), at routing groups of
    8 tokens (several groups a rank), against the unsharded step and the
    JAX step at the same group size."""
    arch = "granite-moe-3b-a800m"
    ranks = _sharded(arch, kw, shape, [("dots", True, 1)], MOE_GROUP)
    _check(ranks, _references(arch, kw, "dots", 1, MOE_GROUP), 0)


def test_sharded_train_step_with_microbatches():
    ranks = _sharded("qwen2-1.5b", {}, (2, 2), [("dots", True, 2)])
    _check(ranks, _references("qwen2-1.5b", {}, "dots", 2), 0)


# -- checkpoints -------------------------------------------------------------------

def _reshard_rank(ckpt_dir, phase):
    """Phase "save": a reduced state placed on (2, 2), saved; "restore4" and
    "restore2x1": restored onto (4,) and (2, 1).  Returns each leaf full and
    its placements, as this rank sees them."""
    from repro_torch.ckpt.checkpoint import restore, save
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import map_with_path
    from repro_torch.parallel.sharding import distribute_tree, placements, plan_for_mesh
    from repro_torch.train.train_step import init_train_state, train_state_axes
    spec = reduced(ARCHS["qwen2-1.5b"])
    shape = {"save": (2, 2), "restore4": (4,), "restore2x1": (2, 1)}[phase]
    mesh = make_mesh(shape, AXES[:len(shape)], device="cpu")
    plan = plan_for_mesh(mesh)
    axes = train_state_axes(spec)
    plain = init_train_state(spec, seed=3, device="cpu")
    plain["m"] = map_with_path(lambda _, t: t.clone(), plain["params"])  # nonzero moments
    if phase == "save":
        state = distribute_tree(plain, axes, plan, mesh)
        save(ckpt_dir, state, step=5)
        got, step = state, 5
    else:
        got, step = restore(ckpt_dir, plain, mesh=mesh, axes=axes, plan=plan)
    flat_axes = flatten(axes, is_leaf=lambda x: isinstance(x, tuple))
    return step, {k: (to_host(v), [str(p) for p in v.placements],
                      [str(p) for p in placements(plan.spec(flat_axes[k], tuple(v.shape)), mesh)])
                  for k, v in flatten(got).items()}


def test_checkpoint_reshards_bit_for_bit(tmp_path):
    """Saved from (2, 2) (only rank 0 writes), restored onto (4,) and onto
    (2, 1): every leaf's values bit for bit, and placed as the new plan says."""
    saved = spawn.run(_reshard_rank, 4, str(tmp_path), "save", timeout=TIMEOUT)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000005"]
    want = saved[0][1]
    assert any(pl != [str(Replicate())] * 2 for _, pl, _ in want.values())
    for phase, n in (("restore4", 4), ("restore2x1", 2)):
        ranks = spawn.run(_reshard_rank, n, str(tmp_path), phase, timeout=TIMEOUT)
        for step, leaves in ranks:
            assert step == 5 and sorted(leaves) == sorted(want)
            for key, (arr, pl, planned) in leaves.items():
                assert arr.dtype == want[key][0].dtype
                np.testing.assert_array_equal(arr, want[key][0], err_msg=key)
                assert pl == planned, (phase, key)
        if phase == "restore4":  # a 4-way data axis splits what it can
            assert leaves["['params']['embed']"][1] == [str(Shard(1))]


def _torchrun(args, n: int, tmp: Path, timeout: float):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", "-m", "repro_torch.launch.train", *args]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env,
                          cwd=tmp)


def test_elastic_rescale_end_to_end(tmp_path):
    """5 steps on a (2, 2) mesh of 4 ranks with a checkpoint, then the loss of
    half the ranks: resume on (2, 1) with 2 ranks for 5 more, each run under
    ``torchrun --standalone`` (a free port of the OS's choosing)."""
    ck = tmp_path / "ck"
    common = ["--reduced", "--device", "cpu", "--batch", "8", "--seq", "32", "--ckpt-dir",
              str(ck), "--ckpt-every", "5", "--log-every", "1"]
    one = _torchrun(common + ["--mesh", "2x2", "--steps", "5"], 4, tmp_path, TIMEOUT)
    assert one.returncode == 0, one.stderr[-3000:]
    assert "[train] done at step 5" in one.stdout
    two = _torchrun(common + ["--mesh", "2x1", "--steps", "10"], 2, tmp_path, TIMEOUT)
    assert two.returncode == 0, two.stderr[-3000:]
    assert "resumed from step 5 onto mesh 2x1" in two.stdout
    losses = [float(ln.split(" loss ")[1].split()[0]) for ln in two.stdout.splitlines()
              if ln.startswith("[train] cpu step")]
    assert len(losses) == 5 and all(math.isfinite(x) for x in losses)
    meta = json.loads((ck / "step_00000010" / "meta.json").read_text())
    assert meta["step"] == 10
    from repro_torch.ckpt.checkpoint import load_arrays
    arrays, step = load_arrays(ck)
    assert step == 10 and int(arrays["['step']"]) == 10
