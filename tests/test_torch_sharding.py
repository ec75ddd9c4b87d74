"""The port's sharding logic and logical axes against the JAX package's, on
the CPU and without any process group.

``ShardingPlan.spec`` returns a tuple where the JAX package returns a
``PartitionSpec``; the two must hold the same entries (``tuple(jax_spec)``)
on every case of ``tests/test_sharding.py`` and on 600 seeded random cases
(axes, shape, axis sizes, ``fsdp``, ``sp``) over meshes with ``pod``,
``data`` and ``model`` axes; ``can_shard`` likewise.  The logical axes of
every parameter (``M.param_axes``) and of every train-state leaf
(``train_state_axes``, f32 and bf16 with its f32 master) equal the JAX
trees leaf for leaf, for every arch of the registry, with the JAX stack's
leading layer axis dropped (the port keeps one subtree per layer).
"""
from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS as JARCHS
from repro.models import model as JM
from repro.parallel.sharding import NULL_PLAN as J_NULL_PLAN, ShardingPlan as JPlan
from repro.train.train_step import RunConfig as JRunConfig, train_state_axes as j_state_axes
from repro_torch.configs import ARCHS
from repro_torch.models import model as M
from repro_torch.parallel.sharding import (NULL_PLAN, _PRIORITY, ShardingPlan, placements,
                                           tree_specs)
from repro_torch.train.train_step import BF16_RUN, RunConfig, train_state_axes

POD = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}

# tests/test_sharding.py, case by case: (sizes, plan kwargs, axes, shape, want)
CASES = {
    "ff_takes_model": (POD, {}, ("embed", "ff"), (4096, 11008), P("data", "model")),
    "nondivisible_falls_back_to_none": (POD, {}, ("embed", "q_heads", "head_dim"),
                                        (1536, 12, 128), P("data",)),
    "mesh_axis_used_once": (POD, {}, ("expert", "embed", "ff"), (64, 2048, 1408),
                            P("model", "data")),
    "expert_nondivisible_frees_model_for_ff": (POD, {}, ("expert", "embed", "ff"),
                                               (40, 1536, 512), P(None, "data", "model")),
    "batch_spans_pod_and_data": (MULTI, {}, ("batch", None, "embed"), (256, 4096, 1024),
                                 P(("pod", "data"),)),
    "batch_unshardable_gives_seq_to_kv": (POD, {}, ("batch", "kv_seq", "kv_heads", "head_dim"),
                                          (1, 524288, 8, 128), P(None, ("data", "model"))),
    "batch_shardable_kv_seq_takes_model": (POD, {}, ("batch", "kv_seq", "kv_heads", "head_dim"),
                                           (128, 32768, 7, 128), P("data", "model")),
    "sp_on": (POD, {}, ("batch", "seq", "embed"), (256, 4096, 1024), P("data", "model")),
    "sp_off": (POD, {"sp": False}, ("batch", "seq", "embed"), (256, 4096, 1024), P("data",)),
    "fsdp_off": (POD, {"fsdp": False}, ("embed", "ff"), (4096, 11008), P(None, "model")),
    "moe_groups_model_major": (POD, {}, ("moe_groups", None, None), (1024, 256, 4096),
                               P(("model", "data"),)),
    "no_shape": (POD, {}, ("embed", "q_heads", "head_dim"), None, P("data", "model")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_spec_matches_jax_on_the_named_cases(name):
    sizes, kw, axes, shape, want = CASES[name]
    got = ShardingPlan(axis_sizes=sizes, **kw).spec(axes, shape)
    jax_spec = JPlan(axis_sizes=sizes, **kw).spec(axes, shape)
    assert jax_spec == want
    assert got == tuple(jax_spec) == tuple(want)


def test_can_shard_matches_jax_on_the_named_cases():
    for plan, jplan in ((ShardingPlan(axis_sizes=POD), JPlan(axis_sizes=POD)),
                        (NULL_PLAN, J_NULL_PLAN)):
        for axis, size in (("q_heads", 32), ("q_heads", 12), ("ff", 8960), ("batch", 1),
                           ("seq", 4096), ("embed", 1536)):
            assert plan.can_shard(axis, size) == jplan.can_shard(axis, size)
    assert ShardingPlan(axis_sizes=POD).can_shard("q_heads", 32)
    assert not ShardingPlan(axis_sizes=POD).can_shard("q_heads", 12)
    assert not NULL_PLAN.can_shard("ff", 8960)


def test_null_plan_constrain_is_identity():
    x = torch.ones((4, 4))
    assert NULL_PLAN.constrain(x, ("batch", "embed")) is x
    # a plain tensor under a real plan too: only a DTensor is redistributed
    assert ShardingPlan(axis_sizes=POD).constrain(x, ("batch", "embed")) is x


NAMES = _PRIORITY + (None, "unknown")
DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 40, 64, 96, 128, 256, 1024)


def _random_case(rng):
    mesh_axes = [a for a in ("pod", "data", "model") if rng.random() < 0.8] or ["data"]
    sizes = {a: int(rng.choice([1, 2, 3, 4, 8, 16])) for a in mesh_axes}
    n = int(rng.integers(1, 5))
    axes = tuple(NAMES[int(rng.integers(len(NAMES)))] for _ in range(n))
    shape = None if rng.random() < 0.15 else tuple(int(rng.choice(DIMS)) for _ in range(n))
    return sizes, axes, shape


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("sp", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_and_can_shard_match_jax_on_random_cases(seed, sp, fsdp):
    """50 seeded cases each, 600 over the 12 parametrisations."""
    rng = np.random.default_rng(1000 * seed + 10 * sp + fsdp)
    sharded = 0
    for _ in range(50):
        sizes, axes, shape = _random_case(rng)
        plan = ShardingPlan(axis_sizes=sizes, fsdp=fsdp, sp=sp)
        jplan = JPlan(axis_sizes=sizes, fsdp=fsdp, sp=sp)
        got, want = plan.spec(axes, shape), tuple(jplan.spec(axes, shape))
        assert got == want, (sizes, axes, shape, got, want)
        sharded += any(e is not None for e in got)
        for name, size in zip(axes, shape or (int(rng.choice(DIMS)),) * len(axes)):
            if name is not None:
                assert plan.can_shard(name, size) == jplan.can_shard(name, size)
    assert sharded >= 10  # the cases do exercise the rules


def test_placements_from_specs():
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    R = Replicate()
    assert placements((), mesh) == (R, R)
    assert placements(("data", "model"), mesh) == (Shard(0), Shard(1))
    assert placements((None, "data"), mesh) == (Shard(1), R)
    assert placements(("model", None, "data"), mesh) == (Shard(2), Shard(0))
    # both mesh axes on one dim: DTensor splits it in mesh-dim order
    assert placements((("model", "data"),), mesh) == (Shard(0), Shard(0))
    assert placements((None, ("data", "model")), mesh) == (Shard(1), Shard(1))
    multi = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert placements((("pod", "data"), None, "model"), multi) == (Shard(0), Shard(0), Shard(2))


def _jax_layer_path(spec, path):
    """The JAX param-axes path of the port's ``path`` and whether the JAX leaf
    is stacked (its first axis the layer index, to drop)."""
    if path[0] != "stack":
        return path, False
    pattern, reps, _ = spec.block_pattern()
    i, rest = path[1], path[2:]
    if i < reps * len(pattern):
        return ("stack", "blocks", f"sub{i % len(pattern)}") + rest, True
    return ("stack", "tail", f"tail{i - reps * len(pattern)}") + rest, False


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (i,))
    else:
        yield path, tree


def _jax_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _jax_paths(v, path + (k,))
    else:
        yield path


def _assert_axes_match(spec, port_tree, jax_tree):
    """Leaf for leaf, and every JAX leaf is met (a stacked one per repeat)."""
    met = set()
    for path, axes in _port_leaves(port_tree):
        jpath, stacked = _jax_layer_path(spec, path)
        want = _at(jax_tree, jpath)
        if stacked:
            assert want[0] is None
            want = want[1:]
        assert axes == want, (path, axes, want)
        met.add(jpath)
    assert met == set(_jax_paths(jax_tree))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_axes_match_jax(arch):
    spec, jspec = ARCHS[arch], JARCHS[arch]
    got, want = M.param_axes(spec), JM.param_axes(jspec)
    _assert_axes_match(spec, got, want)
    # the port's defs carry the same shapes, and the axes name every dim
    for (path, axes), (_, d) in zip(_port_leaves(got), _port_leaves(M.model_param_defs(spec))):
        assert len(axes) == len(d.shape), path


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_state_axes_match_jax(arch, dtype):
    spec, jspec = ARCHS[arch], JARCHS[arch]
    cfg = RunConfig() if dtype == "f32" else BF16_RUN
    jcfg = JRunConfig() if dtype == "f32" else JRunConfig(param_dtype=jnp.bfloat16,
                                                          compute_dtype=jnp.bfloat16)
    got, want = train_state_axes(spec, cfg), j_state_axes(jspec, jcfg)
    assert sorted(got) == sorted(want)
    assert ("master" in got) == (dtype == "bf16")
    assert got["step"] == want["step"] == ()
    for key in ("params", "m", "v") + (("master",) if dtype == "bf16" else ()):
        _assert_axes_match(spec, got[key], want[key])


def test_tree_specs_of_a_train_state():
    """The specs of a reduced state's leaves on a (2, 2) mesh: the plan's
    answer for each leaf's axes and shape."""
    from repro_torch.configs import reduced
    from repro_torch.train.train_step import init_train_state
    spec = reduced(ARCHS["qwen2-1.5b"])
    state = init_train_state(spec, seed=0, device="cpu")
    plan = ShardingPlan(axis_sizes={"data": 2, "model": 2})
    specs = tree_specs(plan, train_state_axes(spec), state)
    wq = state["params"]["stack"][0]["mixer"]["wq"]
    assert specs["params"]["stack"][0]["mixer"]["wq"] == plan.spec(
        ("embed", "q_heads", "head_dim"), tuple(wq.shape)) == ("data", "model")
    assert specs["m"]["embed"] == ("model", "data")
    assert specs["step"] == ()
