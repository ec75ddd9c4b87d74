"""Explicit data parallelism with int8 gradient compression, and the GPipe
pipeline, on four gloo ranks on the CPU.

Counterparts of ``tests/test_parallel.py:14`` (pipeline == sequential),
``:40`` (compressed all-reduce numerics and error feedback) and ``:177``
(explicit DP with compression).  The ranks run through
``repro_torch.parallel.spawn`` (a file store, a timeout per call); where the
JAX side needs four devices it runs in ``helpers.run_with_devices(4, ...)``
and hands its arrays back through an ``.npz``.

Tolerances: ``compressed_psum``'s reduced means and residuals within 1e-6
of the JAX ``compressed_psum`` under ``shard_map`` on the same per-rank
gradients (the same f32 operations: both agree bit for bit here, which the
test reports but does not require); ``make_dp_train_step`` with no
compression against the unsharded step on the global batch, losses rtol
1e-5; with int8 compression the JAX test's own assertions over 25 steps;
``pipeline_forward`` within 1e-5 of the sequential stack and of the JAX
``pipeline_forward``.
"""
from __future__ import annotations

import numpy as np
import pytest

from helpers import run_with_devices
from repro_torch.parallel import spawn
from repro_torch.parallel.compression import wire_bytes
from repro_torch.parallel.pipeline import pipeline_bubble_fraction

TIMEOUT = 150  # seconds, per spawned call: each runs in well under 60 s alone
N = 4


# -- compressed_psum ---------------------------------------------------------------

def _grads(rounds: int = 2):
    """Per-rank gradients of two leaves, ``rounds`` rounds: (rounds, N, ...)."""
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((rounds, N, 64, 64)).astype(np.float32),
            "b": (rng.standard_normal((rounds, N, 64)) * 1e-3).astype(np.float32)}


def _compressed_rank(grads):
    """Two rounds of ``compressed_psum`` over the world, the second fed the
    first's residual: each round's reduced means and this rank's residuals."""
    import torch
    import torch.distributed as dist

    from repro_torch.parallel.compression import compressed_psum, init_error_state
    me = dist.get_rank()
    err = init_error_state({k: torch.from_numpy(v[0, me]) for k, v in grads.items()})
    out = []
    for r in range(grads["w"].shape[0]):
        g = {k: torch.from_numpy(v[r, me].copy()) for k, v in grads.items()}
        red, err = compressed_psum(g, dist.group.WORLD, err, bits=8)
        out.append(({k: v.numpy() for k, v in red.items()},
                    {k: v.numpy().copy() for k, v in err.items()}))
    return out


JAX_COMPRESSED = """
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.launch.mesh import make_mesh
    from repro.parallel.compression import compressed_psum
    z = np.load({path!r})
    mesh = make_mesh((4,), ("dp",))

    def f(gw, gb, ew, eb):
        out, err = compressed_psum({{"w": gw, "b": gb}}, "dp", {{"w": ew, "b": eb}}, bits=8)
        return out["w"], out["b"], err["w"], err["b"]

    spec = P("dp")
    sf = shard_map(f, mesh=mesh, in_specs=(spec,) * 4, out_specs=(spec,) * 4, check_rep=False)
    ew, eb = jnp.zeros_like(z["w"][0]), jnp.zeros_like(z["b"][0])
    res = {{}}
    for r in range(z["w"].shape[0]):
        rw, rb, ew, eb = sf(z["w"][r], z["b"][r], ew, eb)
        res.update({{f"red_w{{r}}": rw, f"red_b{{r}}": rb, f"err_w{{r}}": ew, f"err_b{{r}}": eb}})
    np.savez({out!r}, **{{k: np.asarray(v) for k, v in res.items()}})
    print("OK")
"""


def test_compressed_psum_matches_jax(tmp_path):
    grads = _grads()
    np.savez(tmp_path / "in.npz", **grads)
    out = run_with_devices(4, JAX_COMPRESSED.format(path=str(tmp_path / "in.npz"),
                                                    out=str(tmp_path / "out.npz")), timeout=120)
    assert "OK" in out
    want = np.load(tmp_path / "out.npz")
    ranks = spawn.run(_compressed_rank, N, grads, timeout=TIMEOUT)
    same_bits = True
    for me, rounds in enumerate(ranks):
        for r, (red, err) in enumerate(rounds):
            for k in ("w", "b"):
                # shard_map's out_specs P("dp") keep each rank's mean and residual
                jred = want[f"red_{k}{r}"].reshape((N,) + red[k].shape)[me]
                jerr = want[f"err_{k}{r}"].reshape((N,) + err[k].shape)[me]
                np.testing.assert_allclose(red[k], jred, rtol=0, atol=1e-6 * np.abs(jred).max())
                np.testing.assert_allclose(err[k], jerr, rtol=0, atol=1e-6 * np.abs(jred).max())
                same_bits &= np.array_equal(red[k], jred) and np.array_equal(err[k], jerr)
    # every rank holds the same mean, bit for bit
    for rounds in ranks[1:]:
        for (red, _), (red0, _) in zip(rounds, ranks[0]):
            for k in red:
                np.testing.assert_array_equal(red[k], red0[k])
    print(f"compressed_psum vs JAX bit for bit: {same_bits}")


def test_compressed_psum_numerics_and_error_feedback():
    """The JAX test's own assertions (``tests/test_parallel.py:58-66``)."""
    grads = _grads(rounds=1)
    red, err = spawn.run(_compressed_rank, N, grads, timeout=TIMEOUT)[0][0]
    true_mean = grads["w"][0].mean(axis=0)
    rel = np.abs(red["w"] - true_mean).max() / np.abs(true_mean).max()
    assert rel < 0.05, rel              # 8-bit quantization error bound
    assert np.abs(err["w"]).max() > 0   # the residual is what quantization dropped:
    scale = np.abs(grads["w"][0]).max() / 127  # at most half a step of the shared scale
    assert np.abs(err["w"]).max() <= scale / 2 * (1 + 1e-6)
    comp, full = wire_bytes({"w": np.zeros((64, 64), np.float32)})
    assert comp * 3.5 < full


def test_wire_bytes_matches_jax():
    import jax.numpy as jnp
    import torch

    from repro.parallel.compression import wire_bytes as j_wire_bytes
    shapes = [(64, 64), (7,), (3, 5, 2)]
    tree = {f"t{i}": torch.zeros(s) for i, s in enumerate(shapes)}
    jtree = {f"t{i}": jnp.zeros(s) for i, s in enumerate(shapes)}
    for bits in (8, 4, 16):
        assert wire_bytes(tree, bits=bits) == j_wire_bytes(jtree, bits=bits)
    assert wire_bytes([torch.zeros(10)], bits=8) == (10 + 4, 40)


def test_quantize_rounds_half_to_even_as_jnp_round():
    import jax.numpy as jnp
    import torch

    from repro.parallel.compression import _quantize as j_quantize
    from repro_torch.parallel.compression import _quantize
    g = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, -127.0, 3.49, 126.5], np.float32)
    q, scale = _quantize(torch.from_numpy(g), 8)
    jq, jscale = j_quantize(jnp.asarray(g), 8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)


# -- make_dp_train_step --------------------------------------------------------------

def _dp_rank(cases, steps):
    """For each compress_bits in ``cases``: ``steps`` steps of
    ``make_dp_train_step`` over a 4-way data axis from the seed-0 state;
    the losses and (bits 0) the final parameters."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.dp_explicit import make_dp_train_step
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import RunConfig, init_train_state
    spec = reduced(ARCHS["qwen2-1.5b"], n_layers=2)
    cfg = RunConfig(remat="none", opt=opt.OptConfig(lr=6e-3, warmup_steps=2))
    mesh = make_mesh((N,), ("data",), device="cpu")
    data = SyntheticLM(spec, DataConfig(8, 32, seed=0))
    out = {}
    for bits in cases:
        step, init_extra = make_dp_train_step(spec, mesh, cfg, compress_bits=bits)
        state = init_extra(init_train_state(spec, cfg, seed=0, device="cpu"))
        losses = []
        for i in range(steps):
            state, m = step(state, data.batch_at(i))
            losses.append(m["loss"].item())
        out[bits] = (losses, [t.detach().numpy().copy() for t in opt.leaves(state["params"])],
                     "grad_error" in state)
    return out


def test_dp_train_step_matches_the_unsharded_step():
    """No compression: three steps against the unsharded step on the global
    batch (each rank's mean loss over its quarter, averaged)."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import RunConfig, init_train_state, make_train_step
    spec = reduced(ARCHS["qwen2-1.5b"], n_layers=2)
    cfg = RunConfig(remat="none", opt=opt.OptConfig(lr=6e-3, warmup_steps=2))
    data = SyntheticLM(spec, DataConfig(8, 32, seed=0))
    state, step, want = init_train_state(spec, cfg, seed=0, device="cpu"), \
        make_train_step(spec, cfg=cfg), []
    for i in range(3):
        state, m = step(state, data.batch_at(i))
        want.append(m["loss"].item())
    ranks = spawn.run(_dp_rank, N, (0,), 3, timeout=TIMEOUT)
    for r in ranks:
        losses, params, has_err = r[0]
        assert not has_err
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        assert losses == ranks[0][0][0]  # the same mean on every rank
        for got, rank0 in zip(params, ranks[0][0][1]):
            np.testing.assert_array_equal(got, rank0)  # the replicas stay equal


def test_dp_explicit_with_gradient_compression():
    """int8 error-feedback compressed gradients track the uncompressed run;
    loss decreases in both (the JAX test's assertions, :206-210)."""
    out = spawn.run(_dp_rank, N, (0, 8), 25, timeout=TIMEOUT)[0]
    (l0, p0, _), (l8, p8, has_err) = out[0], out[8]
    assert has_err
    assert np.mean(l0[-5:]) < np.mean(l0[:5]) - 0.02, l0
    assert np.mean(l8[-5:]) < np.mean(l8[:5]) - 0.02, l8
    assert abs(np.mean(l8[-5:]) - np.mean(l0[-5:])) < 0.15
    # compression changes the trajectory, but not by much
    assert any(not np.array_equal(a, b) for a, b in zip(p0, p8))


# -- pipeline_forward ------------------------------------------------------------------

def _stage_fn(p, x):
    import torch
    return torch.tanh(x @ p["w"] + p["b"])


def _pipeline_inputs():
    rng = np.random.default_rng(0)
    d = 16
    return ({"w": (rng.standard_normal((N, d, d)) * 0.5).astype(np.float32),
             "b": (rng.standard_normal((N, d)) * 0.1).astype(np.float32)},
            rng.standard_normal((8, 4, d)).astype(np.float32))


def _pipeline_rank(params, mbs):
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_forward
    mesh = make_mesh((N,), ("pipe",), device="cpu")
    pf = pipeline_forward(_stage_fn, mesh, "pipe")
    out = pf({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(mbs))
    return out.numpy()


JAX_PIPELINE = """
    import jax, jax.numpy as jnp, numpy as np
    from repro.launch.mesh import make_mesh
    from repro.parallel.pipeline import pipeline_forward
    z = np.load({path!r})
    mesh = make_mesh((4,), ("pipe",))
    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])
    pf = pipeline_forward(stage_fn, mesh, "pipe")
    with mesh:
        out = jax.jit(pf)({{"w": z["w"], "b": z["b"]}}, z["mbs"])
    np.save({out!r}, np.asarray(out))
    print("OK")
"""


def test_pipeline_matches_sequential_and_jax(tmp_path):
    params, mbs = _pipeline_inputs()
    ranks = spawn.run(_pipeline_rank, N, params, mbs, timeout=TIMEOUT)
    ref = mbs
    for i in range(N):
        ref = np.tanh(ref @ params["w"][i] + params["b"][i])
    np.savez(tmp_path / "in.npz", mbs=mbs, **params)
    out = run_with_devices(4, JAX_PIPELINE.format(path=str(tmp_path / "in.npz"),
                                                  out=str(tmp_path / "out.npy")), timeout=120)
    assert "OK" in out
    jout = np.load(tmp_path / "out.npy")
    for got in ranks:  # every rank holds the last stage's outputs
        assert got.shape == mbs.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, jout, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got, ranks[0])


@pytest.mark.parametrize("n_stages", [1, 2, 4, 8, 16])
def test_bubble_fraction_matches_jax(n_stages):
    from repro.parallel.pipeline import pipeline_bubble_fraction as j_bubble
    for n_micro in (1, 2, 4, 8, 32, 128):
        assert pipeline_bubble_fraction(n_micro, n_stages) == j_bubble(n_micro, n_stages)
    assert pipeline_bubble_fraction(8, 1) == 0.0


# -- spawn ---------------------------------------------------------------------------

def _rank_id():
    import torch
    import torch.distributed as dist
    t = torch.tensor([float(dist.get_rank())])
    dist.all_reduce(t)
    return dist.get_rank(), dist.get_world_size(), float(t), torch.get_num_threads()


def _fails_on_rank_1():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()  # the others wait for rank 1, which never comes


def _sleeps():
    import time
    time.sleep(60)


def test_spawn_runs_a_gloo_world():
    assert spawn.run(_rank_id, 3, timeout=TIMEOUT) == [(r, 3, 3.0, 1) for r in range(3)]


def test_spawn_raises_on_a_failing_rank_and_a_timeout():
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed:.*rank 1 gives up"):
        spawn.run(_fails_on_rank_1, 3, timeout=TIMEOUT)
    with pytest.raises(TimeoutError, match="did not finish in 2"):
        spawn.run(_sleeps, 2, timeout=2)


WORLD_OF_ONE = """
import torch, torch.distributed as dist
from repro_torch.launch.mesh import make_mesh, single_device_mesh
from repro_torch.parallel.compression import compressed_psum
from repro_torch.parallel.pipeline import pipeline_forward
mesh = single_device_mesh(device="cpu")
assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
assert mesh.mesh_dim_names == ("data",) and tuple(mesh.shape) == (1,)
g = {"w": torch.randn(8, 8, generator=torch.Generator().manual_seed(0))}
red, err = compressed_psum(g, mesh.get_group("data"), {"w": torch.zeros(8, 8)})
torch.testing.assert_close(red["w"] + err["w"], g["w"], rtol=0, atol=1e-6)
pipe = make_mesh((1,), ("pipe",), device="cpu")
w = torch.randn(1, 8, 8, generator=torch.Generator().manual_seed(1))
x = torch.randn(3, 2, 8, generator=torch.Generator().manual_seed(2))
out = pipeline_forward(lambda p, h: torch.tanh(h @ p["w"]), pipe, "pipe")({"w": w}, x)
torch.testing.assert_close(out, torch.tanh(x @ w[0]))
dist.destroy_process_group()
print("OK")
"""


def test_a_mesh_of_one_in_a_single_process():
    """No torchrun: ``single_device_mesh`` starts a world of one (gloo on the
    CPU) itself, as ``chip_smoke.py`` starts one with NCCL on the card."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(src) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", WORLD_OF_ONE], capture_output=True, text=True,
                       timeout=TIMEOUT, env=env)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
