"""The port's model stack vs the JAX package's, on reduced configs at fp32.

Parameters come from ``repro.models.model.init_params``; its zero-initialised
biases and norm weights are overwritten with seeded numpy values (so a
dropped bias or norm shows), then converted with ``from_jax_params``.
Tolerance 1e-4: fp32 throughout, sums taken in another order.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models import model as JM
from repro.models.layers import param_count as param_count_jax
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import from_jax_params
from repro_torch.models import model as M
from repro_torch.models.layers import param_count

TOL = dict(rtol=1e-4, atol=1e-4)
_SEEDED = ("bq", "bk", "bv", "norm1", "norm2", "final_norm", "norm", "d_skip")


def seeded_jax_params(jspec, seed=0):
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed), jspec))
    rng = np.random.default_rng(seed)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                (rng.standard_normal(v.shape).astype(np.float32) * 0.3 if k in _SEEDED else v)
                for k, v in tree.items()}
    return fill(params)


def _setup(arch, seed=0):
    jspec, spec = jreduced(JARCHS[arch]), reduced(ARCHS[arch])
    assert spec == type(spec)(**{f: getattr(jspec, f) for f in jspec.__dataclass_fields__})
    jp = seeded_jax_params(jspec, seed)
    return jspec, spec, jp, from_jax_params(jp, spec, device="cpu")


def _tokens(spec, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, spec.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch,tol", [
    ("qwen2-1.5b", TOL),
    ("gpt3-13b", TOL),
    # 14 layers whose residual stream grows to ~600 (GELU MLP; `wo`'s init
    # fan-in is n_heads = 4), so fp32 rounding alone puts ~5e-4 on every
    # layer's output; one layer of it agrees to 1e-5
    ("gemma3-1b", dict(rtol=3e-3, atol=3e-3)),
    ("mamba2-130m", TOL),
], ids=["qwen2-1.5b", "gpt3-13b", "gemma3-1b", "mamba2-130m"])
def test_forward_matches_jax(arch, tol):
    """qwen2: bias + tied head; gpt3: untied head, GELU; gemma3: sliding-window
    layers and a remainder (tail) of the block pattern; mamba2: SSD mixers
    through ``ops.ssd`` with no FFN."""
    jspec, spec, jp, tp = _setup(arch)
    tok = _tokens(spec, 2, 24)
    expect, _ = JM.forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(tok), jspec, remat="none")
    got = M.forward(tp, torch.from_numpy(tok), spec)
    assert got.shape == (2, 24, spec.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **tol)


def test_prefill_decode_and_caches_match_jax():
    jspec, spec, jp, tp = _setup("qwen2-1.5b")
    b, s, t = 2, 23, 32
    tok = _tokens(spec, b, s + 1)
    jpj = jax.tree.map(jnp.asarray, jp)
    jc = JM.init_caches(jspec, b, t, dtype=jnp.float32)
    jl, jc = JM.prefill(jpj, jnp.asarray(tok[:, :s]), jc, jspec, compute_dtype=jnp.float32)
    tc = M.init_caches(spec, b, t, dtype=torch.float32, device="cpu")
    tl, tc = M.prefill(tp, torch.from_numpy(tok[:, :s]), tc, spec, compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    def check_caches():
        for name in ("k", "v"):
            stacked = np.asarray(jc["blocks"]["sub0"][name])  # qwen2: one-layer pattern
            assert len(tc) == stacked.shape[0]
            for i, layer in enumerate(tc):
                np.testing.assert_allclose(layer[name].numpy(), stacked[i], **TOL)
    check_caches()

    jd, jc = JM.decode_step(jpj, jc, jnp.asarray(tok[:, s]), s, jspec, compute_dtype=jnp.float32)
    td, tc = M.decode_step(tp, tc, torch.from_numpy(tok[:, s]), s, spec,
                           compute_dtype=torch.float32)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    check_caches()


@pytest.mark.parametrize("s", [24, 512])
def test_mamba_prefill_decode_and_caches_match_jax(s):
    """S = 512 is two of the JAX module's 256-token chunks, so the JAX side
    carries its state across a chunk boundary; the port's plain scan is the
    sequential recurrence.  The ``conv`` and ``ssm`` caches are compared leaf
    by leaf after prefill and after one decode step.

    ``w_dt`` is scaled by 0.1 so dt stays near its init range [1e-3, 1e-1].
    At the random-init ``w_dt`` dt reaches ~1, the cumsums inside a JAX
    256-token chunk reach the thousands, and the reference's f32
    ``exp(cum_l - cum_m)`` of two such cumsums loses the digits this
    tolerance asks for, while the port's sequential recurrence keeps them."""
    jspec, spec = jreduced(JARCHS["mamba2-130m"]), reduced(ARCHS["mamba2-130m"])
    jp = seeded_jax_params(jspec)
    mixer = jp["stack"]["blocks"]["sub0"]["mixer"]
    mixer["w_dt"] = mixer["w_dt"] * np.float32(0.1)
    tp = from_jax_params(jp, spec, device="cpu")
    b = 2
    tok = _tokens(spec, b, s + 1)
    jpj = jax.tree.map(jnp.asarray, jp)
    jc = JM.init_caches(jspec, b, s + 1, dtype=jnp.float32)
    jl, jc = JM.prefill(jpj, jnp.asarray(tok[:, :s]), jc, jspec, compute_dtype=jnp.float32)
    tc = M.init_caches(spec, b, s + 1, dtype=torch.float32, device="cpu")
    tl, tc = M.prefill(tp, torch.from_numpy(tok[:, :s]), tc, spec, compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    def check_caches():
        for name in ("conv", "ssm"):
            stacked = np.asarray(jc["blocks"]["sub0"][name])  # mamba2: one-layer pattern
            assert len(tc) == stacked.shape[0]
            for i, layer in enumerate(tc):
                np.testing.assert_allclose(layer[name].numpy(), stacked[i], **TOL)
    check_caches()

    jd, jc = JM.decode_step(jpj, jc, jnp.asarray(tok[:, s]), s, jspec, compute_dtype=jnp.float32)
    td, tc = M.decode_step(tp, tc, torch.from_numpy(tok[:, s]), s, spec,
                           compute_dtype=torch.float32)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    check_caches()


def test_mamba_prefill_then_decode_matches_forward():
    """The scan over S tokens vs the scan over S-1 plus the decode recurrence,
    also for a prompt shorter than the conv window."""
    _, spec, _, tp = _setup("mamba2-130m")
    tok = torch.from_numpy(_tokens(spec, 2, 24))
    full = M.forward(tp, tok, spec)
    for s in (23, 2):
        caches = M.init_caches(spec, 2, 24, dtype=torch.float32, device="cpu")
        lp, caches = M.prefill(tp, tok[:, :s], caches, spec, compute_dtype=torch.float32)
        ld, _ = M.decode_step(tp, caches, tok[:, s], s, spec, compute_dtype=torch.float32)
        np.testing.assert_allclose(lp.numpy(), full[:, s - 1].numpy(), **TOL)
        np.testing.assert_allclose(ld.numpy(), full[:, s].numpy(), **TOL)


def test_prefill_then_decode_matches_forward():
    """The port's own consistency check (``tests/test_archs.py:68``'s): the
    flash path over S tokens vs the flash path over S-1 plus plain decode."""
    _, spec, _, tp = _setup("qwen2-1.5b")
    tok = torch.from_numpy(_tokens(spec, 2, 24))
    full = M.forward(tp, tok, spec)
    caches = M.init_caches(spec, 2, 24, dtype=torch.float32, device="cpu")
    lp, caches = M.prefill(tp, tok[:, :-1], caches, spec, compute_dtype=torch.float32)
    ld, _ = M.decode_step(tp, caches, tok[:, -1], 23, spec, compute_dtype=torch.float32)
    np.testing.assert_allclose(lp.numpy(), full[:, -2].numpy(), **TOL)
    np.testing.assert_allclose(ld.numpy(), full[:, -1].numpy(), **TOL)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-1b", "gpt3-13b", "phi-3-vision-4.2b",
                                  "mamba2-130m"])
def test_param_defs_match_jax_names_shapes_and_inits(arch):
    jspec, spec = jreduced(JARCHS[arch]), reduced(ARCHS[arch])
    pattern, reps, _ = jspec.block_pattern()
    jdefs = JM.model_param_defs(jspec)

    def flat(tree, path=()):
        if isinstance(tree, (dict, list)):
            items = tree.items() if isinstance(tree, dict) else enumerate(tree)
            for k, v in items:
                yield from flat(v, path + (k,))
        else:
            yield path, tree

    want = {}
    for path, d in flat(jdefs):
        if path[:2] == ("stack", "blocks"):
            j = int(path[2][3:])
            for r in range(reps):
                want[("stack", r * len(pattern) + j) + path[3:]] = (d.shape[1:], d.init)
        elif path[:2] == ("stack", "tail"):
            want[("stack", reps * len(pattern) + int(path[2][4:])) + path[3:]] = (d.shape, d.init)
        else:
            want[path] = (d.shape, d.init)
    got = {p: (d.shape, d.init) for p, d in flat(M.model_param_defs(spec))}
    assert got == want


def test_conversion_consumes_every_leaf_and_checks_shapes():
    jspec, spec, jp, tp = _setup("qwen2-1.5b")
    assert param_count(tp) == jspec.param_count()

    extra = dict(jp, stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="not consumed"):
        from_jax_params(extra, spec, device="cpu")
    missing = dict(jp)
    del missing["final_norm"]
    with pytest.raises(ValueError, match="no leaf"):
        from_jax_params(missing, spec, device="cpu")
    bad = dict(jp, embed=jp["embed"][:, :-1])
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(bad, spec, device="cpu")
    deeper = reduced(ARCHS["qwen2-1.5b"], n_layers=3)
    with pytest.raises(ValueError, match="repeats"):
        from_jax_params(jp, deeper, device="cpu")


def test_conversion_unstacks_the_24_repeat_mamba_pattern():
    """mamba2-130m's 24 layers are 24 repeats of a one-layer pattern (reduced
    widths, full depth): layer i of the port is slice i of the JAX stack."""
    jspec = jreduced(JARCHS["mamba2-130m"], n_layers=24)
    spec = reduced(ARCHS["mamba2-130m"], n_layers=24)
    assert jspec.block_pattern()[1:] == (24, [])
    jp = seeded_jax_params(jspec)
    tp = from_jax_params(jp, spec, device="cpu")
    assert len(tp["stack"]) == 24
    for i in (0, 7, 23):
        for name, leaf in tp["stack"][i]["mixer"].items():
            np.testing.assert_array_equal(leaf.numpy(), jp["stack"]["blocks"]["sub0"]["mixer"][name][i])
        np.testing.assert_array_equal(tp["stack"][i]["norm1"].numpy(),
                                      jp["stack"]["blocks"]["sub0"]["norm1"][i])
    assert "norm2" not in tp["stack"][0] and "ffn" not in tp["stack"][0]


def test_param_count_gap_is_the_references_missing_dt_bias():
    """``ArchSpec.param_count`` counts two per-head vectors per Mamba layer
    (A_log, D) where the defs have three (dt_bias too), in both packages:
    the defs count is the true one, and mamba2-130m has 128,940,480."""
    spec, jspec = ARCHS["mamba2-130m"], JARCHS["mamba2-130m"]
    got = param_count(M.model_param_defs(spec))
    assert got == param_count_jax(JM.model_param_defs(jspec)) == 128_940_480
    assert spec.param_count() == jspec.param_count()
    assert got - spec.param_count() == spec.n_layers * spec.ssm_heads == 576


def test_unported_layers_raise_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.model_param_defs(reduced(ARCHS["jamba-v0.1-52b"]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.model_param_defs(reduced(ARCHS["granite-moe-3b-a800m"]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init_caches(reduced(ARCHS["gemma3-1b"]), 1, 8, device="cpu")


def test_ssm_init_kinds_are_seeded_and_in_range():
    spec = reduced(ARCHS["mamba2-130m"], n_layers=24)  # 24 x 8 heads of draws
    a = M.init_params(spec, 3, device="cpu")
    b = M.init_params(spec, 3, device="cpu")
    c = M.init_params(spec, 4, device="cpu")
    a_log = torch.stack([layer["mixer"]["a_log"] for layer in a["stack"]])
    dt_bias = torch.stack([layer["mixer"]["dt_bias"] for layer in a["stack"]])
    assert torch.equal(a_log, torch.stack([layer["mixer"]["a_log"] for layer in b["stack"]]))
    assert not torch.equal(dt_bias, torch.stack([layer["mixer"]["dt_bias"] for layer in c["stack"]]))
    a_neg = -torch.exp(a_log)
    assert a_neg.min() >= -16 and a_neg.max() <= -1 and a_neg.std() > 2
    dt = torch.nn.functional.softplus(dt_bias)
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
    assert (dt < 1e-2).any() and (dt > 1e-2).any()  # log-uniform over two decades
    assert torch.equal(a["stack"][0]["mixer"]["d_skip"], torch.ones(spec.ssm_heads))


def test_init_params_is_seeded_and_follows_init_kinds():
    spec = reduced(ARCHS["qwen2-1.5b"])
    a = M.init_params(spec, 3, device="cpu")
    b = M.init_params(spec, 3, device="cpu")
    c = M.init_params(spec, 4, device="cpu")
    assert torch.equal(a["embed"], b["embed"]) and not torch.equal(a["embed"], c["embed"])
    layer = a["stack"][0]
    assert not layer["norm1"].any() and not layer["mixer"]["bq"].any()
    std = layer["mixer"]["wq"].std().item()
    assert abs(std - 1 / np.sqrt(spec.d_model)) < 0.2 / np.sqrt(spec.d_model)
