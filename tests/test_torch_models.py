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
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import from_jax_params
from repro_torch.models import model as M
from repro_torch.models.layers import param_count

TOL = dict(rtol=1e-4, atol=1e-4)
_SEEDED = ("bq", "bk", "bv", "norm1", "norm2", "final_norm")


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
], ids=["qwen2-1.5b", "gpt3-13b", "gemma3-1b"])
def test_forward_matches_jax(arch, tol):
    """qwen2: bias + tied head; gpt3: untied head, GELU; gemma3: sliding-window
    layers and a remainder (tail) of the block pattern."""
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


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-1b", "gpt3-13b", "phi-3-vision-4.2b"])
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


def test_unported_layers_raise_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.model_param_defs(reduced(ARCHS["mamba2-130m"]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.model_param_defs(reduced(ARCHS["granite-moe-3b-a800m"]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init_caches(reduced(ARCHS["gemma3-1b"]), 1, 8, device="cpu")


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
