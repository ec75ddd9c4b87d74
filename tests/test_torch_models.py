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
from repro.models import moe as jmoe
from repro.models.layers import init_tree as jinit_tree, param_count as param_count_jax
from repro.parallel.sharding import NULL_PLAN
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import from_jax_params
from repro_torch.models import model as M
from repro_torch.models import moe
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
    ("granite-moe-3b-a800m", TOL),
    # 16 layers, 14 of them Mamba at random-init w_dt: the JAX chunked SSD's
    # f32 exp(cum_l - cum_m) loses digits there (see the mamba test below),
    # ~4e-4 on logits of ~4
    ("jamba-v0.1-52b", dict(rtol=1e-3, atol=1e-3)),
], ids=["qwen2-1.5b", "gpt3-13b", "gemma3-1b", "mamba2-130m", "granite-moe-3b-a800m",
        "jamba-v0.1-52b"])
def test_forward_matches_jax(arch, tol):
    """qwen2: bias + tied head; gpt3: untied head, GELU; gemma3: sliding-window
    layers and a remainder (tail) of the block pattern; mamba2: SSD mixers
    through ``ops.ssd`` with no FFN; granite: MoE FFNs; jamba: attention,
    Mamba and MoE layers in one stack.  ``aux`` is the summed load-balance
    loss (0 without MoE)."""
    jspec, spec, jp, tp = _setup(arch)
    tok = _tokens(spec, 2, 24)
    expect, expect_aux = JM.forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(tok), jspec,
                                    remat="none")
    got, aux = M.forward(tp, torch.from_numpy(tok), spec)
    assert got.shape == (2, 24, spec.vocab_size)
    assert aux.shape == () and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **tol)
    np.testing.assert_allclose(aux.item(), float(expect_aux), rtol=1e-5)
    assert (aux.item() > 0) == bool(spec.n_experts)


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
    full, _ = M.forward(tp, tok, spec)
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
    full, _ = M.forward(tp, tok, spec)
    caches = M.init_caches(spec, 2, 24, dtype=torch.float32, device="cpu")
    lp, caches = M.prefill(tp, tok[:, :-1], caches, spec, compute_dtype=torch.float32)
    ld, _ = M.decode_step(tp, caches, tok[:, -1], 23, spec, compute_dtype=torch.float32)
    np.testing.assert_allclose(lp.numpy(), full[:, -2].numpy(), **TOL)
    np.testing.assert_allclose(ld.numpy(), full[:, -1].numpy(), **TOL)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-1b", "gpt3-13b", "phi-3-vision-4.2b",
                                  "mamba2-130m", "granite-moe-3b-a800m", "jamba-v0.1-52b"])
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


def _jax_layer(tree, spec, i, *path):
    """Layer ``i``'s node at ``path`` in a JAX stacked-plus-tail tree (the
    ``stack`` of the parameters, or the caches)."""
    pattern, reps, _ = spec.block_pattern()
    n = reps * len(pattern)
    node = tree["blocks"][f"sub{i % len(pattern)}"] if i < n else tree["tail"][f"tail{i - n}"]
    for key in path:
        node = node[key]
    return np.asarray(node)[i // len(pattern)] if i < n else np.asarray(node)


TOL_GEMMA = dict(rtol=3e-3, atol=3e-3)  # the gemma3 case of test_forward_matches_jax


def _jax_decoder(jspec):
    """``JM.decode_step`` at f32 compute, jitted once for every position."""
    step = jax.jit(lambda p, c, t, pos: JM.decode_step(p, c, t, pos, jspec,
                                                       compute_dtype=jnp.float32))
    return lambda p, c, t, pos: step(p, c, jnp.asarray(t), jnp.asarray(pos, jnp.int32))


def _close_to_scale(got, want, tol=3e-3):
    """Within ``tol`` of the largest |want| (a cache leaf of a deep gemma3
    layer holds values up to ~3 whose fp32 rounding drifts to ~1e-3 of it)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def test_ring_cache_prefill_and_decode_across_the_wrap_match_jax():
    """gemma3-reduced (window 16): a 40-token prompt leaves its last 16 tokens
    in each local layer's ring at slot ``pos % 16``, then 24 decode steps wrap
    the ring (slot 0 again at position 48).  Logits and every cache leaf, slot
    by slot, against the JAX package with f32 caches, after prefill and after
    each step; ``kpos`` exactly."""
    jspec, spec, jp, tp = _setup("gemma3-1b")
    b, s, n_new, t = 2, 40, 24, 64
    tok = _tokens(spec, b, s + n_new)
    jpj = jax.tree.map(jnp.asarray, jp)
    jc = JM.init_caches(jspec, b, t, dtype=jnp.float32)
    tc = M.init_caches(spec, b, t, dtype=torch.float32, device="cpu")
    jl, jc = JM.prefill(jpj, jnp.asarray(tok[:, :s]), jc, jspec, compute_dtype=jnp.float32)
    tl, tc = M.prefill(tp, torch.from_numpy(tok[:, :s]), tc, spec, compute_dtype=torch.float32)
    layers = spec.layer_defs()
    assert {ld.mixer for ld in layers} == {"attn_local", "attn_full"}

    def check():
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_GEMMA)
        for i, (layer, ld) in enumerate(zip(tc, layers)):
            if ld.mixer == "attn_local":
                assert layer["k"].shape[1] == spec.sliding_window
                assert layer["kpos"].dtype == torch.int32
                np.testing.assert_array_equal(layer["kpos"].numpy(), _jax_layer(jc, spec, i, "kpos"))
            else:
                assert "kpos" not in layer and layer["k"].shape[1] == t
            for name in ("k", "v"):
                _close_to_scale(layer[name].numpy(), _jax_layer(jc, spec, i, name))
    check()
    assert sorted(tc[0]["kpos"].tolist()) == list(range(s - 15, s + 1))
    decode = _jax_decoder(jspec)
    for pos in range(s, s + n_new):
        jl, jc = decode(jpj, jc, tok[:, pos], pos)
        tl, tc = M.decode_step(tp, tc, torch.from_numpy(tok[:, pos]), pos, spec,
                               compute_dtype=torch.float32)
        check()
        assert tc[0]["kpos"][pos % 16] == pos + 1


def test_short_prompt_fills_the_ring_from_slot_0_and_empties_the_rest():
    """S < window: slot i holds token i and the other slots are emptied, as
    the JAX prefill rebuilds the ring from zeros."""
    jspec, spec, jp, tp = _setup("gemma3-1b")
    tok = _tokens(spec, 1, 10)
    jc = JM.init_caches(jspec, 1, 32, dtype=jnp.float32)
    _, jc = JM.prefill(jax.tree.map(jnp.asarray, jp), jnp.asarray(tok), jc, jspec,
                       compute_dtype=jnp.float32)
    tc = M.init_caches(spec, 1, 32, dtype=torch.float32, device="cpu")
    for layer in tc:
        for leaf in layer.values():
            leaf.fill_(7)  # a used cache: prefill must clear what it does not write
    _, tc = M.prefill(tp, torch.from_numpy(tok), tc, spec, compute_dtype=torch.float32)
    assert tc[0]["kpos"].tolist() == list(range(1, 11)) + [0] * 6
    for name in ("k", "v", "kpos"):
        _close_to_scale(tc[0][name].numpy(), _jax_layer(jc, spec, 0, name))
    assert not tc[0]["k"][:, 10:].any()


def test_ring_kpos_is_exact_where_the_jax_bf16_cache_rounds():
    """The JAX ring keeps ``kpos`` in the cache dtype: in bf16, position 512's
    ``kpos`` of 513 is stored as 512, and position 514's 515 as 516, which
    masks the new token out of its own attention (ROADMAP Queue 3).  The
    port's ``kpos`` is int32.  With bf16 k/v the port's ring follows the JAX
    ring kept in f32: the same ``kpos`` exactly, the prompt's k/v within one
    bf16 rounding, and decode logits within 0.1 of their scale (bf16 keys and
    values through 14 layers whose residual grows), where the JAX bf16 ring
    is off by more than half of it."""
    jspec, spec, jp, tp = _setup("gemma3-1b")
    b, s, t = 1, 513, 520
    tok = _tokens(spec, b, s + 3)
    jpj = jax.tree.map(jnp.asarray, jp)
    jc16 = JM.init_caches(jspec, b, t, dtype=jnp.bfloat16)
    jc32 = JM.init_caches(jspec, b, t, dtype=jnp.float32)
    tc = M.init_caches(spec, b, t, dtype=torch.bfloat16, device="cpu")
    _, jc16 = JM.prefill(jpj, jnp.asarray(tok[:, :s]), jc16, jspec, compute_dtype=jnp.float32)
    _, jc32 = JM.prefill(jpj, jnp.asarray(tok[:, :s]), jc32, jspec, compute_dtype=jnp.float32)
    _, tc = M.prefill(tp, torch.from_numpy(tok[:, :s]), tc, spec, compute_dtype=torch.float32)
    slot = 512 % spec.sliding_window
    assert float(_jax_layer(jc16, spec, 0, "kpos")[slot]) == 512.0
    assert float(_jax_layer(jc32, spec, 0, "kpos")[slot]) == 513.0
    assert tc[0]["kpos"].dtype == torch.int32 and tc[0]["kpos"][slot] == 513
    local = [i for i, ld in enumerate(spec.layer_defs()) if ld.mixer == "attn_local"]
    for i in local:
        for name in ("k", "v"):
            _close_to_scale(tc[i][name].float().numpy(), _jax_layer(jc32, spec, i, name), 2 ** -8)
    decode = _jax_decoder(jspec)
    gap_jax_bf16 = []
    for pos in range(s, s + 3):
        j16, jc16 = decode(jpj, jc16, tok[:, pos], pos)
        j32, jc32 = decode(jpj, jc32, tok[:, pos], pos)
        got, tc = M.decode_step(tp, tc, torch.from_numpy(tok[:, pos]), pos, spec,
                                compute_dtype=torch.float32)
        for i in local:
            np.testing.assert_array_equal(tc[i]["kpos"].numpy(), _jax_layer(jc32, spec, i, "kpos"))
        j32 = np.asarray(j32)
        scale = np.abs(j32).max()
        assert np.abs(got.numpy() - j32).max() < 0.1 * scale
        gap_jax_bf16.append(np.abs(np.asarray(j16) - j32).max() / scale)
    assert float(_jax_layer(jc16, spec, 0, "kpos")[(s + 1) % spec.sliding_window]) == 516.0
    assert max(gap_jax_bf16) > 0.5


@pytest.mark.parametrize("s,factor,drops", [
    (1, None, False),    # decode: a group of one token, capacity 8
    (300, 0.5, False),   # groups halved from 256 to 4 (300 = 4 x 75), capacity 8
    (256, 0.5, True),    # one group per sequence, capacity 64 of ~128 per expert
    (256, None, False),  # capacity 160 (the default factor 1.25)
], ids=["S1", "S300", "S256-drops", "S256"])
def test_moe_apply_matches_jax(s, factor, drops, monkeypatch):
    """y, ``lb_loss`` and ``drop_frac`` against the JAX ``moe_apply`` on
    granite-reduced (4 experts, top 2).  y within 1e-5 of its scale: f32,
    the same products summed in another order."""
    jspec, spec = jreduced(JARCHS["granite-moe-3b-a800m"]), reduced(ARCHS["granite-moe-3b-a800m"])
    assert (moe.CAPACITY_FACTOR, moe.GROUP_SIZE) == (jmoe.CAPACITY_FACTOR, jmoe.GROUP_SIZE)
    if factor is not None:
        monkeypatch.setattr(moe, "CAPACITY_FACTOR", factor)
    p = jax.tree.map(np.asarray, jinit_tree(jax.random.PRNGKey(0), jmoe.moe_defs(jspec)))
    x = np.random.default_rng(s).standard_normal((2, s, spec.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(p, jnp.asarray(x), jspec, NULL_PLAN, capacity_factor=factor)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    y, aux = moe.moe_apply(tp, torch.from_numpy(x), spec)
    jy = np.asarray(jy)
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5, atol=1e-5 * np.abs(jy).max())
    np.testing.assert_allclose(aux["lb_loss"].item(), float(jaux["lb_loss"]), rtol=1e-6)
    assert aux["drop_frac"].item() == pytest.approx(float(jaux["drop_frac"]), abs=1e-7)
    assert (aux["drop_frac"].item() > 0) == drops
    tg = moe.group_size_for(s)
    assert moe.expert_capacity(tg, spec) == jmoe.expert_capacity(tg, jspec, factor)


def test_moe_routing_drops_the_latest_slots_first():
    """Positions within an expert count every earlier routing slot (all
    tokens) before the earlier tokens of the same slot, dropped assignments
    included: a hand-made group where expert 0 takes every assignment."""
    logits = torch.tensor([[[3.0, 2.0, 0.0], [3.0, 2.0, 0.0], [2.0, 3.0, 0.0]]])  # (1, 3, 3)
    experts, slots, keep, weights, aux = moe.route(logits, 2, cap=2)
    assert experts.tolist() == [[[0, 1], [0, 1], [1, 0]]]
    # expert 0: slot-0 tokens 0, 1 at 0, 1; then token 2's slot 1 at 2
    # expert 1: token 2's slot 0 at 0; then slot-1 tokens 0, 1 at 1, 2
    assert slots.tolist() == [[[0, 1], [1, 2], [0, 2]]]
    assert keep.tolist() == [[[True, True], [True, False], [True, False]]]
    assert aux["drop_frac"].item() == pytest.approx(2 / 6)
    torch.testing.assert_close(weights.sum(-1), torch.ones(1, 3))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "gemma3-1b", "jamba-v0.1-52b"])
def test_conversion_of_moe_and_stacked_plus_tail_trees(arch):
    """``from_jax_params`` consumes the MoE leaves (``router`` (D, E);
    ``w_gate``/``w_up`` (E, D, F), ``w_down`` (E, F, D)) and gemma3's layout
    (4 repeats of a 6-layer pattern at full depth, 2 here, then a 2-layer
    tail): layer i of the port holds layer i of the JAX tree, leaf for leaf."""
    jspec, spec, jp, tp = _setup(arch)
    assert param_count(tp) == param_count_jax(JM.model_param_defs(jspec))
    layers = spec.layer_defs()
    assert len(tp["stack"]) == len(layers)
    for i, ld in enumerate(layers):
        assert ("ffn" in tp["stack"][i] and "router" in tp["stack"][i]["ffn"]) == (ld.ffn == "moe")
        for sub, leaves in tp["stack"][i].items():
            for name, leaf in (leaves.items() if isinstance(leaves, dict) else [(None, leaves)]):
                path = (sub,) if name is None else (sub, name)
                np.testing.assert_array_equal(leaf.numpy(), _jax_layer(jp["stack"], spec, i, *path))
    if spec.n_experts:
        ffn = next(layer["ffn"] for layer in tp["stack"] if "router" in layer.get("ffn", {}))
        e, d, f = spec.n_experts, spec.d_model, spec.d_ff
        assert (ffn["router"].shape, ffn["w_gate"].shape, ffn["w_down"].shape) == (
            (d, e), (e, d, f), (e, f, d))


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
