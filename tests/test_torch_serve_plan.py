"""Serving under a sharding plan on four gloo ranks, on the CPU: every
arch on (2, 2), and the decode slot and the caches.

``Engine(plan=)`` and ``M.prefill`` / ``M.decode_step`` under
``plan_for_mesh`` of a (2, 2) ("data", "model") mesh, against the port's
unsharded ``Engine`` and model functions on every rank, and against the JAX
``Engine`` with ``NULL_PLAN`` in the test process, for reduced qwen2,
mamba2, gemma3 (window 16: a 40-token prompt wraps the ring, and 16
decode steps cross its slot 0 again; 1 KV group, so its caches' kv_seq
splits over 'model'), granite-moe and jamba, one spawned call each; plus
reduced qwen2 on a (1, 4) mesh, where ``kv_seq`` splits over 'model' (2 KV
groups do not divide it): a 32-slot cache in shards of 8, a 7-token
prompt, decode slots 7 and 8 on either side of a shard boundary, and
decode on until the last shard fills; decode over a kv_seq split over
'model' on (1, 4) in reduced jamba with one KV group (its attention
layer's 24-slot cache in shards of 6; the last shard holds only masked
slots for the first two steps) and in reduced gemma3 (one KV group; its
window-16 ring caches in shards of 4 slots, wrapped by a 20-token prompt,
and its global layers' 32 slots in shards of 8); and the cache axes of
every arch against the JAX ``cache_axes``.
``tests/test_torch_serve_plan_shards.py`` holds the MoE, Mamba and FSDP
cases.

Each rank starts from the same parameters (the port's ``init_params``, seed
0, which ``convert.to_jax_params`` hands to the JAX Engine; the JAX
``init_params`` draws a stacked layer leaf with the repeat count as its
fan-in, which leaves reduced gemma3 ill-conditioned, as
``tests/test_torch_parallel_train.py`` explains), distributes them by
``M.param_axes`` and the caches by ``M.cache_axes``.  Held: greedy tokens
equal to the unsharded Engine's and the JAX Engine's, token for token, on
every rank; prefill and decode logits within rtol 1e-5 of the unsharded
ones, with an atol of 1e-5 of the step's largest logit (the same f32 sums,
some of them partial sums added across ranks, so rounding shows against
the logits' scale; where kv_seq is split, decode attends on each rank's own
slots and splits the softmax, where the unsharded path reads a slice).
Each rank records what the plan's Engine took: the (position, first slot,
slots) of each decode attention on its own slots, and the local shapes of
the MoE's expert weights.  The ranks import the port only; JAX is
imported in the test process alone.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.models import model as M
from repro_torch.parallel import spawn

AXES = ("data", "model")
TIMEOUT = 600  # seconds, per spawned call: each takes 20 to 60 s alone, more under load
RTOL = 1e-5  # logits, relative; atol RTOL * the step's largest |logit|
# arch -> (prompt, new tokens, cache length)
CASES = {"qwen2-1.5b": (16, 8, 24), "mamba2-130m": (16, 8, 24), "gemma3-1b": (40, 16, 64),
         "granite-moe-3b-a800m": (16, 8, 24), "jamba-v0.1-52b": (16, 8, 24)}
BOUNDARY = ("qwen2-1.5b", (1, 4), (7, 25, 32))  # kv_seq over 'model': shards of 8 slots
# arch -> (mesh, arch overrides, (prompt, new tokens, cache length)): kv_seq split
KV_SEQ_SPLIT = {"jamba-v0.1-52b": ((1, 4), {"n_kv_heads": 1}, (16, 4, 24)),
                "gemma3-1b": ((1, 4), {}, (20, 6, 32))}


def _prompts(vocab: int, prompt: int, batch: int = 2) -> np.ndarray:
    return np.random.default_rng(7).integers(0, vocab, (batch, prompt)).astype(np.int32)


def _params(arch, kw=None):
    return M.init_params(reduced(ARCHS[arch], **(kw or {})), 0, device="cpu")


# -- on every rank -------------------------------------------------------------

def _serve_rank(shape, runs, kw=None, group_size=None, batch=2):
    """For each (arch, params, (prompt, new, max_len)): tokens from the
    unsharded Engine and from ``Engine(plan=)``, and (rank 0) the logits of
    prefill and of each greedy decode step, unsharded and under the plan,
    with the placements of the first layer's cache k.  ``kw`` reduces the
    arch further; ``group_size``: the MoE's routing group; ``batch``: the
    prompts'."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention, moe
    from repro_torch.parallel.sharding import distribute_tree, placements, plan_for_mesh
    from repro_torch.parallel.sharding import NULL_PLAN
    from repro_torch.serve.engine import Engine

    mesh = make_mesh(shape, AXES, device="cpu")
    plan = plan_for_mesh(mesh)
    moe.GROUP_SIZE = group_size or moe.GROUP_SIZE
    f32 = torch.float32
    out = []
    seen = {"slots": [], "ffn": set(), "on": False}  # what the plan's runs took
    own_slots, expert_ffn = attention._own_slots, moe._expert_ffn

    def recording_slots(k, v, qg, kpos=None, **kwargs):
        if seen["on"]:
            seen["slots"].append((kwargs["pos"], kwargs["lo"], k.shape[1]))
        return own_slots(k, v, qg, kpos, **kwargs)

    def recording_ffn(xe, w_gate, *args):
        if seen["on"]:
            seen["ffn"].add(tuple(w_gate.shape))
        return expert_ffn(xe, w_gate, *args)

    attention._own_slots, moe._expert_ffn = recording_slots, recording_ffn
    for arch, params, (prompt, new, max_len) in runs:
        spec = reduced(ARCHS[arch], **(kw or {}))
        prompts = _prompts(spec.vocab_size, prompt, batch)
        dparams = distribute_tree(params, M.param_axes(spec), plan, mesh)
        base, _ = Engine(spec, params, max_len=max_len, device="cpu").generate(prompts, new)
        seen.update(slots=[], ffn=set(), on=True)
        got, _ = Engine(spec, dparams, plan=plan, max_len=max_len,
                        device="cpu").generate(prompts, new)
        seen["on"] = False

        @torch.inference_mode()
        def logits(p, pl):
            caches = M.init_caches(spec, batch, max_len, dtype=f32, device="cpu")
            tok = torch.as_tensor(prompts)
            if pl is not NULL_PLAN:
                caches = distribute_tree(caches, M.cache_axes(spec, batch, max_len), pl, mesh)
                tok = distribute_tensor(tok, mesh, placements(pl.spec(("batch", None), tok.shape),
                                                              mesh), src_data_rank=None)
            lg, caches = M.prefill(p, tok, caches, spec, pl, compute_dtype=f32)
            steps = []
            for i in range(new):
                whole = lg.full_tensor() if isinstance(lg, DTensor) else lg
                steps.append(whole.numpy().copy())
                lg, caches = M.decode_step(p, caches, whole.argmax(-1), prompt + i, spec, pl,
                                           compute_dtype=f32)
            k = next((c["k"] for c in caches if "k" in c), None)
            return steps, (tuple(map(str, k.placements)) if isinstance(k, DTensor) else None)

        want, _ = logits(params, NULL_PLAN)
        have, k_placements = logits(dparams, plan)
        out.append(dict(base=base, got=got, k_placements=k_placements, slots=seen["slots"],
                        ffn=seen["ffn"],
                        want=want if dist.get_rank() == 0 else None,
                        have=have if dist.get_rank() == 0 else None))
    return out


# -- in the test process -----------------------------------------------------------

_RUNS: dict = {}


def _ranks(shape, runs, kw=None, group_size=None, batch=2):
    key = (shape, tuple(runs), tuple(sorted((kw or {}).items())), group_size, batch)
    if key not in _RUNS:
        _RUNS[key] = spawn.run(_serve_rank, 4, shape,
                               [(arch, _params(arch, kw), cfg) for arch, cfg in runs], kw,
                               group_size, batch, timeout=TIMEOUT)
    return _RUNS[key]


def _jax_tokens(arch, prompt, new, kw=None, group_size=None, batch=2):
    import repro.models.moe as jmoe
    from repro.configs import ARCHS as JARCHS, reduced as jreduced
    from repro.serve.engine import Engine as JEngine
    from repro_torch.convert import to_jax_params
    jspec = jreduced(JARCHS[arch], **(kw or {}))
    jparams = to_jax_params(_params(arch, kw), reduced(ARCHS[arch], **(kw or {})))
    saved = jmoe.GROUP_SIZE
    jmoe.GROUP_SIZE = group_size or saved
    try:
        out, _ = JEngine(jspec, jparams, max_len=256).generate(
            _prompts(jspec.vocab_size, prompt, batch), max_new=new)
    finally:
        jmoe.GROUP_SIZE = saved
    return out


def _check(ranks, i, arch, prompt, new, kw=None, group_size=None, batch=2):
    res = [r[i] for r in ranks]
    for r in res:  # every rank: the plan's tokens are the unsharded Engine's
        np.testing.assert_array_equal(r["got"], r["base"])
        np.testing.assert_array_equal(r["got"], res[0]["got"])
    np.testing.assert_array_equal(res[0]["got"],
                                  _jax_tokens(arch, prompt, new, kw, group_size, batch))
    assert len(res[0]["have"]) == new
    for step, (have, want) in enumerate(zip(res[0]["have"], res[0]["want"])):
        np.testing.assert_allclose(have, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                                   err_msg=f"{arch} logits of step {step} (0: prefill)")
    return res[0]


@pytest.mark.parametrize("arch", list(CASES))
def test_engine_under_a_2x2_plan_matches_unsharded_and_jax(arch):
    prompt, new, _ = CASES[arch]
    _check(_ranks((2, 2), [(arch, CASES[arch])]), 0, arch, prompt, new)


def test_decode_slot_crosses_a_kv_seq_shard_boundary():
    """On a (1, 4) mesh qwen2's 2 KV groups do not divide 'model', so the
    cache's kv_seq splits over ('data', 'model'): a 32-slot cache in four
    shards of 8; the 7-token prompt leaves decode writing slot 7 on rank 0's
    shard and slot 8 on rank 1's, and 25 decode steps go on until slot 31
    fills the last shard.  Every decode step attends on each rank's own
    slots (the split softmax): at the first, ranks 1 to 3 hold only masked
    slots."""
    arch, shape, (prompt, new, max_len) = BOUNDARY
    ranks = _ranks(shape, [(arch, (prompt, new, max_len))])
    r = _check(ranks, 0, arch, prompt, new)
    assert r["k_placements"] == ("S(1)", "S(1)")
    assert prompt < max_len // 4 < prompt + new and prompt + new == max_len
    layers = len(reduced(ARCHS[arch]).layer_defs())
    for rank, res in enumerate(ranks):
        slots = res[0]["slots"]  # (pos, first slot, slots) of each call on this rank
        assert sorted({c[0] for c in slots}) == list(range(prompt, prompt + new))
        assert len(slots) == new * layers and {c[1:] for c in slots} == {(8 * rank, 8)}
        assert (slots[0][1] > slots[0][0]) == (rank > 0)  # all masked at the first step


@pytest.mark.parametrize("arch", list(KV_SEQ_SPLIT))
def test_engine_decodes_on_its_own_kv_seq_slots(arch):
    """One KV group on (1, 4): kv_seq splits over 'model', so every decode
    step of every attention layer attends on each rank's own slots (the
    split softmax), a full cache's and a ring's; a shard past the position
    holds only masked slots."""
    shape, kw, (prompt, new, max_len) = KV_SEQ_SPLIT[arch]
    ranks = _ranks(shape, [(arch, (prompt, new, max_len))], kw)
    _check(ranks, 0, arch, prompt, new, kw)
    spec = reduced(ARCHS[arch], **kw)
    attn = sum(ld.mixer != "mamba" for ld in spec.layer_defs())
    masked = []
    for rank, res in enumerate(ranks):
        slots = res[0]["slots"]  # (pos, first slot, slots) of each call on this rank
        assert len(slots) == new * attn
        assert {c[0] for c in slots} == set(range(prompt, prompt + new))
        masked += [pos < lo for pos, lo, n in slots if n == max_len // shape[1]]
    assert any(masked) and not all(masked)


def _jax_layer_axes(tree, spec):
    """The JAX cache-axes tree in the port's layer order: the scanned stack's
    pattern repeated (its leading stack axis dropped), then the tail."""
    pattern, reps, rem = spec.block_pattern()
    strip = lambda t: {k: (strip(v) if isinstance(v, dict) else tuple(v[1:])) for k, v in t.items()}
    layers = [strip(tree["blocks"][f"sub{i % len(pattern)}"]) for i in range(reps * len(pattern))]
    return layers + [tree["tail"][f"tail{j}"] for j in range(len(rem))]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_axes_match_jax(arch):
    from repro.configs import ARCHS as JARCHS
    from repro.models import model as JM
    spec, jspec = ARCHS[arch], JARCHS[arch]
    got = [{k: tuple(v) for k, v in layer.items()} for layer in M.cache_axes(spec, 8, 4096)]
    want = _jax_layer_axes(JM.cache_axes(jspec, 8, 4096), jspec)
    assert got == [{k: tuple(v) for k, v in layer.items()} for layer in want]
