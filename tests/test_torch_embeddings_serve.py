"""Serving through the embeddings frontend against the JAX package, on the CPU.

phi-3-vision-4.2b and musicgen-medium take frame or patch embeddings in
place of tokens (``src/repro/models/model.py:8-9``): ``prefill`` on (B, S,
D) embeddings and ``decode_step`` on (B, D) ones, as the JAX package's
``tests/test_perf_features.py`` drives its model.  Reduced phi-3-vision
(RoPE, SiLU, an untied head) and musicgen (GELU): the same parameters (the
JAX ``init_params`` with seeded norm weights, ``test_torch_models``'
``seeded_jax_params``) and the same seeded embeddings through both
packages' f32 ``prefill`` and two ``decode_step``s; the logits of each and
every cache leaf after each within ``TOL`` of the JAX ones (f32, sums
taken in other orders).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import _jax_decoder, _jax_layer, _setup

from repro.models import model as JM
from repro_torch.models import model as M

ARCHS_EMB = ("phi-3-vision-4.2b", "musicgen-medium")
BATCH, PROMPT, STEPS = 2, 24, 2
TOL = dict(rtol=1e-4, atol=1e-4)


def _embeddings(spec):
    rng = np.random.default_rng(3)
    prompt = (rng.standard_normal((BATCH, PROMPT, spec.d_model)) * 0.5).astype(np.float32)
    steps = (rng.standard_normal((STEPS, BATCH, spec.d_model)) * 0.5).astype(np.float32)
    return prompt, steps


@pytest.mark.parametrize("arch", ARCHS_EMB)
def test_embeddings_prefill_and_decode_match_jax(arch):
    jspec, spec, jp, tp = _setup(arch)
    assert spec.frontend == "embeddings"
    prompt, steps = _embeddings(spec)
    t, f32 = PROMPT + STEPS, torch.float32
    jpj = jax.tree.map(jnp.asarray, jp)
    jc = JM.init_caches(jspec, BATCH, t, dtype=jnp.float32)
    tc = M.init_caches(spec, BATCH, t, dtype=f32, device="cpu")
    want, jc = JM.prefill(jpj, jnp.asarray(prompt), jc, jspec, compute_dtype=jnp.float32)
    with torch.inference_mode():
        got, tc = M.prefill(tp, torch.from_numpy(prompt), tc, spec, compute_dtype=f32)
    decode = _jax_decoder(jspec)
    for i in range(STEPS + 1):
        what = "prefill" if i == 0 else f"decode step {i}"
        assert got.shape == (BATCH, spec.vocab_size), what
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **TOL)
        for layer, cache in enumerate(tc):
            for name, leaf in cache.items():
                np.testing.assert_allclose(leaf.numpy(), _jax_layer(jc, spec, layer, name),
                                           err_msg=f"{what}: layer {layer} {name}", **TOL)
        if i == STEPS:
            break
        want, jc = decode(jpj, jc, steps[i], PROMPT + i)
        with torch.inference_mode():
            got, tc = M.decode_step(tp, tc, torch.from_numpy(steps[i]), PROMPT + i, spec,
                                    compute_dtype=f32)
