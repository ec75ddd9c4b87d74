"""bf16 serving against the JAX package's, on the CPU.

The JAX ``Engine(dtype=jnp.bfloat16)`` (``src/repro/serve/engine.py:36``)
serves with bf16 parameters, caches and compute; the port's
``Engine(dtype=torch.bfloat16)`` does the same through ``M.prefill`` and
``M.decode_step``.  For reduced qwen2 (bias, tied head), mamba2 (the SSD
scan and its conv cache), gemma3 (window-16 ring caches and global layers;
a 40-token prompt wraps the ring and stays below 256, where the JAX
package's bf16 ``kpos`` would round) and granite-moe (capacity factor 8, so
no group drops a token on either side): the same parameters, cast to
bf16, through both packages' bf16 prefill and first decode step (the
port's greedy token fed to both), logits within ``TOL`` of their scale
(two bf16 programs whose roundings fall in other places: the port's
RMSNorm multiplies by (1 + w) in f32 and rounds once, its flash attention
keeps f32 scores), and the port's within ``TOL`` of its own f32 logits
from the same bf16-rounded parameters; and the port's ``Engine`` in bf16
generates the tokens its own bf16 prefill and decode steps pick.

The parameters are the port's ``init_params`` (seed 0), as the serving
tests under a plan take them: with ``test_torch_models``' seeded norm
weights and biases, reduced gemma3's residual stream grows until either
package's bf16 logits lie 0.44 to 0.78 of their scale from its own f32
ones, and the JAX package's bf16 granite decode lies 1.24 of its scale
from its f32 one where the port's lies 0.088 from its own.
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
from repro_torch.configs import ARCHS, reduced
from repro_torch.convert import to_jax_params
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.layers import map_with_path
from repro_torch.serve.engine import Engine

CASES = {"qwen2-1.5b": 48, "mamba2-130m": 64, "gemma3-1b": 40, "granite-moe-3b-a800m": 48}
BATCH, NEW = 2, 4
TOL = 0.1  # logits: max |port - JAX| over the largest |JAX logit|
NO_DROP_CAPACITY = 8.0


def _close_to_scale(got, want, what):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max()
    assert err < TOL, (what, err)
    return err


@pytest.mark.parametrize("arch", list(CASES))
def test_bf16_prefill_and_decode_match_jax(arch, monkeypatch):
    monkeypatch.setattr(moe, "CAPACITY_FACTOR", NO_DROP_CAPACITY)
    monkeypatch.setattr(jmoe, "CAPACITY_FACTOR", NO_DROP_CAPACITY)
    jspec, spec = jreduced(JARCHS[arch]), reduced(ARCHS[arch])
    bf16, f32 = torch.bfloat16, torch.float32
    params = M.init_params(spec, 0, device="cpu", dtype=bf16)
    jpb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                       to_jax_params(M.init_params(spec, 0, device="cpu"), spec))
    s = CASES[arch]
    tok = np.random.default_rng(1).integers(0, spec.vocab_size, (BATCH, s)).astype(np.int32)

    @torch.inference_mode()
    def port(p, dtype, nxt=None):
        caches = M.init_caches(spec, BATCH, s + NEW, dtype=dtype, device="cpu")
        lg, caches = M.prefill(p, torch.from_numpy(tok), caches, spec, compute_dtype=dtype)
        nxt = lg.argmax(-1) if nxt is None else nxt
        return lg, nxt, M.decode_step(p, caches, nxt, s, spec, compute_dtype=dtype)[0]

    got, nxt, got2 = port(params, bf16)
    assert got.dtype == got2.dtype == bf16
    assert bool(torch.isfinite(got.float()).all() and torch.isfinite(got2.float()).all())
    jc = JM.init_caches(jspec, BATCH, s + NEW, dtype=jnp.bfloat16)
    want, jc = JM.prefill(jpb, jnp.asarray(tok), jc, jspec, compute_dtype=jnp.bfloat16)
    want2, _ = JM.decode_step(jpb, jc, jnp.asarray(nxt.numpy()), jnp.asarray(s, jnp.int32), jspec,
                              compute_dtype=jnp.bfloat16)
    _close_to_scale(got.float().numpy(), want, "prefill")
    _close_to_scale(got2.float().numpy(), want2, "decode")
    ref, _, ref2 = port(map_with_path(lambda _, t: t.to(f32), params), f32, nxt)
    _close_to_scale(got.float().numpy(), ref.numpy(), "prefill against f32")
    _close_to_scale(got2.float().numpy(), ref2.numpy(), "decode against f32")

    # the Engine's bf16 tokens are its own prefill's and decode steps' picks
    out, _ = Engine(spec, params, max_len=s + NEW, dtype=bf16, device="cpu").generate(tok, NEW)
    caches = M.init_caches(spec, BATCH, s + NEW, dtype=bf16, device="cpu")
    picks = []
    with torch.inference_mode():
        lg, caches = M.prefill(params, torch.from_numpy(tok), caches, spec, compute_dtype=bf16)
        for i in range(NEW):
            picks.append(lg.argmax(-1))
            lg, caches = M.decode_step(params, caches, picks[-1], s + i, spec, compute_dtype=bf16)
    np.testing.assert_array_equal(out, torch.stack(picks, 1).numpy())
