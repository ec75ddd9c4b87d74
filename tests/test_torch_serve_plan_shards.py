"""Serving under a sharding plan on four gloo ranks, on the CPU: the MoE,
Mamba and the FSDP-split weights on their shards.

The same harness as ``tests/test_torch_serve_plan.py`` (its ``_ranks`` and
``_check``: ``Engine(plan=)`` and the model functions under
``plan_for_mesh`` against the port's unsharded ones on every rank and the
JAX ``Engine`` in the test process; tokens equal, logits within rtol 1e-5
with an atol of 1e-5 of the step's largest logit), for:
  * reduced granite-moe at routing groups of 4 tokens (a 16-token prompt:
    four groups a row, one chunk a 'model' rank of 4), its experts split
    over 'model' on (1, 4) (prefill exchanges the capacity rows by
    all-to-all, decode runs each rank's own experts) or their ff columns
    (6 experts on (1, 4), 3 on (2, 2)), which stay split at these sizes:
    every rank routes every row of its 'data' share; and with a 240-token
    prompt (6 experts on (1, 4)), where moving the rows and holding every
    row's capacity buffer costs more than gathering the ff columns
    (``moe._ff_bytes``), so prefill gathers them and each rank routes its
    own groups, while decode's few rows keep the columns split;
  * reduced mamba2 at d_model 48 on (1, 4), whose 6 heads do not divide
    'model' and whose head_dim does (the scan split over head_dim);
  * reduced jamba and granite-moe at batch 1 on (4, 1) and (2, 2), where
    'data' splits no rows (the MoE, the lookup and the head on their FSDP
    shards; jamba's attention cache on (4, 1) splits kv_seq over 'data');
  * reduced mamba2 with a 250-word vocabulary on (1, 4), whose tied head
    splits it over the 'model' axis that decode leaves idle.
"""
from __future__ import annotations

import pytest
from test_torch_serve_plan import CASES, _check, _ranks

from repro_torch.configs import ARCHS, reduced

MOE = "granite-moe-3b-a800m"
MOE_GROUP = 4  # the MoE's routing group in the MOE_CASES
MOE_CASES = [((1, 4), {}), ((1, 4), {"n_experts": 6}), ((2, 2), {"n_experts": 3})]
MOE_LONG = ((1, 4), {"n_experts": 6}, (240, 4, 244))  # ff columns gathered in prefill


def _ff_widths(ranks):
    """The expert weights' local ff widths that every rank's plan run saw."""
    return {w[2] for r in ranks for w in r[0]["ffn"]}


@pytest.mark.parametrize("shape,kw", MOE_CASES, ids=lambda c: str(c).replace(" ", ""))
def test_engine_moe_on_its_shards_matches_unsharded_and_jax(shape, kw):
    prompt, new, _ = cfg = CASES[MOE]
    ranks = _ranks(shape, [(MOE, cfg)], kw, MOE_GROUP)
    _check(ranks, 0, MOE, prompt, new, kw, MOE_GROUP)
    if kw:  # ff split: every call on the rank's columns, prefill's and decode's
        assert _ff_widths(ranks) == {reduced(ARCHS[MOE], **kw).d_ff // shape[1]}


def test_engine_moe_gathers_ff_columns_for_a_long_prompt():
    """6 experts on (1, 4) and a 240-token prompt: prefill gathers the ff
    columns (each rank runs its own 15 groups through whole experts), decode
    keeps them split."""
    shape, kw, (prompt, new, max_len) = MOE_LONG
    ranks = _ranks(shape, [(MOE, (prompt, new, max_len))], kw, MOE_GROUP)
    _check(ranks, 0, MOE, prompt, new, kw, MOE_GROUP)
    f = reduced(ARCHS[MOE], **kw).d_ff
    assert _ff_widths(ranks) == {f, f // shape[1]}


def test_engine_mamba_scans_over_head_dim_splits_matches_unsharded_and_jax():
    """Reduced mamba2 at d_model 48 on (1, 4): 6 heads of 16 do not divide
    'model', their head_dim does, so prefill scans each rank's 4 columns of
    every head, the final state lands in the cache's own head_dim split,
    and decode's recurrence runs on that split."""
    arch, kw = "mamba2-130m", {"d_model": 48}
    prompt, new, _ = cfg = CASES[arch]
    _check(_ranks((1, 4), [(arch, cfg)], kw), 0, arch, prompt, new, kw)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=str)
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "granite-moe-3b-a800m"])
def test_engine_at_batch_1_keeps_fsdp_weights_on_their_shards(arch, shape):
    """One prompt: 'data' splits no rows, so the residual stream is split
    over its D columns there, and the MoE, the embedding lookup and the
    head run on their weights' FSDP shards (the partial products summed
    over 'data') where the unsharded Engine and the JAX Engine run whole."""
    prompt, new, _ = cfg = CASES[arch]
    _check(_ranks(shape, [(arch, cfg)], batch=1), 0, arch, prompt, new, batch=1)


def test_engine_tied_head_splits_an_undivided_vocabulary_in_decode():
    """Reduced mamba2 with a 250-word vocabulary on (1, 4): 250 does not
    divide 'model', and decode's rows leave 'model' idle, so the tied head
    splits its vocabulary columns there (pieces of 63, the last 61) and
    the logits are gathered whole."""
    arch, kw = "mamba2-130m", {"vocab_size": 250}
    prompt, new, _ = cfg = CASES[arch]
    _check(_ranks((1, 4), [(arch, cfg)], kw), 0, arch, prompt, new, kw)
