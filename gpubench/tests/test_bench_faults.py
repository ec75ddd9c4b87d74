"""A whole run, its look for a card skipped, at reduced sizes on the CPU:
sound, it comes out correct; with the timed path broken underneath, not.
The faults a one-card cell can have: a train step that returns its state
unchanged, half of each batch left out (the mean over the rest), a served
token altered where it is produced."""
import time

import pytest
import torch

from gpubench import harness
from gpubench.tests.conftest import SMALL

TRAIN = {"mamba2-130m": "mamba2-130m.train.b4s4096",
         "granite-moe-3b-a800m": "granite-moe-3b-a800m.train.b4s1024"}
SERVE = {"mamba2-130m": "mamba2-130m.serve.p4096n4",
         "granite-moe-3b-a800m": "granite-moe-3b-a800m.serve.p1024n4"}


def run(cell: str, config: str) -> dict:
    traffic = {"batch": 2, "seq": 64} if "train" in cell else \
        {"batch": 2, "prompt_len": 64, "checked_batches": 3, "warm_batches": 1,
         "check_share": 1.0}
    return harness.run(cell, 2**31 + 77, 0.3, False, "cpu", time.perf_counter(), "cpu",
                       {"arch": SMALL[config], "traffic": traffic})


@pytest.mark.parametrize("config", sorted(TRAIN))
def test_sound_runs_are_correct(config):
    for cell in (TRAIN[config], SERVE[config]):
        line = run(cell, config)
        assert line["correct"] and line["attempted"] > 0, line
        assert list(line)[-1] == "checks"


@pytest.mark.parametrize("config", sorted(TRAIN))
def test_a_state_left_unchanged_fails(config, monkeypatch):
    from repro_torch.train import optimizer

    def unchanged(state, grads, cfg):
        return state, {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}

    monkeypatch.setattr(optimizer, "apply_updates", unchanged)
    line = run(TRAIN[config], config)
    assert not line["correct"]
    # the worst leaf reads 1, the median leaf at least half of that
    change = [c["value"] for k, c in line["checks"].items() if k.startswith("change_gap")]
    assert change and all(v > 0.5 for v in change)


@pytest.mark.parametrize("config", sorted(TRAIN))
def test_half_the_batch_left_out_fails(config, monkeypatch):
    from repro_torch.train import train_step
    to_device = train_step.to_device

    def half(batch, device):
        return {k: v[: v.shape[0] // 2] for k, v in to_device(batch, device).items()}

    monkeypatch.setattr(train_step, "to_device", half)
    line = run(TRAIN[config], config)
    assert not line["correct"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("config", sorted(SERVE))
def test_a_token_altered_where_it_is_produced_fails(config, monkeypatch):
    """The sampler serves token 0 where the model's own logits, left as they
    are, put another first: the reference, which reads the served tokens to
    judge them, agrees with the logits that follow; the greedy count sees it."""
    from repro_torch.serve import engine
    whole = engine._whole

    def first_is_zero(logits):
        logits = whole(logits).clone()
        logits[:, 0] = logits.amax(dim=-1) + 1.0
        return logits

    monkeypatch.setattr(engine, "_whole", first_is_zero)
    line = run(SERVE[config], config)
    assert not line["correct"]
    assert line["checks"]["greedy_miss"]["value"] > 0
    # the logits agree with the reference's: only the token is wrong
    assert all(c["value"] <= c["limit"] for k, c in line["checks"].items()
               if k.startswith("logit_err")), line["checks"]
