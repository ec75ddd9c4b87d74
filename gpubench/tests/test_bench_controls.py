"""On the card: each cell's control (the plain reference in TF32, the
precision below the configuration's float32), where its file does not say
it lies inside the reference's own rounding, and the planted faults fail
the cell's limits, at full widths and depth on a smaller batch (granite's
numbers, set at full depth, need its 32 layers).  Run by path on a card:
``python3 -m pytest -q -m cuda gpubench/tests/test_bench_controls.py``."""
import pytest

from gpubench import controls, harness

SIZES = {"train_loop": {"batch": 2, "seq": 1024},
         "serve_batches": {"batch": 2, "prompt_len": 512, "checked_batches": 4,
                           "warm_batches": 1, "check_share": 1.0}}


def fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > v for k, v in limits.items() if k in numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark()["workloads"]])
def test_controls_and_faults_fail(cell, card):
    c = harness.cell(cell)
    kind = harness.traffic(c["traffic"])["kind"]
    got = controls.readings(cell, 2**31 + 5, 2.0, "cuda",
                            {"traffic": SIZES[kind]})
    # the control fails a number, unless the cell's file says that at its
    # size the control lies inside the reference's own rounding (PERF.md);
    # each planted fault fails a number
    planted = ["half_batch", "state_unchanged", "token_altered"]
    for name in planted + (["control"] if c.get("control_separated", True) else []):
        if name in got:
            assert fails(got[name], c["limits"]), (name, got[name], c["limits"])
    if "program" in got:
        assert not fails(got["program"], c["limits"]), got["program"]
