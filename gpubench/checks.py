"""The numbers that decide ``correct``, each compared with its limit.

Training: each checked step's loss (and the first step's alone), the first
gradient as the optimizer got it (per leaf, from its first moment after one
step) and the change of the parameters over the checked steps (per leaf).
A leaf's number is the gap between the program's norm and the reference's,
over the reference's norm of that leaf or of the median leaf, whichever is
larger; the worst leaf counts, and the median leaf too.
A leaf whose reference gradient is under ``FLAT`` of the median leaf's
moves by round-off alone, and its change is not compared.

Serving: at each served position of the sampled requests, the gap by which
the served token's reference logit lies below the reference's best (the
widest, and the 90th percentile), and the largest difference between the
program's logits and the reference's (the widest position, and the median
one); each over the root mean square of the reference's logits at that
position.  The reference reads the served tokens to judge them, so a wrong
token moves none of these where the logits that follow it agree: the
served tokens that lie below the best of the program's own logits at their
position are counted apart (``greedy_miss``, limit 0: the traffic is
greedy), and with ``logit_err`` against the reference that covers the
sampler.

A cell's limits name the numbers it compares.
"""
from __future__ import annotations

import json
import statistics
import sys


FLAT = 1e-3


def worst_leaf(prog: list[float], ref: list[float], keep: list[bool] | None = None) -> float:
    med = statistics.median(ref)
    keep = keep or [True] * len(ref)
    return max(abs(p - r) / max(r, med, 1e-30) for p, r, k in zip(prog, ref, keep) if k)


def median_leaf(prog: list[float], ref: list[float], keep: list[bool]) -> float:
    med = statistics.median(ref)
    return statistics.median(abs(p - r) / max(r, med, 1e-30)
                             for p, r, k in zip(prog, ref, keep) if k)


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """prog, ref: {"losses": [...], "grad_norms": [...], "change_norms": [...]}."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    med = statistics.median(ref["grad_norms"])
    moving = [g >= FLAT * med for g in ref["grad_norms"]]
    first = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    return {"loss_gap": loss, "loss1_gap": first,
            "grad_norm_gap": worst_leaf(prog["grad_norms"], ref["grad_norms"]),
            "grad_norm_gap_p50": median_leaf(prog["grad_norms"], ref["grad_norms"],
                                             [True] * len(moving)),
            "change_gap": worst_leaf(prog["change_norms"], ref["change_norms"], moving),
            "change_gap_p50": median_leaf(prog["change_norms"], ref["change_norms"], moving)}


def serve_numbers(prog_logits, ref_logits, served) -> dict[str, float]:
    """prog_logits, ref_logits: (R, P + 1, V) at the positions that produced
    the P served tokens (R, P) and the one after the last."""
    ref = ref_logits.double()
    rms = ref.square().mean(dim=-1).sqrt()                            # (R, P + 1)
    p = served.shape[1]
    best = ref[:, :p].amax(dim=-1)
    got = ref[:, :p].gather(-1, served[..., None].long())[..., 0]
    gap = (best - got) / rms[:, :p]                                   # (R, P)
    err = (prog_logits.double() - ref).abs().amax(dim=-1) / rms       # (R, P + 1)
    own = prog_logits[:, :p]
    miss = own.gather(-1, served[..., None].long())[..., 0] < own.amax(dim=-1)
    return {"token_gap": float(gap.max()), "token_gap_p90": float(gap.flatten().quantile(0.9)),
            "logit_err": float(err.max()), "logit_err_p50": float(err.flatten().median()),
            "greedy_miss": float(miss.sum()), "tokens_checked": float(served.numel())}


def judged(numbers: dict[str, float], limits: dict[str, float]) -> list[tuple[str, float, float]]:
    """The numbers the cell's limits name, each beside its limit; every
    number read goes to standard error first."""
    print("numbers " + json.dumps(numbers), file=sys.stderr)
    return [(name, numbers[name], limits[name]) for name in limits]
