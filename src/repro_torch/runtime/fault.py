"""Fault tolerance + straggler mitigation for the training loop.

Designed for thousands of nodes, exercised here with injected failures:

* ``Heartbeat``          — per-host liveness file; the coordinator treats a
                           stale heartbeat as node failure.
* ``StragglerMonitor``   — online mean/std of step times; a step slower than
                           mean + k*sigma is flagged; the mitigation hook
                           (e.g. shrink microbatch, skip host, re-shard) is
                           pluggable and its decisions are logged.
* ``run_with_restarts``  — crash-restart supervisor: runs the train loop,
                           restores from the latest checkpoint after a
                           failure, retries up to ``max_restarts``.  This is
                           the single-process analogue of a cluster
                           controller rescheduling a failed job.

The port's own copy of the JAX package's ``runtime/fault.py`` (it imports
neither JAX nor torch).
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable


class Heartbeat:
    def __init__(self, path: str | Path, host_id: int = 0):
        self.path = Path(path)
        self.host_id = host_id
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def beat(self, step: int):
        self.path.write_text(json.dumps({
            "host": self.host_id, "step": step, "time": time.time()}))

    def is_alive(self, timeout_s: float = 60.0) -> bool:
        if not self.path.exists():
            return False
        try:
            t = json.loads(self.path.read_text())["time"]
        except (json.JSONDecodeError, KeyError):
            return False
        return (time.time() - t) < timeout_s


@dataclass
class StragglerMonitor:
    """Welford-online step-time statistics with an outlier threshold."""

    k_sigma: float = 3.0
    min_samples: int = 8
    n: int = 0
    mean: float = 0.0
    m2: float = 0.0
    events: list[dict] = field(default_factory=list)

    def observe(self, step: int, dt_s: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if self.n >= self.min_samples:
            std = math.sqrt(self.m2 / max(self.n - 1, 1))
            if dt_s > self.mean + self.k_sigma * max(std, 1e-9):
                is_straggler = True
                self.events.append({"step": step, "dt_s": dt_s,
                                    "mean_s": self.mean, "std_s": std})
        # update stats (stragglers excluded so one hiccup doesn't poison the
        # baseline)
        if not is_straggler:
            self.n += 1
            d = dt_s - self.mean
            self.mean += d / self.n
            self.m2 += d * (dt_s - self.mean)
        return is_straggler


@dataclass
class RestartReport:
    completed_steps: int
    restarts: int
    failures: list[str]


def run_with_restarts(make_loop: Callable[[int], int], *, target_step: int,
                      max_restarts: int = 3) -> RestartReport:
    """Supervise ``make_loop(start_step) -> reached_step`` until it reaches
    ``target_step``, restarting from the last checkpoint on failure.

    ``make_loop`` is expected to restore its own state from the checkpoint
    directory (the same path a real cluster controller would hand a
    rescheduled worker)."""
    restarts = 0
    failures: list[str] = []
    step = 0
    while step < target_step:
        try:
            step = make_loop(step)
        except Exception as e:  # noqa: BLE001 — injected/real failures
            failures.append(f"{type(e).__name__}: {e}")
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded {max_restarts} restarts; failures: {failures}") from e
    return RestartReport(step, restarts, failures)
