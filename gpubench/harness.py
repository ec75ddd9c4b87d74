"""What every cell shares: finding a cell's files by name, the run's
context, the result line and the checks printed beside it.

A cell is ``workloads/<cell>.json`` (its configuration, traffic mix,
chips, why and the limits of its checks).  Its configuration is
``configs/<config>.json`` (the published source, what the port runs, the
family of its plain reference, ``reference/<family>.py``); its traffic mix
is ``traffic/<mix>.json``, whose ``kind`` names the driver that runs it,
``drivers/<kind>.py``.  ``BENCHMARK.json`` says which end-to-end and
per-layer metrics a cell reports; a per-layer metric is read by
``metrics/<metric>.py``.  Adding any of them adds files and entries and
edits none.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def _named(kind: str, name: str, suffix: str) -> Path:
    path = BENCH / kind / f"{name}{suffix}"
    if not path.is_file():
        known = sorted(p.name.removesuffix(suffix) for p in (BENCH / kind).glob(f"*{suffix}"))
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r}; "
                       f"known: {known}")
    return path


def load_module(path: Path) -> ModuleType:
    """A file of the benchmark as a module of its own (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"gpubench._{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    return read_json(_named("workloads", name, ".json"))


def config(name: str) -> dict:
    return read_json(_named("configs", name, ".json"))


def traffic(name: str) -> dict:
    return read_json(_named("traffic", name, ".json"))


def driver(kind: str) -> ModuleType:
    return load_module(_named("drivers", kind, ".py"))


def reference(family: str) -> ModuleType:
    return importlib.import_module(f"gpubench.reference.{family}")


def metric(name: str) -> ModuleType:
    return load_module(_named("metrics", name, ".py"))


def _reports(entry: dict, cell_name: str) -> bool:
    return "workloads" not in entry or cell_name in entry["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if _reports(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    moved = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


@dataclass
class Context:
    """One run of one cell: what a driver and a metric reader are given."""
    cell_name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float                      # process start, on time.perf_counter
    arch: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)   # what the driver measured for the readers
    ranges: dict = field(default_factory=dict)  # {label: "module:attr"} the traced run opens

    @property
    def dtype(self) -> str:
        return self.config["dtype"]

    @property
    def limits(self) -> dict:
        return self.cell["limits"]

    def reference_cfg(self) -> dict:
        """The configuration as the plain reference reads it."""
        return {**self.arch, **self.config.get("model", {})}


def context(cell_name: str, seed: int, seconds: float, trace: bool, device: str,
            t0: float, overrides: dict | None = None) -> Context:
    """``overrides``: {"arch": {...}, "traffic": {...}} laid over the files'
    (the tests' small shapes on the CPU)."""
    c = cell(cell_name)
    cfg = config(c["config"])
    over = overrides or {}
    for target, want in cfg.get("program_constants", {}).items():
        mod_name, attr = target.split(":")
        got = getattr(importlib.import_module(mod_name), attr)
        if got != want:
            raise ValueError(f"the program's {target} is {got!r} where the configuration "
                             f"{c['config']} states {want!r}")
    return Context(cell_name, c, cfg, {**traffic(c["traffic"]), **over.get("traffic", {})}, seed,
                   seconds, trace, device, t0, arch={**cfg["arch"], **over.get("arch", {})})


@dataclass
class Outcome:
    """What a driver hands back."""
    end_to_end: dict[str, float]
    attempted: int
    failed: int
    checks: list[tuple[str, float, float]]   # (name, value, limit): correct if value <= limit
    memory_peak_bytes: int
    view: Any = None                         # trace.TraceView of the traced run


def correct(out: Outcome) -> bool:
    return (out.attempted > 0 and out.failed == 0 and bool(out.checks)
            and all(math.isfinite(v) and v <= lim for _, v, lim in out.checks))


def result(ctx: Context, out: Outcome, device_name: str, bench: dict) -> dict:
    """The result line: the cell's end-to-end metrics (``--trace 0``) or its
    per-layer metrics (``--trace 1``), a reader that finds nothing to read
    leaving its metric out; the checks last."""
    metrics: dict[str, dict] = {}
    if not ctx.trace:
        for m in end_to_end(bench, ctx.cell_name):
            if m["name"] in out.end_to_end:
                metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    else:
        for m in per_layer(bench, ctx.cell_name):
            value = metric(m["name"]).read(ctx, out.view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": ctx.cell["chips"],
              "memory_peak_bytes": out.memory_peak_bytes}
    line: dict[str, Any] = {"correct": correct(out), "attempted": out.attempted,
                            "failed": out.failed, "metrics": metrics, "device": device}
    if ctx.trace:
        device["busy_s"] = out.view.busy_s
        device["window_s"] = out.view.window_s
        line["breakdown"] = out.view.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out.checks}
    return line


def ranges_for(bench: dict, cell_name: str) -> dict[str, str]:
    """The layer ranges the cell's per-layer metrics read."""
    out: dict[str, str] = {}
    for m in per_layer(bench, cell_name):
        out.update(getattr(metric(m["name"]), "RANGES", {}))
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({n for n in sys.modules if n.split(".", 1)[0] in FORBIDDEN})


def run(cell_name: str, seed: int, seconds: float, trace: bool, device: str, t0: float,
        device_name: str, overrides: dict | None = None) -> dict:
    bench = benchmark()
    ctx = context(cell_name, seed, seconds, trace, device, t0, overrides)
    if trace:
        ctx.ranges = ranges_for(bench, cell_name)
    out = driver(ctx.traffic["kind"]).run(ctx)
    return result(ctx, out, device_name, bench)
