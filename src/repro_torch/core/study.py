"""The Study API: one declarative, serializable front door for the DSE stack.

A ``StudySpec`` is a frozen, JSON-round-trippable description of a whole
co-design experiment: (model x system x scenario x searched stacks x
objective x agent grid x seeds x budget).  Everything resolves through
first-class registries — ``configs.ARCHS`` for the model,
``core.systems.SYSTEM_REGISTRY`` for the target system,
``core.scenario.SCENARIO_REGISTRY`` for the workload shape, and
``core.rewards.OBJECTIVES`` for the reward — and is validated at spec
construction, not deep inside a search.

``run_study`` executes the spec's (agent x seed) grid as ONE campaign:

  * one shared ``eval_store`` across every cell — a design point any cell
    already evaluated is free for the rest;
  * one reusable process pool (``workers > 1``) held open across cells;
  * per-cell ``SearchResult``s streamed to a JSONL results file stamped
    with the spec hash and git metadata as each cell finishes;
  * ``resume=True`` skips cells the results file already holds, so a
    killed campaign finishes from where it stopped without re-evaluating.

The CLI lives in ``repro_torch.dse``:  ``python -m repro_torch.dse run study.json``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Mapping

from repro_torch.core.agents.base import AGENT_HYPER, KNOWN_AGENTS
from repro_torch.core.backends import BACKEND_REGISTRY
from repro_torch.core.dse import SearchResult, run_search
from repro_torch.core.psa import ParameterSet, paper_psa
from repro_torch.core.rewards import Evaluation, get_objective
from repro_torch.core.scenario import Scenario, build_scenario, scenario_psa
from repro_torch.core.systems import get_system


def _freeze(v: Any) -> Any:
    """JSON values -> canonical immutable-ish form (lists become tuples,
    dicts are copied) so two specs built from JSON and from Python literals
    compare equal."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, Mapping):
        return {k: _freeze(x) for k, x in v.items()}
    return v


def _thaw(v: Any) -> Any:
    """The inverse direction for JSON dumping: tuples -> lists."""
    if isinstance(v, tuple):
        return [_thaw(x) for x in v]
    if isinstance(v, Mapping):
        return {k: _thaw(x) for k, x in v.items()}
    return v


@dataclass(frozen=True)
class AgentSpec:
    """One column of the agent grid: an agent kind, an optional per-agent
    step budget (e.g. BO's cubic GP cost wants a smaller one), and agent
    hyperparameters (stored as sorted pairs so the spec stays frozen)."""
    kind: str
    steps: int | None = None
    hyper: tuple = ()

    def __post_init__(self):
        if self.kind not in KNOWN_AGENTS:
            raise ValueError(f"unknown agent kind {self.kind!r}; "
                             f"known: {sorted(KNOWN_AGENTS)}")
        if isinstance(self.hyper, Mapping):
            object.__setattr__(self, "hyper",
                               tuple(sorted(self.hyper.items())))
        else:
            object.__setattr__(self, "hyper",
                               tuple(sorted(tuple(kv) for kv in self.hyper)))
        bad = sorted(set(k for k, _ in self.hyper) - AGENT_HYPER[self.kind])
        if bad:
            raise ValueError(
                f"unknown hyper {bad} for agent kind {self.kind!r}; "
                f"known: {sorted(AGENT_HYPER[self.kind])} — a typo here "
                f"would otherwise TypeError a cell deep into the campaign")

    @classmethod
    def coerce(cls, v: "str | Mapping | AgentSpec") -> "AgentSpec":
        if isinstance(v, AgentSpec):
            return v
        if isinstance(v, str):
            return cls(v)
        v = dict(v)
        unknown = sorted(v.keys() - {"kind", "steps", "hyper"})
        if unknown:
            raise ValueError(f"unknown agent-spec keys {unknown}; "
                             f"known: ['kind', 'steps', 'hyper']")
        return cls(kind=v["kind"], steps=v.get("steps"),
                   hyper=v.get("hyper") or ())

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"kind": self.kind}
        if self.steps is not None:
            out["steps"] = self.steps
        if self.hyper:
            out["hyper"] = {k: _thaw(v) for k, v in self.hyper}
        return out


_SPEC_DEFAULT_CAPACITY_GB = 24.0


@dataclass(frozen=True)
class StudySpec:
    """A whole DSE experiment as data.

    Every name resolves through a registry (arch / system / scenario /
    objective) and the spec validates itself — including building the
    scenario and checking streaming-objective compatibility — at
    construction, so a bad study fails before any search runs.

    ``scenario_params`` are the registered scenario's constructor params
    (JSON-shaped; for ``"train"``, ``batch`` defaults to 1024 and ``seq``
    to the arch's max_seq, mirroring the old hand-assembly).  ``stacks``
    restricts the searched stacks, pinning the rest to the system preset's
    Table-3 defaults; ``psa_overrides`` pin individual parameters on top.
    """
    name: str
    arch: str
    system: str
    scenario: str = "train"
    scenario_params: Mapping[str, Any] = field(default_factory=dict)
    stacks: tuple | None = None          # None = full stack
    psa_overrides: Mapping[str, Any] = field(default_factory=dict)
    objective: str = "perf_per_bw"
    agents: tuple = (AgentSpec("ga"),)
    seeds: tuple = (0,)
    steps: int = 500
    batch_size: int = 32
    workers: int = 0
    max_pp: int = 4
    capacity_gb: float = _SPEC_DEFAULT_CAPACITY_GB
    # simulation backend every cell's evaluations run on (registry name
    # from ``repro_torch.core.backends``; part of the spec hash — a vectorized
    # backend's results may differ within tolerance from the reference's)
    backend: str = "reference"
    # optional cross-campaign persistent eval store (JSONL): memoized
    # evaluations preload from here and fresh ones append back, so
    # successive studies over the same (arch x system x scenario x
    # objective x backend) stop re-evaluating known design points.
    # Hash-exempt like ``workers`` — reuse never changes results.
    eval_store_path: "str | None" = None

    def __post_init__(self):
        set_ = object.__setattr__
        set_(self, "scenario_params", _freeze(dict(self.scenario_params)))
        set_(self, "psa_overrides", _freeze(dict(self.psa_overrides)))
        set_(self, "agents",
             tuple(AgentSpec.coerce(a) for a in self.agents))
        set_(self, "seeds", tuple(int(s) for s in self.seeds))
        if self.stacks is not None:
            set_(self, "stacks", tuple(self.stacks))
        self.validate()

    # -- validation (spec time, not search time) -------------------------
    def validate(self) -> None:
        from repro_torch.configs import ARCHS

        if self.arch not in ARCHS:
            raise ValueError(f"unknown arch {self.arch!r}; "
                             f"known: {sorted(ARCHS)}")
        get_system(self.system)           # raises on an unknown preset
        obj = get_objective(self.objective)
        sc = self.build_scenario()        # raises on bad kind/params
        if obj.streaming and not getattr(sc, "supports_stream_objectives",
                                         False):
            raise ValueError(
                f"objective {obj.name!r} needs a streaming scenario "
                f"(per-request metrics); scenario {self.scenario!r} only "
                f"supports scalar objectives")
        if self.backend not in BACKEND_REGISTRY:
            raise ValueError(f"unknown simulation backend {self.backend!r}; "
                             f"known: {sorted(BACKEND_REGISTRY)}")
        if not self.agents:
            raise ValueError("agents grid is empty")
        if not self.seeds:
            raise ValueError("seeds grid is empty")
        if self.steps < 1 or self.batch_size < 1:
            raise ValueError(f"steps ({self.steps}) and batch_size "
                             f"({self.batch_size}) must be >= 1")
        if self.stacks is not None:
            known = {"workload", "collective", "network", "compute",
                     "scenario"}
            bad = set(self.stacks) - known
            if bad:
                raise ValueError(f"unknown stacks {sorted(bad)}; "
                                 f"known: {sorted(known)}")
        self.build_pset()                 # raises on bad psa_overrides

    # -- JSON round trip -------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name, "arch": self.arch, "system": self.system,
            "scenario": self.scenario,
            "scenario_params": _thaw(self.scenario_params),
            "stacks": list(self.stacks) if self.stacks is not None else None,
            "psa_overrides": _thaw(self.psa_overrides),
            "objective": self.objective,
            "agents": [a.to_dict() for a in self.agents],
            "seeds": list(self.seeds), "steps": self.steps,
            "batch_size": self.batch_size, "workers": self.workers,
            "max_pp": self.max_pp, "capacity_gb": self.capacity_gb,
            "backend": self.backend,
            "eval_store_path": self.eval_store_path,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "StudySpec":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown StudySpec keys {unknown}; "
                             f"known: {sorted(known)}")
        if d.get("stacks") is not None:
            d["stacks"] = tuple(d["stacks"])
        return cls(**d)

    def to_json(self, path: "str | Path | None" = None) -> str:
        text = json.dumps(self.to_dict(), indent=2, sort_keys=True)
        if path is not None:
            Path(path).write_text(text + "\n")
        return text

    @classmethod
    def from_json(cls, source: "str | Path") -> "StudySpec":
        """Load from a JSON string or a file path."""
        text = str(source)
        if not text.lstrip().startswith("{"):
            text = Path(source).read_text()
        return cls.from_dict(json.loads(text))

    def spec_hash(self) -> str:
        """Stable content hash of the canonical JSON form — stamps results
        so a JSONL file can't silently mix campaigns.  ``workers`` is
        excluded: it only parallelizes evaluation (results are bit-identical
        across the pool path), so a killed campaign may legitimately resume
        with a different pool size.  ``eval_store_path`` is excluded for the
        same reason — memo reuse never changes results.  ``backend`` IS
        hashed: backends may differ within tolerance."""
        d = self.to_dict()
        del d["workers"]
        del d["eval_store_path"]
        if d["backend"] == "reference":
            # drop the default so campaigns recorded before the backend
            # field existed (hashes computed without the key) stay
            # resumable; a non-default backend changes results and hashes
            del d["backend"]
        canon = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()[:16]

    def eval_signature(self) -> str:
        """Hash of the evaluation-relevant spec subset: two studies sharing
        it produce identical ``Evaluation``s for identical configs, so their
        persistent eval-store entries are interchangeable.  Search-shaping
        fields (agents/seeds/steps/stacks/overrides/budgets) only change
        WHICH points are visited, not their values."""
        d = {"arch": self.arch, "system": self.system,
             "scenario": self.scenario,
             "scenario_params": _thaw(self.scenario_params),
             "objective": self.objective, "capacity_gb": self.capacity_gb,
             "backend": self.backend}
        canon = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()[:16]

    # -- resolution through the registries -------------------------------
    def build_scenario(self) -> Scenario:
        from repro_torch.configs import ARCHS

        params = dict(self.scenario_params)
        if self.scenario == "train":
            params.setdefault("batch", 1024)
            params.setdefault("seq", ARCHS[self.arch].max_seq)
        return build_scenario(self.scenario, params)

    def build_pset(self) -> ParameterSet:
        preset = get_system(self.system)
        ps = paper_psa(preset.n_npus, max_pp=self.max_pp)
        if self.stacks is not None:
            ps = ps.restrict(set(self.stacks), preset.stack_defaults())
        ps = scenario_psa(ps, self.build_scenario(), preset.n_npus)
        if self.psa_overrides:
            ps = ps.pin(dict(self.psa_overrides))
        return ps

    def build_env(self, eval_store: dict | None = None,
                  sim_device: str | None = None):
        from repro_torch.configs import ARCHS
        from repro_torch.core.env import CosmicEnv

        preset = get_system(self.system)
        return CosmicEnv(spec=ARCHS[self.arch], n_npus=preset.n_npus,
                         device=preset.device,
                         scenario=self.build_scenario(),
                         objective=self.objective,
                         capacity_gb=self.capacity_gb,
                         backend=self.backend,
                         eval_store=eval_store, sim_device=sim_device)

    # -- the campaign grid ------------------------------------------------
    def cells(self) -> list[tuple[str, AgentSpec, int]]:
        """The (agent x seed) grid as ``(cell_id, agent, seed)`` rows.  The
        id embeds the grid position, so duplicate (agent, seed) columns stay
        distinct cells."""
        out = []
        for ai, aspec in enumerate(self.agents):
            for seed in self.seeds:
                out.append((f"{ai}:{aspec.kind}:s{seed}", aspec, seed))
        return out


# ---------------------------------------------------------------------------
# Persistent (cross-campaign) eval store
# ---------------------------------------------------------------------------

def _json_default(o: Any) -> Any:
    """Detail dicts occasionally carry numpy scalars; coerce or stringify."""
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


def iter_jsonl_lenient(path: Path):
    """Yield parsed records from a JSONL file, skipping blank and malformed
    lines (a campaign killed mid-append leaves a torn tail).  The lenient
    reader for cache/inspection surfaces — resume's strict reader
    (``_read_results``) keeps its own corruption handling."""
    for line in path.read_text().splitlines():
        if not line.strip():
            continue
        try:
            yield json.loads(line)
        except json.JSONDecodeError:
            continue


class PersistentEvalStore:
    """A JSONL file of memoized (config -> Evaluation) pairs shared across
    campaigns.  Entries are stamped with the owning study's
    ``eval_signature()`` so one file can serve many studies without ever
    cross-hitting incompatible ones; malformed lines (a campaign killed
    mid-append) are skipped — this is a cache, not a ledger."""

    def __init__(self, path: "str | Path", signature: str) -> None:
        self.path = Path(path)
        self.signature = signature
        self.entries: list[tuple[dict, Evaluation]] = []
        self._known: set[str] = set()
        self._pending: list[str] = []
        if self.path.exists():
            for rec in iter_jsonl_lenient(self.path):
                if rec.get("sig") != signature:
                    continue
                config = rec.get("config")
                if not isinstance(config, dict) or "reward" not in rec:
                    continue
                self._known.add(self._canon(config))
                self.entries.append((config, Evaluation(
                    rec["reward"], rec["latency_ms"], rec["valid"],
                    rec.get("detail") or {})))

    @staticmethod
    def _canon(config: Mapping[str, Any]) -> str:
        return json.dumps(_thaw(dict(config)), sort_keys=True,
                          separators=(",", ":"), default=_json_default)

    def preload(self, env) -> int:
        """Install every matching entry into ``env.eval_store`` (keyed
        through the env's own canonicalization) and hook ``env.eval_record``
        so fresh evaluations queue for ``flush()``."""
        assert env.eval_store is not None, "env needs a shared eval_store"
        for config, ev in self.entries:
            cfg = {k: _freeze(v) for k, v in config.items()}
            env.eval_store[env._point_key(cfg)] = ev
        env.eval_record = self.record
        return len(self.entries)

    def record(self, config: Mapping[str, Any], ev: Evaluation) -> None:
        canon = self._canon(config)
        if canon in self._known:
            return
        self._known.add(canon)
        self._pending.append(json.dumps(
            {"sig": self.signature, "config": _thaw(dict(config)),
             "reward": ev.reward, "latency_ms": ev.latency_ms,
             "valid": ev.valid, "detail": _thaw(ev.detail)},
            default=_json_default))

    def flush(self) -> int:
        """Append queued fresh evaluations; returns how many were written."""
        if not self._pending:
            return 0
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self.path.open("a") as f:
            for line in self._pending:
                f.write(line + "\n")
        n = len(self._pending)
        self._pending = []
        return n


# ---------------------------------------------------------------------------
# Campaign execution
# ---------------------------------------------------------------------------

@dataclass
class CellOutcome:
    cell_id: str
    agent: str
    seed: int
    result: SearchResult
    store_hits: int = 0
    store_misses: int = 0
    resumed: bool = False


@dataclass
class StudyResult:
    spec: StudySpec
    outcomes: list[CellOutcome]
    store_hits: int
    store_misses: int
    distinct_points: int
    out: Path | None
    wall_s: float
    # persistent eval store accounting (spec.eval_store_path): entries
    # preloaded from disk, and fresh ones appended back after the campaign
    store_preloaded: int = 0
    store_persisted: int = 0

    @property
    def store_hit_rate(self) -> float:
        return self.store_hits / max(self.store_hits + self.store_misses, 1)

    @property
    def cells_run(self) -> int:
        return sum(not o.resumed for o in self.outcomes)

    @property
    def cells_skipped(self) -> int:
        return sum(o.resumed for o in self.outcomes)

    def best(self) -> CellOutcome | None:
        done = [o for o in self.outcomes if o.result.best_config is not None]
        return max(done, key=lambda o: o.result.best_reward) if done else None


def git_metadata() -> dict[str, Any]:
    """Best-effort provenance for the results file; {} outside a checkout."""
    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=10)
        if rev.returncode != 0:
            return {}
        dirty = subprocess.run(["git", "status", "--porcelain"],
                               capture_output=True, text=True, timeout=10)
        return {"commit": rev.stdout.strip(),
                "dirty": bool(dirty.stdout.strip())}
    except (OSError, subprocess.SubprocessError):
        return {}


def _read_results(path: Path, spec_hash: str) -> dict[str, dict]:
    """Completed cell records keyed by cell_id.  A results file written for
    a DIFFERENT spec is an error — resuming must never mix campaigns.

    A campaign killed mid-append (the exact case resume exists for) can
    leave a truncated final line: that line is discarded — and trimmed off
    the file so appended records don't concatenate onto it — and its cell
    simply re-runs.  A malformed line anywhere else is corruption and
    raises."""
    lines = path.read_text().splitlines()
    done: dict[str, dict] = {}
    valid: list[str] = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                path.write_text("\n".join(valid) + "\n" if valid else "")
                break
            raise ValueError(f"{path} line {i + 1} is not valid JSON (and "
                             f"is not a truncated final line)") from None
        valid.append(line)
        if rec.get("spec_hash") != spec_hash:
            raise ValueError(
                f"{path} holds results for spec_hash "
                f"{rec.get('spec_hash')!r}, not {spec_hash!r} — refusing to "
                f"resume a different study into it")
        if rec.get("record") == "cell":
            if "cell_id" not in rec:
                raise ValueError(f"{path} line {i + 1}: cell record has no "
                                 f"cell_id — corrupt results file")
            done[rec["cell_id"]] = rec
    return done


def _result_from_record(rec: dict) -> SearchResult:
    result = rec.get("result")
    if not isinstance(result, dict):
        raise ValueError(
            f"cell record {rec.get('cell_id')!r} has no result payload — "
            f"corrupt results file")
    r = dict(result)
    if r.get("best_config") is not None:
        # JSON turned the config's tuples (coll_algo, topology, ...) into
        # lists; re-freeze so a resumed best_config round-trips through the
        # hashable memo/eval_store paths like a live one
        r["best_config"] = {k: _freeze(v) for k, v in r["best_config"].items()}
    known = {f.name for f in dataclasses.fields(SearchResult)}
    return SearchResult(**{k: v for k, v in r.items() if k in known})


def run_study(spec: StudySpec, *, out: "str | Path | None" = None,
              resume: bool = False,
              log: Callable[[str], None] | None = None,
              sim_device: str | None = None) -> StudyResult:
    """Execute a ``StudySpec``'s (agent x seed) grid as one campaign.

    All cells share one ``eval_store`` (design points an earlier cell
    evaluated are free) and — when ``spec.workers > 1`` — one process pool.
    With ``out`` set, each finished cell is appended to the JSONL results
    file immediately; ``resume=True`` then skips cells already on disk
    (after checking the file's spec hash matches) and re-runs only the
    rest.  ``sim_device`` is where a torch backend runs (default: the
    card); it is no part of the spec or its hash."""
    say = log or (lambda s: None)
    out_path = Path(out) if out is not None else None
    if resume and out_path is None:
        raise ValueError("resume=True needs a results file (out=...)")
    spec_hash = spec.spec_hash()

    done: dict[str, dict] = {}
    if out_path is not None and out_path.exists():
        if not resume:
            raise ValueError(
                f"results file {out_path} already exists — pass resume=True "
                f"(--resume) to continue that campaign, or delete it / "
                f"choose another out path to start fresh")
        done = _read_results(out_path, spec_hash)

    pset = spec.build_pset()
    store: dict = {}
    env = spec.build_env(eval_store=store, sim_device=sim_device)
    persist: PersistentEvalStore | None = None
    preloaded = 0
    if spec.eval_store_path:
        persist = PersistentEvalStore(spec.eval_store_path,
                                      spec.eval_signature())
        preloaded = persist.preload(env)
        say(f"eval store {persist.path}: preloaded {preloaded} "
            f"evaluation(s) [{persist.signature}]")
    # warm-start corpus for surrogate agents: built ONCE per campaign from
    # the store's in-memory entries (the JSONL was already read exactly
    # once, in the PersistentEvalStore constructor) and shared by every
    # cell — so all cells see the same corpus regardless of cell order,
    # and no cell re-reads the file
    warm_records = [
        ({k: _freeze(v) for k, v in cfg.items()}, ev.reward)
        for cfg, ev in persist.entries] if persist is not None else []
    outcomes: list[CellOutcome] = []
    persisted = 0
    t0 = time.time()

    writer = None
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        # an existing-but-empty file (touched, or fully torn-trimmed) has no
        # header yet — treat it as fresh or the resumed file never gets one
        fresh = not (resume and out_path.exists()
                     and out_path.stat().st_size > 0)
        writer = out_path.open("w" if fresh else "a")
        if fresh:
            header = {"record": "study", "name": spec.name,
                      "spec_hash": spec_hash, "spec": spec.to_dict(),
                      "git": git_metadata(), "created_unix": time.time()}
            writer.write(json.dumps(header) + "\n")
            writer.flush()

    try:
        with env:
            for cell_id, aspec, seed in spec.cells():
                if cell_id in done:
                    rec = done[cell_id]
                    outcomes.append(CellOutcome(
                        cell_id, aspec.kind, seed,
                        _result_from_record(rec),
                        store_hits=rec.get("store_hits", 0),
                        store_misses=rec.get("store_misses", 0),
                        resumed=True))
                    say(f"cell {cell_id}: complete in results file, skipped")
                    continue
                h0, m0 = env.store_hits, env.store_misses
                env.history.clear()   # bound campaign memory; best is in res
                # fail-fast gate: statically verify a probe design point's
                # scheduling plan before the search burns steps on a space
                # whose every trace would hang or crash the simulator
                # (verdicts are memoized per trace — ~free on shared plans)
                from repro_torch.core.analysis import preflight
                rep = preflight(env, pset, seed=seed)
                if rep is not None:
                    rep.raise_if_issues()
                res = run_search(pset, env, aspec.kind,
                                 steps=aspec.steps or spec.steps, seed=seed,
                                 batch_size=spec.batch_size,
                                 workers=spec.workers,
                                 warm_start=warm_records,
                                 **dict(aspec.hyper))
                cell = CellOutcome(cell_id, aspec.kind, seed, res,
                                   store_hits=env.store_hits - h0,
                                   store_misses=env.store_misses - m0)
                outcomes.append(cell)
                say(f"cell {cell_id}: best={res.best_reward:.4g} "
                    f"latency={res.best_latency_ms:.1f}ms "
                    f"steps_to_peak={res.steps_to_peak} "
                    f"points_per_s={res.points_per_s:.0f} "
                    f"store_hits={cell.store_hits}")
                if writer is not None:
                    rec = {"record": "cell", "cell_id": cell_id,
                           "agent": aspec.to_dict(), "seed": seed,
                           "spec_hash": spec_hash,
                           "result": dataclasses.asdict(res),
                           "store_hits": cell.store_hits,
                           "store_misses": cell.store_misses,
                           "finished_unix": time.time()}
                    writer.write(json.dumps(rec) + "\n")
                    writer.flush()
                if persist is not None:
                    # per-cell flush: a killed campaign keeps everything up
                    # to its last finished cell (the lenient reader skips a
                    # torn tail), and pending memory stays bounded
                    persisted += persist.flush()
    finally:
        if persist is not None:
            persisted += persist.flush()
        if writer is not None:
            writer.close()

    if persist is not None:
        say(f"eval store {persist.path}: persisted {persisted} new "
            f"evaluation(s)")
    return StudyResult(spec=spec, outcomes=outcomes,
                       store_hits=env.store_hits,
                       store_misses=env.store_misses,
                       distinct_points=len(store), out=out_path,
                       wall_s=time.time() - t0,
                       store_preloaded=preloaded, store_persisted=persisted)
