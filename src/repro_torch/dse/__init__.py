"""``python -m repro_torch.dse`` — the Study CLI.

    python -m repro_torch.dse run study.json [--out results.jsonl] [--resume]
                                       [--backend reference|torch|torch-unfused]
                                       [--device cuda|cpu]
    python -m repro_torch.dse lint study.json
    python -m repro_torch.dse analyze results.jsonl
    python -m repro_torch.dse compare a.results.jsonl b.results.jsonl
    python -m repro_torch.dse store stats evals.jsonl
    python -m repro_torch.dse list-scenarios
    python -m repro_torch.dse list-systems
    python -m repro_torch.dse list-objectives
    python -m repro_torch.dse list-backends

``run`` executes a serialized ``StudySpec`` as one campaign (shared
eval_store + process pool across the (agent x seed) grid), streaming
per-cell results to a JSONL file next to the spec; ``--resume`` finishes a
half-done campaign without re-evaluating completed cells.  ``lint``
statically checks a spec WITHOUT running it: every registry name resolves,
the constraint set is satisfiable, no searched knob is dead, and a probe
design point's scheduling plan verifies — plus campaign shape/cost
(cells, max evaluations, raw cardinality).  ``analyze`` re-derives each
recorded cell's best design point and prints its critical-path bottleneck
attribution (compute vs collective vs xfer vs gate).  ``compare`` prints a
per-cell best-reward table over two results files and a one-line winner
summary.  ``store stats`` inventories a persistent eval store: records,
valid counts, and reward spread per ``eval_signature()`` — the corpus a
surrogate agent warm-starts from.  The ``list-*`` commands enumerate the
registries a spec's names resolve through.

The torch backends run on the card unless ``--device cpu`` asks for the
host (the kernels' plain twins); without CUDA they fail with an error.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path


def _cmd_run(args: argparse.Namespace) -> int:
    from repro_torch.core.analysis import PlanVerificationError
    from repro_torch.core.study import StudySpec, run_study

    say = (lambda s: None) if args.quiet else print
    try:
        spec = StudySpec.from_json(Path(args.spec))
        if args.steps is not None or args.workers is not None \
                or args.backend is not None:
            # a --steps or --backend override changes the spec (and its
            # hash): a resumed run must use the same override as the
            # original.  --workers only changes evaluation parallelism and
            # is hash-exempt.
            spec = dataclasses.replace(
                spec,
                steps=args.steps if args.steps is not None else spec.steps,
                workers=args.workers if args.workers is not None
                else spec.workers,
                backend=args.backend if args.backend is not None
                else spec.backend)
        say(f"study {spec.name!r} [{spec.spec_hash()}]: "
            f"{spec.arch} on {spec.system}, scenario={spec.scenario}, "
            f"objective={spec.objective}, backend={spec.backend}, "
            f"{len(spec.agents)} agent(s) x {len(spec.seeds)} seed(s)")
        # instantiate the backend BEFORE run_study touches the results
        # file: a missing device (no CUDA for a torch backend) must fail
        # with a clean error, not a traceback after the header was written
        from repro_torch.core.backends import get_backend
        get_backend(spec.backend, args.device)
        out = Path(args.out) if args.out else \
            Path(args.spec).with_suffix(".results.jsonl")
        res = run_study(spec, out=out, resume=args.resume, log=say,
                        sim_device=args.device)
    except PlanVerificationError as e:
        # the per-cell preflight gate: a defective scheduling plan (cycle,
        # dangling reference, infeasible pool) fails fast with the report
        print(f"error: static verification failed\n{e.report.format()}",
              file=sys.stderr)
        return 2
    except (ValueError, OSError, ImportError, RuntimeError) as e:
        # ValueError covers spec validation + resume refusals + bad JSON
        # (json.JSONDecodeError subclasses it); OSError covers missing
        # files; ImportError covers an unavailable optional backend;
        # RuntimeError a torch backend's missing CUDA or failed kernel
        print(f"error: {e}", file=sys.stderr)
        return 2
    best = res.best()
    if best is not None:
        say(f"best cell {best.cell_id}: reward={best.result.best_reward:.6g}"
            f" latency_ms={best.result.best_latency_ms:.1f}")
    persist = "" if res.spec.eval_store_path is None else \
        (f"store_preloaded={res.store_preloaded} "
         f"store_persisted={res.store_persisted} ")
    # the stable machine-readable trailer (CI greps cells_run on resume)
    print(f"campaign done: cells_run={res.cells_run} "
          f"cells_skipped={res.cells_skipped} store_hits={res.store_hits} "
          f"store_misses={res.store_misses} "
          f"store_hit_rate={res.store_hit_rate:.2f} {persist}"
          f"distinct_points={res.distinct_points} "
          f"wall_s={res.wall_s:.1f} results={res.out}")
    return 0


def _read_campaign(path: Path) -> tuple[dict, dict[str, dict]]:
    """(study header, cell_id -> cell record) from a results JSONL."""
    from repro_torch.core.study import iter_jsonl_lenient

    header: dict = {}
    cells: dict[str, dict] = {}
    for rec in iter_jsonl_lenient(path):
        if rec.get("record") == "study" and not header:
            header = rec
        elif rec.get("record") == "cell" and "cell_id" in rec:
            cells[rec["cell_id"]] = rec
    if not cells:
        raise ValueError(f"{path} holds no cell records")
    return header, cells


def _cmd_compare(args: argparse.Namespace) -> int:
    path_a, path_b = Path(args.a), Path(args.b)
    try:
        (head_a, cells_a), (head_b, cells_b) = \
            _read_campaign(path_a), _read_campaign(path_b)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    hash_a, hash_b = head_a.get("spec_hash"), head_b.get("spec_hash")
    if hash_a != hash_b:
        print(f"warning: spec hashes differ ({hash_a} vs {hash_b}) — "
              f"the campaigns ran different studies; comparing by cell id "
              f"anyway", file=sys.stderr)

    def reward(rec: "dict | None") -> "float | None":
        if rec is None:
            return None
        return (rec.get("result") or {}).get("best_reward")

    ids = list(dict.fromkeys([*cells_a, *cells_b]))
    name_a, name_b = path_a.name, path_b.name
    w = max(len(i) for i in ids)
    print(f"{'cell':<{w}}  {'A: ' + name_a:>24}  {'B: ' + name_b:>24}  "
          f"delta")
    wins_a = wins_b = 0
    for cid in ids:
        ra, rb = reward(cells_a.get(cid)), reward(cells_b.get(cid))
        fa = "n/a" if ra is None else f"{ra:.6g}"
        fb = "n/a" if rb is None else f"{rb:.6g}"
        if ra is None or rb is None:
            delta = "n/a"
        elif rb == ra:
            delta = "tie"
        else:
            wins_b += rb > ra
            wins_a += ra > rb
            delta = "+inf% B" if ra == 0 else \
                f"{(rb - ra) / abs(ra) * 100:+.2f}% {'B' if rb > ra else 'A'}"
        print(f"{cid:<{w}}  {fa:>24}  {fb:>24}  {delta}")

    both = [cid for cid in ids if cid in cells_a and cid in cells_b]
    best_a = max((r for c in cells_a if (r := reward(cells_a[c])) is not None),
                 default=None)
    best_b = max((r for c in cells_b if (r := reward(cells_b[c])) is not None),
                 default=None)
    if wins_a == wins_b:
        verdict = "tie"
    else:
        win_name, wins = (name_a, wins_a) if wins_a > wins_b \
            else (name_b, wins_b)
        verdict = f"{win_name} — better in {wins}/{len(both)} shared cells"
    fmt = lambda r: "n/a" if r is None else f"{r:.6g}"  # noqa: E731
    print(f"winner: {verdict} "
          f"(best reward A={fmt(best_a)} B={fmt(best_b)})")
    return 0


def _cmd_lint(args: argparse.Namespace) -> int:
    from repro_torch.core.analysis import lint_study
    from repro_torch.core.study import StudySpec

    try:
        spec = StudySpec.from_json(Path(args.spec))
        rep = lint_study(spec)
    except (ValueError, OSError, ImportError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(rep.format())
    if not rep.ok:
        print(f"lint: {len(rep.errors)} error(s) — this study would fail "
              f"or waste its campaign", file=sys.stderr)
        return 1
    return 0


def _cmd_analyze(args: argparse.Namespace) -> int:
    from repro_torch.core.analysis import (PlanVerificationError, aggregate_summaries,
                                     analyze_job)
    from repro_torch.core.study import StudySpec, _result_from_record

    try:
        header, cells = _read_campaign(Path(args.results))
        spec_d = header.get("spec")
        if not spec_d:
            raise ValueError(f"{args.results} has no study header record — "
                             f"cannot rebuild the evaluation environment")
        spec = StudySpec.from_dict(spec_d)
        from repro_torch.core.backends import get_backend
        backend = get_backend(args.backend or spec.backend, args.device)
        env = spec.build_env(sim_device=args.device)

        cols = ("cell", "reward", "makespan_ms", "cp%", "compute%", "coll%",
                "xfer%", "gate%", "bound")
        rows: list[tuple] = []
        for cid, rec in sorted(cells.items()):
            res = _result_from_record(rec)
            if res.best_config is None:
                rows.append((cid, "n/a") + ("-",) * (len(cols) - 2))
                continue
            job = env.scenario.sim_job(env.context(res.best_config))
            _, summaries = analyze_job(job, backend)
            agg = aggregate_summaries(summaries)
            if agg is None:    # best point gated invalid on re-evaluation
                rows.append((cid, f"{res.best_reward:.6g}")
                            + ("-",) * (len(cols) - 2))
                continue

            def _attr_row(label, reward, a):
                frac = a["breakdown_frac"]
                return (label, reward,
                        f"{a['makespan_us'] / 1e3:.1f}",
                        f"{a['cp_frac_of_makespan'] * 100:.1f}",
                        f"{frac['compute'] * 100:.1f}",
                        f"{frac['collective'] * 100:.1f}",
                        f"{frac['xfer'] * 100:.1f}",
                        f"{frac['gate'] * 100:.1f}",
                        a["bound"])

            rows.append(_attr_row(cid, f"{res.best_reward:.6g}", agg))
            if args.per_call and len(summaries) > 1:
                # per-call sub-rows: one per SimCall — for fleet jobs that
                # is one per replica, attributing bottlenecks replica by
                # replica
                for i, s in enumerate(summaries):
                    sub = aggregate_summaries([s])
                    if sub is not None:
                        rows.append(_attr_row(f"{cid}[{i}]", "-", sub))
    except PlanVerificationError as e:
        print(f"error: static verification failed\n{e.report.format()}",
              file=sys.stderr)
        return 2
    except (ValueError, OSError, ImportError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    widths = [max(len(str(r[i])) for r in [cols, *rows])
              for i in range(len(cols))]
    for r in [cols, *rows]:
        print("  ".join(f"{str(v):<{w}}" for v, w in zip(r, widths)).rstrip())
    return 0


def _cmd_store_stats(args: argparse.Namespace) -> int:
    """Per-signature inventory of a persistent eval store: how much corpus
    each ``eval_signature()`` has accumulated (the surrogate layer's
    warm-start budget) and its reward spread.  Tolerates a torn tail —
    the store is append-only and a killed campaign may leave one."""
    import statistics

    from repro_torch.core.study import iter_jsonl_lenient

    path = Path(args.store)
    try:
        if not path.exists():
            raise OSError(f"eval store {path} does not exist")
        per: dict[str, dict] = {}
        for rec in iter_jsonl_lenient(path):
            sig = rec.get("sig")
            if not isinstance(rec.get("config"), dict) \
                    or "reward" not in rec or not isinstance(sig, str):
                continue
            d = per.setdefault(sig, {"n": 0, "valid": 0, "rewards": []})
            d["n"] += 1
            d["valid"] += bool(rec.get("valid"))
            d["rewards"].append(float(rec["reward"]))
        if not per:
            raise ValueError(f"{path} holds no eval records")
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cols = ("signature", "records", "valid", "reward_min", "reward_median",
            "reward_max")
    rows = []
    for sig in sorted(per, key=lambda s: -per[s]["n"]):
        d = per[sig]
        rows.append((sig, str(d["n"]), str(d["valid"]),
                     f"{min(d['rewards']):.6g}",
                     f"{statistics.median(d['rewards']):.6g}",
                     f"{max(d['rewards']):.6g}"))
    widths = [max(len(str(r[i])) for r in [cols, *rows])
              for i in range(len(cols))]
    for r in [cols, *rows]:
        print("  ".join(f"{str(v):<{w}}" for v, w in zip(r, widths)).rstrip())
    print(f"total: {sum(d['n'] for d in per.values())} record(s) across "
          f"{len(per)} signature(s) in {path}")
    return 0


def _cmd_list_scenarios(args: argparse.Namespace) -> int:
    from repro_torch.core.scenario import list_scenarios

    for kind, doc in sorted(list_scenarios().items()):
        print(f"{kind:16s} {doc}")
    return 0


def _cmd_list_systems(args: argparse.Namespace) -> int:
    from repro_torch.core.systems import list_systems

    for name, p in sorted(list_systems().items()):
        print(f"{name:10s} n_npus={p.n_npus:<5d} device={p.device.name:18s} "
              f"{p.doc}")
    return 0


def _cmd_list_objectives(args: argparse.Namespace) -> int:
    from repro_torch.core.rewards import list_objectives

    for name, obj in sorted(list_objectives().items()):
        kind = "stream" if obj.streaming else "scalar"
        print(f"{name:18s} [{kind}] {obj.doc}")
    return 0


def _cmd_list_backends(args: argparse.Namespace) -> int:
    from repro_torch.core.backends import backend_available, list_backends

    for name, doc in sorted(list_backends().items()):
        avail = "" if backend_available(name) else " [unavailable]"
        print(f"{name:12s} {doc}{avail}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dse",
        description="Run serialized DSE studies and inspect the registries "
                    "their names resolve through.")
    sub = ap.add_subparsers(dest="command", required=True)

    run_p = sub.add_parser("run", help="execute a StudySpec JSON file")
    run_p.add_argument("spec", help="path to the study .json")
    run_p.add_argument("--out", default=None,
                       help="results JSONL path (default: <spec>.results.jsonl)")
    run_p.add_argument("--resume", action="store_true",
                       help="skip cells already in the results file")
    run_p.add_argument("--steps", type=int, default=None,
                       help="override the spec's step budget")
    run_p.add_argument("--workers", type=int, default=None,
                       help="override the spec's process-pool size")
    run_p.add_argument("--backend", default=None,
                       help="override the spec's simulation backend "
                            "(see list-backends)")
    run_p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                       help="where a torch backend runs (default: the card)")
    run_p.add_argument("--quiet", action="store_true",
                       help="only print the final campaign trailer")
    run_p.set_defaults(fn=_cmd_run)

    lint_p = sub.add_parser(
        "lint", help="statically check a StudySpec without running it")
    lint_p.add_argument("spec", help="path to the study .json")
    lint_p.set_defaults(fn=_cmd_lint)

    an_p = sub.add_parser(
        "analyze",
        help="critical-path bottleneck attribution for each recorded "
             "cell's best design point")
    an_p.add_argument("results", help="campaign results .jsonl")
    an_p.add_argument("--backend", default=None,
                      help="simulation backend for the re-evaluation "
                           "(default: the spec's)")
    an_p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                      help="where a torch backend runs (default: the card)")
    an_p.add_argument("--per-call", action="store_true", dest="per_call",
                      help="also print one attribution row per SimCall "
                           "(per replica, for fleet scenarios)")
    an_p.set_defaults(fn=_cmd_analyze)

    cmp_p = sub.add_parser(
        "compare", help="per-cell best-reward table over two results files")
    cmp_p.add_argument("a", help="first results .jsonl")
    cmp_p.add_argument("b", help="second results .jsonl")
    cmp_p.set_defaults(fn=_cmd_compare)

    store_p = sub.add_parser(
        "store", help="inspect a persistent eval store (JSONL)")
    store_sub = store_p.add_subparsers(dest="action", required=True)
    stats_p = store_sub.add_parser(
        "stats", help="per-signature record counts and reward spread")
    stats_p.add_argument("store", help="eval store .jsonl "
                                       "(a StudySpec's eval_store_path)")
    stats_p.set_defaults(fn=_cmd_store_stats)

    sub.add_parser("list-scenarios",
                   help="registered scenario kinds").set_defaults(
        fn=_cmd_list_scenarios)
    sub.add_parser("list-systems",
                   help="registered system presets").set_defaults(
        fn=_cmd_list_systems)
    sub.add_parser("list-objectives",
                   help="registered objectives").set_defaults(
        fn=_cmd_list_objectives)
    sub.add_parser("list-backends",
                   help="registered simulation backends").set_defaults(
        fn=_cmd_list_backends)

    args = ap.parse_args(argv)
    return args.fn(args)
