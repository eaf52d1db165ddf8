"""Telemetry run report driver (``photon-ml-tpu-torch report``; port of
``photon_ml_tpu/cli/report.py``).

Renders a run's telemetry JSONL (written by any driver's
``--telemetry-dir``) into a per-phase wall/compile/transfer summary plus
the analytic device-cost table, diffs two runs (the sweep-readout
format), exports the span timeline as Chrome-trace/Perfetto JSON,
validates a run's schema, and GATES a run against a committed baseline
with per-metric thresholds. It reads either package's runs; its
``compile_s`` is the port's kernel build timer ``cuda.build_s``
(``obs/report.py``). Host only: it takes no ``--device``.

Usage:
    photon-ml-tpu-torch report RUN.jsonl
    photon-ml-tpu-torch report RUN.jsonl --diff OTHER.jsonl
    photon-ml-tpu-torch report TELEMETRY_DIR            # newest run in the dir
    photon-ml-tpu-torch report RUN.jsonl --export-trace trace.json
    photon-ml-tpu-torch report RUN.jsonl --json         # machine-readable summary
    photon-ml-tpu-torch report fleet RUNDIR             # merged multi-process view
    photon-ml-tpu-torch report fleet RUNDIR --run-id ID --export-trace trace.json
    photon-ml-tpu-torch report validate RUN.jsonl       # exit 1 on schema errors
    photon-ml-tpu-torch report gate RUN --baseline BASE # exit 1 on regression
    photon-ml-tpu-torch report gate --fleet RUNDIR --baseline BASE
    photon-ml-tpu-torch report gate RUN --write-baseline OUT.json

(or ``python -m photon_ml_tpu_torch.cli.report ...``).

``fleet`` joins one run's canonical ``run-<id>.jsonl`` with its
per-process ``run-<id>.p<k>.jsonl`` shards (written by every non-zero
process under fleet telemetry) and renders the per-process phase-wall
table, the straggler summary, the correlated per-link P2P table and the
unmatched-event telemetry-health count; ``--export-trace`` merges every
shard into ONE Chrome-trace timeline (pid = process index). ``gate
--fleet`` gates the MERGED view — balance/overlap/straggler regressions
anywhere in the fleet trip it, not just on process 0.

``gate`` accepts a telemetry run JSONL/dir, a bench JSON document (the
format of the repo's ``bench.py --quick`` output), or a saved
gate-baseline file, on EITHER side; both sides must be the same kind or
share metric names. ``--thresholds`` takes a JSON object (inline or a
file path) of ``{pattern: {"rel": r, "abs": a}}`` overrides on top of the
defaults in ``obs/report.py``. Combining ``--baseline`` with
``--write-baseline`` is update-and-verify: the gate runs against the
PREVIOUS baseline first and the new one is written only on PASS (a
failing run's metrics never become the baseline). Exit codes: 0 pass, 1
regression (or schema errors for ``validate``), 2 an artifact that
cannot be read or compared.
"""

from __future__ import annotations

import argparse
import json
import os


def _resolve(path: str) -> str:
    """A run file, or the newest run inside a telemetry directory."""
    if os.path.isdir(path):
        from photon_ml_tpu_torch.obs.report import latest_run

        run = latest_run(path)
        if run is None:
            raise SystemExit(f"no run-*.jsonl files in {path}")
        return run
    return path


def _validate_main(argv: list[str]) -> None:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch report validate",
        description="schema-check a telemetry run; exit 1 on violations",
    )
    p.add_argument("run", help="run JSONL file or telemetry dir")
    p.add_argument("--json", action="store_true",
                   help="print problems as a JSON list")
    args = p.parse_args(argv)

    from photon_ml_tpu_torch.obs.report import load_run, validate_run

    run = _resolve(args.run)
    try:
        records = load_run(run)
    except (OSError, ValueError) as e:
        # load errors exit 2 (same contract as the gate subcommand): a
        # path typo must be distinguishable from a schema violation
        if args.json:
            print(json.dumps({"run": run, "error": str(e)}))
        else:
            print(f"{run}: cannot load: {e}")
        raise SystemExit(2)
    problems = validate_run(records)
    if args.json:
        print(json.dumps({"run": run, "problems": problems}))
    elif problems:
        print(f"{run}: INVALID telemetry run:")
        for pr in problems:
            print(f"  - {pr}")
    else:
        print(f"{run}: valid telemetry run (schema ok)")
    raise SystemExit(1 if problems else 0)


def _fleet_main(argv: list[str]) -> None:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch report fleet",
        description="merged per-process view of one fleet run "
                    "(canonical file + .p<k> shards)",
    )
    p.add_argument("run", help="telemetry dir, canonical run JSONL, or "
                               "any one shard of the run")
    p.add_argument("--run-id", default=None,
                   help="pick a specific run inside a telemetry dir "
                        "(default: newest canonical run)")
    p.add_argument("--export-trace", default=None, metavar="OUT_JSON",
                   help="also write ONE merged Chrome-trace/Perfetto "
                        "timeline (pid = process index)")
    p.add_argument("--json", action="store_true",
                   help="print the machine-readable fleet dict instead "
                        "of the tables")
    args = p.parse_args(argv)

    from photon_ml_tpu_torch.obs.report import (
        fleet_run_paths,
        format_fleet,
        summarize_fleet,
    )

    try:
        paths = fleet_run_paths(args.run, run_id=args.run_id)
        fs = summarize_fleet(paths)
    except (OSError, ValueError) as e:
        # load errors exit 2 (the gate/validate contract): a path typo
        # must be distinguishable from a real fleet-health failure
        if args.json:
            print(json.dumps({"run": args.run, "error": str(e)}))
        else:
            print(f"{args.run}: cannot load fleet run: {e}")
        raise SystemExit(2)
    if args.export_trace:
        from photon_ml_tpu_torch.obs.export import export_chrome_trace

        export_chrome_trace(paths, args.export_trace)
    print(json.dumps(fs) if args.json else format_fleet(fs))


def _load_thresholds(spec: str | None) -> dict | None:
    if not spec:
        return None
    if os.path.exists(spec):
        with open(spec) as f:
            return json.load(f)
    return json.loads(spec)


def _gate_main(argv: list[str]) -> None:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch report gate",
        description="diff a run's cost/wall/quality metrics against a "
                    "baseline; exit 1 on regression",
    )
    p.add_argument("run", help="telemetry run JSONL/dir, or a bench.py "
                               "JSON document")
    p.add_argument("--fleet", action="store_true",
                   help="gate the MERGED fleet view of the run "
                        "(canonical file + every .p<k> shard) instead "
                        "of process 0's summary alone")
    p.add_argument("--baseline", default=None,
                   help="baseline artifact (same formats as RUN)")
    p.add_argument("--thresholds", default=None, metavar="JSON",
                   help="per-metric threshold overrides: a JSON object "
                        "(inline or a file path)")
    p.add_argument("--allow-missing", action="store_true",
                   help="do not fail on baseline metrics the run lacks")
    p.add_argument("--write-baseline", default=None, metavar="OUT_JSON",
                   help="write the run's metrics as a gate-baseline file")
    p.add_argument("--json", action="store_true",
                   help="print the machine-readable gate result")
    args = p.parse_args(argv)

    from photon_ml_tpu_torch.obs.report import (
        GATE_SCHEMA_VERSION,
        gate_run,
        load_gate_metrics,
    )

    def _error(msg: str):
        # gate errors exit 2 — a CI script must be able to tell "could
        # not read/compare the artifacts" from a genuine regression
        # (exit 1) — and the --json contract holds on error paths too
        if args.json:
            print(json.dumps({"pass": False, "error": msg}))
        else:
            print(f"gate error: {msg}")
        raise SystemExit(2)

    def _load(path, side):
        try:
            return load_gate_metrics(path, fleet=args.fleet)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            _error(f"cannot load {side} {path!r}: {e}")

    kind, current = _load(args.run, "run")

    def _info(msg: str):
        # informational lines go to stderr under --json: stdout must stay
        # a single machine-readable object (the bench-contract discipline)
        import sys

        print(msg, file=sys.stderr if args.json else sys.stdout)

    def _write_baseline():
        # atomic (fsync -> rename): same-path update-and-verify must
        # never leave a truncated baseline behind a mid-write crash
        from photon_ml_tpu_torch.utils.atomic_io import atomic_replace_bytes

        out = os.path.abspath(args.write_baseline)
        data = json.dumps(
            {
                "gate_baseline": GATE_SCHEMA_VERSION,
                "source": os.path.abspath(args.run),
                "source_kind": kind,
                "metrics": current,
            },
            indent=2, sort_keys=True,
        ).encode()
        atomic_replace_bytes(os.path.dirname(out), out, data)
        _info(f"wrote gate baseline ({len(current)} metrics) to "
              f"{args.write_baseline}")

    if args.baseline is None:
        if args.write_baseline:
            try:
                _write_baseline()
            except OSError as e:
                _error(f"cannot write {args.write_baseline!r}: {e}")
            if args.json:
                print(json.dumps({
                    "baseline_written": True,
                    "metrics": len(current),
                    "run_kind": kind,
                }))
            raise SystemExit(0)
        p.error("--baseline (or --write-baseline) is required")
    # load the baseline BEFORE any write: with both flags (update-and-
    # verify, possibly the SAME path) the gate must compare against the
    # PREVIOUS baseline, and a failing run's metrics must never be
    # persisted as the new one
    bkind, baseline = _load(args.baseline, "baseline")
    try:
        thresholds = _load_thresholds(args.thresholds)
    except (OSError, ValueError) as e:  # json errors are ValueErrors
        _error(f"cannot load --thresholds {args.thresholds!r}: {e}")
    try:
        failures, lines = gate_run(
            current, baseline,
            thresholds=thresholds,
            allow_missing=args.allow_missing,
        )
    except ValueError as e:
        _error(str(e))
    comparable = set(current) & set(baseline)
    if not comparable:
        _error(
            f"no comparable metrics between run ({kind}: "
            f"{len(current)} metrics) and baseline ({bkind}: "
            f"{len(baseline)} metrics) — are the artifacts the same kind?"
        )
    # the write happens BEFORE the result object prints, so
    # baseline_written reports the COMPLETED side effect, not a prediction
    baseline_written = False
    if args.write_baseline and not failures:
        try:
            _write_baseline()
            baseline_written = True
        except OSError as e:
            _error(f"gate passed but writing {args.write_baseline!r} "
                   f"failed: {e}")
    if args.json:
        print(json.dumps({
            "pass": not failures,
            "failures": failures,
            "compared": len(baseline),
            "run_kind": kind,
            "baseline_kind": bkind,
            "baseline_written": baseline_written,
        }))
    else:
        print(f"gate: run={args.run} ({kind})  baseline={args.baseline} "
              f"({bkind})")
        print("\n".join(lines))
        print(
            "gate PASS" if not failures
            else f"gate FAIL: {len(failures)} regression(s)"
        )
    if args.write_baseline and failures:
        _info(
            f"gate: NOT writing {args.write_baseline} — a failing "
            f"run's metrics must not become the baseline"
        )
    raise SystemExit(1 if failures else 0)


def main(argv: list[str] | None = None) -> None:
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "validate":
        _validate_main(argv[1:])
        return
    if argv and argv[0] == "gate":
        _gate_main(argv[1:])
        return
    if argv and argv[0] == "fleet":
        _fleet_main(argv[1:])
        return
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch report",
        description="summarize / diff / export / validate / gate "
                    "telemetry runs",
    )
    p.add_argument("run", help="run JSONL file, or a --telemetry-dir "
                               "(newest run is picked)")
    p.add_argument("--diff", default=None, metavar="OTHER",
                   help="second run (or telemetry dir) to diff against")
    p.add_argument("--export-trace", default=None, metavar="OUT_JSON",
                   help="also write the span timeline as Chrome-trace/"
                        "Perfetto JSON")
    p.add_argument("--json", action="store_true",
                   help="print the machine-readable summary dict instead "
                        "of the table")
    args = p.parse_args(argv)

    from photon_ml_tpu_torch.obs.report import (
        diff_summaries,
        format_summary,
        summarize_run,
    )

    run = _resolve(args.run)
    summary = summarize_run(run)
    if args.export_trace:
        from photon_ml_tpu_torch.obs.export import export_chrome_trace

        export_chrome_trace(run, args.export_trace)
    if args.diff:
        other = summarize_run(_resolve(args.diff))
        if args.json:
            print(json.dumps({"a": summary, "b": other}))
        else:
            print(diff_summaries(summary, other))
        return
    print(json.dumps(summary) if args.json else format_summary(summary))


if __name__ == "__main__":
    main()
