"""``photon-ml-tpu-torch lint``: the AST invariant checker driver (port of
``photon_ml_tpu/cli/lint.py``).

Runs the five analysis passes (``photon_ml_tpu_torch/analysis``) over the
port and exits 1 on any finding not covered by an inline waiver or the
committed baseline (``lint_baseline_torch.json`` at the repo root). The
JSON mode is the CI contract (one document on stdout); ``--write-baseline``
triages the CURRENT findings into the baseline (review the diff: a
baseline entry is a debt record, not a fix); ``--write-docs`` regenerates
the port's README knob table from the registry, between the port's
markers only.

Usage:
    photon-ml-tpu-torch lint                       # human-readable, exit 1 on findings
    photon-ml-tpu-torch lint --json                # machine-readable (CI)
    photon-ml-tpu-torch lint --select knobs,telemetry
    photon-ml-tpu-torch lint --baseline my.json
    photon-ml-tpu-torch lint --write-baseline      # triage current findings
    photon-ml-tpu-torch lint --write-docs          # regenerate the port's README knob table
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _write_docs(root: str) -> int:
    from photon_ml_tpu_torch.analysis.knobs_pass import readme_table_block
    from photon_ml_tpu_torch.analysis.registry import render_knob_table

    readme = os.path.join(root, "README.md")
    if not os.path.exists(readme):
        print(f"lint --write-docs: no README.md under {root}", file=sys.stderr)
        return 2
    block = readme_table_block(readme)
    if block is None:
        print("lint --write-docs: README.md has no port knob-table markers; add a "
              "'<!-- torch-knob-table:begin ... -->' / '<!-- torch-knob-table:end -->' pair where the table "
              "should live", file=sys.stderr)
        return 2
    with open(readme, encoding="utf-8") as f:
        text = f.read()
    new_text = text.replace(block, render_knob_table(), 1)
    if new_text != text:
        with open(readme, "w", encoding="utf-8") as f:
            f.write(new_text)
        print(f"lint --write-docs: regenerated the port's knob table in {readme}")
    else:
        print("lint --write-docs: the port's knob table is already current")
    return 0


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch lint",
        description="AST invariant checker of the port (knob discipline, cache and capture keys, concurrency, "
                    "exception discipline, telemetry surfaces)",
    )
    p.add_argument("--root", default=None,
                   help="repo root (default: auto-discover from cwd / the installed package)")
    p.add_argument("--json", action="store_true", help="one machine-readable JSON document on stdout")
    p.add_argument("--select", default=None,
                   help="comma-separated pass subset (knobs,cache-keys,concurrency,exceptions,telemetry)")
    p.add_argument("--baseline", default=None,
                   help="suppression baseline path (default: <root>/lint_baseline_torch.json)")
    p.add_argument("--write-baseline", action="store_true",
                   help="triage the current ACTIVE findings into the baseline file and exit 0")
    p.add_argument("--write-docs", action="store_true",
                   help="regenerate the port's README knob table from the registry and exit")
    args = p.parse_args(argv)

    from photon_ml_tpu_torch.analysis.core import DEFAULT_BASELINE_NAME, write_baseline
    from photon_ml_tpu_torch.analysis.runner import discover_root, lint, render_text

    root = os.path.abspath(args.root) if args.root else discover_root()
    if args.write_docs:
        raise SystemExit(_write_docs(root))

    baseline = args.baseline or os.path.join(root, DEFAULT_BASELINE_NAME)
    select = [s.strip() for s in args.select.split(",") if s.strip()] if args.select else None
    doc = lint(root, select=select, baseline_path=baseline)

    if args.write_baseline:
        findings = doc["_active"] + doc["_suppressed_findings"]
        write_baseline(baseline, findings)
        print(f"lint: wrote {len(findings)} suppression(s) to {baseline}; each entry is triaged debt: review "
              f"the diff before committing")
        raise SystemExit(0)

    active = doc.pop("_active")
    doc.pop("_suppressed_findings")
    if args.json:
        print(json.dumps(doc))
    else:
        print(render_text({**doc, "_active": active}))
    raise SystemExit(doc["exit"])


if __name__ == "__main__":
    main()
