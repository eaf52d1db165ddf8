"""Lint orchestration: run passes, apply waivers + baseline, render output
(the port's counterpart of ``photon_ml_tpu/analysis/runner.py``).

The machine-readable contract (``photon-ml-tpu-torch lint --json``) is the
reference's: one JSON document on stdout,

```
{"lint_schema_version": 1, "root": ..., "passes": [...], "baseline": ...,
 "findings": [{code, file, line, scope, message}, ...],   # active only
 "suppressed": N, "waived": N, "exit": 0|1}
```

Exit is 1 exactly when active findings (or parse errors) remain after
inline waivers and the committed baseline (``lint_baseline_torch.json``).
"""

from __future__ import annotations

import os

from photon_ml_tpu_torch.analysis import (
    cache_keys_pass, concurrency_pass, exceptions_pass, knobs_pass, telemetry_pass,
)
from photon_ml_tpu_torch.analysis.core import (
    DEFAULT_BASELINE_NAME, Finding, Project, apply_waivers, load_baseline, split_suppressed,
)

LINT_SCHEMA_VERSION = 1

#: pass name -> entry point; the CLI's --select values
PASSES = {
    "knobs": knobs_pass.run,
    "cache-keys": cache_keys_pass.run,
    "concurrency": concurrency_pass.run,
    "exceptions": exceptions_pass.run,
    "telemetry": telemetry_pass.run,
}


def discover_root(start: str | None = None) -> str:
    """The repo root: walk up from ``start`` (default cwd) to the first
    directory holding the ``photon_ml_tpu_torch`` package; fall back to
    the installed package's parent."""
    cur = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isfile(os.path.join(cur, "photon_ml_tpu_torch", "__init__.py")):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            break
        cur = parent
    import photon_ml_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(photon_ml_tpu_torch.__file__)))


def run_passes(project: Project, select: list[str] | None = None, registry=None) -> list[Finding]:
    names = select or list(PASSES)
    unknown = [n for n in names if n not in PASSES]
    if unknown:
        raise ValueError(f"unknown lint pass(es): {unknown}; valid: {sorted(PASSES)}")
    findings: list[Finding] = []
    for name in names:
        findings.extend(PASSES[name](project, registry=registry))
    findings.extend(project.parse_errors)
    return findings


def lint(root: str, select: list[str] | None = None, baseline_path: str | None = None, registry=None) -> dict:
    """One full lint run; returns the JSON-contract document."""
    project = Project(root=root)
    raw = run_passes(project, select=select, registry=registry)
    kept, waived = apply_waivers(project, raw)
    bp = baseline_path or os.path.join(root, DEFAULT_BASELINE_NAME)
    baseline_keys, _ = load_baseline(bp)
    active, suppressed = split_suppressed(kept, baseline_keys)
    active.sort(key=lambda f: (f.file, f.line, f.code, f.scope))
    return {
        "lint_schema_version": LINT_SCHEMA_VERSION,
        "root": root,
        "passes": select or list(PASSES),
        "baseline": os.path.relpath(bp, root) if os.path.exists(bp) else None,
        "findings": [f.to_json() for f in active],
        "suppressed": len(suppressed),
        "waived": waived,
        "exit": 1 if active else 0,
        "_active": active,  # stripped before serialization by the CLI
        "_suppressed_findings": suppressed,
    }


def render_text(doc: dict) -> str:
    lines: list[str] = []
    active = doc["_active"]
    by_code: dict[str, int] = {}
    for f in active:
        by_code[f.code] = by_code.get(f.code, 0) + 1
        lines.append(f"{f.file}:{f.line}: [{f.code}] {f.message}")
    if active:
        lines.append("")
    summary = ", ".join(f"{c}={n}" for c, n in sorted(by_code.items())) or "clean"
    lines.append(f"photon-ml-tpu-torch lint: {len(active)} finding(s) ({summary}); "
                 f"{doc['suppressed']} baseline-suppressed, {doc['waived']} waived")
    return "\n".join(lines)
