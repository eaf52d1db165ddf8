"""Pass 4 — exception discipline in the fault-bearing modules (the port's
counterpart of ``photon_ml_tpu/analysis/exceptions_pass.py``).

Swallowed exceptions hid the reference's P2P drain errors until they were
made typed and telemetered. The rule, scoped to the modules where a swallowed error
means silent data loss or a hung fleet (``parallel/``,
``game/streaming.py``, ``game/descent.py``): an ``except`` handler must
do at least one of

- **re-raise** (bare ``raise``, or harden into a typed error —
  ``raise PeerLost(...) from e``),
- **emit telemetry** — ``emit_event``/``emit_log``, a metrics-registry
  instrument (``counter_inc``/``gauge_set``/``timer_add``/
  ``histogram_observe``), a ``sink.emit``, or
- **log loudly** — ``warnings.warn`` or a logger ``warning``/``error``/
  ``exception`` call

anywhere in its body (nested calls count — a handler that delegates to a
``_record_drain_error`` helper is fine if it calls one of the emitters
through any spelled name below). Handlers that deliberately swallow (the
"telemetry must never take down the run" guards) carry an inline
``# lint: waive(except-swallow) reason``.

Code: ``except-swallow``.
"""

from __future__ import annotations

import ast

from photon_ml_tpu_torch.analysis.core import Finding, ModuleInfo, Project

#: repo-relative prefixes/files the discipline applies to
SCOPE_PREFIXES = ("photon_ml_tpu_torch/parallel/",)
SCOPE_FILES = (
    "photon_ml_tpu_torch/game/streaming.py",
    "photon_ml_tpu_torch/game/descent.py",
)

_HANDLING_CALLS = {
    # telemetry emitters
    "emit_event", "emit_log", "emit",
    "counter_inc", "gauge_set", "timer_add", "histogram_observe",
    # loud logging
    "warn", "warning", "error", "exception", "critical",
    # pytest-style hard failure (defensive harness code)
    "fail",
}


def in_scope(relpath: str) -> bool:
    rel = relpath.replace("\\", "/")
    return rel.startswith(SCOPE_PREFIXES) or rel in SCOPE_FILES


def _handler_handles(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None
            )
            if name in _HANDLING_CALLS:
                return True
    return False


def run(project: Project, registry=None) -> list[Finding]:
    findings: list[Finding] = []
    for mi in project.iter_modules():
        if not in_scope(mi.relpath):
            continue
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _handler_handles(node):
                continue
            fn_name = mi.enclosing_function(node)
            exc = (
                ast.unparse(node.type) if node.type is not None
                else "BaseException"
            )
            findings.append(Finding(
                "except-swallow", mi.relpath, node.lineno,
                f"{fn_name}:{exc}:{node.lineno - _fn_line(mi, node)}",
                f"'{fn_name}' swallows {exc} without re-raising, "
                f"hardening into a typed error, or emitting a telemetry "
                f"event/counter/log — in this module a silent except "
                f"hides drain errors and dead peers; emit or raise, or "
                f"waive with a reason",
            ))
    return findings


def _fn_line(mi: ModuleInfo, node: ast.AST) -> int:
    """Line of the enclosing function (scope anchor: handler offsets
    inside a function are stabler than absolute lines)."""
    for anc in mi.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc.lineno
    return 0
