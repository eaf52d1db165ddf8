"""Pass 5 — telemetry surface check, emitters vs. report consumers (the
port's counterpart of ``photon_ml_tpu/analysis/telemetry_pass.py``).

Every telemetry name crosses a process boundary as a STRING: an event
type in a JSONL record, a counter/gauge/timer name in a metrics snapshot.
The port's ``obs/report.py`` (summarize / fleet / gate) and
``obs/export.py`` consume those strings by spelling them again — so a renamed emission
silently empties a report row, and a consumer typo reads a name nothing
emits. This pass collects both sides from the AST and flags disagreement:

- **Emitters** (the whole port package): ``emit_event("name", ...)``
  and any local ``*emit*``-named wrapper with a constant first argument
  (the repo wraps ``emit_event`` in never-raise guards like multihost's
  ``_emit_event``); ``{"event": "name"}`` dict literals (the sink/span
  records); ``REGISTRY.counter_inc / gauge_set / timer_add /
  histogram_observe`` first-arg constants. F-string names
  (``f"devcost.{label}.flops"``) become wildcard patterns.
- **Consumers** (the port's ``obs/report.py`` + ``obs/export.py``; the
  port has no bench consumer until it has a bench entry):
  string constants compared against an ``event`` field, and string
  constants used to index/get/test membership on metric mappings
  (``counters`` / ``gauges`` / ``timers`` / ``histograms`` and their
  ``base_*`` twins). Snapshot structure fields (``seconds``/``value``/…)
  and the category names themselves are not telemetry names.

Directionality is deliberately asymmetric to keep false positives near
zero: a *dangling consumer* must be a STRUCTURALLY extracted consumed
name with no emitter; a *never-rendered emission* is an emitted name
whose string appears NOWHERE in the consumer files (any textual mention —
a literal list the report iterates, a prefix table — counts as
consumed). Wildcard emissions are matched by their literal prefix.

Codes: ``telem-dangling-consumer``, ``telem-unrendered-emission``.
"""

from __future__ import annotations

import ast
import re

from photon_ml_tpu_torch.analysis.core import (
    Finding, ModuleInfo, Project, const_str,
)

_REPORT_RELPATH = "photon_ml_tpu_torch/obs/report.py"
_EXPORT_RELPATH = "photon_ml_tpu_torch/obs/export.py"

_METRIC_EMIT_CALLS = {
    "counter_inc", "gauge_set", "timer_add", "histogram_observe",
}
_EVENT_EMIT_RE = re.compile(r"emit")
#: metric-snapshot STRUCTURE, not telemetry names: instrument categories
#: and per-instrument fields ride the same get/subscript idioms
_NON_NAMES = {
    "counters", "gauges", "histograms", "timers", "metrics", "knobs",
    "seconds", "calls", "value", "count", "sum", "min", "max",
    "log2_buckets", "metrics_baseline",
}
_METRIC_MAP_HINT = re.compile(
    r"(counters|gauges|timers|histograms|metrics)", re.IGNORECASE
)
#: record fields that are NOT telemetry names even though they ride the
#: same string-compare idioms in report.py
_EVENT_FIELD = "event"


class Emission:
    __slots__ = ("name", "pattern", "file", "line", "kind")

    def __init__(self, name, pattern, file, line, kind):
        self.name = name  # display name ("devcost.*.flops" for f-strings)
        self.pattern = pattern  # compiled regex or None (exact)
        self.file = file
        self.line = line
        self.kind = kind  # "event" | "metric"


def _joined_to_pattern(node: ast.JoinedStr) -> tuple[str, re.Pattern] | None:
    """f-string emission name -> (display, regex). None when it has no
    literal anchor at all (pure dynamic — unmatchable, skip)."""
    display = []
    regex = []
    has_literal = False
    for part in node.values:
        if isinstance(part, ast.Constant) and isinstance(part.value, str):
            display.append(part.value)
            regex.append(re.escape(part.value))
            has_literal = True
        else:
            display.append("*")
            regex.append("[^\"']*")
    if not has_literal:
        return None
    return "".join(display), re.compile("^" + "".join(regex) + "$")


def collect_emissions(project: Project) -> list[Emission]:
    out: list[Emission] = []
    modules = list(project.iter_modules())
    bench = project.bench_module()
    if bench is not None:
        modules.append(bench)
    for mi in modules:
        if mi.relpath in (_REPORT_RELPATH, _EXPORT_RELPATH):
            continue  # consumers; their event literals are not emissions
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Call):
                fn = node.func
                name = fn.id if isinstance(fn, ast.Name) else (
                    fn.attr if isinstance(fn, ast.Attribute) else None
                )
                if (
                    name
                    and name not in _METRIC_EMIT_CALLS
                    and _EVENT_EMIT_RE.search(name)
                    and node.args
                ):
                    arg = node.args[0]
                    s = const_str(arg)
                    if s:
                        out.append(Emission(
                            s, None, mi.relpath, node.lineno, "event"
                        ))
                    elif isinstance(arg, ast.JoinedStr):
                        pat = _joined_to_pattern(arg)
                        if pat:
                            out.append(Emission(
                                pat[0], pat[1], mi.relpath, node.lineno,
                                "event",
                            ))
                elif name in _METRIC_EMIT_CALLS and node.args:
                    arg = node.args[0]
                    s = const_str(arg)
                    if s:
                        out.append(Emission(
                            s, None, mi.relpath, node.lineno, "metric"
                        ))
                    elif isinstance(arg, ast.JoinedStr):
                        pat = _joined_to_pattern(arg)
                        if pat:
                            out.append(Emission(
                                pat[0], pat[1], mi.relpath, node.lineno,
                                "metric",
                            ))
            elif isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if const_str(k) == _EVENT_FIELD:
                        s = const_str(v)
                        if s:
                            out.append(Emission(
                                s, None, mi.relpath, node.lineno, "event"
                            ))
    return out


class Consumption:
    __slots__ = ("name", "file", "line", "kind")

    def __init__(self, name, file, line, kind):
        self.name = name
        self.file = file
        self.line = line
        self.kind = kind


def _expr_mentions_event(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if const_str(sub) == _EVENT_FIELD:
            return True
        if isinstance(sub, ast.Name) and sub.id in ("ev", "event"):
            return True
    return False


def _expr_mentions_metric_map(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and _METRIC_MAP_HINT.search(sub.id):
            return True
        if isinstance(sub, ast.Attribute) and _METRIC_MAP_HINT.search(
            sub.attr
        ):
            return True
    return False


def collect_consumptions(mi: ModuleInfo) -> list[Consumption]:
    out: list[Consumption] = []
    for node in ast.walk(mi.tree):
        if isinstance(node, ast.Compare):
            sides = [node.left] + list(node.comparators)
            consts = [s for s in sides if const_str(s) is not None]
            others = [s for s in sides if const_str(s) is None]
            if not consts or not others:
                continue
            is_membership = any(
                isinstance(op, (ast.In, ast.NotIn)) for op in node.ops
            )
            if any(_expr_mentions_event(o) for o in others):
                for c in consts:
                    s = const_str(c)
                    if s and s != _EVENT_FIELD:
                        out.append(Consumption(
                            s, mi.relpath, node.lineno, "event"
                        ))
            elif is_membership and any(
                _expr_mentions_metric_map(o) for o in others
            ):
                for c in consts:
                    s = const_str(c)
                    if s and s not in _NON_NAMES:
                        out.append(Consumption(
                            s, mi.relpath, node.lineno, "metric"
                        ))
            # membership of a const against a tuple of event names:
            # `ev in ("p2p_send", "p2p_recv")` has a Name left side (no
            # const), tuple right side — dig into tuple elements
            if is_membership and any(
                _expr_mentions_event(s) for s in sides
            ):
                for side in sides:
                    if isinstance(side, (ast.Tuple, ast.Set, ast.List)):
                        for el in side.elts:
                            s = const_str(el)
                            if s and s != _EVENT_FIELD:
                                out.append(Consumption(
                                    s, mi.relpath, node.lineno, "event"
                                ))
        elif isinstance(node, ast.Call):
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and node.args
                and _expr_mentions_metric_map(node.func.value)
            ):
                s = const_str(node.args[0])
                if s and s not in _NON_NAMES:
                    out.append(Consumption(
                        s, mi.relpath, node.lineno, "metric"
                    ))
        elif isinstance(node, ast.Subscript) and isinstance(
            node.ctx, ast.Load
        ):
            if _expr_mentions_metric_map(node.value):
                s = const_str(node.slice)
                if s and s not in _NON_NAMES:
                    out.append(Consumption(
                        s, mi.relpath, node.lineno, "metric"
                    ))
    return out


#: names no single emitter owns — structural fields of every record, or
#: injected by the sink/bench machinery rather than an emit call
_STRUCTURAL_NAMES = {"event", "t"}


def run(project: Project, registry=None) -> list[Finding]:
    emissions = collect_emissions(project)
    emitted_exact = {e.name for e in emissions if e.pattern is None}
    emitted_patterns = [e for e in emissions if e.pattern is not None]

    consumer_mis = []
    for relpath in (_REPORT_RELPATH, _EXPORT_RELPATH):
        mi = project.module(relpath)
        if mi is not None:
            consumer_mis.append(mi)
    bench_mi = project.bench_module()
    if bench_mi is not None:
        consumer_mis.append(bench_mi)
    if not consumer_mis:
        return []

    consumptions: list[Consumption] = []
    consumer_text = ""
    for mi in consumer_mis:
        consumptions.extend(collect_consumptions(mi))
        consumer_text += mi.source

    findings: list[Finding] = []

    def _emitted(name: str) -> bool:
        if name in emitted_exact:
            return True
        return any(e.pattern.match(name) for e in emitted_patterns)

    seen_dangling: set[tuple[str, str]] = set()
    for c in consumptions:
        if c.name in _STRUCTURAL_NAMES or _emitted(c.name):
            continue
        key = (c.name, c.file)
        if key in seen_dangling:
            continue
        seen_dangling.add(key)
        findings.append(Finding(
            "telem-dangling-consumer", c.file, c.line,
            f"{c.kind}:{c.name}",
            f"{c.file} consumes {c.kind} name '{c.name}' but nothing in "
            f"the package emits it — the report row it feeds is silently "
            f"empty (renamed or removed emitter?)",
        ))

    seen_unrendered: set[str] = set()
    for e in emissions:
        if e.name in seen_unrendered:
            continue
        if e.pattern is None:
            rendered = f'"{e.name}"' in consumer_text or \
                f"'{e.name}'" in consumer_text
        else:
            # wildcard names count as rendered when any literal segment
            # (e.g. "devcost." of "devcost.*.flops", ".rows_max" of
            # "*.rows_max") appears in a consumer — the report renders
            # such families by prefix/suffix iteration
            segments = [s for s in e.name.split("*") if len(s) >= 4]
            rendered = any(s in consumer_text for s in segments)
        if not rendered:
            seen_unrendered.add(e.name)
            findings.append(Finding(
                "telem-unrendered-emission", e.file, e.line,
                f"{e.kind}:{e.name}",
                f"{e.kind} '{e.name}' is emitted here but neither "
                f"obs/report.py nor obs/export.py ever mentions it — no "
                f"summarize/fleet/gate row renders it (dead instrument, "
                f"or a consumer was never wired)",
            ))
    return findings
