"""Lint core: the project model, findings, inline waivers, the baseline
(the port's counterpart of ``photon_ml_tpu/analysis/core.py``).

The checker is a plain-AST tool on purpose: every invariant it enforces
(knob mirror surfaces, cache and capture keys, lock discipline, exception
discipline, telemetry name agreement) is SYNTACTICALLY visible in the port
because its idioms are uniform: env reads go through ``os.environ.get``,
locks are module-level ``threading.Lock()``s, telemetry flows through
``emit_event``/``REGISTRY.*``. No checked module is ever imported (linting
must not load torch or touch a card), so the whole run costs one
``ast.parse`` per file.

Suppression model, two tiers, in the reference's formats:

- **Inline waiver**: ``# lint: waive(code) reason`` on the finding's line
  or the line above. For deliberate, load-bearing exceptions (a lock-free
  memo, a telemetry guard that must swallow); the reason lives next to the
  code it excuses and moves with it in review.
- **Baseline file** (``lint_baseline_torch.json``, committed): triaged
  findings only. Keys are line-number-free ``(code, file, scope)`` so
  ordinary edits don't churn it; a new finding anywhere fails the run
  until fixed, waived, or explicitly triaged in.

The port has no bench entry yet, so a ``Project`` names no bench module
unless its caller passes ``bench_path``; it never picks up the
reference's ``bench.py``.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field

BASELINE_VERSION = 1
DEFAULT_BASELINE_NAME = "lint_baseline_torch.json"

_WAIVE_RE = re.compile(r"#\s*lint:\s*waive\(\s*([a-z0-9_,\s-]+?)\s*\)")


@dataclass(frozen=True)
class Finding:
    """One invariant violation. ``scope`` is a line-number-free anchor
    (knob name, qualified function, container name) so baseline keys
    survive unrelated edits to the same file."""

    code: str
    file: str  # repo-relative path
    line: int
    scope: str
    message: str

    def key(self) -> tuple[str, str, str]:
        return (self.code, self.file, self.scope)

    def to_json(self) -> dict:
        return {"code": self.code, "file": self.file, "line": self.line, "scope": self.scope,
                "message": self.message}


class ModuleInfo:
    """One parsed source file: tree, parent links, and waived lines."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        # line -> set of waived codes ("*" waives every code on the line);
        # a waiver comment covers its own line and the line below it
        self.waivers: dict[int, set[str]] = {}
        for i, line in enumerate(source.splitlines(), start=1):
            m = _WAIVE_RE.search(line)
            if m:
                codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
                self.waivers.setdefault(i, set()).update(codes)
                self.waivers.setdefault(i + 1, set()).update(codes)

    def waived(self, line: int, code: str) -> bool:
        codes = self.waivers.get(line)
        return bool(codes) and (code in codes or "*" in codes)

    def ancestors(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST) -> str:
        names = [a.name for a in self.ancestors(node) if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))]
        return ".".join(reversed(names)) if names else "<module>"


@dataclass
class Project:
    """The file set one lint run looks at. ``root`` is the repo root (the
    directory holding ``README.md``/``pyproject.toml``); the package tree
    is scanned recursively. Tests construct Projects over fixture trees
    and may point ``readme_path`` at a modified copy, or seed
    ``_modules`` with a modified module: the drift tests work that way.
    ``bench_path`` stays None until the port has a bench entry."""

    root: str
    package_dirs: tuple[str, ...] = ("photon_ml_tpu_torch",)
    bench_path: str | None = None
    readme_path: str | None = None  # None -> <root>/README.md if present
    exclude: tuple[str, ...] = ("__pycache__",)
    _modules: dict[str, ModuleInfo] = field(default_factory=dict)
    parse_errors: list[Finding] = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.readme_path is None:
            cand = os.path.join(self.root, "README.md")
            self.readme_path = cand if os.path.exists(cand) else None

    def _load(self, path: str) -> ModuleInfo | None:
        relpath = os.path.relpath(path, self.root).replace(os.sep, "/")
        mi = self._modules.get(relpath)
        if mi is not None:
            return mi
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            mi = ModuleInfo(path, relpath, source)
        except (OSError, SyntaxError, ValueError) as e:
            self.parse_errors.append(
                Finding("parse-error", relpath, getattr(e, "lineno", 0) or 0, relpath, f"could not parse: {e}"))
            return None
        self._modules[relpath] = mi
        return mi

    def iter_modules(self):
        """Every package module (sorted, stable order)."""
        paths = []
        for pkg in self.package_dirs:
            base = os.path.join(self.root, pkg)
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = sorted(d for d in dirnames if d not in self.exclude)
                paths += [os.path.join(dirpath, fn) for fn in sorted(filenames) if fn.endswith(".py")]
        for p in sorted(paths):
            mi = self._load(p)
            if mi is not None:
                yield mi

    def bench_module(self) -> ModuleInfo | None:
        if self.bench_path and os.path.exists(self.bench_path):
            return self._load(self.bench_path)
        return None

    def module(self, relpath: str) -> ModuleInfo | None:
        """One specific module by repo-relative path (None if absent)."""
        if relpath in self._modules:
            return self._modules[relpath]
        path = os.path.join(self.root, relpath)
        if os.path.exists(path):
            return self._load(path)
        return None


def apply_waivers(project: Project, findings: list[Finding]) -> tuple[list[Finding], int]:
    """Drop findings waived inline; return (kept, waived_count)."""
    kept: list[Finding] = []
    waived = 0
    for f in findings:
        mi = project._modules.get(f.file)
        if mi is not None and mi.waived(f.line, f.code):
            waived += 1
        else:
            kept.append(f)
    return kept, waived


# -- baseline ---------------------------------------------------------------------------
def load_baseline(path: str) -> tuple[set[tuple[str, str, str]], list[dict]]:
    """Returns (suppression key set, raw entries). Missing file = empty."""
    if not os.path.exists(path):
        return set(), []
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    entries = doc.get("suppressions", [])
    keys = {(e["code"], e["file"], e["scope"]) for e in entries if "code" in e and "file" in e and "scope" in e}
    return keys, entries


def write_baseline(path: str, findings: list[Finding], reason: str = "triaged pre-existing finding") -> None:
    entries = [{"code": f.code, "file": f.file, "scope": f.scope, "reason": reason, "note": f.message}
               for f in sorted(findings, key=lambda f: f.key())]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": BASELINE_VERSION, "suppressions": entries}, f, indent=2)
        f.write("\n")


def split_suppressed(findings: list[Finding], baseline_keys: set[tuple[str, str, str]]
                     ) -> tuple[list[Finding], list[Finding]]:
    """(active, suppressed) under the baseline."""
    active, suppressed = [], []
    for f in findings:
        (suppressed if f.key() in baseline_keys else active).append(f)
    return active, suppressed


# -- shared AST helpers -----------------------------------------------------------------
def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def call_name(node: ast.Call) -> str | None:
    """The bare name a call dispatches on: ``f(...)`` -> "f",
    ``a.b.f(...)`` -> "f"."""
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def dotted_name(node: ast.AST) -> str:
    """Best-effort dotted rendering of a Name/Attribute chain (empty
    string for anything else): used to match ``torch.cuda.graph``,
    ``functools.cache``, lock expressions."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return ""


def env_reads(mi_or_tree):
    """Yield ``(name, node)`` for every PHOTON_* environment read under a
    module or a subtree: a ``.get("PHOTON_X")`` call, a Load-context
    ``[...]`` subscript, or an ``in``-membership test. The base is matched
    loosely on purpose (``os.environ``, ``os.getenv`` or a local alias
    like devcost's ``env = os.environ``): in this package string-keyed
    ``PHOTON_*`` lookups ARE environment reads."""
    tree = mi_or_tree.tree if isinstance(mi_or_tree, ModuleInfo) else mi_or_tree
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            if (isinstance(node.func, ast.Attribute) and node.func.attr in ("get", "getenv") and node.args) or (
                    isinstance(node.func, ast.Name) and node.func.id == "getenv" and node.args):
                name = const_str(node.args[0])
                if name and name.startswith("PHOTON_"):
                    yield name, node
        elif isinstance(node, ast.Subscript):
            if isinstance(node.ctx, ast.Load):
                name = const_str(node.slice)
                if name and name.startswith("PHOTON_"):
                    yield name, node
        elif isinstance(node, ast.Compare):
            if len(node.ops) == 1 and isinstance(node.ops[0], (ast.In, ast.NotIn)):
                name = const_str(node.left)
                if name and name.startswith("PHOTON_"):
                    yield name, node
