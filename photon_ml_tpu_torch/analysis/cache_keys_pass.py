"""Pass 2 — cache and capture keys (the stale-program class; the port's
counterpart of ``photon_ml_tpu/analysis/jit_keys_pass.py``).

The discipline: a knob is read at CALL time, so a flip takes effect at the
next call. The violation this pass hunts is a value read where a later
knob flip cannot reach it. Where the reference looks in a ``jax.jit``
body, the port's equivalents are bodies whose Python runs once and whose
result is then replayed or reused:

- a CUDA graph capture: the block of ``with torch.cuda.graph(...)``, the
  statements between ``g.capture_begin()`` and ``g.capture_end()``, and a
  callee of ``torch.cuda.make_graphed_callables`` (a knob read while a
  graph is captured is baked into every replay);
- a ``torch.compile``d function (guards do not cover a value read through
  an accessor or from the environment);
- a ``functools.cache`` / ``functools.lru_cache`` function (the first
  call's value is returned for ever).

Inside those bodies, nested helpers included (a nested ``def`` and any
function of the same module the body calls by name, followed
transitively), it flags a knob accessor call, a read of a module global
that mirrors a knob, and an environment read.

Bodies are recognized syntactically: a decorator (``@functools.cache``,
``@lru_cache(maxsize=...)``, ``@torch.compile`` / ``@torch.compile(...)``),
a wrapping call by name anywhere in the module (``torch.compile(fn)``,
``functools.cache(fn)``, ``lru_cache(...)(fn)``,
``torch.cuda.make_graphed_callables(fn, args)`` or a tuple of functions),
or a capture block or span.

Codes: ``cache-knob-accessor``, ``cache-retune-global``,
``cache-env-read``.
"""

from __future__ import annotations

import ast

from photon_ml_tpu_torch.analysis import registry as reg_mod
from photon_ml_tpu_torch.analysis.core import (
    Finding, ModuleInfo, Project, call_name, const_str, dotted_name, env_reads,
)

_CACHE_NAMES = {"functools.cache", "cache", "functools.lru_cache", "lru_cache"}
_COMPILE_NAMES = {"torch.compile"}
_GRAPH_CALLEE_NAMES = {"torch.cuda.make_graphed_callables", "cuda.make_graphed_callables",
                       "make_graphed_callables"}
_GRAPH_BLOCK_NAMES = {"torch.cuda.graph", "cuda.graph", "graph"}
_ENV_BASES = {"os.environ", "environ"}
_GETENV_NAMES = {"os.getenv", "getenv"}


def _is_wrapper_expr(node: ast.AST) -> bool:
    """``functools.cache`` / ``lru_cache(...)`` / ``torch.compile`` /
    ``torch.compile(...)``: a decorator that makes a cached body."""
    if isinstance(node, ast.Call):
        node = node.func
    return dotted_name(node) in _CACHE_NAMES | _COMPILE_NAMES


def _wrapped_names(node: ast.Call) -> list[str]:
    """The functions a wrapping call takes by name: ``torch.compile(fn)``,
    ``functools.cache(fn)``, ``lru_cache(maxsize=None)(fn)``,
    ``make_graphed_callables(fn, ...)`` or ``((f, g), ...)``."""
    if not node.args:
        return []
    fn = node.func
    if not (dotted_name(fn) in _CACHE_NAMES | _COMPILE_NAMES | _GRAPH_CALLEE_NAMES
            or (isinstance(fn, ast.Call) and dotted_name(fn.func) in _CACHE_NAMES)):
        return []
    arg = node.args[0]
    elts = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]
    return [e.id for e in elts if isinstance(e, ast.Name)]


class Region:
    """One body whose reads are baked in: its name (the scope's anchor)
    and its statements."""

    def __init__(self, name: str, nodes: list):
        self.name = name
        self.nodes = nodes


def _shadowed(mi: ModuleInfo, node: ast.Name) -> bool:
    """Is the name a parameter of a function around it? A parameter named
    like the global IS the discipline working: the value comes in."""
    for anc in mi.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            args = anc.args
            if node.id in {a.arg for a in args.args + args.kwonlyargs + args.posonlyargs}:
                return True
    return False


def _statement_lists(tree: ast.AST):
    for node in ast.walk(tree):
        for attr in ("body", "orelse", "finalbody"):
            stmts = getattr(node, attr, None)
            if isinstance(stmts, list) and stmts and isinstance(stmts[0], ast.stmt):
                yield stmts


def _is_capture_call(stmt: ast.stmt, attr: str) -> bool:
    return (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
            and isinstance(stmt.value.func, ast.Attribute) and stmt.value.func.attr == attr)


def regions(mi: ModuleInfo) -> list[Region]:
    """Every cached, compiled or captured body of one module."""
    out: list[Region] = []
    by_name: dict[str, list[ast.FunctionDef]] = {}
    seen: set[ast.AST] = set()
    for node in ast.walk(mi.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, []).append(node)
            if any(_is_wrapper_expr(d) for d in node.decorator_list) and node not in seen:
                seen.add(node)
                out.append(Region(node.name, [node]))
    for node in ast.walk(mi.tree):
        if isinstance(node, ast.Call):
            for name in _wrapped_names(node):
                for fn in by_name.get(name, ()):
                    if fn not in seen:
                        seen.add(fn)
                        out.append(Region(fn.name, [fn]))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if any(isinstance(it.context_expr, ast.Call) and dotted_name(it.context_expr.func) in _GRAPH_BLOCK_NAMES
                   for it in node.items):
                out.append(Region(f"{mi.enclosing_function(node)}@graph", node.body))
    for stmts in _statement_lists(mi.tree):
        for i, stmt in enumerate(stmts):
            if _is_capture_call(stmt, "capture_begin"):
                end = next((j for j in range(i + 1, len(stmts)) if _is_capture_call(stmts[j], "capture_end")),
                           len(stmts))
                out.append(Region(f"{mi.enclosing_function(stmt)}@capture", stmts[i + 1:end]))
    return out


def _env_reads_in(nodes):
    """Environment reads under ``nodes``: every ``PHOTON_*`` read the knob
    pass sees, and any other read straight off ``os.environ`` /
    ``os.getenv`` (its name, or ``<dynamic>``)."""
    for root in nodes:
        yield from env_reads(root)
        for node in ast.walk(root):
            if isinstance(node, ast.Call) and node.args:
                fn, key = node.func, const_str(node.args[0])
                direct = dotted_name(fn) in _GETENV_NAMES or (
                    isinstance(fn, ast.Attribute) and fn.attr == "get" and dotted_name(fn.value) in _ENV_BASES)
            elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
                key, direct = const_str(node.slice), dotted_name(node.value) in _ENV_BASES
            else:
                continue
            if direct and not (key or "").startswith("PHOTON_"):
                yield key or "<dynamic>", node


def _reachable(mi: ModuleInfo, region: Region) -> list[ast.AST]:
    """The region's nodes and every module-level function it calls by
    name, transitively."""
    top = {n.name: n for n in mi.tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    nodes = list(region.nodes)
    seen = {id(n) for n in nodes}
    i = 0
    while i < len(nodes):
        for node in ast.walk(nodes[i]):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                fn = top.get(node.func.id)
                if fn is not None and id(fn) not in seen:
                    seen.add(id(fn))
                    nodes.append(fn)
        i += 1
    return nodes


def run(project: Project, registry=None) -> list[Finding]:
    knobs = list(registry or reg_mod.KNOBS)
    accessor_owner = {a: k.name for k in knobs for a in k.accessors}
    global_owner = {k.retune_global: k.name for k in knobs if k.retune_global}
    findings: list[Finding] = []
    emitted: set[tuple[str, int, str]] = set()

    def add(code: str, mi: ModuleInfo, node: ast.AST, scope: str, message: str) -> None:
        if (code, node.lineno, scope) not in emitted:
            emitted.add((code, node.lineno, scope))
            findings.append(Finding(code, mi.relpath, node.lineno, scope, message))

    for mi in project.iter_modules():
        for region in regions(mi):
            what = f"cached or captured body '{region.name}'"
            nodes = _reachable(mi, region)
            for root in nodes:
                for node in ast.walk(root):
                    if isinstance(node, ast.Call) and call_name(node) in accessor_owner:
                        cn = call_name(node)
                        add("cache-knob-accessor", mi, node, f"{region.name}:{cn}",
                            f"{what} calls knob accessor {cn}() ({accessor_owner[cn]}): the value is read once, "
                            f"when the body is captured, compiled or first cached, and a later knob flip "
                            f"reuses the stale result; read it at the call site and pass it in (or key the "
                            f"cache on it)")
                    elif isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load) \
                            and node.attr in global_owner:
                        add("cache-retune-global", mi, node, f"{region.name}:{node.attr}",
                            f"{what} reads knob-mirroring global {dotted_name(node) or node.attr} "
                            f"({global_owner[node.attr]}); pass it in as an argument instead")
                    elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                            and node.id in global_owner and not _shadowed(mi, node):
                        add("cache-retune-global", mi, node, f"{region.name}:{node.id}",
                            f"{what} reads knob-mirroring global {node.id} ({global_owner[node.id]}); pass it "
                            f"in as an argument instead")
            for name, read in _env_reads_in(nodes):
                add("cache-env-read", mi, read, f"{region.name}:{name}",
                    f"{what} reads {name} from the environment: the read happens once, when the body is "
                    f"captured, compiled or first cached; hoist it to the call site and pass it in")
    return findings
