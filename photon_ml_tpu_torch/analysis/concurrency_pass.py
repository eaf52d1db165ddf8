"""Pass 3 — concurrency lint, the unlocked-process-wide-cache class (the
port's counterpart of ``photon_ml_tpu/analysis/concurrency_pass.py``).

The reference's ``_FP_MEMO`` once raced under the prefetch worker pool
because a module-level cache gained a second writer thread after it was
written lock-free. This pass makes the rule mechanical, scoped to exactly the
modules where a second thread exists or a process-wide cache lives:

- **In scope** — modules that build worker threads
  (``ThreadPoolExecutor`` / ``threading.Thread``) or hold a module-level
  ``threading.Lock``/``RLock`` (the repo's marker for a process-wide
  shared structure).
- **Checked** — every mutation of a module-level mutable container
  (dict/list/set/OrderedDict/deque/defaultdict literals or constructor
  calls): mutating method calls, subscript/slice stores and deletes,
  aug-assigns.
- **Passes when** — the mutation sits under a ``with <lock>`` whose
  context expression names a module-level lock, OR inside a function
  whose name ends in ``_locked`` (the repo idiom for
  caller-holds-the-lock helpers: ``_rotate_locked``,
  ``_evict_over_limits_locked``).

Deliberately lock-free structures (single-writer memos, benign-race
caches) carry an inline ``# lint: waive(conc-unlocked-mutation) reason``
— the reason then lives next to the code it excuses.

Code: ``conc-unlocked-mutation``.
"""

from __future__ import annotations

import ast

from photon_ml_tpu_torch.analysis.core import (
    Finding, ModuleInfo, Project, dotted_name,
)

_CONTAINER_CALLS = {
    "dict", "list", "set", "OrderedDict", "deque", "defaultdict",
    "WeakValueDictionary", "Counter",
}
_LOCK_CALLS = {"Lock", "RLock", "Condition"}
_THREAD_MARKERS = {"ThreadPoolExecutor", "Thread"}
_MUTATING_METHODS = {
    "append", "add", "update", "setdefault", "pop", "popitem", "clear",
    "extend", "remove", "insert", "appendleft", "popleft", "discard",
    "move_to_end",
}


def _module_level_bindings(mi: ModuleInfo):
    """Yield (name, value) for module-level Assign/AnnAssign targets."""
    for node in mi.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    yield t.id, node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            if node.value is not None:
                yield node.target.id, node.value


def _is_container_value(value: ast.AST) -> bool:
    if isinstance(value, (ast.Dict, ast.List, ast.Set)):
        return True
    if isinstance(value, ast.Call):
        fn = value.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None
        )
        return name in _CONTAINER_CALLS
    return False


def _is_lock_value(value: ast.AST) -> bool:
    if isinstance(value, ast.Call):
        fn = value.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None
        )
        return name in _LOCK_CALLS
    return False


def module_in_scope(mi: ModuleInfo) -> bool:
    """Worker-pool or process-wide-cache module?"""
    for _, value in _module_level_bindings(mi):
        if _is_lock_value(value):
            return True
    for node in ast.walk(mi.tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None
            )
            if name in _THREAD_MARKERS:
                return True
    return False


def _base_name(node: ast.AST) -> str | None:
    """The bare Name a mutation targets (``X[...]``, ``X.append`` → X).
    Attribute chains (``self.x``) return None — only module-level names
    are in scope."""
    if isinstance(node, ast.Name):
        return node.id
    return None


def _under_lock(mi: ModuleInfo, node: ast.AST, locks: set[str]) -> bool:
    for anc in mi.ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                expr = item.context_expr
                # `with _lock:` or `with lock_holder.acquire():` — any
                # dotted mention of a known module-level lock name
                text = dotted_name(expr) or ast.dump(expr)
                if any(lk in text for lk in locks):
                    return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if anc.name.endswith("_locked"):
                return True
    return False


def run(project: Project, registry=None) -> list[Finding]:
    findings: list[Finding] = []
    seen: set[tuple[str, int, str]] = set()
    for mi in project.iter_modules():
        if not module_in_scope(mi):
            continue
        containers: set[str] = set()
        locks: set[str] = set()
        for name, value in _module_level_bindings(mi):
            if _is_container_value(value):
                containers.add(name)
            elif _is_lock_value(value):
                locks.add(name)
        if not containers:
            continue
        for node in ast.walk(mi.tree):
            target_name: str | None = None
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                if node.func.attr in _MUTATING_METHODS:
                    target_name = _base_name(node.func.value)
            elif isinstance(node, (ast.Subscript,)) and isinstance(
                node.ctx, (ast.Store, ast.Del)
            ):
                target_name = _base_name(node.value)
            elif isinstance(node, ast.AugAssign) and isinstance(
                node.target, ast.Subscript
            ):
                target_name = _base_name(node.target.value)
            if target_name is None or target_name not in containers:
                continue
            # module-level initialization statements are single-threaded
            # import-time code, not runtime mutation
            if mi.enclosing_function(node) == "<module>":
                continue
            if _under_lock(mi, node, locks):
                continue
            fn_name = mi.enclosing_function(node)
            dedup = (mi.relpath, node.lineno, target_name)
            if dedup in seen:
                # an AugAssign's inner Subscript store is the same
                # mutation, not a second one
                continue
            seen.add(dedup)
            findings.append(Finding(
                "conc-unlocked-mutation", mi.relpath, node.lineno,
                f"{fn_name}:{target_name}",
                f"module-level container '{target_name}' is mutated in "
                f"'{fn_name}' without holding a module lock, in a module "
                f"that hosts worker threads or process-wide caches — "
                f"take the lock, rename the helper *_locked if the "
                f"caller holds it, or waive with a reason if the "
                f"structure is deliberately lock-free",
            ))
    return findings
