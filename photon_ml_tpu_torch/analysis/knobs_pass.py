"""Pass 1: knob discipline (the port's counterpart of
``photon_ml_tpu/analysis/knobs_pass.py``).

Finds every ``PHOTON_*`` environment read in the port package, then
cross-checks the port's knob registry against every mirror surface BY
PARSING THE SOURCES: the ``obs/sink._knob_snapshot`` keys, the
``obs/devcost._knob_raw_state`` fingerprint, and the port's generated
README knob table. Drift in any direction fails. (The reference's bench
``RETUNE_ENV*`` tables have no counterpart until the port has a bench
entry: ``registry.py`` says so.)

Codes:

- ``knob-unregistered``: an env read of a PHOTON_* name absent from the
  registry (new knobs must be registered before they ship).
- ``knob-truthy-parse``: an int/flag/float knob's env read used directly
  in a boolean context (``if os.environ.get(...)`` /
  ``not os.environ.get(...)``): the string ``"0"`` is truthy, so ``=0``
  INVERTS the operator's intent. Strict-parse (``int(env) != 0``) instead.
- ``knob-sink-missing`` / ``knob-sink-unregistered``: registry (knobs and
  declared constants) vs. the ``_knob_snapshot`` keys, both directions.
- ``knob-devcost-missing``: a snapshot-carried knob whose env var
  ``_knob_raw_state`` does not fingerprint (the memoized snapshot would go
  stale on a mid-process flip of only that knob).
- ``knob-readme-missing`` / ``knob-readme-stale``: registry vs. the
  committed port knob table (regenerate with ``--write-docs``).
"""

from __future__ import annotations

import ast

from photon_ml_tpu_torch.analysis import registry as reg_mod
from photon_ml_tpu_torch.analysis.core import Finding, ModuleInfo, Project, const_str, env_reads

_SINK_RELPATH = "photon_ml_tpu_torch/obs/sink.py"
_DEVCOST_RELPATH = "photon_ml_tpu_torch/obs/devcost.py"

#: parse kinds the boolean-context check applies to: a raw string / path /
#: JSON knob used truthily ("set or not") is fine by design
_NUMERIC_KINDS = ("int", "flag", "float")


def _in_boolean_context(mi: ModuleInfo, node: ast.AST) -> bool:
    """Is this expression consumed directly as a truth value? Covers
    ``if os.environ.get(X)``, ``not os.environ.get(X)``,
    ``... and os.environ.get(X)``, and conditional-expression tests."""
    parent = mi.parents.get(node)
    if isinstance(parent, ast.UnaryOp) and isinstance(parent.op, ast.Not):
        return True
    if isinstance(parent, ast.BoolOp):
        return True
    if isinstance(parent, (ast.If, ast.While, ast.IfExp)) and parent.test is node:
        return True
    return False


def scan_env_reads(project: Project, registry=None) -> list[Finding]:
    knobs = {k.name: k for k in (registry or reg_mod.KNOBS)}
    findings: list[Finding] = []
    modules = list(project.iter_modules())
    bench = project.bench_module()
    if bench is not None:
        modules.append(bench)
    for mi in modules:
        for name, node in env_reads(mi):
            knob = knobs.get(name)
            if knob is None:
                findings.append(Finding(
                    "knob-unregistered", mi.relpath, node.lineno, name,
                    f"environment read of unregistered knob {name}; add it to "
                    f"photon_ml_tpu_torch/analysis/registry.py (with surface exemptions where they apply)",
                ))
                continue
            if knob.kind in _NUMERIC_KINDS and _in_boolean_context(mi, node):
                findings.append(Finding(
                    "knob-truthy-parse", mi.relpath, node.lineno, name,
                    f"{name} is a {knob.kind} knob but this read is used as a bare truth value: '0' is a "
                    f"truthy string, so '=0' inverts the intent; use the strict parse idiom (int(env) != 0) "
                    f"like the sibling knobs",
                ))
    return findings


# -- mirror-surface extraction ------------------------------------------------------------
def _function(mi: ModuleInfo, name: str) -> ast.FunctionDef | None:
    for node in ast.walk(mi.tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def sink_snapshot_keys(sink_mi: ModuleInfo) -> set[str] | None:
    """Keys assigned as ``knobs["..."] = ...`` inside ``_knob_snapshot``."""
    fn = _function(sink_mi, "_knob_snapshot")
    if fn is None:
        return None
    return {s for node in ast.walk(fn)
            if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store) and (s := const_str(node.slice))}


def devcost_fingerprint(devcost_mi: ModuleInfo) -> set[str] | None:
    """The env names ``_knob_raw_state`` reads."""
    fn = _function(devcost_mi, "_knob_raw_state")
    if fn is None:
        return None
    return {name for name, _ in env_reads(fn)}


def readme_table_block(readme_path: str) -> str | None:
    """The committed port knob-table block, markers included (None =
    markers not found)."""
    with open(readme_path, encoding="utf-8") as f:
        text = f.read()
    begin = text.find(reg_mod.KNOB_TABLE_BEGIN_PREFIX)
    end = text.find(reg_mod.KNOB_TABLE_END, max(begin, 0))
    if begin < 0 or end < 0:
        return None
    return text[begin:end + len(reg_mod.KNOB_TABLE_END)]


def readme_table_names(readme_path: str) -> set[str] | None:
    """Knob names in the generated port table (None = no markers)."""
    block = readme_table_block(readme_path)
    if block is None:
        return None
    return {line.strip().split("`")[1] for line in block.splitlines() if line.strip().startswith("| `PHOTON_")}


def check_surfaces(project: Project, registry=None) -> list[Finding]:
    knobs = list(registry or reg_mod.KNOBS)
    # a fixture registry declares no constants
    constants = reg_mod.SNAPSHOT_CONSTANTS if registry is None else ()
    findings: list[Finding] = []

    # -- sink snapshot (both directions) ---------------------------------------------------
    sink_mi = project.module(_SINK_RELPATH)
    if sink_mi is not None:
        keys = sink_snapshot_keys(sink_mi)
        if keys is not None:
            for k in knobs:
                if k.sink_key and k.sink_key not in keys:
                    findings.append(Finding(
                        "knob-sink-missing", sink_mi.relpath, 1, k.name,
                        f"{k.name} requires snapshot key '{k.sink_key}' in sink._knob_snapshot but the "
                        f"snapshot does not report it",
                    ))
            for key, _ in constants:
                if key not in keys:
                    findings.append(Finding(
                        "knob-sink-missing", sink_mi.relpath, 1, key,
                        f"the registry declares snapshot constant '{key}' but sink._knob_snapshot does not "
                        f"report it; drop the declaration or restore the key",
                    ))
            claimed = {k.sink_key for k in knobs if k.sink_key} | {key for key, _ in constants}
            for key in sorted(keys - claimed):
                findings.append(Finding(
                    "knob-sink-unregistered", sink_mi.relpath, 1, key,
                    f"sink._knob_snapshot reports '{key}' but no registered knob claims that key and the "
                    f"registry declares no such constant",
                ))

    # -- devcost fingerprint ----------------------------------------------------------------
    devcost_mi = project.module(_DEVCOST_RELPATH)
    if devcost_mi is not None:
        envs = devcost_fingerprint(devcost_mi)
        if envs is not None:
            for k in knobs:
                # the snapshot reads env > global through the accessors at
                # SNAPSHOT time, so the env var itself must be fingerprinted:
                # the global alone goes stale on a mid-process env flip
                if k.needs_devcost and k.name not in envs:
                    findings.append(Finding(
                        "knob-devcost-missing", devcost_mi.relpath, 1, k.name,
                        f"{k.name} feeds sink._knob_snapshot (key '{k.sink_key}') but "
                        f"devcost._knob_raw_state does not fingerprint its env var: a mid-process flip of "
                        f"only this knob would reuse a stale memoized snapshot in capture keys",
                    ))

    # -- README knob table ------------------------------------------------------------------
    if project.readme_path is not None:
        names = readme_table_names(project.readme_path)
        relpath = "README.md"
        if names is None:
            findings.append(Finding(
                "knob-readme-missing", relpath, 1, "knob-table",
                "README has no generated port knob table (markers not found); run "
                "`photon-ml-tpu-torch lint --write-docs`",
            ))
        else:
            registered = {k.name for k in knobs}
            for name in sorted(registered - names):
                findings.append(Finding(
                    "knob-readme-missing", relpath, 1, name,
                    f"{name} is registered but absent from the port's README knob table; run "
                    f"`photon-ml-tpu-torch lint --write-docs`",
                ))
            for name in sorted(names - registered):
                findings.append(Finding(
                    "knob-readme-stale", relpath, 1, name,
                    f"the port's README knob table lists {name}, which is not in the registry; run "
                    f"`photon-ml-tpu-torch lint --write-docs`",
                ))
            if names == registered and registry is None:
                # same names but drifted content (a default, doc or surface
                # column): the committed block must match the rendered table
                # line for line. Only meaningful against the real registry.
                committed = _normalize_block(readme_table_block(project.readme_path) or "")
                if committed != _normalize_block(reg_mod.render_knob_table()):
                    findings.append(Finding(
                        "knob-readme-stale", relpath, 1, "knob-table",
                        "the port's README knob table content drifted from the registry (a default/doc/"
                        "surface column changed); run `photon-ml-tpu-torch lint --write-docs`",
                    ))
    return findings


def _normalize_block(block: str) -> list[str]:
    return [ln.strip() for ln in block.splitlines() if ln.strip()]


def run(project: Project, registry=None) -> list[Finding]:
    return scan_env_reads(project, registry) + check_surfaces(project, registry)
