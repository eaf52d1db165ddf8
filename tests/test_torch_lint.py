"""The port's static analysis (``photon_ml_tpu_torch/analysis``) against the
reference's (``photon_ml_tpu/analysis``), and the port's tree held to it.

Three parts, all host-side stdlib ``ast`` work:

- **Parity.** The fixture trees of ``tests/test_lint.py`` are built twice,
  once under each package's name, and both packages' ``knobs`` (with a
  fixture registry), ``concurrency``, ``exceptions`` and ``telemetry``
  passes must give the same findings (code, package-relative file, line,
  scope). The reference's ``jit-keys`` bodies are paired with the same
  bodies under ``torch.cuda.graph``, a capture span,
  ``make_graphed_callables``, ``torch.compile`` and ``functools`` caches:
  ``cache-keys`` must flag what ``jit-keys`` flags, at the same lines. The
  suppression round trip and the CLI's JSON keys match the reference's.
- **Repo drift.** The port's tree lints clean with its baseline, and drift
  seeded into copies of its modules is caught: a variable dropped from the
  devcost fingerprint, an unregistered read, a knob accessor under a CUDA
  graph capture or a cache, a snapshot key renamed or dropped.
- **Registry.** Its names are exactly the ``PHOTON_*`` names the port
  reads: the reference's less its four TPU schedule constants.

The faults the lint found in the port are held at the end.
"""

from __future__ import annotations

import ast
import json
import os
import socket
import struct
import sys
import textwrap
import threading
import time

import pytest

from photon_ml_tpu.analysis import (
    concurrency_pass as ref_concurrency, exceptions_pass as ref_exceptions, jit_keys_pass as ref_jit,
    knobs_pass as ref_knobs, telemetry_pass as ref_telemetry,
)
from photon_ml_tpu.analysis import core as ref_core
from photon_ml_tpu.analysis import registry as ref_registry
from photon_ml_tpu.analysis import runner as ref_runner
from photon_ml_tpu_torch.analysis import (
    cache_keys_pass, concurrency_pass, core, exceptions_pass, knobs_pass, registry, runner, telemetry_pass,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PKG, PORT_PKG = "photon_ml_tpu", "photon_ml_tpu_torch"


def _write(root, relpath: str, source: str) -> None:
    path = os.path.join(str(root), relpath)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(textwrap.dedent(source))


def _tree(tmp_path, pkg: str, files: dict[str, str]) -> str:
    """One fixture tree under package ``pkg``: ``files`` maps paths
    relative to the package to sources."""
    root = tmp_path / pkg
    _write(root, f"{pkg}/__init__.py", "")
    for rel, src in files.items():
        _write(root, f"{pkg}/{rel}", src)
    return str(root)


def _norm(findings, pkg: str) -> list[tuple]:
    """(code, package-relative file, line, scope), sorted."""
    out = []
    for f in findings:
        rel = f.file[len(pkg) + 1:] if f.file.startswith(pkg + "/") else f.file
        out.append((f.code, rel, f.line, f.scope))
    return sorted(out)


def _both(tmp_path, files, ref_pass, port_pass, ref_kw=None, port_kw=None):
    """Run one pass of each package over the same fixture tree, built
    under each package's name; returns both findings, normalized, and both
    waived counts."""
    out = []
    for pkg, run, kw, core_mod in ((REF_PKG, ref_pass, ref_kw or {}, ref_core),
                                   (PORT_PKG, port_pass, port_kw or {}, core)):
        project = core_mod.Project(root=_tree(tmp_path, pkg, files), package_dirs=(pkg,))
        kept, waived = core_mod.apply_waivers(project, run(project, **kw))
        out.append((_norm(kept, pkg), waived))
    return out


# ---------------------------------------------------------------------------
# parity: the fixture trees of tests/test_lint.py, under both names
# ---------------------------------------------------------------------------
def _mini_registries():
    """The reference test's MINI_REGISTRY in each package's Knob."""
    common = [
        dict(name="PHOTON_TEST_INT", kind="int", parse="strict_int", default="0", owner="pkg/mod.py",
             doc="test int knob", accessors=("test_int_knob",), retune_global="TEST_INT"),
        dict(name="PHOTON_TEST_PATH", kind="path", parse="raw", default="unset", owner="pkg/mod.py",
             doc="test path knob"),
    ]
    ref = tuple(ref_registry.Knob(**k, exempt=(("retune", "test"), ("sink", "test"))) for k in common)
    port = tuple(registry.Knob(**k, exempt=(("sink", "test"),)) for k in common)
    return ref, port


KNOB_FIXTURES = {
    "unregistered": """
        import os

        def f():
            return os.environ.get("PHOTON_TOTALLY_NEW")
    """,
    "truthy_parse": """
        import os

        def f():
            return not os.environ.get("PHOTON_TEST_INT")
    """,
    "strict_parse_and_path_truthiness": """
        import os

        def f():
            env = os.environ.get("PHOTON_TEST_INT")
            if env is not None and env != "":
                return int(env) != 0
            return False

        def g():
            # truthiness on a path knob is fine by design
            return os.environ.get("PHOTON_TEST_PATH") or "/tmp/x"
    """,
    "truthy_in_bool_op_and_if": """
        import os

        def f(x):
            if os.environ.get("PHOTON_TEST_INT"):
                return x and os.environ.get("PHOTON_TEST_INT")
            return "PHOTON_OTHER_NEW" in os.environ
    """,
}


@pytest.mark.parametrize("name", sorted(KNOB_FIXTURES))
def test_knobs_pass_parity(tmp_path, name):
    ref_reg, port_reg = _mini_registries()
    (ref, _), (port, _) = _both(tmp_path, {"mod.py": KNOB_FIXTURES[name]}, ref_knobs.run, knobs_pass.run,
                                {"registry": ref_reg}, {"registry": port_reg})
    assert port == ref
    expected = {"unregistered": ["knob-unregistered"], "truthy_parse": ["knob-truthy-parse"],
                "strict_parse_and_path_truthiness": [],
                "truthy_in_bool_op_and_if": ["knob-truthy-parse"] * 2 + ["knob-unregistered"]}[name]
    assert sorted(f[0] for f in port) == expected


def test_knobs_surface_drift_parity(tmp_path):
    """Sink and devcost drift on a fixture registry: a knob missing from
    the snapshot, a key no knob claims, a snapshot knob the fingerprint
    does not read; the same findings in both packages."""
    files = {
        "obs/sink.py": """
            def _knob_snapshot():
                knobs = {}
                knobs["alpha"] = alpha()
                knobs["zzz"] = 1
                return knobs
        """,
        "obs/devcost.py": """
            import os

            def _knob_raw_state():
                env = os.environ
                return (env.get("PHOTON_ALPHA"),)
        """,
    }
    kws = []
    for knob_cls, exempt in ((ref_registry.Knob, (("retune", "test"),)), (registry.Knob, ())):
        kws.append({"registry": tuple(
            knob_cls(name=n, kind="int", parse="strict_int", default="0", owner="pkg/mod.py", doc="d",
                     accessors=(a,), sink_key=key, exempt=exempt, **({"alt": "1"} if knob_cls is registry.Knob
                                                                      else {}))
            for n, a, key in (("PHOTON_ALPHA", "alpha", "alpha"), ("PHOTON_BETA", "beta", "beta")))})
    (ref, _), (port, _) = _both(tmp_path, files, ref_knobs.check_surfaces, knobs_pass.check_surfaces, *kws)
    assert port == ref == sorted([
        ("knob-devcost-missing", "obs/devcost.py", 1, "PHOTON_BETA"),
        ("knob-sink-missing", "obs/sink.py", 1, "PHOTON_BETA"),
        ("knob-sink-unregistered", "obs/sink.py", 1, "zzz"),
    ])


CONCURRENCY_FIXTURES = {
    "unlocked_mutation_in_pool_module": ("""
        import threading
        from concurrent.futures import ThreadPoolExecutor

        _CACHE = {}
        _POOL = ThreadPoolExecutor(2)

        def remember(k, v):
            _CACHE[k] = v
    """, 1, 0),
    "locked_and_locked_helper_and_waiver": ("""
        import threading

        _LOCK = threading.Lock()
        _CACHE = {}
        _MEMO = []

        def remember(k, v):
            with _LOCK:
                _CACHE[k] = v

        def _evict_over_limits_locked():
            _CACHE.clear()

        def memoize(v):
            # lint: waive(conc-unlocked-mutation) single-writer memo
            _MEMO.append(v)
    """, 0, 1),
    "threadless_module": ("""
        _CACHE = {}

        def remember(k, v):
            _CACHE[k] = v
    """, 0, 0),
    "aug_assign_and_delete": ("""
        import threading

        _STATS = {"n": 0}
        _T = threading.Thread(target=print)

        def bump():
            _STATS["n"] += 1
            del _STATS["n"]
            _STATS.update(n=0)
    """, 3, 0),
}


@pytest.mark.parametrize("name", sorted(CONCURRENCY_FIXTURES))
def test_concurrency_pass_parity(tmp_path, name):
    src, n_findings, n_waived = CONCURRENCY_FIXTURES[name]
    (ref, ref_w), (port, port_w) = _both(tmp_path, {"mod.py": src}, ref_concurrency.run, concurrency_pass.run)
    assert (port, port_w) == (ref, ref_w)
    assert (len(port), port_w) == (n_findings, n_waived)
    assert all(f[0] == "conc-unlocked-mutation" for f in port)


EXCEPTION_FIXTURES = {
    "swallow_in_scoped_module": ("parallel/bad.py", """
        def drain():
            try:
                risky()
            except OSError:
                pass
    """, 1),
    "raise_emit_and_counter": ("parallel/ok.py", """
        def a():
            try:
                risky()
            except OSError as e:
                raise PeerLost(1) from e

        def b():
            try:
                risky()
            except OSError:
                emit_event("exchange_drain_error", tag="x")

        def c():
            try:
                risky()
            except OSError:
                REGISTRY.counter_inc("p2p.drain_errors")
    """, 0),
    "out_of_scope_module": ("obs/guard.py", """
        def sample():
            try:
                risky()
            except Exception:
                pass  # telemetry must never take down the run
    """, 0),
    "streaming_and_descent_in_scope": ("game/streaming.py", """
        class T:
            def fit(self):
                try:
                    go()
                except (OSError, ValueError):
                    return None
                except BaseException:
                    log.warning("x")
                    raise
    """, 1),
    "descent_waived": ("game/descent.py", """
        def run():
            try:
                go()
            # lint: waive(except-swallow) a deliberate swallow
            except KeyError:
                pass
    """, 0),
}


@pytest.mark.parametrize("name", sorted(EXCEPTION_FIXTURES))
def test_exceptions_pass_parity(tmp_path, name):
    rel, src, n = EXCEPTION_FIXTURES[name]
    (ref, ref_w), (port, port_w) = _both(tmp_path, {rel: src}, ref_exceptions.run, exceptions_pass.run)
    assert (port, port_w) == (ref, ref_w)
    assert len(port) == n and all(f[0] == "except-swallow" for f in port)


TELEMETRY_FIXTURES = {
    "dangling_consumer": ("""
        def summarize(records):
            return [r for r in records
                    if r["event"] == "ghost_event"]
    """, """
        def run():
            emit_event("real_event", x=1)
    """, {"event:ghost_event", "event:real_event"}),
    "unrendered_emission": ("""
        def summarize(records):
            return [r for r in records
                    if r["event"] == "real_event"]
    """, """
        def run():
            emit_event("real_event", x=1)
            emit_event("orphan_event", x=2)
    """, {"event:orphan_event"}),
    "agreeing_surfaces": ("""
        def summarize(records, metrics):
            spans = [r for r in records
                     if r["event"] == "real_event"]
            counters = metrics.get("counters", {})
            hits = counters.get("cache.hits", {})
            return spans, hits
    """, """
        def run():
            emit_event("real_event", x=1)
            REGISTRY.counter_inc("cache.hits")
    """, set()),
    "wildcards_and_dict_records": ("""
        def summarize(records, metrics):
            gauges = metrics.get("gauges", {})
            flops = [v for k, v in gauges.items() if k.startswith("devcost.")]
            return [r for r in records if r["event"] in ("span", "peer_lost")], flops
    """, """
        def run(label):
            REGISTRY.gauge_set(f"devcost.{label}.flops", 1.0)
            REGISTRY.gauge_set(f"lonely.{label}", 1.0)
            sink.emit({"event": "span", "name": "x"})
    """, {"metric:lonely.*"}),
}


@pytest.mark.parametrize("name", sorted(TELEMETRY_FIXTURES))
def test_telemetry_pass_parity(tmp_path, name):
    report, emitter, scopes = TELEMETRY_FIXTURES[name]
    files = {"obs/report.py": report, "obs/__init__.py": "", "emitter.py": emitter}
    (ref, _), (port, _) = _both(tmp_path, files, ref_telemetry.run, telemetry_pass.run)
    assert port == ref
    assert {f[3] for f in port} == scopes


# -- jit-keys and its twin, cache-keys -------------------------------------
JIT_BODIES = {
    # tests/test_lint.py's three bodies; {deco} replaces the decorator line
    # and {tail} wraps the function by name instead
    "accessor_call": ("f", """
        import os, functools, jax, torch
        from functools import partial

        {deco}
        def f(x):
            return x * (2 if kernel_dtype() == "f32" else 1)
        {tail}
    """, 1),
    "retune_global_and_env_read": ("f", """
        import os, functools, jax, torch
        from functools import partial

        {deco_partial}
        def f(x, n):
            k = os.environ.get("PHOTON_GROUPS_PER_RUN")
            return x + GROUPS_PER_RUN

        def g(x):
            return x

        {wrap_g}
        {tail}
    """, 2),
    "static_arg_discipline": ("_apply", """
        import os, functools, jax, torch
        from functools import partial

        {deco_partial}
        def _apply(x, groups_per_run, GROUPS_PER_RUN):
            return x * groups_per_run * GROUPS_PER_RUN

        def apply(x):
            return _apply(x, groups_per_run=kernel_dtype_outside())
        {tail}
    """, 0),
    "nested_helper": ("f", """
        import os, functools, jax, torch
        from functools import partial

        {deco}
        def f(x):
            def inner():
                return GROUPS_PER_RUN + int(os.environ["PHOTON_GROUPS_PER_RUN"])
            return x * inner() * kernel_dtype()
        {tail}
    """, 3),
}
JIT_FORM = {"deco": "@jax.jit", "deco_partial": '@partial(jax.jit, static_argnames=("n",))',
            "wrap": "_W_{n} = jax.jit({n})"}
# the port's bodies: (decorator or None, wrapping statement)
CACHE_FORMS = {
    "functools_cache": ("@functools.cache", "_W_{n} = functools.cache({n})"),
    "lru_cache": ("@functools.lru_cache(maxsize=None)", "_W_{n} = functools.lru_cache(maxsize=None)({n})"),
    "torch_compile": ("@torch.compile", "_W_{n} = torch.compile({n})"),
    "torch_compile_args": ("@torch.compile(dynamic=False)", "_W_{n} = torch.compile({n}, dynamic=False)"),
    "cuda_graph_block": (None, "with torch.cuda.graph(G): _W_{n} = {n}(X)"),
    "capture_span": (None, "G.capture_begin(); _W_{n} = {n}(X); G.capture_end()"),
    "graphed_callables": (None, "_W_{n} = torch.cuda.make_graphed_callables({n}, (X,))"),
}
_CODES = {"jit-knob-accessor": "cache-knob-accessor", "jit-retune-global": "cache-retune-global",
          "jit-env-read": "cache-env-read"}


def _jit_fixture_registries():
    kw = dict(name="PHOTON_GROUPS_PER_RUN", kind="int", parse="strict_int", default="2", owner="pkg/mod.py",
              doc="d", accessors=("kernel_dtype",), retune_global="GROUPS_PER_RUN")
    return (ref_registry.Knob(**kw, exempt=(("retune", "t"), ("sink", "t"))),
            registry.Knob(**kw, exempt=(("sink", "t"),)))


def _render(body: str, fn: str, deco: str | None, wrap: str, by_name: bool) -> str:
    wrap_g = wrap.format(n="g")
    if by_name or deco is None:
        return body.format(deco="# wrapped below", deco_partial="# wrapped below", wrap_g=wrap_g,
                           tail=wrap.format(n=fn))
    return body.format(deco=deco, deco_partial=deco, wrap_g=wrap_g, tail="")


# a capture wraps a call, never a definition: those forms come by name only
_FORM_CASES = [(form, by_name) for form in sorted(CACHE_FORMS) for by_name in (False, True)
               if by_name or CACHE_FORMS[form][0] is not None]


@pytest.mark.parametrize("form, by_name", _FORM_CASES,
                         ids=[f"{f}-{'by_name' if b else 'decorated'}" for f, b in _FORM_CASES])
@pytest.mark.parametrize("body", sorted(JIT_BODIES))
def test_cache_keys_flags_what_jit_keys_flags(tmp_path, body, form, by_name):
    fn, src, n = JIT_BODIES[body]
    deco, wrap = CACHE_FORMS[form]
    ref_reg, port_reg = _jit_fixture_registries()
    jit_src = _render(src, fn, JIT_FORM["deco_partial" if "deco_partial" in src else "deco"], JIT_FORM["wrap"],
                      by_name)
    ref_root = _tree(tmp_path, REF_PKG, {"mod.py": jit_src})
    ref = ref_jit.run(ref_core.Project(root=ref_root, package_dirs=(REF_PKG,)), registry=(ref_reg,))
    port_root = _tree(tmp_path, PORT_PKG, {"mod.py": _render(src, fn, deco, wrap, by_name)})
    port = cache_keys_pass.run(core.Project(root=port_root, package_dirs=(PORT_PKG,)), registry=(port_reg,))
    assert len(ref) == n
    assert sorted((_CODES[f.code], f.line) for f in ref) == sorted((f.code, f.line) for f in port)


def test_cache_keys_reads_any_environment_variable_and_follows_callees(tmp_path):
    """Beyond the reference's rule: a capture reads ``os.getenv`` and
    non-``PHOTON_`` variables too, through a module function it calls."""
    root = _tree(tmp_path, PORT_PKG, {"mod.py": """
        import os, torch

        def helper():
            return os.getenv("CUDA_VISIBLE_DEVICES"), os.environ["HOME"], os.getenv("PHOTON_RE_SHARD")

        def step(x):
            return helper()

        def capture(g, x):
            g.capture_begin()
            try:
                out = step(x)
            finally:
                g.capture_end()
            return out

        def not_captured():
            return os.getenv("HOME")
    """})
    fs = cache_keys_pass.run(core.Project(root=root, package_dirs=(PORT_PKG,)))
    assert sorted(f.scope for f in fs) == ["capture@capture:CUDA_VISIBLE_DEVICES", "capture@capture:HOME",
                                           "capture@capture:PHOTON_RE_SHARD"]
    assert {f.code for f in fs} == {"cache-env-read"} and {f.line for f in fs} == {5}


# -- suppression and the CLI -------------------------------------------------
def _unregistered_tree(tmp_path, pkg: str, name: str = "mod.py", knob: str = "PHOTON_NOT_REGISTERED") -> str:
    root = tmp_path / pkg
    _write(root, f"{pkg}/__init__.py", "")
    _write(root, f"{pkg}/{name}", f"""
        import os

        def f():
            return os.environ.get("{knob}")
    """)
    return str(root)


def test_baseline_round_trip_matches_the_references(tmp_path):
    docs = []
    for pkg, lint, core_mod in ((REF_PKG, ref_runner.lint, ref_core), (PORT_PKG, runner.lint, core)):
        root = _unregistered_tree(tmp_path, pkg)
        doc = lint(root)
        assert doc["exit"] == 1 and [f.code for f in doc["_active"]] == ["knob-unregistered"]
        bp = os.path.join(root, core_mod.DEFAULT_BASELINE_NAME)
        core_mod.write_baseline(bp, doc["_active"], reason="triaged for the test")
        with open(bp) as f:
            entries = json.load(f)
        assert entries["version"] == 1 and len(entries["suppressions"]) == 1
        e = entries["suppressions"][0]
        assert set(e) == {"code", "file", "scope", "reason", "note"}
        entries = (e["code"], e["file"][len(pkg) + 1:], e["scope"], e["reason"])
        doc2 = lint(root)
        assert (doc2["exit"], doc2["suppressed"], doc2["findings"]) == (0, 1, [])
        # a second finding is not absorbed by the baseline
        _write(root, f"{pkg}/mod2.py", """
            import os

            def g():
                return os.environ.get("PHOTON_ALSO_NEW")
        """)
        doc3 = lint(root)
        assert [f.scope for f in doc3["_active"]] == ["PHOTON_ALSO_NEW"]
        docs.append(entries)
    assert docs[0] == docs[1]
    assert core.DEFAULT_BASELINE_NAME == "lint_baseline_torch.json"


def test_cli_json_keys_and_exit_codes_match_the_references(tmp_path, capsys):
    from photon_ml_tpu.cli import lint as ref_cli
    from photon_ml_tpu_torch.cli import lint as port_cli

    docs = []
    for pkg, cli in ((REF_PKG, ref_cli), (PORT_PKG, port_cli)):
        root = _unregistered_tree(tmp_path, pkg)
        with pytest.raises(SystemExit) as exc:
            cli.main(["--root", root, "--json", "--select", "knobs,concurrency,exceptions,telemetry"])
        assert exc.value.code == 1
        docs.append(json.loads(capsys.readouterr().out))
    ref, port = docs
    assert set(port) == set(ref)
    assert port["lint_schema_version"] == ref["lint_schema_version"] == 1
    assert [set(f) for f in port["findings"]] == [set(f) for f in ref["findings"]]
    assert [(f["code"], f["scope"], f["line"]) for f in port["findings"]] == \
        [(f["code"], f["scope"], f["line"]) for f in ref["findings"]]
    root = _unregistered_tree(tmp_path / "clean", PORT_PKG, knob="PHOTON_RE_SHARD")
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["--root", root, "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert exc.value.code == 0 and doc["passes"] == list(runner.PASSES) and len(doc["passes"]) == 5


def test_unknown_pass_is_refused():
    with pytest.raises(ValueError, match="unknown lint pass"):
        runner.run_passes(core.Project(root=ROOT), select=["jit-keys"])


# ---------------------------------------------------------------------------
# repo drift: the port's tree, and drift seeded into copies of its modules
# ---------------------------------------------------------------------------
def _port_project(**mutated: str) -> core.Project:
    """The port's tree, with ``mutated`` (repo-relative path -> source)
    standing in for those modules."""
    project = core.Project(root=ROOT)
    for rel, src in mutated.items():
        project._modules[rel] = core.ModuleInfo(f"<mutated {rel}>", rel, src)
    return project


def _source(rel: str) -> str:
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        return f.read()


def test_port_tree_lints_clean():
    doc = runner.lint(runner.discover_root(os.path.dirname(__file__)))
    assert doc["findings"] == [], (
        "photon-ml-tpu-torch lint found non-suppressed findings: fix, waive inline with a reason, or "
        "triage into lint_baseline_torch.json:\n"
        + "\n".join(f"{f['file']}:{f['line']} [{f['code']}] {f['message']}" for f in doc["findings"]))
    assert doc["exit"] == 0 and doc["passes"] == list(runner.PASSES)
    assert doc["baseline"] == "lint_baseline_torch.json"


def test_no_knob_code_is_waived_or_baselined_and_every_suppression_has_a_reason():
    _, entries = core.load_baseline(os.path.join(ROOT, core.DEFAULT_BASELINE_NAME))
    assert entries and all(e["reason"].strip() for e in entries)
    assert not [e for e in entries if e["code"].startswith("knob-")]
    for mi in core.Project(root=ROOT).iter_modules():
        for i, line in enumerate(mi.source.splitlines(), start=1):
            m = core._WAIVE_RE.search(line)
            if m:
                assert "knob-" not in m.group(1), f"{mi.relpath}:{i} waives a knob code"
                assert line[m.end():].strip(), f"{mi.relpath}:{i} waives without a reason"


_DEVCOST = "photon_ml_tpu_torch/obs/devcost.py"


def _fingerprinted() -> list[str]:
    return sorted(knobs_pass.devcost_fingerprint(core.ModuleInfo(_DEVCOST, _DEVCOST, _source(_DEVCOST))))


@pytest.mark.parametrize("name", [k.name for k in registry.KNOBS if k.sink_key])
def test_env_read_dropped_from_the_devcost_fingerprint_is_caught(name):
    """The class found by hand once: a snapshot knob the fingerprint does
    not read. Each one, dropped from a copy of ``_knob_raw_state``."""
    src = _source(_DEVCOST)
    read = f'env.get("{name}"),'
    assert src.count(read) == 1, name
    fs = knobs_pass.check_surfaces(_port_project(**{_DEVCOST: src.replace(read, "")}))
    assert [(f.code, f.scope) for f in fs] == [("knob-devcost-missing", name)]


def test_fingerprint_reads_every_snapshot_knob():
    assert _fingerprinted() == sorted(k.name for k in registry.KNOBS if k.sink_key)


def test_unregistered_read_added_to_a_port_module_is_caught():
    rel = "photon_ml_tpu_torch/ops/streaming.py"
    src = _source(rel) + '\n\ndef _new_knob():\n    return os.environ.get("PHOTON_TOTALLY_NEW_KNOB")\n'
    fs = knobs_pass.scan_env_reads(_port_project(**{rel: src}))
    assert [(f.code, f.file, f.scope) for f in fs] == [("knob-unregistered", rel, "PHOTON_TOTALLY_NEW_KNOB")]


def test_truthy_parse_seeded_into_a_port_accessor_is_caught():
    rel = "photon_ml_tpu_torch/ops/glm.py"
    src = _source(rel)
    good = '    env = os.environ.get("PHOTON_DISABLE_FUSED")\n    if env is not None and env != "":\n'
    assert good in src
    src = src.replace(good, '    env = os.environ.get("PHOTON_DISABLE_FUSED")\n'
                            '    if os.environ.get("PHOTON_DISABLE_FUSED"):\n', 1)
    fs = knobs_pass.scan_env_reads(_port_project(**{rel: src}))
    assert [(f.code, f.scope) for f in fs] == [("knob-truthy-parse", "PHOTON_DISABLE_FUSED")]


_STREAMING = "photon_ml_tpu_torch/ops/streaming.py"
_ACCESSOR_LINE = "    executor = stream_executor.stream_executor_enabled()\n"


def _enclosing(rel: str, text: str) -> str:
    mi = core.ModuleInfo(rel, rel, _source(rel))
    line = mi.source.splitlines().index(text.rstrip("\n")) + 1
    node = next(n for n in ast.walk(mi.tree) if isinstance(n, ast.stmt) and n.lineno == line)
    return mi.enclosing_function(node)


def test_knob_accessor_wrapped_in_a_cuda_graph_capture_is_caught():
    src = _source(_STREAMING)
    assert src.count(_ACCESSOR_LINE) == 1
    fn = _enclosing(_STREAMING, _ACCESSOR_LINE)
    seeded = src.replace(_ACCESSOR_LINE, "    with torch.cuda.graph(_graph):\n    " + _ACCESSOR_LINE, 1)
    assert cache_keys_pass.run(_port_project()) == []
    fs = cache_keys_pass.run(_port_project(**{_STREAMING: seeded}))
    assert [(f.code, f.file, f.scope) for f in fs] == [
        ("cache-knob-accessor", _STREAMING, f"{fn}@graph:stream_executor_enabled")]


def test_knob_accessor_under_a_functools_cache_is_caught():
    src = _source(_STREAMING)
    fn = _enclosing(_STREAMING, _ACCESSOR_LINE)
    seeded = src.replace(f"\ndef {fn}(", f"\n@functools.lru_cache(maxsize=None)\ndef {fn}(", 1)
    assert seeded != src
    fs = cache_keys_pass.run(_port_project(**{_STREAMING: seeded}))
    assert ("cache-knob-accessor", f"{fn}:stream_executor_enabled") in {(f.code, f.scope) for f in fs}


_SINK = "photon_ml_tpu_torch/obs/sink.py"


def test_sink_snapshot_key_renamed_is_caught_both_ways():
    src = _source(_SINK)
    assert 'knobs["kernel_dtype"]' in src
    fs = knobs_pass.check_surfaces(_port_project(**{_SINK: src.replace('knobs["kernel_dtype"]',
                                                                        'knobs["kernel_dtypo"]')}))
    assert sorted((f.code, f.scope) for f in fs) == [("knob-sink-missing", "PHOTON_KERNEL_DTYPE"),
                                                     ("knob-sink-unregistered", "kernel_dtypo")]


@pytest.mark.parametrize("key", [key for key, _ in registry.SNAPSHOT_CONSTANTS])
def test_declared_snapshot_constant_dropped_is_caught(key):
    src = _source(_SINK)
    assert f'knobs["{key}"]' in src
    fs = knobs_pass.check_surfaces(_port_project(**{_SINK: src.replace(f'knobs["{key}"]', "_dropped")}))
    assert [(f.code, f.scope) for f in fs] == [("knob-sink-missing", key)]


def test_readme_tables_do_not_match_each_other(tmp_path):
    """Each package's README check reads its own table only, and the
    port's --write-docs rewrites only between the port's markers."""
    readme = os.path.join(ROOT, "README.md")
    assert knobs_pass.readme_table_names(readme) == {k.name for k in registry.KNOBS}
    assert ref_knobs.readme_table_names(readme) == {k.name for k in ref_registry.KNOBS}
    with open(readme, encoding="utf-8") as f:
        text = f.read()
    port_block = knobs_pass.readme_table_block(readme)
    ref_block = ref_knobs.readme_table_block(readme)
    assert port_block not in ref_block and ref_block not in port_block
    only_ref = tmp_path / "README.md"
    only_ref.write_text(text.replace(port_block, ""))
    assert knobs_pass.readme_table_names(str(only_ref)) is None
    # a stale port table: --write-docs regenerates it and leaves the reference's as it was
    stale = text.replace(port_block, port_block.replace("| `PHOTON_RE_SHARD` |", "| `PHOTON_RE_SHARDX` |"))
    root = tmp_path / "docs"
    os.makedirs(root)
    (root / "README.md").write_text(stale)
    fs = knobs_pass.check_surfaces(core.Project(root=str(root)))
    assert sorted((f.code, f.scope) for f in fs) == [("knob-readme-missing", "PHOTON_RE_SHARD"),
                                                     ("knob-readme-stale", "PHOTON_RE_SHARDX")]
    from photon_ml_tpu_torch.cli import lint as port_cli

    with pytest.raises(SystemExit) as exc:
        port_cli.main(["--root", str(root), "--write-docs"])
    assert exc.value.code == 0
    assert (root / "README.md").read_text() == text


# ---------------------------------------------------------------------------
# the registry: exactly the names the port reads
# ---------------------------------------------------------------------------
TPU_SCHEDULE_CONSTANTS = {"PHOTON_GROUPS_PER_STEP", "PHOTON_SEGMENTS_PER_DMA", "PHOTON_GROUPS_PER_RUN",
                          "PHOTON_PIPELINE_SEGMENTS"}


def _port_reads() -> set[str]:
    return {name for mi in core.Project(root=ROOT).iter_modules() for name, _ in core.env_reads(mi)}


def test_registry_is_the_ports_read_names():
    names = {k.name for k in registry.KNOBS}
    assert names == _port_reads()
    assert len(names) == len(registry.KNOBS) == 43
    ref_names = {k.name for k in ref_registry.KNOBS}
    assert len(ref_names) == 47 and ref_names - names == TPU_SCHEDULE_CONSTANTS and names <= ref_names


def test_registry_matches_the_references_semantics():
    """Kind, parse idiom and snapshot key as the reference declares them
    (the port's snapshot carries ``fused`` for the knob the reference
    exempts from its snapshot)."""
    ref = ref_registry.by_name()
    for k in registry.KNOBS:
        r = ref[k.name]
        assert (k.kind, k.parse) == (r.kind, r.parse), k.name
        assert k.sink_key == (r.sink_key if k.name != "PHOTON_DISABLE_FUSED" else "fused"), k.name
        assert k.retune_global in (None, r.retune_global), k.name


def test_registry_owners_accessors_and_globals_are_the_ports():
    for k in registry.KNOBS:
        assert k.owner.startswith("photon_ml_tpu_torch/") and os.path.exists(os.path.join(ROOT, k.owner)), k.name
        tree = ast.parse(_source(k.owner))
        defs = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
        assert set(k.accessors) <= defs, (k.name, set(k.accessors) - defs)
        if k.retune_global:
            module_globals = {t.id for n in tree.body if isinstance(n, ast.Assign) for t in n.targets
                              if isinstance(t, ast.Name)}
            assert k.retune_global in module_globals, k.name


def test_registry_self_check_refuses_ambiguity(monkeypatch):
    bad = registry.Knob(name="PHOTON_X", kind="int", parse="strict_int", default="0", owner="x", doc="d")
    monkeypatch.setattr(registry, "KNOBS", registry.KNOBS + (bad,))
    with pytest.raises(AssertionError, match="no sink_key"):
        registry._validate_registry()
    no_alt = registry.Knob(name="PHOTON_X", kind="int", parse="strict_int", default="0", owner="x", doc="d",
                           sink_key="x")
    monkeypatch.setattr(registry, "KNOBS", registry.KNOBS[:-1] + (no_alt,))
    with pytest.raises(AssertionError, match="alt"):
        registry._validate_registry()


def test_render_knob_table_covers_registry_under_the_ports_markers():
    table = registry.render_knob_table()
    assert table.startswith(registry.KNOB_TABLE_BEGIN) and table.endswith(registry.KNOB_TABLE_END)
    assert "<!-- knob-table:begin" not in table and ref_registry.KNOB_TABLE_END not in table
    for k in registry.KNOBS:
        assert f"`{k.name}`" in table


def test_alt_values_move_the_snapshot(monkeypatch):
    """Each snapshot knob's ``alt`` is valid and not its default: set, the
    live snapshot's key changes (the smoke's ``main_lint`` does this on the
    card)."""
    from photon_ml_tpu_torch.obs import devcost, sink

    for k in registry.KNOBS:
        monkeypatch.delenv(k.name, raising=False)
    base = sink._knob_snapshot()
    assert set(base) == registry.sink_keys()
    raw = devcost._knob_raw_state()
    for k in registry.KNOBS:
        if not k.sink_key:
            continue
        monkeypatch.setenv(k.name, k.alt)
        try:
            assert sink._knob_snapshot()[k.sink_key] != base[k.sink_key], k.name
            assert devcost._knob_raw_state() != raw, k.name
        finally:
            monkeypatch.delenv(k.name)


# ---------------------------------------------------------------------------
# the faults the lint found
# ---------------------------------------------------------------------------
def test_exchange_pool_is_created_once_under_concurrent_first_use(monkeypatch):
    """``conc-unlocked-mutation`` on ``_EXCHANGE_POOL``: two first uses at
    once must not start two workers (exchanges would leave program
    order)."""
    from concurrent.futures import ThreadPoolExecutor

    from photon_ml_tpu_torch.parallel import multihost as mh

    made = []

    class SlowPool(ThreadPoolExecutor):
        def __init__(self, *a, **kw):
            time.sleep(0.05)  # widen the check-then-create window
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(mh, "ThreadPoolExecutor", SlowPool)
    monkeypatch.setattr(mh, "_EXCHANGE_POOL", [None])
    barrier = threading.Barrier(8)
    got = []

    def first_use():
        barrier.wait(timeout=10)
        got.append(mh._exchange_pool())

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert len(made) == 1 and len(got) == 8 and all(p is made[0] for p in got)
    finally:
        for p in made:
            p.shutdown(wait=True)


def test_collective_books_lose_no_update_under_threads():
    """``conc-unlocked-mutation`` on ``collective_stats``: process-wide
    books, read-modify-written by whichever thread runs a collective."""
    from photon_ml_tpu_torch.parallel import multihost as mh

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n_threads, per = 16, 2000
    mh.reset_collective_stats()
    try:
        threads = [threading.Thread(target=lambda: [mh._count_collective(time.perf_counter(), 3)
                                                    for _ in range(per)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert mh.collective_stats["calls"] == n_threads * per
        assert mh.collective_stats["bytes"] == 3 * n_threads * per
    finally:
        sys.setswitchinterval(old)
        mh.reset_collective_stats()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def two_process_mesh(monkeypatch):
    """Process 0's side of a two-process mesh build on loopback; process
    1 is played by the test: a listener that takes 0's dial, and dials of
    its own toward 0."""
    from photon_ml_tpu_torch.parallel import multihost as mh

    port0 = _free_port()
    peer = socket.socket()
    peer.bind(("127.0.0.1", 0))
    peer.listen(4)
    monkeypatch.setattr(mh, "_self_pid", lambda: 0)
    monkeypatch.setattr(mh, "_HOST_ADDRS", {0: ("127.0.0.1", port0), 1: ("127.0.0.1", peer.getsockname()[1])})
    monkeypatch.delenv("PHOTON_P2P_CRC", raising=False)
    monkeypatch.delenv("PHOTON_P2P_TIMEOUT_S", raising=False)
    yield mh, port0
    peer.close()


def _dial(port: int, payload: bytes | None, deadline: float) -> socket.socket | None:
    while True:
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=1.0)
            break
        except OSError:
            if time.monotonic() > deadline:
                return None
            time.sleep(0.01)
    if payload is None:
        s.close()  # torn before its hello
        return None
    s.sendall(payload)
    return s


def test_mesh_build_survives_a_dial_torn_before_its_hello(two_process_mesh):
    """``except-swallow`` in ``_build_host_links.accept_all``: one torn
    dial (a peer's aborted earlier attempt) killed the acceptor, so the
    build failed though the peer dialed again; it is dropped now."""
    mh, port0 = two_process_mesh
    kept = []

    def peer_side():
        deadline = time.monotonic() + 10
        _dial(port0, None, deadline)
        kept.append(_dial(port0, struct.pack("!i", 1), deadline))

    t = threading.Thread(target=peer_side)
    t.start()
    try:
        links = mh._build_host_links([0, 1], 5.0)
    finally:
        t.join(timeout=15)
    try:
        assert set(links["send"]) == set(links["recv"]) == {1}
    finally:
        for side in ("send", "recv"):
            for s in links[side].values():
                s.close()
        for s in kept:
            if s is not None:
                s.close()


def test_incomplete_mesh_names_the_acceptors_error(two_process_mesh, monkeypatch):
    """The acceptor's own error, recorded and never read before, is chained
    into the incomplete-mesh error the building thread raises."""
    mh, port0 = two_process_mesh

    def broken(raw):
        raise ValueError("hello decoder broke")

    monkeypatch.setattr(mh, "_decode_hello", broken)
    kept = []
    t = threading.Thread(target=lambda: kept.append(_dial(port0, struct.pack("!i", 1), time.monotonic() + 10)))
    t.start()
    try:
        with pytest.raises(mh.PeerUnreachable, match="acceptor stopped on ValueError") as exc:
            mh._build_host_links([0, 1], 5.0)
    finally:
        t.join(timeout=15)
        for s in kept:
            if s is not None:
                s.close()
    assert isinstance(exc.value.__cause__, ValueError)
