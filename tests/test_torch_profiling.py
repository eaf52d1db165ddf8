"""The port's device traces and stage timers (``photon_ml_tpu_torch/utils/
profiling.py``) on the CPU: ``profile_trace`` writes a loadable Chrome
trace per label (``torch.profiler``; the CUDA activity joins on a card)
and is a no-op without a directory, ``annotate`` names a range in it, the
stage timers are the metrics registry's timers, and the kernels' build at
first use adds its seconds to the ``cuda.build_s`` timer (a stand-in
``nvcc`` here: this machine has none)."""

from __future__ import annotations

import json
import os
import stat
import sys

import torch

from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.utils import annotate, profile_trace, profiling


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path), "unit"):
        with annotate("matmul"):
            x = torch.ones((64, 64)) @ torch.ones((64, 64))
    assert float(x[0, 0]) == 64.0
    trace = json.loads((tmp_path / "unit" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "matmul" in names  # the annotated range
    assert any("mm" in str(n) for n in names)  # the operator it ran


def test_profile_trace_labels_are_separate_traces(tmp_path):
    for label in ("a", "b"):
        with profile_trace(str(tmp_path), label):
            torch.ones(8).sum()
    assert sorted(os.listdir(tmp_path)) == ["a", "b"]


def test_profile_trace_none_is_noop(tmp_path):
    with profile_trace(None, "unit"):
        pass
    assert list(tmp_path.iterdir()) == []


def test_stage_timers_are_registry_timers():
    profiling.reset_counters("proftest.")
    with profiling.stage_timer("proftest.a"):
        pass
    profiling.add_seconds("proftest.a", 2.0)
    profiling.add_seconds("proftest.b", 0.5)
    snap = profiling.counter_snapshot("proftest.")
    assert snap["proftest.a"]["calls"] == 2 and snap["proftest.a"]["seconds"] >= 2.0
    assert snap["proftest.b"] == {"seconds": 0.5, "calls": 1}
    assert REGISTRY.timer_snapshot("proftest.") == snap
    profiling.reset_counters("proftest.a")
    assert list(profiling.counter_snapshot("proftest.")) == ["proftest.b"]
    profiling.reset_counters("proftest.")


_FAKE_NVCC = """#!{python}
import sys
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "wb").write(b"object")
"""


def test_kernel_build_seconds_land_in_the_registry(tmp_path, monkeypatch):
    from photon_ml_tpu_torch.ops import _cuda

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")

    def calls():
        return REGISTRY.timer_snapshot("cuda.build_s").get("cuda.build_s", {"calls": 0})["calls"]

    before = calls()
    lib = _cuda.build()
    assert lib.exists() and lib.parent == tmp_path / "build"
    assert calls() == before + 1
    assert _cuda.build() == lib  # built already: nothing compiled, nothing timed
    assert calls() == before + 1
