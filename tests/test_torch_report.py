"""The port's run report (``photon_ml_tpu_torch/obs/report.py``) and its
command (``cli/report.py``) on the CPU, held to the JAX package's
``photon_ml_tpu/obs/report.py`` and ``cli/report.py``.

Every run file is written by the port's telemetry (its ``obs`` sink, or
its ``TelemetrySink`` for hand-made records), then read by both packages:

- the synthetic runs of ``tests/test_telemetry.py`` (``TestExportAndReport``
  , ``TestFleetReport``, ``TestFleetCLI``, ``TestElasticFleetNarrative``),
  rebuilt here, plus one run and one fleet that fill every section of the
  summary and of the fleet view (serving, the stream executor, placement,
  projection, re-planning, device cost, memory, recovery);
- a run the port's own streamed GAME trainer writes;
- a stream-executor run of each package on the same chunks, whose stream
  sections (arbiter bytes, entries, charges, each consumer's counters)
  are equal.

``summarize_run``, ``summarize_fleet`` and every gate-metric extractor give
the reference's values exactly, as plain Python values; ``format_summary``
, ``diff_summaries``, ``format_fleet`` and ``gate_run`` give the reference's
text and results. The one stated exception is ``compile_s`` (and the gate
metric of that name): the port reads its kernel build timer
``cuda.build_s`` where the reference reads its XLA compile events and
``jax.compile_s``.
"""

from __future__ import annotations

import copy
import inspect
import json
import os
import threading
import time

import numpy as np
import pytest

import photon_ml_tpu.obs.report as R
import photon_ml_tpu_torch.obs.report as P
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.cli import report as cli
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.obs.sink import TelemetrySink


@pytest.fixture(autouse=True)
def _no_sink():
    """The sink is process-global: never leak one into another test."""
    obs.shutdown()
    yield
    obs.shutdown()


def _strip_compile(x):
    """``x`` without its ``compile_s`` entries, at any depth."""
    if isinstance(x, dict):
        return {k: _strip_compile(v) for k, v in x.items() if k != "compile_s"}
    if isinstance(x, list):
        return [_strip_compile(v) for v in x]
    return x


def _plain(x) -> bool:
    """JSON-plain: survives a JSON round trip unchanged."""
    return json.loads(json.dumps(x)) == x


def _build_s(path: str) -> float:
    """The run's ``cuda.build_s`` seconds (run_end less run_start)."""
    recs = P.load_run(path)
    end = next((r for r in recs if r["event"] == "run_end"), {}).get("metrics", {}).get("timers", {})
    base = recs[0].get("metrics_baseline", {}).get("timers", {})
    sec = lambda t: float(t.get("cuda.build_s", {}).get("seconds", 0.0))  # noqa: E731
    return max(sec(end) - sec(base), 0.0)


def _summaries(path: str) -> tuple[dict, dict]:
    """Both packages' summaries of one run, held equal but for compile_s."""
    ps, rs = P.summarize_run(path), R.summarize_run(path)
    assert _strip_compile(ps) == _strip_compile(rs)
    assert _plain(ps)
    assert ps["compile_s"] == _build_s(path)
    return ps, rs


# ---------------------------------------------------------------------------
# runs: the reference's synthetic ones, rebuilt on the port's telemetry
# ---------------------------------------------------------------------------
def _make_run(directory, name, extra_span=None):
    """``TestExportAndReport._make_run``."""
    path = obs.configure(str(directory), run_id=name)
    with obs.span("ingest/read", files=1):
        pass
    with obs.span("descent/iter", iteration=0):
        with obs.span("descent/visit", coordinate="fixed"):
            obs.emit_event("optim_result", reason="GRADIENT_CONVERGED", iterations=3, value=1.0, grad_norm=1e-5)
        with obs.span("descent/validation", coordinate="fixed"):
            pass
    if extra_span:
        with obs.span(extra_span):
            pass
    obs.shutdown()
    return path


def _lane_runs(directory):
    """``test_report_wasted_lane_accounting``'s two runs."""
    paths = []
    for name, launches, executed in (("runOFF", 2, 1000.0), ("runON", 9, 660.0)):
        paths.append(obs.configure(str(directory / name), run_id=name))
        REGISTRY.counter_inc("re_solve.launches", launches)
        REGISTRY.counter_inc("re_solve.executed_entity_iterations", executed)
        REGISTRY.counter_inc("re_solve.useful_entity_iterations", 600.0)
        obs.shutdown()
    return paths


def _parity_runs(directory, monkeypatch):
    """``test_report_quality_parity_section``'s two runs."""
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "bf16")
    b = obs.configure(str(directory / "b"), run_id="runBF16")
    obs.emit_event("quality_parity", kernel_dtype="bf16", auc=0.9951, auc_f32=0.9950, auc_delta=0.0001,
                   final_loss=983.32, final_loss_f32=983.28, loss_rel_delta=4.4e-05,
                   margins_rmse_vs_f32=0.0035)
    obs.shutdown()
    monkeypatch.delenv("PHOTON_KERNEL_DTYPE")
    a = obs.configure(str(directory / "a"), run_id="runF32")
    obs.shutdown()
    return a, b


def _concurrent_run(directory):
    """``test_phase_wall_unions_concurrent_worker_spans``'s run."""
    path = obs.configure(str(directory), run_id="conc")
    barrier = threading.Barrier(2)

    def worker():
        with obs.span("ingest/worker"):
            barrier.wait(timeout=10)
            time.sleep(0.05)

    ts = [threading.Thread(target=worker) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    obs.shutdown()
    return path


T0 = 1_000.0


def _run_start(run_id: str, pidx: int, *, knobs=None, baseline=None, count=2, fleet=True) -> dict:
    rec = {"event": "run_start", "t": T0 + 0.01 * pidx, "schema_version": obs.SCHEMA_VERSION,
           "run_id": run_id, "pid": 100 + pidx, "process_index": pidx,
           "knobs": knobs if knobs is not None else {"re_shard": 1},
           "metrics_baseline": baseline or {}}
    if fleet:
        rec["fleet"] = {"process_count": count}
    return rec


def _full_metrics(scale: float) -> dict:
    """A run_end registry snapshot naming every metric a summary section
    reads (serving, the stream executor, placement, feature ranges,
    combine, projection, re-planning, prefetch, memory)."""
    timers = {n: {"seconds": v * scale, "calls": 2} for n, v in (
        ("cuda.build_s", 31.5), ("jax.compile_s", 4.25), ("prefetch.device_put_s", 1.5),
        ("prefetch.host_pack_s", 0.75), ("prefetch.consumer_wait_s", 0.5), ("re_exchange.exchange_s", 0.5),
        ("re_exchange.wait_s", 0.1), ("re_combine.exchange_s", 0.3), ("re_combine.wait_s", 0.05),
        ("serve.window_s", 2.0), ("serve.refresh_s", 0.2), ("stream.glm.wait_s", 0.4),
        ("stream.game.wait_s", 0.6))}
    counters = {n: {"value": v * scale, "calls": 3} for n, v in (
        ("re_solve.launches", 12.0), ("re_solve.executed_entity_iterations", 900.0),
        ("re_solve.useful_entity_iterations", 700.0), ("re_combine.exchanges", 4.0),
        ("re_combine.bytes_sent", 4096.0), ("re_replan.checks", 2.0), ("re_replan.count", 1.0),
        ("re_replan.migrations", 17.0), ("serve.requests", 5000.0), ("serve.windows", 80.0),
        ("serve.forwarded", 12.0), ("serve.hot.hit_bytes", 1 << 20), ("serve.hot.miss_bytes", 1 << 16),
        ("serve.hot.evictions", 3.0), ("serve.refresh.count", 4.0), ("serve.replan.count", 1.0),
        ("serve.replan.migrations", 9.0), ("stream.streams", 2.0), ("stream.cache.hit_bytes", 3 << 20),
        ("stream.cache.miss_bytes", 1 << 20), ("stream.cache.shared_hit_bytes", 1 << 19),
        ("stream.cache.evictions", 5.0), ("stream.glm.items", 10.0), ("stream.glm.hit_bytes", 1 << 20),
        ("stream.glm.miss_bytes", 1 << 18), ("stream.glm.yields", 2.0), ("stream.game.items", 6.0),
        ("stream.passes", 9.0), ("stream.chunks", 36.0))}
    gauges = {"re_shard.shards": 2.0, "re_shard.balance": 1.05, "re_shard.rows_max": 120.0,
              "re_shard.exchange_overlap_ratio": 0.9, "re_shard.device_balance": 1.1,
              "re_shard.split_classes": 2.0, "re_shard.atoms": 6.0, "fe_shard.ranges": 2.0,
              "fe_shard.nnz_balance": 1.01, "fe_shard.range_width": 4096.0, "re_project.mean_ratio": 0.5,
              "re_project.dims_saved_bytes": 65536.0, "re_replan.last_imbalance": 1.7,
              "serve.latency_p50_ms": 1.25 * scale, "serve.latency_p99_ms": 7.5 * scale,
              "serve.hot.hit_rate": 0.93, "serve.window.occupancy_mean": 0.61,
              "stream.glm.charged_bytes": 1 << 21, "hbm.budget_bytes": 8 << 30, "hbm.budget_queried": 1.0}
    histograms = {"serve.window.occupancy": {"count": 80, "sum": 48.8, "min": 0.1, "max": 1.0}}
    return {"counters": counters, "timers": timers, "gauges": gauges, "histograms": histograms}


def _full_records(run_id: str, pidx: int, scale: float = 1.0, count: int = 2) -> list[dict]:
    """One process's records filling every section of the summary."""
    knobs = {"re_shard": 1, "kernel_dtype": "bf16", "re_combine": "segments"}
    base = {"timers": {"cuda.build_s": {"seconds": 1.5, "calls": 1}},
            "counters": {"re_solve.launches": {"value": 2.0, "calls": 1}}}
    recs = [_run_start(run_id, pidx, knobs=knobs, baseline=base, count=count)]
    sid = iter(range(1, 100))
    t = T0 + 0.1

    def span(name, dur, parent=None, **attrs):
        rec = {"event": "span", "t": t, "name": name, "span_id": next(sid), "parent_id": parent,
               "tid": 1, "thread": "MainThread", "dur_s": dur * scale}
        if attrs:
            rec["attrs"] = attrs
        recs.append(rec)
        return rec["span_id"]

    root = span("game/fit", 3.0)
    span("ingest/re-shard", 0.5, root)
    it = span("descent/iter", 2.0, root, iteration=0)
    span("descent/visit", 1.0, it, iteration=0, coordinate="fixed")
    span("descent/visit", 0.8, it, iteration=0, coordinate="per_user")
    span("ingest/worker", 0.4)
    for i, reason in enumerate(("GRADIENT_CONVERGED", "MAX_ITERATIONS", "GRADIENT_CONVERGED")):
        recs.append({"event": "optim_result", "t": T0 + 1 + i, "reason": reason, "iterations": 5 + i,
                     "value": 1.0, "grad_norm": 1e-4, "coordinate": "fixed"})
    for label, knob, flops, nbytes in (("fused.value_grad", "bf16", 2e9, 5e8), ("fused.value_grad", "f32", 2e9, 1e9),
                                       ("fused.hvp", "bf16", 3e9, 6e8)):
        recs.append({"event": "executable_cost", "t": T0 + 1.5, "label": label, "flops": flops,
                     "bytes_accessed": nbytes, "peak_bytes": int(nbytes / 2), "peak_is_estimate": knob == "f32",
                     "capture_s": 0.01, "knobs": {"kernel_dtype": knob}})
    recs += [
        {"event": "hbm_budget", "t": T0 + 1.6, "budget_bytes": 8 << 30, "source": "device_memory_stats"},
        {"event": "hbm_watermark", "t": T0 + 2.9, "available": True, "peak_bytes_in_use": 3 << 30,
         "bytes_in_use": 1 << 30, "root_span": "game/fit"},
        {"event": "quality_parity", "t": T0 + 2.0, "kernel_dtype": "bf16", "auc": 0.9951, "auc_f32": 0.995,
         "auc_delta": 0.0001, "loss_rel_delta": 4.4e-05, "margins_rmse_vs_f32": 0.0035},
        {"event": "re_project", "t": T0 + 2.1, "mode": "support",
         "classes": [{"capacity": 8, "width": 4}, {"capacity": 16, "width": 6}]},
        {"event": "re_replan", "t": T0 + 2.2, "iteration": 1, "coordinate": "per_user", "imbalance": 1.7,
         "threshold": 1.5, "migrated": 17, "old_balance": 1.7, "new_balance": 1.1},
        {"event": "log", "t": T0 + 2.3, "level": "WARN", "message": "slow chunk"},
        {"event": "log", "t": T0 + 2.4, "level": "INFO", "message": "fine"},
        {"event": "run_end", "t": T0 + 4.0 + pidx, "run_id": run_id, "metrics": _full_metrics(scale),
         "stream_cache": {"entries": 7, "bytes": 7 << 20, "charges": {"glm": 3 << 20}}},
    ]
    return recs


def _write(directory, records: list[dict], run_id: str, shard: int | None = None) -> str:
    sink = TelemetrySink(str(directory), run_id=run_id, shard_index=shard)
    for r in records:
        sink.emit(r)
    sink.close()
    return sink.path


def _p2p(kind, t_start, peer, nbytes, corr):
    return {"event": kind, "t": t_start + 0.01, "peer": peer, "bytes": nbytes, "rows": nbytes // 40,
            "dur_s": 0.01, "t_start": t_start, "corr": corr, "tag": "offsets", "transport": "p2p_host_async"}


def _write_fleet_fixture(directory, run_id="F1", unmatched=False, missing_shard=False, elastic=False):
    """``tests/test_telemetry.py``'s ``_write_fleet_fixture`` (and, with
    ``elastic``, ``TestElasticFleetNarrative._write``)."""

    def run_end(pidx, overlap):
        return {"event": "run_end", "t": T0 + 4.0 + pidx, "run_id": run_id, "metrics": {
            "counters": {}, "histograms": {},
            "timers": {"re_exchange.exchange_s": {"seconds": 0.5, "calls": 2},
                       "re_exchange.wait_s": {"seconds": 0.1, "calls": 2}},
            "gauges": {"re_shard.shards": 2.0, "re_shard.balance": 1.05, "re_shard.rows_max": 120.0,
                       "re_shard.exchange_overlap_ratio": overlap}}}

    def iter_span(tid, dur):
        return {"event": "span", "t": T0 + 0.1, "name": "descent/iter", "span_id": 1, "parent_id": None,
                "tid": tid, "thread": "Main", "dur_s": dur}

    p0 = [_run_start(run_id, 0), iter_span(1, 1.0), _p2p("p2p_send", T0 + 0.2, 1, 400, "p2p:0>1#1"),
          _p2p("p2p_recv", T0 + 0.5, 1, 240, "p2p:1>0#1")]
    if elastic:
        p0 += [{"event": "degraded_descent", "t": 1_001.0, "iteration": 1, "survivors": [0], "lost": [1]},
               {"event": "rejoin", "t": 1_002.0, "iteration": 2, "rejoined": [1], "group": [0, 1],
                "migrated": {"per_entity": 7}, "role": "survivor"}]
    _write(directory, p0 + [run_end(0, 0.9)], run_id)
    if missing_shard:
        return
    p1 = [_run_start(run_id, 1), iter_span(7, 3.0), _p2p("p2p_recv", T0 + 0.3, 0, 400, "p2p:0>1#1")]
    if not unmatched:
        p1.append(_p2p("p2p_send", T0 + 0.35, 0, 240, "p2p:1>0#1"))
    _write(directory, p1 + [run_end(1, 0.6)], run_id, shard=1)


def _write_full_fleet(directory, run_id="G1", processes=3):
    """Every section of the fleet view: each process's full records, the
    recovery narrative (retries, give-ups, drain errors, injected faults,
    peer loss, roll call, recovery, degraded descent, rejoin) and one
    re-plan that every process emits."""
    for pidx in range(processes):
        recs = _full_records(run_id, pidx, scale=1.0 + 0.5 * pidx, count=processes + 1)
        end = recs.pop()
        peer = (pidx + 1) % processes
        recs += [
            _p2p("p2p_send", T0 + 0.2 + pidx, peer, 400 + pidx, f"p2p:{pidx}>{peer}#1"),
            _p2p("p2p_recv", T0 + 0.3 + pidx, (pidx - 1) % processes, 400 + (pidx - 1) % processes,
                 f"p2p:{(pidx - 1) % processes}>{pidx}#1"),
            {"event": "p2p_retry", "t": T0 + 2.5, "peer": peer, "error": "timeout" if pidx else "crc"},
            {"event": "p2p_retry", "t": T0 + 2.6, "peer": peer, "error": "timeout"},
            {"event": "fault_injected", "t": T0 + 2.55, "op": "drop"},
        ]
        if pidx == 0:
            recs += [{"event": "p2p_giveup", "t": T0 + 2.7, "peer": 3},
                     {"event": "exchange_drain_error", "t": T0 + 2.71, "error": "reset"},
                     {"event": "peer_lost", "t": T0 + 2.72, "peer": 3},
                     {"event": "roll_call", "t": T0 + 2.73, "survivors": [0, 1, 2], "lost": [3]},
                     {"event": "recovery", "t": T0 + 2.74, "survivors": [0, 1, 2], "lost": [3]}]
        if pidx == 1:
            recs += [{"event": "degraded_descent", "t": T0 + 2.8, "iteration": 1, "survivors": [0, 1, 2],
                      "lost": [3]},
                     {"event": "rejoin", "t": T0 + 2.9, "iteration": 2, "rejoined": [3], "group": [0, 1, 2, 3],
                      "migrated": {"per_user": 11}, "role": "survivor"}]
        _write(directory, recs + [end], run_id, shard=pidx or None)


def _executor_run(directory, pkg: str) -> str:
    """One run of ``pkg``'s stream executor on a fixed chunk set: a
    streamed objective's two passes (the first chunks evicted by the
    budget), a scorer over fresh copies of the chunks (shared hits) and a
    refresh stream held to depth 1 under an active serve window (yields).
    Depth 0 for the puts keeps the arbiter's order, so its counts, the
    run's knob-on deterministic."""
    import importlib

    se = importlib.import_module(f"{pkg}.ops.stream_executor")
    pf = importlib.import_module(f"{pkg}.ops.prefetch")
    st = importlib.import_module(f"{pkg}.ops.streaming")
    tel = importlib.import_module(f"{pkg}.obs")
    task = importlib.import_module(f"{pkg}.types").TaskType.LOGISTIC_REGRESSION
    loss = importlib.import_module(f"{pkg}.ops.losses").loss_for_task(task)
    rng = np.random.default_rng(8)
    X = rng.normal(size=(300, 6)).astype(np.float32)
    y = (rng.uniform(size=300) < 0.5).astype(np.float32)
    chunks = st.dense_chunks(X, y, 64)
    copies = [{k: np.array(v) for k, v in c.items()} for c in chunks]
    w = np.full(6, 0.1, np.float32)
    kw = {"device": "cpu"} if pkg == "photon_ml_tpu_torch" else {}
    pf.clear_cache()
    se.clear()
    tel.REGISTRY.reset(prefix="stream")
    path = tel.configure(str(directory / pkg), run_id="X_" + pkg)
    try:
        obj = st.StreamingGLMObjective(chunks, loss, 6, **kw)
        obj.value(w)
        obj.value(w)
        st.stream_scores(copies, w, 300, **kw)
        with se.active_stream("serve"):
            list(se.stream("refresh", 6, lambda i: i, depth=2))
    finally:
        tel.shutdown()
        pf.clear_cache()
        se.clear()
    return path


def test_stream_section_of_a_port_run_equals_the_references_run(tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_STREAM_EXECUTOR", "1")
    monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", "0")
    monkeypatch.setenv("PHOTON_CHUNK_CACHE_BUDGET", "8192")
    port, ref = _executor_run(tmp_path, "photon_ml_tpu_torch"), _executor_run(tmp_path, "photon_ml_tpu")
    ps, _ = _summaries(port)
    rs = R.summarize_run(ref)

    def timeless(section):  # wait seconds are the one measured value
        return dict(section, consumers={k: {m: v for m, v in c.items() if m != "wait_s"}
                                        for k, c in section["consumers"].items()})

    assert timeless(ps["stream"]) == timeless(rs["stream"])
    st = ps["stream"]
    assert st["cache_evictions"] > 0 and st["cache_shared_hit_bytes"] > 0 and st["cache_entries"] > 0
    assert st["consumers"]["refresh"]["yields"] > 0 and "wait_s" in st["consumers"]["refresh"]
    assert "stream" in P.format_summary(ps)


# ---------------------------------------------------------------------------
# the single runs
# ---------------------------------------------------------------------------
@pytest.fixture
def single_runs(tmp_path, monkeypatch):
    runs = {"runA": _make_run(tmp_path / "a", "runA"),
            "runB": _make_run(tmp_path / "b", "runB", extra_span="cv/fold")}
    runs["lanes_off"], runs["lanes_on"] = _lane_runs(tmp_path / "lanes")
    runs["f32"], runs["bf16"] = _parity_runs(tmp_path / "parity", monkeypatch)
    runs["concurrent"] = _concurrent_run(tmp_path / "conc")
    runs["full"] = _write(tmp_path / "full", _full_records("FULL", 0), "FULL")
    runs["full_x2"] = _write(tmp_path / "full2", _full_records("FULL2", 0, scale=2.0), "FULL2")
    return runs


SINGLE = ["runA", "runB", "lanes_off", "lanes_on", "f32", "bf16", "concurrent", "full", "full_x2"]
PAIRS = [("runA", "runB"), ("lanes_off", "lanes_on"), ("f32", "bf16"), ("full", "full_x2"), ("runA", "full"),
         ("full", "runA")]


@pytest.mark.parametrize("name", SINGLE)
def test_summary_equals_the_references(single_runs, name):
    ps, rs = _summaries(single_runs[name])
    assert P.format_summary(ps) == R.format_summary(ps)
    assert P.format_summary(rs) == R.format_summary(rs)
    assert P.gate_metrics_from_summary(ps) == R.gate_metrics_from_summary(ps)
    assert _strip_compile(P.gate_metrics_from_summary(ps)) == _strip_compile(R.gate_metrics_from_summary(rs))
    assert P.gate_metrics_from_summary(ps)["compile_s"] == ps["compile_s"]


@pytest.mark.parametrize("a, b", PAIRS)
def test_diff_equals_the_references(single_runs, a, b):
    pa, ra = _summaries(single_runs[a])
    pb, rb = _summaries(single_runs[b])
    assert P.diff_summaries(pa, pb) == R.diff_summaries(pa, pb)
    assert P.diff_summaries(ra, rb) == R.diff_summaries(ra, rb)


def test_the_references_assertions_hold_on_the_port(single_runs):
    """``TestExportAndReport``'s own readouts, through the port."""
    s = P.summarize_run(single_runs["runA"])
    assert s["run_id"] == "runA" and s["complete"]
    assert set(s["phases"]) == {"ingest", "descent"} and s["phases"]["descent"]["spans"] == 3
    assert s["optim"] == {"solves": 1, "iterations": 3, "reasons": {"GRADIENT_CONVERGED": 1}}
    a, b = P.summarize_run(single_runs["lanes_off"]), P.summarize_run(single_runs["lanes_on"])
    assert a["re_solve"]["executed_entity_iterations"] == 1000.0
    assert abs(a["re_solve"]["wasted_lane_fraction"] - 0.4) < 1e-9
    assert b["re_solve"]["wasted_lane_fraction"] == 1.0 - 600.0 / 660.0
    assert "wasted-lane 40.0%" in P.format_summary(a)
    d = P.diff_summaries(a, b)
    assert "wasted-lane" in d and "exec-entity-it" in d and "1000" in d and "660" in d
    q = P.summarize_run(single_runs["bf16"])
    assert q["quality_parity"]["auc_delta"] == 0.0001
    assert "auc_delta=+0.000100" in P.format_summary(q)
    assert "(unrecorded)" in P.diff_summaries(P.summarize_run(single_runs["f32"]), q)
    assert P._union_seconds([(0.0, 2.0), (1.0, 3.0), (10.0, 11.0)]) == 4.0
    c = P.summarize_run(single_runs["concurrent"])
    total = sum(r["dur_s"] for r in P.load_run(single_runs["concurrent"]) if r["event"] == "span")
    assert c["phases"]["ingest"]["spans"] == 2 and c["phases"]["ingest"]["wall_s"] < 0.75 * total


def test_every_section_renders(single_runs):
    """The full run fills the sections that render only when their names
    are present: serving, the stream executor, projection, re-planning,
    combine, feature ranges, device cost."""
    s = P.summarize_run(single_runs["full"])
    assert {"serve", "stream", "re_project", "re_replan", "re_combine", "exchange_s", "fleet"} <= set(s)
    assert s["serve"]["replans"] == 1.0 and s["stream"]["consumers"]["glm"]["charged_bytes"] == 1 << 21
    assert set(s["devcost"]) == {"fused.value_grad", "fused.value_grad[kernel_dtype=f32]", "fused.hvp"}
    assert s["re_solve"]["launches"] == 10.0  # less the run_start baseline
    assert s["warnings"] == 1 and s["hbm"]["budget_source"] == "device_memory_stats"
    text = P.format_summary(s)
    assert "analytic device cost" in text and "quality-parity" in text
    m = P.gate_metrics_from_summary(s)
    assert {"serve/latency_p99_ms", "stream/cache_miss_bytes", "re_shard/atoms", "fe_shard/ranges",
            "re_combine/bytes_sent", "re_project/mean_ratio", "re_replan/migrations",
            "hbm/peak_bytes_in_use"} <= set(m)


def test_compile_s_reads_the_kernel_build_timer(single_runs):
    """The decided difference: the port's ``compile_s`` is ``cuda.build_s``
    (less its run_start baseline), the reference's ``jax.compile_s``."""
    p, r = P.summarize_run(single_runs["full"]), R.summarize_run(single_runs["full"])
    assert p["compile_s"] == 31.5 - 1.5
    assert r["compile_s"] == 4.25
    assert P.gate_metrics_from_summary(p)["compile_s"] == 30.0
    for name in ("runA", "lanes_on", "concurrent"):  # no build in the run: both read 0
        assert P.summarize_run(single_runs[name])["compile_s"] == 0.0


# ---------------------------------------------------------------------------
# the fleet view
# ---------------------------------------------------------------------------
@pytest.fixture
def fleets(tmp_path):
    kinds = {"clean": {}, "unmatched": {"unmatched": True}, "missing": {"missing_shard": True},
             "elastic": {"elastic": True}}
    out = {}
    for name, kw in kinds.items():
        _write_fleet_fixture(tmp_path / name, **kw)
        out[name] = str(tmp_path / name)
    _write_full_fleet(tmp_path / "full")
    out["full"] = str(tmp_path / "full")
    return out


FLEETS = ["clean", "unmatched", "missing", "elastic", "full"]


def _fleets(directory: str) -> tuple[dict, dict]:
    paths = P.fleet_run_paths(directory)
    assert paths == R.fleet_run_paths(directory)
    pf, rf = P.summarize_fleet(paths), R.summarize_fleet(paths)
    assert _strip_compile(pf) == _strip_compile(rf)
    assert _plain(pf)
    return pf, rf


@pytest.mark.parametrize("name", FLEETS)
def test_fleet_view_equals_the_references(fleets, name):
    pf, rf = _fleets(fleets[name])
    assert P.format_fleet(pf) == R.format_fleet(pf)
    assert P.format_fleet(rf) == R.format_fleet(rf)
    assert P.gate_metrics_from_fleet(pf) == R.gate_metrics_from_fleet(pf) == R.gate_metrics_from_fleet(rf)
    for stat in ("balance", "rows_max", "device_balance", "atoms"):
        assert P._re_shard_fleet_max(pf, stat) == R._re_shard_fleet_max(pf, stat)


def test_fleet_readouts_of_the_references_tests(fleets):
    """``TestFleetReport`` / ``TestElasticFleetNarrative``'s readouts,
    through the port."""
    fs = P.summarize_fleet(P.fleet_run_paths(fleets["clean"]))
    assert fs["process_count"] == 2 and fs["missing_shards"] == 0
    assert fs["phases"]["descent"]["per_process"] == {"0": 1.0, "1": 3.0}
    assert fs["straggler"]["slowest_process"] == 1
    assert fs["p2p"]["matched"] == 2 and abs(fs["p2p"]["links"]["1->0"]["one_sided_wait_s"] - 0.15) < 1e-9
    assert "slowest process p1" in P.format_fleet(fs) and "0 unmatched" in P.format_fleet(fs)
    assert "unmatched correlated events" in P.format_fleet(P.summarize_fleet(P.fleet_run_paths(fleets["unmatched"])))
    assert "MISSING" in P.format_fleet(P.summarize_fleet(P.fleet_run_paths(fleets["missing"])))
    el = P.summarize_fleet(P.fleet_run_paths(fleets["elastic"]))
    text = P.format_fleet(el)
    assert "degraded_descent: p0 degraded IN PLACE at iteration 1" in text
    assert "rejoin: p0 (survivor) — [1] rejoined" in text and "migrated back: per_entity:7" in text
    full = P.summarize_fleet(P.fleet_run_paths(fleets["full"]))
    assert [r["processes"] for r in full["replans"]] == [[0, 1, 2]]  # one decision, seen by each
    assert full["recovery"]["retry_errors"] == {"crc": 1, "timeout": 5}


def test_fleet_paths_from_dir_file_and_shard(fleets):
    d = fleets["clean"]
    expect = [os.path.join(d, "run-F1.jsonl"), os.path.join(d, "run-F1.p1.jsonl")]
    for arg in (d, expect[0], expect[1]):
        assert P.fleet_run_paths(arg) == R.fleet_run_paths(arg) == expect
    assert P.latest_run(d) == R.latest_run(d) == expect[0]
    with pytest.raises(ValueError, match="no run-NOPE"):
        P.fleet_run_paths(d, run_id="NOPE")


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------
def test_gate_tables_and_public_names_equal_the_references():
    assert P.DEFAULT_GATE_THRESHOLDS == R.DEFAULT_GATE_THRESHOLDS
    assert P.GATE_SCHEMA_VERSION == R.GATE_SCHEMA_VERSION
    ref_public = {n for n, v in vars(R).items() if not n.startswith("_") and inspect.isfunction(v)
                  and v.__module__ == R.__name__}
    port_public = {n for n, v in vars(P).items() if not n.startswith("_") and inspect.isfunction(v)
                   and v.__module__ == P.__name__}
    assert ref_public == port_public
    for name in ("wall_s", "fleet/p3/exchange_wait_s", "re_shard/exchange_overlap_ratio", "devcost/x/flops",
                 "fleet/phase/descent/imbalance", "serve/latency_p99_ms", "quality/auc_delta_abs", "zzz"):
        assert P.resolve_threshold(name, P.DEFAULT_GATE_THRESHOLDS) == R.resolve_threshold(
            name, R.DEFAULT_GATE_THRESHOLDS)
    for v in (None, 0.0, 1e-6, 0.5, 999.0, 12345.0, 3.2e9):
        assert P._fmt_gate(v) == R._fmt_gate(v)


def _doctored(metrics: dict, seed: int) -> dict:
    """A copy with some metrics moved (seeded): halved, doubled, dropped,
    one added."""
    rng = np.random.default_rng(seed)
    out = dict(metrics)
    names = sorted(out)
    for n in rng.choice(names, size=min(4, len(names)), replace=False):
        out[n] = out[n] * float(rng.choice([0.5, 2.0, 0.0]))
    out.pop(names[int(rng.integers(len(names)))])
    out["new/instrument"] = 1.0
    return out


GATE_CASES = [("full", None, False), ("full", {"wall_s": {"rel": 0.5, "abs": 0.0}}, False), ("runA", None, True),
              ("full", {"": {"rel": 0.0}, "serve/": {}}, True)]


@pytest.mark.parametrize("run, thresholds, allow_missing", GATE_CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_gate_run_equals_the_references(single_runs, run, thresholds, allow_missing, seed):
    cur = P.gate_metrics_from_summary(P.summarize_run(single_runs[run]))
    for base in (cur, _doctored(cur, seed)):
        for a, b in ((cur, base), (base, cur)):
            got = P.gate_run(a, b, thresholds=thresholds, allow_missing=allow_missing)
            assert got == R.gate_run(a, b, thresholds=thresholds, allow_missing=allow_missing)
            assert _plain(got[0])


def test_gate_semantics():
    """A baseline metric the run lacks fails unless ``allow_missing``; a
    metric only the run has is informational; an empty baseline raises."""
    base = {"wall_s": 10.0, "warnings": 0.0}
    failures, lines = P.gate_run({"wall_s": 10.0, "extra": 5.0}, base)
    assert failures == [{"metric": "warnings", "problem": "missing", "baseline": 0.0, "limit": 0.0}]
    assert lines[-1] == "  (+1 metrics not in baseline — ignored)"
    assert P.gate_run({"wall_s": 10.0}, base, allow_missing=True)[0] == []
    assert P.gate_run({"wall_s": 30.1, "warnings": 0.0}, base)[0][0]["problem"] == "regression"
    with pytest.raises(ValueError, match="no gateable metrics"):
        P.gate_run({"wall_s": 1.0}, {})


def _bench_doc() -> dict:
    """A bench JSON document: two configs with telemetry blocks, one
    failed config, serving gauges, a split placement and a quality gate."""
    tel = {"metrics": {
        "gauges": {"devcost.fused.value_grad.flops": 2e9, "devcost.fused.value_grad.bytes_accessed": 5e8,
                   "hbm.peak_bytes_in_use": 3e9, "serve.latency_p99_ms": 7.5, "serve.hot.hit_rate": 0.9,
                   "serve.window.occupancy_mean": 0.6, "re_shard.split_classes": 2.0, "re_shard.atoms": 6.0,
                   "re_shard.balance": 1.02},
        "timers": {"cuda.build_s": {"seconds": 31.0, "calls": 1}, "jax.compile_s": {"seconds": 4.0, "calls": 3}}},
        "quality_parity": {"auc_delta": -0.0002, "loss_rel_delta": 1e-5, "margins_rmse_vs_f32": 0.002}}
    return {"configs": {
        "A": {"telemetry": tel, "packed_stream_bytes_per_pass": 1.5e9, "sec_per_solve": 2.5},
        "B": {"telemetry": {"metrics": {"gauges": {"devcost.k.flops": 1.0}, "timers": {}}}, "sec_per_solve": 0.5},
        "C": {"error": "out of memory"},
    }}


def test_gate_metrics_from_bench_equals_the_references():
    doc = _bench_doc()
    port, ref = P.gate_metrics_from_bench(doc), R.gate_metrics_from_bench(doc)
    assert {k: v for k, v in port.items() if k != "A/compile_s"} == {k: v for k, v in ref.items()
                                                                  if k != "A/compile_s"}
    assert port["A/compile_s"] == 31.0 and ref["A/compile_s"] == 4.0
    assert "B/compile_s" not in port and "C/wall_s" not in port
    single = doc["configs"]["B"]
    assert P.gate_metrics_from_bench(single) == R.gate_metrics_from_bench(single)


def test_load_gate_metrics_equals_the_references(single_runs, fleets, tmp_path):
    bench = tmp_path / "bench.json"
    bench.write_text(json.dumps(_bench_doc()))
    saved = tmp_path / "baseline.json"
    saved.write_text(json.dumps({"gate_baseline": 1, "metrics": {"wall_s": 2.0, "note": "x"}}))
    for path, fleet in ((single_runs["full"], False), (os.path.dirname(single_runs["runA"]), False),
                        (fleets["full"], True), (fleets["clean"], True), (str(saved), False), (str(saved), True),
                        (str(bench), False), (str(bench), True)):
        pk, pm = P.load_gate_metrics(path, fleet=fleet)
        rk, rm = R.load_gate_metrics(path, fleet=fleet)
        assert pk == rk
        assert {k: v for k, v in pm.items() if not k.endswith("compile_s")} == {
            k: v for k, v in rm.items() if not k.endswith("compile_s")}


# ---------------------------------------------------------------------------
# a run of the port's own trainer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """Two streamed GAME fits (1 and 2 outer iterations) of
    ``tests/test_telemetry.py``'s ``TestEndToEndGame`` fixture, telemetry
    on (devcost capture off, as the tier-1 conftest pins it)."""
    import photon_ml_tpu_torch.config as tcfg
    from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer

    work = tmp_path_factory.mktemp("report_trainer")
    rng = np.random.default_rng(42)
    n, d, E, dr = 240, 5, 6, 3
    X = rng.normal(size=(n, d)).astype(np.float32)
    Xr = rng.normal(size=(n, dr)).astype(np.float32)
    ids = rng.integers(0, E, size=n).astype(np.int32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    opt = {"optimizer": {"max_iterations": 8, "tolerance": 1e-6}, "regularization": {"regularization_type": "L2"},
           "regularization_weight": 1.0}
    paths = []
    for iters in (1, 2):
        cfg = tcfg.parse_config({
            "task_type": "LOGISTIC_REGRESSION", "coordinate_update_sequence": ["fixed", "user"],
            "coordinate_descent_iterations": iters,
            "fixed_effect_coordinates": {"fixed": {"feature_shard_id": "g", "optimization": opt}},
            "random_effect_coordinates": {"user": {"feature_shard_id": "r", "random_effect_type": "uid",
                                                   "optimization": opt}},
            "evaluators": ["AUC"]})
        data = StreamedGameData(labels=y, features={"g": X, "r": Xr}, id_tags={"uid": ids})
        val = StreamedGameData(labels=y[:80], features={"g": X[:80], "r": Xr[:80]}, id_tags={"uid": ids[:80]})
        path = obs.configure(str(work / f"it{iters}"), run_id=f"port{iters}")
        try:
            StreamedGameTrainer(cfg, chunk_rows=96, evaluators=("AUC",), device="cpu").fit(data, validation=val)
        finally:
            obs.shutdown()
        paths.append(path)
    return paths


def test_port_trainer_run_report_equals_the_references(trainer_runs):
    one, two = trainer_runs
    p1, r1 = _summaries(one)
    p2, r2 = _summaries(two)
    assert {"game", "ingest", "descent"} <= set(p2["phases"])
    assert p2["optim"]["solves"] > p1["optim"]["solves"] > 0
    assert P.format_summary(p2) == R.format_summary(p2)
    assert P.diff_summaries(p1, p2) == R.diff_summaries(p1, p2)
    m1, m2 = P.gate_metrics_from_summary(p1), P.gate_metrics_from_summary(p2)
    assert m2 == R.gate_metrics_from_summary(p2)
    assert P.gate_run(m2, m1) == R.gate_run(m2, m1)
    assert P.gate_run(m2, m2)[0] == []
    pf, rf = _fleets(two)  # a one-process run is a fleet of one
    assert pf["process_count"] == 1 and P.format_fleet(pf) == R.format_fleet(pf)


# ---------------------------------------------------------------------------
# (v) the command
# ---------------------------------------------------------------------------
def _main(argv) -> int:
    try:
        cli.main(argv)
    except SystemExit as e:
        return int(e.code or 0)
    return 0


def test_report_summary_json_diff_and_trace(single_runs, tmp_path, capsys):
    run = single_runs["full"]
    assert _main([run, "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == P.summarize_run(run)
    assert _main([os.path.dirname(single_runs["runA"])]) == 0  # a directory: its newest run
    assert capsys.readouterr().out.strip() == P.format_summary(P.summarize_run(single_runs["runA"]))
    trace = tmp_path / "trace.json"
    assert _main([run, "--diff", single_runs["full_x2"], "--export-trace", str(trace)]) == 0
    out = capsys.readouterr().out
    assert out.strip() == P.diff_summaries(P.summarize_run(run), P.summarize_run(single_runs["full_x2"]))
    assert any(e["name"] == "descent/visit" for e in json.loads(trace.read_text())["traceEvents"])
    assert _main([run, "--diff", single_runs["runA"], "--json"]) == 0
    assert set(json.loads(capsys.readouterr().out)) == {"a", "b"}


def test_report_validate_exit_codes(single_runs, tmp_path, capsys):
    assert _main(["validate", single_runs["runA"]]) == 0
    bad = tmp_path / "run-bad.jsonl"
    bad.write_text(json.dumps({"event": "span", "t": 1.0}) + "\n")
    assert _main(["validate", str(bad), "--json"]) == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["problems"]
    torn = tmp_path / "run-torn.jsonl"
    torn.write_text("{not json\n")
    assert _main(["validate", str(torn)]) == 2
    assert _main(["validate", str(tmp_path / "absent.jsonl"), "--json"]) == 2
    assert "error" in json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_report_fleet_renders_and_exports(fleets, tmp_path, capsys):
    trace = tmp_path / "fleet-trace.json"
    assert _main(["fleet", fleets["clean"], "--export-trace", str(trace)]) == 0
    out = capsys.readouterr().out
    assert "fleet run F1" in out and "slowest process p1" in out
    assert {e.get("pid") for e in json.loads(trace.read_text())["traceEvents"]} == {0, 1}
    assert _main(["fleet", fleets["full"], "--json", "--run-id", "G1"]) == 0
    assert json.loads(capsys.readouterr().out)["process_count"] == 3
    assert _main(["fleet", os.path.join(fleets["clean"], "nope")]) == 2


def test_gate_update_and_verify(single_runs, tmp_path, capsys):
    """``--write-baseline`` alone writes; with ``--baseline`` it gates
    against the previous baseline first and writes only on a pass."""
    run, worse = single_runs["full"], single_runs["full_x2"]
    base = tmp_path / "base.json"
    assert _main(["gate", run, "--write-baseline", str(base), "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == {"baseline_written": True, "metrics": len(
        P.gate_metrics_from_summary(P.summarize_run(run))), "run_kind": "telemetry"}
    doc = json.loads(base.read_text())
    assert doc["gate_baseline"] == 1 and doc["source_kind"] == "telemetry"
    assert doc["metrics"] == P.gate_metrics_from_summary(P.summarize_run(run))
    assert _main(["gate", run, "--baseline", str(base)]) == 0
    assert "gate PASS" in capsys.readouterr().out
    # twice the latencies and walls: the serve and wall tiers trip; the
    # baseline is left as it was
    before = base.read_bytes()
    assert _main(["gate", worse, "--baseline", str(base), "--write-baseline", str(base), "--json"]) == 1
    res = json.loads(capsys.readouterr().out)
    assert res["pass"] is False and res["baseline_written"] is False and res["failures"]
    assert base.read_bytes() == before
    # a passing update rewrites it
    assert _main(["gate", run, "--baseline", str(base), "--write-baseline", str(base)]) == 0
    capsys.readouterr()


def test_gate_thresholds_and_doctored_baseline(single_runs, tmp_path, capsys):
    """The smoke's check: a copy of the baseline with wall_s halved fails
    under a tight wall tier given by ``--thresholds`` (inline or a file),
    and passes under the defaults."""
    run = single_runs["runA"]
    base = tmp_path / "base.json"
    assert _main(["gate", run, "--write-baseline", str(base)]) == 0
    doc = json.loads(base.read_text())
    doc["metrics"]["wall_s"] /= 2
    doctored = tmp_path / "doctored.json"
    doctored.write_text(json.dumps(doc))
    tight = json.dumps({"wall_s": {"rel": 0.5, "abs": 0.0}})
    assert _main(["gate", run, "--baseline", str(doctored)]) == 0
    assert _main(["gate", run, "--baseline", str(doctored), "--thresholds", tight]) == 1
    assert "wall_s" in capsys.readouterr().out
    spec = tmp_path / "thresholds.json"
    spec.write_text(tight)
    assert _main(["gate", run, "--baseline", str(doctored), "--thresholds", str(spec), "--json"]) == 1
    assert [f["metric"] for f in json.loads(capsys.readouterr().out)["failures"]] == ["wall_s"]
    assert _main(["gate", run, "--baseline", str(base), "--thresholds", tight]) == 0
    assert _main(["gate", run, "--baseline", str(doctored), "--thresholds", "{not json"]) == 2


def test_gate_fleet_round_trip(fleets, tmp_path, capsys):
    base = tmp_path / "fleet-base.json"
    assert _main(["gate", "--fleet", fleets["clean"], "--write-baseline", str(base)]) == 0
    doc = json.loads(base.read_text())
    assert doc["source_kind"] == "fleet" and doc["metrics"]["fleet/unmatched_p2p"] == 0.0
    assert _main(["gate", "--fleet", fleets["clean"], "--baseline", str(base)]) == 0
    capsys.readouterr()
    assert _main(["gate", "--fleet", fleets["missing"], "--baseline", str(base)]) == 1
    assert "fleet/missing_shards" in capsys.readouterr().out
    doctored = copy.deepcopy(doc)
    doctored["metrics"]["fleet/wall_s"] /= 2
    (tmp_path / "d.json").write_text(json.dumps(doctored))
    assert _main(["gate", "--fleet", fleets["clean"], "--baseline", str(tmp_path / "d.json"), "--thresholds",
                  json.dumps({"wall_s": {"rel": 0.5, "abs": 0.0}})]) == 1


def test_gate_errors_exit_2(single_runs, tmp_path, capsys):
    run = single_runs["runA"]
    assert _main(["gate", run, "--baseline", str(tmp_path / "absent.json"), "--json"]) == 2
    assert json.loads(capsys.readouterr().out)["pass"] is False
    # nothing comparable: a baseline of fleet metrics, which no single run has
    base = tmp_path / "fleet-base.json"
    base.write_text(json.dumps({"gate_baseline": 1, "source_kind": "fleet",
                                "metrics": {"fleet/unmatched_p2p": 0.0, "fleet/missing_shards": 0.0}}))
    assert _main(["gate", run, "--baseline", str(base)]) == 2
    assert _main(["gate", run]) == 2  # argparse: --baseline or --write-baseline is required
