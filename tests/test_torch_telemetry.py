"""Run telemetry of the PyTorch port (``photon_ml_tpu_torch/obs``) on the
CPU, held to the JAX package's ``photon_ml_tpu/obs``.

- The unit classes mirror ``tests/test_telemetry.py``'s on the port's
  copies: spans (nesting, thread-local stacks, the no-op without a sink),
  the sink and its schema (strict JSON, atomic rotation, one writer across
  processes, the logger's event hook), atomic writes, the metrics registry
  (and ``utils/profiling`` and the prefetch stage timers as views of it)
  and the fleet shards.
- The parity test runs the reference's acceptance fixture
  (``tests/test_telemetry.py`` ``TestEndToEndGame``: n = 240, d = 5, 6
  entities, 2 outer iterations) through both packages' streamed GAME
  trainers, each with its own sink, and reads the port's file with the
  reference's ``validate_run``, ``summarize_run`` and ``chrome_trace``: the
  same span names, visits and record kinds (``jax_event`` aside).
- Telemetry on and off give bitwise-equal models: ``train_glm``,
  ``train_glm_streamed``, ``GameEstimator.fit``,
  ``StreamedGameTrainer.fit``, two gloo processes of the streamed trainer
  (with ``PHOTON_TELEMETRY_FLEET=1``: the canonical file and the ``.p1``
  shard, one run id) and the three drivers with ``--telemetry-dir`` and
  ``--profile-dir``.
- The name check: every record kind and registry name the port emits is
  one the reference's report or exporter reads, or is in ``ALLOWED`` with
  its reason (the rule of the reference's ``analysis/telemetry_pass.py``).
"""

from __future__ import annotations

import ast
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import photon_ml_tpu_torch.config as tcfg
import photon_ml_tpu_torch.types as ttypes
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.obs import metrics as obs_metrics
from photon_ml_tpu_torch.obs.export import chrome_trace, export_chrome_trace
from photon_ml_tpu_torch.obs.report import load_run, validate_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "photon_ml_tpu_torch")
WORKER_TIMEOUT_S = 120


@pytest.fixture
def telemetry(tmp_path):
    """An enabled sink in a temp dir, always shut down (the sink is
    process-global: a leak would redirect other tests' spans)."""
    path = obs.configure(str(tmp_path / "telemetry"))
    try:
        yield path
    finally:
        obs.shutdown()


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


class TestSpans:
    def test_nesting_parent_ids(self, telemetry):
        with obs.span("a/outer") as outer:
            with obs.span("a/inner", k=1) as inner:
                assert inner.parent_id == outer.span_id
            with obs.span("a/inner2") as inner2:
                assert inner2.parent_id == outer.span_id
        obs.shutdown()
        spans = {r["name"]: r for r in _records(telemetry) if r["event"] == "span"}
        assert spans["a/inner"]["parent_id"] == spans["a/outer"]["span_id"]
        assert spans["a/outer"]["parent_id"] is None
        assert spans["a/inner"]["attrs"] == {"k": 1}

    def test_no_cross_thread_parent_leakage(self, telemetry):
        """Spans opened on the prefetch workers root in their own thread."""
        from photon_ml_tpu_torch.ops import prefetch

        def prepare(i):
            with obs.span("worker/prepare", item=i):
                return i

        with obs.span("consumer/run"):
            out = list(prefetch.prefetch_iter(4, prepare, depth=2))
        assert out == [0, 1, 2, 3]
        obs.shutdown()
        spans = [r for r in _records(telemetry) if r["event"] == "span"]
        consumer = next(s for s in spans if s["name"] == "consumer/run")
        workers = [s for s in spans if s["name"] == "worker/prepare"]
        assert len(workers) == 4
        for w in workers:
            assert w["parent_id"] is None, "a worker span adopted another thread's parent"
            assert w["tid"] != consumer["tid"]

    def test_disabled_sink_is_shared_noop(self):
        obs.shutdown()
        assert obs.span("x") is obs.span("y", k=2) is obs.NOOP_SPAN
        with obs.span("x"):
            assert obs.current_span_id() is None
            obs.emit_event("nothing", k=1)

    def test_exception_still_emits_and_unwinds(self, telemetry):
        with pytest.raises(RuntimeError):
            with obs.span("a/raises"):
                raise RuntimeError("boom")
        assert obs.current_span_id() is None
        obs.shutdown()
        rec = next(r for r in _records(telemetry) if r["event"] == "span" and r["name"] == "a/raises")
        assert rec["error"] == "RuntimeError"


class TestSinkAndSchema:
    def test_jsonl_schema_round_trip(self, telemetry):
        with obs.span("phase/work", tag="v"):
            obs.emit_event("optim_iter", it=1, loss=0.5, grad_norm=0.1)
        obs.REGISTRY.counter_inc("test.counter", 3)
        obs.shutdown()
        records = load_run(telemetry)
        assert validate_run(records) == []
        assert records[0]["event"] == "run_start" and records[0]["schema_version"] == obs.SCHEMA_VERSION == 1
        assert records[-1]["event"] == "run_end"
        assert records[-1]["metrics"]["counters"]["test.counter"]["value"] >= 3
        assert "chunk_cache" in records[-1]
        ev = next(r for r in records if r["event"] == "optim_iter")
        sp = next(r for r in records if r["event"] == "span")
        assert ev["span_id_ref"] == sp["span_id"]

    def test_run_start_records_the_ports_knobs(self, telemetry, monkeypatch):
        obs.shutdown()
        monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "bf16")
        monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", "3")
        path = obs.configure(os.path.dirname(telemetry))
        obs.shutdown()
        knobs = load_run(path)[0]["knobs"]
        assert knobs["kernel_dtype"] == "bf16" and knobs["prefetch_depth"] == 3
        assert knobs["k1_tiles_max_features_f32"] == 124 and knobs["fused"] == 1
        assert "groups_per_step" not in knobs  # the TPU kernel's schedule is not the port's

    def test_nonfinite_floats_stay_strict_json(self, telemetry):
        with obs.span("optim/diverged", loss=float("nan")):
            obs.emit_event("optim_iter", it=1, loss=float("nan"), grad_norm=float("inf"), step=-float("inf"))
        obs.shutdown()
        text = open(telemetry).read()
        json.loads(f"[{','.join(text.splitlines())}]", parse_constant=self._reject)
        ev = next(r for r in _records(telemetry) if r["event"] == "optim_iter")
        assert (ev["loss"], ev["grad_norm"], ev["step"]) == ("NaN", "Infinity", "-Infinity")
        json.dumps(chrome_trace(_records(telemetry)), allow_nan=False)

    @staticmethod
    def _reject(const):
        raise AssertionError(f"non-strict JSON constant in the sink's output: {const}")

    def test_rotation_keeps_file_complete_prefix(self, tmp_path):
        from photon_ml_tpu_torch.obs.sink import TelemetrySink

        sink = TelemetrySink(str(tmp_path))
        for i in range(300):  # crosses the first rotation (128)
            sink.emit({"event": "tick", "t": float(i), "i": i})
            if os.path.exists(sink.path):
                for line in open(sink.path):
                    json.loads(line)
        sink.close()
        assert [json.loads(line)["i"] for line in open(sink.path)] == list(range(300))

    def test_multihost_nonzero_process_does_not_write(self, tmp_path, monkeypatch):
        import photon_ml_tpu_torch.obs.sink as sink_mod

        monkeypatch.setattr(sink_mod, "_process_index", lambda: 1)
        assert obs.configure(str(tmp_path / "t")) is None
        assert not obs.enabled()
        obs.shutdown()

    def test_disabled_logger_hook_and_enabled_capture(self, telemetry):
        from photon_ml_tpu_torch.utils import PhotonLogger

        log = PhotonLogger(stream=open(os.devnull, "w"))
        log.warn("dropped rows", tag="uid", fraction=0.6)
        log.error("bad shard", shard="g")
        log.info("quiet")  # INFO lines never become records
        obs.shutdown()
        logs = [r for r in _records(telemetry) if r["event"] == "log"]
        assert {(r["level"], r["message"]) for r in logs} == {("WARN", "dropped rows"), ("ERROR", "bad shard")}
        assert next(r for r in logs if r["level"] == "WARN")["fields"] == {"tag": "uid", "fraction": 0.6}

    def test_logger_hook_opt_out_and_custom(self):
        from photon_ml_tpu_torch.utils import PhotonLogger

        seen = []
        log = PhotonLogger(stream=open(os.devnull, "w"),
                           event_hook=lambda lvl, msg, fields: seen.append((lvl, msg, fields)))
        log.warn("w", a=1)
        assert seen == [("WARN", "w", {"a": 1})]
        PhotonLogger(stream=open(os.devnull, "w"), event_hook=False).warn("silent")

    def test_perfetto_export_is_valid_chrome_trace(self, tmp_path):
        path = obs.configure(str(tmp_path / "t"), run_id="runA")
        with obs.span("ingest/read", files=1):
            pass
        with obs.span("descent/iter", iteration=0):
            with obs.span("descent/visit", coordinate="fixed"):
                obs.emit_event("optim_result", reason="GRADIENT_CONVERGED", iterations=3, value=1.0,
                               grad_norm=1e-5)
        obs.shutdown()
        out = str(tmp_path / "trace.json")
        trace = export_chrome_trace(path, out)
        with open(out) as f:
            assert json.load(f) == json.loads(json.dumps(trace))
        complete = [e for e in trace["traceEvents"] if e["ph"] == "X"]
        assert {"ingest/read", "descent/iter", "descent/visit"} <= {e["name"] for e in complete}
        for e in complete:
            assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e) and e["ts"] >= 0 and e["dur"] >= 0
        assert any(e["ph"] == "i" for e in trace["traceEvents"])
        assert export_chrome_trace(str(tmp_path / "t")) == trace  # a directory: its newest run

    def test_validate_rejects_foreign_files(self, tmp_path):
        p = tmp_path / "x.jsonl"
        p.write_text('{"not": "telemetry"}\n')
        assert validate_run(load_run(str(p)))
        p2 = tmp_path / "y.jsonl"
        p2.write_text("not json\n")
        with pytest.raises(ValueError):
            load_run(str(p2))


class TestAtomicIO:
    def test_crash_simulation_partial_never_shadows_complete(self, tmp_path, monkeypatch):
        from photon_ml_tpu_torch.utils.atomic_io import atomic_replace_bytes

        d = str(tmp_path)
        final = os.path.join(d, "run.jsonl")
        atomic_replace_bytes(d, final, b'{"event":"run_start"}\n')

        class Boom(RuntimeError):
            pass

        calls = {"n": 0}
        real_fsync = os.fsync

        def dying_fsync(fd):
            calls["n"] += 1
            if calls["n"] == 1:
                raise Boom()  # die mid-write, before the rename
            return real_fsync(fd)

        monkeypatch.setattr(os, "fsync", dying_fsync)
        with pytest.raises(Boom):
            atomic_replace_bytes(d, final, b"x" * (1 << 20))
        assert open(final, "rb").read() == b'{"event":"run_start"}\n'
        assert [f for f in os.listdir(d) if f.endswith(".tmp")] == []

    def test_sink_rotation_survives_one_failed_rotate(self, tmp_path, monkeypatch):
        import photon_ml_tpu_torch.utils.atomic_io as aio
        from photon_ml_tpu_torch.obs.sink import TelemetrySink

        sink = TelemetrySink(str(tmp_path))
        sink.emit({"event": "run_start", "t": 0.0})
        sink.flush()
        good = open(sink.path).read()
        real = aio.atomic_replace_bytes
        monkeypatch.setattr(aio, "atomic_replace_bytes", lambda *a: (_ for _ in ()).throw(OSError("disk full")))
        with pytest.raises(OSError):
            sink.flush()
        assert open(sink.path).read() == good
        monkeypatch.setattr(aio, "atomic_replace_bytes", real)
        sink.emit({"event": "tick", "t": 1.0})
        sink.close()
        assert len(open(sink.path).readlines()) == 2


class TestMetricsRegistry:
    def test_typed_instruments_snapshot(self):
        r = obs_metrics.MetricsRegistry()
        r.counter_inc("c.bytes", 10)
        r.counter_inc("c.bytes", 5)
        r.gauge_set("g.frac", 0.25)
        for v in (1, 2, 8):
            r.histogram_observe("h.iters", v)
        r.timer_add("t.pack_s", 0.5)
        snap = r.snapshot()
        assert snap["counters"]["c.bytes"] == {"value": 15.0, "calls": 2}
        assert snap["gauges"]["g.frac"] == 0.25
        h = snap["histograms"]["h.iters"]
        assert (h["count"], h["sum"], h["min"], h["max"]) == (3, 11.0, 1, 8)
        assert h["log2_buckets"] == {"0": 1, "1": 1, "3": 1}
        assert snap["timers"]["t.pack_s"]["calls"] == 1
        json.dumps(snap)
        r.reset("c.")
        assert r.snapshot()["counters"] == {} and r.snapshot()["gauges"] != {}

    def test_profiling_shim_is_a_view_of_the_registry(self):
        from photon_ml_tpu_torch.utils import profiling

        profiling.reset_counters("shimtest.")
        with profiling.stage_timer("shimtest.stage"):
            pass
        snap = profiling.counter_snapshot("shimtest.")
        assert snap["shimtest.stage"]["calls"] == 1
        assert obs_metrics.REGISTRY.snapshot("shimtest.")["timers"] == snap
        profiling.reset_counters("shimtest.")
        assert profiling.counter_snapshot("shimtest.") == {}

    def test_prefetch_stages_and_cache_are_registry_instruments(self, monkeypatch):
        """The pipeline's stage seconds are the registry's ``prefetch.*``
        timers (``stage_seconds`` a view of them) and the chunk cache's
        hits and misses feed ``prefetch.cache.*`` from the increments
        behind ``cache_stats``."""
        from photon_ml_tpu_torch.ops import prefetch

        prefetch.clear_cache()
        prefetch.reset_stage_seconds()
        obs.REGISTRY.reset("prefetch.cache.")
        chunks = [{"X": np.ones((4, 3), np.float32) * i} for i in range(3)]
        for _ in range(2):
            list(prefetch.prefetch_iter(3, lambda i: prefetch.cached_device_put(chunks[i], "cpu"), depth=2))
        timers = obs.REGISTRY.timer_snapshot("prefetch.")
        assert dict(prefetch.stage_seconds) == {
            k: timers.get(f"prefetch.{k}", {"seconds": 0.0})["seconds"]
            for k in ("host_pack_s", "device_put_s", "consumer_wait_s")}
        assert timers["prefetch.host_pack_s"]["calls"] == 6
        stats, counters = prefetch.cache_stats(), obs.REGISTRY.snapshot("prefetch.cache.")["counters"]
        assert (stats["misses"], stats["device_hits"]) == (3, 3)
        assert counters["prefetch.cache.miss_bytes"] == {"value": 3 * 48.0, "calls": 3}
        assert counters["prefetch.cache.hit_bytes"] == {"value": 3 * 48.0, "calls": 3}
        prefetch.reset_stage_seconds()
        assert set(dict(prefetch.stage_seconds).values()) == {0.0}
        prefetch.clear_cache()

    def test_optimization_result_telemetry_record(self):
        from photon_ml_tpu_torch.optim.common import ConvergenceReason, OptimizationResult

        res = OptimizationResult(
            w=torch.zeros(2), value=torch.tensor(1.5), grad_norm=torch.tensor(1e-4), iterations=7,
            reason=int(ConvergenceReason.GRADIENT_CONVERGED), loss_history=torch.zeros(8),
            grad_norm_history=torch.zeros(8), objective_passes=9,
        )
        rec = res.telemetry_record(coordinate="fixed")
        assert rec == {"reason": "GRADIENT_CONVERGED", "iterations": 7, "value": 1.5,
                       "grad_norm": pytest.approx(1e-4), "objective_passes": 9, "coordinate": "fixed"}


class TestFleetSink:
    def test_shard_sink_filename_and_schema(self, tmp_path):
        from photon_ml_tpu_torch.obs.sink import TelemetrySink

        s = TelemetrySink(str(tmp_path), run_id="X", shard_index=3)
        assert s.path.endswith("run-X.p3.jsonl")
        s.emit({"event": "run_start", "t": 1.0, "schema_version": obs.SCHEMA_VERSION, "run_id": "X",
                "process_index": 3})
        s.close()
        assert validate_run(load_run(s.path)) == []

    def test_configure_single_process_never_shards(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PHOTON_TELEMETRY_FLEET", "1")
        path = obs.configure(str(tmp_path / "t"), run_id="solo")
        obs.shutdown()
        assert path.endswith("run-solo.jsonl")
        assert "fleet" not in load_run(path)[0]

    def test_fleet_knob_parses_and_is_off_by_default(self, monkeypatch):
        """Unset, the port's fleet knob is off, ``PHOTON_RE_SHARD`` or not:
        the reference's default follows the re-sharded schedule, which the
        port does not have yet."""
        from photon_ml_tpu_torch.obs.sink import fleet_telemetry_enabled

        monkeypatch.delenv("PHOTON_TELEMETRY_FLEET", raising=False)
        monkeypatch.setenv("PHOTON_RE_SHARD", "1")
        assert fleet_telemetry_enabled() is False
        monkeypatch.setenv("PHOTON_TELEMETRY_FLEET", "1")
        assert fleet_telemetry_enabled() is True
        monkeypatch.setenv("PHOTON_TELEMETRY_FLEET", "junk")
        with pytest.raises(ValueError):
            fleet_telemetry_enabled()


# ---------------------------------------------------------------------------
# the parity test: the reference's acceptance fixture through both trainers
# ---------------------------------------------------------------------------
def _ref_game_config(iters: int):
    from photon_ml_tpu.config import (
        FixedEffectCoordinateConfig,
        GameTrainingConfig,
        OptimizationConfig,
        OptimizerConfig,
        RandomEffectCoordinateConfig,
        RegularizationContext,
    )
    from photon_ml_tpu.types import RegularizationType, TaskType

    opt = OptimizationConfig(optimizer=OptimizerConfig(max_iterations=8, tolerance=1e-6),
                             regularization=RegularizationContext(RegularizationType.L2),
                             regularization_weight=1.0)
    return GameTrainingConfig(
        task_type=TaskType.LOGISTIC_REGRESSION,
        coordinate_update_sequence=("fixed", "user"),
        coordinate_descent_iterations=iters,
        fixed_effect_coordinates={"fixed": FixedEffectCoordinateConfig(feature_shard_id="g", optimization=opt)},
        random_effect_coordinates={"user": RandomEffectCoordinateConfig(
            feature_shard_id="r", random_effect_type="uid", optimization=opt)},
        evaluators=("AUC",),
    )


def _fixture_arrays(seed: int = 42):
    """``TestEndToEndGame._fit``'s draws, from the conftest ``rng`` seed."""
    rng = np.random.default_rng(seed)
    n, d, E, dr = 240, 5, 6, 3
    X = rng.normal(size=(n, d)).astype(np.float32)
    Xr = rng.normal(size=(n, dr)).astype(np.float32)
    ids = rng.integers(0, E, size=n).astype(np.int32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return X, Xr, ids, y


def _port_fit(directory, iters=2, run_id="portA"):
    from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer

    X, Xr, ids, y = _fixture_arrays()
    cfg = tcfg.parse_config(_ref_game_config(iters).to_dict())
    data = StreamedGameData(labels=y, features={"g": X, "r": Xr}, id_tags={"uid": ids})
    val = StreamedGameData(labels=y[:80], features={"g": X[:80], "r": Xr[:80]}, id_tags={"uid": ids[:80]})
    path = None if directory is None else obs.configure(str(directory), run_id=run_id)
    try:
        model, _ = StreamedGameTrainer(cfg, chunk_rows=96, evaluators=("AUC",), device="cpu").fit(
            data, validation=val)
    finally:
        obs.shutdown()
    return path, model


@pytest.fixture(scope="module")
def parity_runs(tmp_path_factory):
    """One streamed GAME fit of the fixture in each package, each with its
    own sink (device-cost capture off in both: ``PHOTON_DEVCOST=0``)."""
    from photon_ml_tpu import obs as jobs
    from photon_ml_tpu.game.streaming import StreamedGameData, StreamedGameTrainer

    work = tmp_path_factory.mktemp("telemetry_parity")
    X, Xr, ids, y = _fixture_arrays()
    data = StreamedGameData(labels=y, features={"g": X, "r": Xr}, id_tags={"uid": ids})
    val = StreamedGameData(labels=y[:80], features={"g": X[:80], "r": Xr[:80]}, id_tags={"uid": ids[:80]})
    ref_path = jobs.configure(str(work / "ref"), run_id="refA")
    try:
        StreamedGameTrainer(_ref_game_config(2), chunk_rows=96, evaluators=("AUC",)).fit(data, validation=val)
    finally:
        jobs.shutdown()
    port_path, _ = _port_fit(work / "port")
    return load_run(ref_path), load_run(port_path), port_path


def _spans(records):
    return [r for r in records if r["event"] == "span"]


class TestParity:
    def test_reference_validates_and_summarizes_the_port_run(self, parity_runs):
        from photon_ml_tpu.obs.report import load_run as ref_load_run
        from photon_ml_tpu.obs.report import summarize_run
        from photon_ml_tpu.obs.report import validate_run as ref_validate_run

        _, port, path = parity_runs
        assert ref_validate_run(ref_load_run(path)) == []
        assert {"game", "ingest", "descent"} <= set(summarize_run(path)["phases"])

    def test_reference_chrome_trace_of_the_port_run(self, parity_runs):
        from photon_ml_tpu.obs.export import chrome_trace as ref_chrome_trace

        trace = ref_chrome_trace(parity_runs[1])
        json.dumps(trace)
        assert any(e["name"] == "descent/visit" for e in trace["traceEvents"])

    def test_span_tree(self, parity_runs):
        spans = _spans(parity_runs[1])
        by_id = {s["span_id"]: s for s in spans}
        visit = next(s for s in spans if s["name"] == "descent/visit")
        it_span = by_id[visit["parent_id"]]
        assert it_span["name"] == "descent/iter" and by_id[it_span["parent_id"]]["name"] == "game/fit"
        ingest = next(s for s in spans if s["name"] == "ingest/re-shard")
        assert by_id[ingest["parent_id"]]["name"] == "game/fit"
        val_span = next(s for s in spans if s["name"] == "descent/validation")
        assert by_id[val_span["parent_id"]]["name"] == "descent/iter"

    def test_span_names_and_visits_equal_the_references(self, parity_runs):
        ref, port, _ = parity_runs
        assert {s["name"] for s in _spans(port)} == {s["name"] for s in _spans(ref)}

        def visits(records):
            return {(s["attrs"]["iteration"], s["attrs"]["coordinate"])
                    for s in _spans(records) if s["name"] == "descent/visit"}

        assert visits(port) == visits(ref) == {(0, "fixed"), (0, "user"), (1, "fixed"), (1, "user")}

    def test_event_kinds_equal_the_references(self, parity_runs):
        ref, port, _ = parity_runs
        # the reference's compile listener has no counterpart record (the
        # port records its kernel build as the timer cuda.build_s)
        only_ref = {"jax_event"}
        assert {r["event"] for r in port} == {r["event"] for r in ref} - only_ref

    def test_solver_and_visit_records(self, parity_runs):
        port = parity_runs[1]
        assert any(r["event"] == "optim_iter" for r in port)
        opt_res = [r for r in port if r["event"] == "optim_result"]
        assert opt_res and all(isinstance(r["reason"], str) and "iterations" in r for r in opt_res)
        assert sum(r["event"] == "visit_result" for r in port) == 4
        end = port[-1]
        assert end["event"] == "run_end"
        assert end["metrics"]["counters"]["stream.passes"]["value"] > 0
        assert end["metrics"]["counters"]["re_solve.launches"]["value"] > 0
        assert "re_solve.executed_entity_iterations" in end["metrics"]["counters"]

    def test_watermark_record(self, parity_runs):
        """On the CPU: one ``available: false`` record, at the root span's
        exit, as the reference writes."""
        port = parity_runs[1]
        wm = [r for r in port if r["event"] == "hbm_watermark"]
        assert len(wm) == 1 and wm[0]["available"] is False and wm[0]["root_span"] == "game/fit"


# ---------------------------------------------------------------------------
# the name check (the reference's telemetry lint rule, applied to the port)
# ---------------------------------------------------------------------------
ALLOWED = {
    "cuda.build_s": "the port's kernel build timer, the counterpart of the reference's jax.compile_s",
    "optim.iterations": "the reference's host solvers record it (host_lbfgs.py, host_tron.py); "
                        "no report row reads it yet",
    "optim.reason.*": "as optim.iterations",
    "stream.passes": "the reference records it per streamed pass; its acceptance test reads it",
    "stream.chunks": "recorded beside stream.passes, as in the reference",
    "prefetch.cache.host_hit_bytes": "the reference's host-tier twin of prefetch.cache.hit_bytes",
    "prefetch.cache.hit_bytes": "the reference's chunk-cache counter (bench reads it)",
    "prefetch.cache.miss_bytes": "as prefetch.cache.hit_bytes",
    "prefetch.cache.evictions": "as prefetch.cache.hit_bytes",
    "re_solve.active_lane_fraction": "the reference's gauge beside the re_solve counters",
    "re_solve.visit_wall_s": "the reference's per-visit solve timer, which its re-planner reads",
    "game.grouped_dropped_frac.*": "the reference's dropped-row gauge per grouped tag",
    "devcost.capture_errors": "the reference's capture-failure counter",
    "devcost.captures": "the reference's capture counter (devcost._publish); the report reads "
                        "the devcost.* family by prefix",
    "devcost.capture_s": "as devcost.captures",
    "devcost.tile_layout.packs": "the reference's layout-pack counters (devcost.record_layout_pack)",
    "devcost.tile_layout.packed_bytes_total": "as devcost.tile_layout.packs",
    "devcost.tile_layout.packed_bytes": "as devcost.tile_layout.packs",
    "hbm.bytes_in_use": "the reference's watermark gauges (devcost.sample_hbm_watermarks)",
    "hbm.peak_bytes_in_use": "as hbm.bytes_in_use",
    "descent_iteration": "the reference's end-of-iteration record (game/descent.py)",
    "dropped_rows": "the reference's dropped-row record (game/streaming.py)",
    "visit_result": "the reference's per-visit record; its acceptance test reads it",
    "tile_layout_pack": "the reference's layout-pack record (devcost.record_layout_pack)",
}
_METRIC_CALLS = {"counter_inc", "gauge_set", "timer_add", "histogram_observe"}


def _emitted_names() -> set[str]:
    """Record kinds (``emit_event("k", ...)``, ``{"event": "k"}``) and
    registry names (the four registry writes) in the port's modules;
    f-string names become ``*`` patterns."""
    names = set()

    def name_of(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.JoinedStr):
            return "".join(p.value if isinstance(p, ast.Constant) else "*" for p in node.values)
        return None

    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if not f.endswith(".py") or dirpath.endswith("obs") and f in ("report.py", "export.py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and node.args:
                    fn = node.func
                    fname = fn.id if isinstance(fn, ast.Name) else getattr(fn, "attr", None)
                    if fname and (fname in _METRIC_CALLS or "emit" in fname):
                        n = name_of(node.args[0])
                        if n and (fname in _METRIC_CALLS or fname in ("emit_event", "emit")):
                            names.add(n)
                elif isinstance(node, ast.Dict):
                    for k, v in zip(node.keys, node.values):
                        if isinstance(k, ast.Constant) and k.value == "event" and name_of(v):
                            names.add(name_of(v))
    # the prefetch stage timers are named through profiling.add_seconds
    names.update(f"prefetch.{s}" for s in ("host_pack_s", "device_put_s", "consumer_wait_s"))
    return names


def test_every_emitted_name_is_read_by_the_reference_or_allowed():
    consumer_text = "".join(open(os.path.join(ROOT, "photon_ml_tpu", "obs", f)).read()
                            for f in ("report.py", "export.py"))
    names = _emitted_names()
    assert {"span", "run_start", "run_end", "optim_iter", "optim_result", "re_solve.launches",
            "stream.passes", "hbm_watermark", "executable_cost"} <= names
    unread = []
    for n in sorted(names):
        if n in ALLOWED:
            continue
        if "*" in n:
            segments = [s for s in n.split("*") if len(s) >= 4]
            if any(s in consumer_text for s in segments):
                continue
        elif f'"{n}"' in consumer_text or f"'{n}'" in consumer_text:
            continue
        unread.append(n)
    assert not unread, f"emitted names no reference reader reads and not allowed: {unread}"
    stale = [n for n in ALLOWED if n not in names]
    assert not stale, f"allow-list entries the port no longer emits: {stale}"


# ---------------------------------------------------------------------------
# telemetry on and off: bitwise-equal results
# ---------------------------------------------------------------------------
def _glm_arrays(n=300, d=6, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-X @ rng.normal(size=d)))).astype(np.float32)
    return X, y


def _on_off(fn, tmp_path):
    """``fn()`` with no sink, then under a sink; both results and the
    run's records."""
    obs.shutdown()
    off = fn()
    path = obs.configure(str(tmp_path / "tel"))
    try:
        on = fn()
    finally:
        obs.shutdown()
    return off, on, load_run(path)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.cpu(), b.cpu())


def test_on_off_train_glm(tmp_path):
    from photon_ml_tpu_torch.config import OptimizerConfig
    from photon_ml_tpu_torch.convert import dense_batch_from_numpy
    from photon_ml_tpu_torch.supervised.training import train_glm

    X, y = _glm_arrays()
    batch = dense_batch_from_numpy(X, y, device="cpu")

    def fit():
        return train_glm(batch, ttypes.TaskType.LOGISTIC_REGRESSION, optimizer_config=OptimizerConfig(),
                         regularization_weights=[0.1, 1.0], device="cpu")

    off, on, records = _on_off(fit, tmp_path)
    for lam in (0.1, 1.0):
        assert _same(off.models[lam].coefficients.means, on.models[lam].coefficients.means)
    assert [s["attrs"]["weight"] for s in _spans(records) if s["name"] == "glm/lambda"] == [0.1, 1.0]
    assert [r["weight"] for r in records if r["event"] == "optim_result"] == [0.1, 1.0]


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_on_off_train_glm_streamed(tmp_path, optimizer):
    from photon_ml_tpu_torch.config import OptimizerConfig
    from photon_ml_tpu_torch.ops.streaming import dense_chunks
    from photon_ml_tpu_torch.supervised.training import train_glm_streamed

    X, y = _glm_arrays()
    chunks = dense_chunks(X, y, chunk_rows=64)
    cfg = OptimizerConfig(optimizer_type=ttypes.OptimizerType(optimizer))

    def fit():
        return train_glm_streamed(chunks, ttypes.TaskType.LOGISTIC_REGRESSION, num_features=X.shape[1],
                                  optimizer_config=cfg, regularization_weights=[1.0], device="cpu")

    obs.REGISTRY.reset("stream.")
    off, on, records = _on_off(fit, tmp_path)
    assert _same(off.models[1.0].coefficients.means, on.models[1.0].coefficients.means)
    (res,) = [r for r in records if r["event"] == "optim_result"]
    assert res["algorithm"] == optimizer.lower() and res["iterations"] == on.trackers[1.0].iterations
    assert sum(r["event"] == "optim_iter" for r in records) == res["iterations"]
    passes = records[-1]["metrics"]["counters"]["stream.passes"]["value"]
    base = records[0]["metrics_baseline"]["counters"]["stream.passes"]["value"]
    assert passes - base == on.trackers[1.0].objective_passes  # one registry pass per streamed pass


def _game_fixture(n=300, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    Xr = rng.normal(size=(n, 2)).astype(np.float32)
    ids = rng.integers(0, 7, size=n).astype(np.int64)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return X, Xr, ids, y


def test_on_off_game_estimator(tmp_path):
    from photon_ml_tpu_torch.convert import game_batch_from_numpy
    from photon_ml_tpu_torch.estimators import GameEstimator

    X, Xr, ids, y = _game_fixture()
    cfg = tcfg.parse_config(_ref_game_config(2).to_dict())
    batch = game_batch_from_numpy(y, {"g": X, "r": Xr}, id_tags={"uid": ids}, device="cpu")
    val = game_batch_from_numpy(y[:90], {"g": X[:90], "r": Xr[:90]}, id_tags={"uid": ids[:90]}, device="cpu")

    def fit():
        return GameEstimator(cfg, device="cpu").fit(batch, val)[0].model

    off, on, records = _on_off(fit, tmp_path)
    for cid in ("fixed", "user"):
        assert _same(off[cid].coefficient_means, on[cid].coefficient_means)
    names = {s["name"] for s in _spans(records)}
    assert {"descent/iter", "descent/visit", "descent/validation"} <= names
    assert sum(r["event"] == "descent_iteration" for r in records) == 2
    counters = records[-1]["metrics"]["counters"]
    assert counters["re_solve.launches"]["value"] > 0
    assert counters["re_solve.useful_entity_iterations"]["value"] > 0


def test_on_off_streamed_game_trainer(tmp_path):
    _, off = _port_fit(None)
    path, on = _port_fit(tmp_path / "t")
    for cid in ("fixed", "user"):
        assert _same(off[cid].coefficient_means, on[cid].coefficient_means)
    assert validate_run(load_run(path)) == []


# ---------------------------------------------------------------------------
# two gloo processes of the streamed trainer, fleet telemetry
# ---------------------------------------------------------------------------
_FLEET_WORKER = textwrap.dedent(
    """
    import os, sys
    root, port, rank, work, telemetry = sys.argv[1:6]
    sys.path.insert(0, root)
    import numpy as np, torch
    torch.set_num_threads(1)
    import photon_ml_tpu_torch.config as tcfg
    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer
    from photon_ml_tpu_torch.parallel import multihost as mh

    rank = int(rank)
    mh.initialize_multihost(f"127.0.0.1:{port}", 2, rank, timeout_s=100)
    a = np.load(os.path.join(work, "arrays.npz"))
    half = slice(0, 120) if rank == 0 else slice(120, 240)
    data = StreamedGameData(labels=a["y"][half], features={"g": a["X"][half], "r": a["Xr"][half]},
                            id_tags={"uid": a["ids"][half]})
    cfg = tcfg.parse_config(__import__("json").load(open(os.path.join(work, "config.json"))))
    if telemetry == "1":
        obs.configure(os.path.join(work, "tel"))
    try:
        model, _ = StreamedGameTrainer(cfg, chunk_rows=48, multihost=True, device="cpu").fit(data)
    finally:
        obs.shutdown()
    np.savez(os.path.join(work, f"model-{telemetry}-{rank}.npz"),
             **{cid: sub.coefficient_means.numpy() for cid, sub in model.models.items()})
    mh.shutdown_multihost()
    print("WORKER DONE", rank)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_fleet(work, telemetry: str) -> None:
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")}
    env.update(OMP_NUM_THREADS="1", PHOTON_TELEMETRY_FLEET="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _FLEET_WORKER, ROOT, port, str(rank), str(work), telemetry],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
             for rank in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0 and f"WORKER DONE {rank}" in out, f"worker {rank} failed (rc {rc}):\n{out}\n{err[-4000:]}"


def test_two_process_fleet_telemetry_on_off(tmp_path):
    X, Xr, ids, y = _fixture_arrays()
    np.savez(tmp_path / "arrays.npz", X=X, Xr=Xr, ids=ids, y=y)
    (tmp_path / "config.json").write_text(json.dumps(_ref_game_config(2).to_dict()))
    for tel in ("0", "1"):  # the two pairs run one after the other, each on its own port
        _spawn_fleet(tmp_path, tel)
    for rank in (0, 1):
        off, on = np.load(tmp_path / f"model-0-{rank}.npz"), np.load(tmp_path / f"model-1-{rank}.npz")
        for cid in ("fixed", "user"):
            np.testing.assert_array_equal(off[cid], on[cid])
    files = sorted(os.listdir(tmp_path / "tel"))
    assert len(files) == 2 and files[1].endswith(".p1.jsonl"), files
    (canonical, shard) = (load_run(str(tmp_path / "tel" / f)) for f in files)
    for records, pidx in ((canonical, 0), (shard, 1)):
        assert validate_run(records) == []
        assert records[0]["process_index"] == pidx and records[0]["fleet"] == {"process_count": 2}
        assert {"game/fit", "descent/visit"} <= {s["name"] for s in _spans(records)}
    assert canonical[0]["run_id"] == shard[0]["run_id"]
    assert files[0] == f"run-{canonical[0]['run_id']}.jsonl"


# ---------------------------------------------------------------------------
# the three drivers with --telemetry-dir and --profile-dir
# ---------------------------------------------------------------------------
def _avro_schema():
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA

    schema = json.loads(json.dumps(TRAINING_EXAMPLE_SCHEMA))
    schema["fields"].insert(5, {"name": "userFeatures", "type": {"type": "array", "items": "NameTermValueAvro"},
                                "default": []})
    return schema


def _write_game_avro(path, X, Xr, ids, y):
    from photon_ml_tpu_torch.io.avro import write_avro_file

    def bag(name, M, i):
        return [{"name": name, "term": str(j), "value": float(M[i, j])} for j in range(M.shape[1])]

    recs = [{"uid": f"s{i}", "response": float(y[i]), "offset": None, "weight": None,
             "features": bag("g", X, i), "userFeatures": bag("u", Xr, i),
             "metadataMap": {"userId": f"user_{int(ids[i])}"}} for i in range(len(y))]
    write_avro_file(str(path), _avro_schema(), recs)


def _driver_config(iterations=2):
    opt = tcfg.OptimizationConfig(
        optimizer=tcfg.OptimizerConfig(max_iterations=20, tolerance=1e-7),
        regularization=tcfg.RegularizationContext(ttypes.RegularizationType.L2), regularization_weight=1.0)
    return tcfg.GameTrainingConfig(
        task_type=ttypes.TaskType.LOGISTIC_REGRESSION,
        coordinate_update_sequence=("fixed", "per_user"),
        coordinate_descent_iterations=iterations,
        fixed_effect_coordinates={"fixed": tcfg.FixedEffectCoordinateConfig("global", opt)},
        random_effect_coordinates={"per_user": tcfg.RandomEffectCoordinateConfig("userId", "per_user", opt)},
        feature_shards={
            "global": tcfg.FeatureShardConfig(feature_bags=("features",), has_intercept=True),
            "per_user": tcfg.FeatureShardConfig(feature_bags=("userFeatures",), has_intercept=False),
        },
        evaluators=("AUC",),
    )


def _outputs(out) -> dict:
    """Every model, score and checkpoint file of a driver's output, decoded
    (Avro records, npz arrays, JSON), keyed by relative path; the log and
    the profiler and telemetry directories are not outputs."""
    from photon_ml_tpu_torch.io.avro import read_avro_file

    got = {}
    for d, _, files in os.walk(out):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), out)
            full = os.path.join(d, f)
            if f.endswith(".avro"):
                got[rel] = read_avro_file(full)[1]
            elif f.endswith(".npz"):
                with np.load(full) as z:
                    got[rel] = {k: z[k].tobytes() for k in z.files}
            elif f.endswith(".json"):
                got[rel] = json.load(open(full))
    return got


@pytest.fixture(scope="module")
def game_files(tmp_path_factory):
    work = tmp_path_factory.mktemp("telemetry_drivers")
    X, Xr, ids, y = _game_fixture(n=260, seed=9)
    (work / "train").mkdir()
    _write_game_avro(work / "train" / "part-00000.avro", X[:200], Xr[:200], ids[:200], y[:200])
    _write_game_avro(work / "val.avro", X[200:], Xr[200:], ids[200:], y[200:])
    (work / "config.json").write_text(json.dumps(_driver_config().to_dict()))
    return work


@pytest.mark.parametrize("streamed", [False, True], ids=["in_memory", "streamed"])
def test_game_driver_telemetry_and_profile(game_files, tmp_path, streamed):
    from photon_ml_tpu_torch.cli import train as port_train

    base = ["--config", str(game_files / "config.json"), "--train-data", str(game_files / "train"),
            "--validation-data", str(game_files / "val.avro"), "--device", "cpu"]
    if streamed:
        base += ["--streaming-chunk-rows", "64"]
    port_train.main(base + ["--output-dir", str(tmp_path / "off")])
    port_train.main(base + ["--output-dir", str(tmp_path / "on"), "--telemetry-dir", str(tmp_path / "tel"),
                            "--profile-dir", str(tmp_path / "prof")])
    assert not obs.enabled()
    off, on = _outputs(tmp_path / "off"), _outputs(tmp_path / "on")
    assert off.keys() == on.keys() and any(k.startswith("best") for k in off)
    for k in off:
        assert off[k] == on[k], k
    label = "streamed-game" if streamed else "grid-fit"
    assert (tmp_path / "prof" / label / "trace.json").stat().st_size > 0
    (run,) = os.listdir(tmp_path / "tel")
    records = load_run(str(tmp_path / "tel" / run))
    assert validate_run(records) == []
    spans = _spans(records)
    by_id = {s["span_id"]: s for s in spans}
    top = "train/streamed-descent" if streamed else "train/grid-fit"
    ingest = {"ingest/stats-pass", "ingest/fill-pass", "ingest/fill-validation"} if streamed else {
        "ingest/train-data", "ingest/validation-data"}
    assert ingest | {top, "descent/iter", "descent/visit"} <= {s["name"] for s in spans}
    visit = next(s for s in spans if s["name"] == "descent/visit")
    chain = []
    s = visit
    while s is not None:
        chain.append(s["name"])
        s = by_id.get(s.get("parent_id"))
    assert chain[:2] == ["descent/visit", "descent/iter"] and chain[-1] == top


def test_score_driver_telemetry_and_profile(game_files, tmp_path):
    from photon_ml_tpu_torch.cli import score as port_score
    from photon_ml_tpu_torch.cli import train as port_train

    port_train.main(["--config", str(game_files / "config.json"), "--train-data", str(game_files / "train"),
                     "--device", "cpu", "--output-dir", str(tmp_path / "model")])
    base = ["--model-dir", str(tmp_path / "model"), "--data", str(game_files / "val.avro"),
            "--config", str(game_files / "config.json"), "--evaluators", "AUC", "--device", "cpu"]
    port_score.main(base + ["--output-dir", str(tmp_path / "off")])
    port_score.main(base + ["--output-dir", str(tmp_path / "on"), "--telemetry-dir", str(tmp_path / "tel"),
                            "--profile-dir", str(tmp_path / "prof")])
    assert _outputs(tmp_path / "off") == _outputs(tmp_path / "on")
    assert (tmp_path / "prof" / "score" / "trace.json").stat().st_size > 0
    (run,) = os.listdir(tmp_path / "tel")
    records = load_run(str(tmp_path / "tel" / run))
    assert validate_run(records) == [] and "score/pass" in {s["name"] for s in _spans(records)}


def test_glm_driver_telemetry_and_profile(tmp_path):
    from photon_ml_tpu_torch.cli.train_glm import main as glm_main

    X, y = _glm_arrays(n=200, d=5)
    with open(tmp_path / "train.libsvm", "w") as f:
        for xi, yi in zip(X, y):
            f.write(f"{int(yi)} " + " ".join(f"{j + 1}:{v:.6f}" for j, v in enumerate(xi)) + "\n")
    base = ["--task", "LOGISTIC_REGRESSION", "--train-data", str(tmp_path / "train.libsvm"),
            "--weights", "0.1", "1", "--device", "cpu"]
    glm_main(base + ["--output-dir", str(tmp_path / "off")])
    glm_main(base + ["--output-dir", str(tmp_path / "on"), "--telemetry-dir", str(tmp_path / "tel"),
                     "--profile-dir", str(tmp_path / "prof")])
    off, on = _outputs(tmp_path / "off"), _outputs(tmp_path / "on")
    assert off == on and any(k.startswith("best") for k in off)
    assert (tmp_path / "prof" / "glm-sweep" / "trace.json").stat().st_size > 0
    (run,) = os.listdir(tmp_path / "tel")
    records = load_run(str(tmp_path / "tel" / run))
    assert validate_run(records) == []
    assert [s["attrs"]["weight"] for s in _spans(records) if s["name"] == "glm/lambda"] == [0.1, 1.0]
