"""The port's analytic device cost (``photon_ml_tpu_torch/obs/devcost``) on
the CPU: the kernel launchers (K1 ``fused_value_grad``, K2 ``fused_hvp``,
K3 ``sparse_apply``) record the bytes and operations of each call
signature once, as ``executable_cost`` records with the reference's fields;
the bytes are the ones the kernels' roofline bound divides (each input read
once, each output written once). Capture is gated as the reference's is
(on with a sink, ``PHOTON_DEVCOST`` forcing it) and never fatal. The
memory axis: the budget record, the watermark at a root span's exit
(``available: false`` without CUDA; the CUDA reading from
``torch.cuda.memory_stats``, faked here), the layout-pack record.

``PHOTON_DEVCOST`` is set per test with ``monkeypatch`` (the conftest pins
it to 0 for the suite)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.obs import devcost
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.obs.report import load_run
from photon_ml_tpu_torch.ops import fused
from photon_ml_tpu_torch.ops import sparse_tiled as st
from photon_ml_tpu_torch.ops.losses import logistic_loss as LOGISTIC
from photon_ml_tpu_torch.ops.losses import squared_loss as SQUARED

# the reference's executable_cost fields (photon_ml_tpu/obs/devcost.py capture)
COST_FIELDS = {"event", "t", "cost_schema_version", "label", "knobs", "arg_sig", "flops", "bytes_accessed",
               "arith_intensity", "memory", "peak_bytes", "peak_is_estimate", "capture_s"}


@pytest.fixture
def telemetry(tmp_path, monkeypatch):
    """A sink with capture on (its production default) and a clean
    seen-set; both process-global, so always reset."""
    monkeypatch.delenv("PHOTON_DEVCOST", raising=False)
    devcost.reset()
    REGISTRY.reset(prefix="devcost.")
    REGISTRY.reset(prefix="hbm.")
    path = obs.configure(str(tmp_path / "telemetry"))
    try:
        yield path
    finally:
        obs.shutdown()
        devcost.reset()


def _costs(path, label=None):
    return [r for r in load_run(path) if r["event"] == "executable_cost" and label in (None, r["label"])]


def _k1_inputs(n=64, d=6, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((n, d), generator=g).to(dtype)
    y = (torch.rand(n, generator=g) < 0.5).float()
    off = torch.randn(n, generator=g)
    w = torch.rand(n, generator=g)
    u = torch.randn(d, generator=g)
    return X, y, off, w, u


class TestCapture:
    def test_k1_captures_once_per_signature(self, telemetry):
        X, y, off, w, u = _k1_inputs()
        for _ in range(3):
            fused.fused_value_grad(X, y, off, w, u, 0.1, loss=LOGISTIC)
        fused.fused_value_grad(X[:32], y[:32], None, None, u, 0.1, loss=LOGISTIC)  # a new signature
        obs.shutdown()
        recs = _costs(telemetry, "fused.value_grad")
        assert len(recs) == 2
        assert set(recs[0]) >= COST_FIELDS
        assert recs[0]["knobs"] == load_run(telemetry)[0]["knobs"]
        assert recs[0]["peak_is_estimate"] is True
        assert recs[0]["peak_bytes"] == recs[0]["bytes_accessed"]
        json.dumps(recs)

    @pytest.mark.parametrize("dtype,offsets", [(torch.float32, True), (torch.bfloat16, False)],
                             ids=["f32_offsets_weights", "bf16_plain"])
    def test_k1_bytes_are_the_bound_counts(self, telemetry, dtype, offsets):
        """X, labels (offsets, weights where given) and u read once, the
        value, Xᵀr and Σr written once; 4·n·d operations."""
        n, d = 96, 10
        X, y, off, w, u = _k1_inputs(n, d, dtype)
        if not offsets:
            off = w = None
        fused.fused_value_grad(X, y, off, w, u, 0.0, loss=LOGISTIC)
        obs.shutdown()
        (rec,) = _costs(telemetry, "fused.value_grad")
        itemsize = 4 if dtype is torch.float32 else 2
        want = n * d * itemsize + 4 * n * (1 + 2 * offsets) + 4 * d + 4 * (d + 2)
        assert rec["bytes_accessed"] == want and rec["flops"] == 4.0 * n * d
        assert rec["arith_intensity"] == pytest.approx(4.0 * n * d / want)

    def test_k2_bytes_are_the_bound_counts(self, telemetry):
        """X, labels, offsets, weights, u and v read once; Xᵀq and Σq
        written once; 6·n·d operations."""
        n, d = 80, 7
        X, y, off, w, u = _k1_inputs(n, d)
        fused.fused_hvp(X, y, off, w, u, u * 0.5, 0.1, 0.0, loss=SQUARED)
        fused.fused_hvp(X, y, off, w, u, u, 0.0, 0.0, loss=SQUARED)  # the same signature
        obs.shutdown()
        (rec,) = _costs(telemetry, "fused.hvp")
        assert rec["bytes_accessed"] == n * d * 4 + 4 * n * 3 + 8 * d + 4 * (d + 1)
        assert rec["flops"] == 6.0 * n * d

    def test_k3_bytes_are_the_bound_counts(self, telemetry):
        """The layout's streams and the float32 source read once, the output
        written once; 2 operations a nonzero, 4 squared."""
        from photon_ml_tpu_torch.convert import sparse_batch_from_numpy

        rng = np.random.default_rng(1)
        n, d, k = 50, 40, 4
        idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
        val = rng.normal(size=(n, k)).astype(np.float32)
        y = (rng.uniform(size=n) < 0.5).astype(np.float32)
        tb = st.tile_sparse_batch(sparse_batch_from_numpy(idx, val, y, num_features=d, device="cpu"))
        w, r = torch.ones(d), torch.ones(n)
        tb.matvec(w)
        tb.matvec(w)
        tb.rmatvec_sq(r)
        obs.shutdown()
        recs = {r_["flops"]: r_ for r_ in _costs(telemetry, "sparse_tiled.tiled_apply")}
        assert len(recs) == 2
        m = recs[2.0 * tb.m.nnz]
        assert m["bytes_accessed"] == tb.m.stream_bytes() + 4 * d + 4 * n
        sq = recs[4.0 * tb.g.nnz]
        assert sq["bytes_accessed"] == tb.g.stream_bytes() + 4 * n + 4 * d

    def test_knob_tuple_keys_the_capture(self, telemetry, monkeypatch):
        X, y, off, w, u = _k1_inputs()
        fused.fused_value_grad(X, y, off, w, u, 0.1, loss=LOGISTIC)
        monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "bf16")
        fused.fused_value_grad(X, y, off, w, u, 0.1, loss=LOGISTIC)  # same shapes, another rung
        fused.fused_value_grad(X, y, off, w, u, 0.1, loss=LOGISTIC)
        obs.shutdown()
        recs = _costs(telemetry, "fused.value_grad")
        assert [r["knobs"]["kernel_dtype"] for r in recs] == ["f32", "bf16"]
        assert recs[0]["arg_sig"] == recs[1]["arg_sig"]

    @pytest.mark.parametrize("env,value,key,want", [
        ("PHOTON_RE_REPLAN_IMBALANCE", "1.5", "re_replan_imbalance", 1.5),
        ("PHOTON_SERVE_HOT_BYTES", "4096", "serve_hot_bytes", 4096),
        ("PHOTON_SERVE_MAX_BATCH", "7", "serve_max_batch", 7),
        ("PHOTON_SERVE_MAX_WAIT_MS", "0.5", "serve_max_wait_ms", 0.5),
        ("PHOTON_SERVE_REFRESH_EVERY", "3", "serve_refresh_every", 3),
        ("PHOTON_STREAM_EXECUTOR", "1", "stream_executor", 1),
        ("PHOTON_STREAM_PRIORITY", "refresh=5", "stream_priority", "refresh=5"),
        ("PHOTON_STREAM_SHARE", "serve=0.5", "stream_share", "serve=0.5"),
    ])
    def test_serve_replan_and_stream_knobs_key_the_memo(self, env, value, key, want, monkeypatch):
        """A flip of any of these knobs changes the memo's key and the knobs
        a capture records."""
        monkeypatch.delenv(env, raising=False)
        before, knobs = devcost._knob_raw_state(), devcost.knob_key()
        monkeypatch.setenv(env, value)
        assert devcost._knob_raw_state() != before
        assert devcost.knob_key()[key] == want != knobs[key]

    def test_gating_env_overrides_sink(self, tmp_path, monkeypatch):
        devcost.reset()
        X, y, off, w, u = _k1_inputs()
        monkeypatch.delenv("PHOTON_DEVCOST", raising=False)
        obs.shutdown()
        assert not devcost.capture_enabled()
        before = REGISTRY.snapshot("devcost.captures")["counters"].get("devcost.captures", {"value": 0})["value"]
        fused.fused_value_grad(X, y, off, w, u, 0.1, loss=LOGISTIC)
        monkeypatch.setenv("PHOTON_DEVCOST", "1")  # on without a sink: the registry only
        fused.fused_value_grad(X, y, off, w, u, 0.1, loss=LOGISTIC)
        after = REGISTRY.snapshot("devcost.captures")["counters"]["devcost.captures"]["value"]
        assert after == before + 1
        assert REGISTRY.snapshot("devcost.fused")["gauges"]["devcost.fused.value_grad.flops"] > 0
        monkeypatch.setenv("PHOTON_DEVCOST", "0")  # off wins over a sink
        obs.configure(str(tmp_path / "t"))
        try:
            assert not devcost.capture_enabled()
        finally:
            obs.shutdown()
        devcost.reset()

    def test_malformed_env_degrades_to_off_not_crash(self, monkeypatch):
        monkeypatch.setenv("PHOTON_DEVCOST", "true")
        monkeypatch.setattr(devcost, "_warned_bad_env", [False])
        with pytest.warns(UserWarning, match="PHOTON_DEVCOST"):
            assert devcost.capture_enabled() is False
        X, y, off, w, u = _k1_inputs()
        fused.fused_value_grad(X, y, off, w, u, 0.1, loss=LOGISTIC)  # the launch path stays silent

    def test_a_failing_cost_is_counted_never_raised(self, telemetry):
        def broken():
            raise ZeroDivisionError

        before = REGISTRY.snapshot("devcost.capture_errors")["counters"].get(
            "devcost.capture_errors", {"value": 0})["value"]
        assert devcost.capture("t.broken", (torch.zeros(3),), broken) is None
        assert devcost.capture("t.broken", (torch.zeros(3),), broken) is None  # not retried
        after = REGISTRY.snapshot("devcost.capture_errors")["counters"]["devcost.capture_errors"]["value"]
        assert after == before + 1

    def test_streamed_objective_captures_once_per_chunk_shape(self, telemetry):
        """K1's record of the streamed objective's chunks: one per chunk
        shape, however many passes (the chunks are uniform)."""
        from photon_ml_tpu_torch.ops.streaming import StreamingGLMObjective, dense_chunks

        rng = np.random.default_rng(0)
        X = rng.normal(size=(64, 6)).astype(np.float32)
        y = (rng.uniform(size=64) < 0.5).astype(np.float32)
        sobj = StreamingGLMObjective(dense_chunks(X, y, chunk_rows=16), LOGISTIC, num_features=6, device="cpu")
        w = np.zeros(6, np.float32)
        sobj.value_and_grad(w)
        sobj.value_and_grad(w)
        obs.shutdown()
        (rec,) = _costs(telemetry, "fused.value_grad")
        assert rec["bytes_accessed"] == 16 * 6 * 4 + 4 * 16 * 3 + 4 * 6 + 4 * 8


class TestHbmAxes:
    def test_budget_event_records_fallback_source(self, telemetry):
        from photon_ml_tpu_torch.ops.streaming import device_hbm_budget_bytes

        assert device_hbm_budget_bytes(default=123.0, device="cpu") == 123.0
        device_hbm_budget_bytes(default=123.0, device="cpu")  # one record a run
        obs.shutdown()
        evs = [r for r in load_run(telemetry) if r["event"] == "hbm_budget"]
        assert len(evs) == 1 and evs[0]["source"] == "fallback_default" and evs[0]["budget_bytes"] == 123.0
        assert REGISTRY.snapshot(prefix="hbm")["gauges"]["hbm.budget_queried"] == 0.0

    def test_watermark_sampled_at_root_span_exit(self, telemetry):
        with obs.span("fit/root"):
            with obs.span("fit/inner"):
                pass
        obs.shutdown()
        wm = [r for r in load_run(telemetry) if r["event"] == "hbm_watermark"]
        assert len(wm) == 1 and wm[0]["available"] is False and wm[0]["root_span"] == "fit/root"

    def test_watermark_reads_the_cards_allocator(self, telemetry, monkeypatch):
        """On CUDA the record carries each card's allocator counters
        (``allocated_bytes.all.current`` / ``.peak``) and free memory; the
        reading is faked here."""
        stats = {"allocated_bytes.all.current": 1000, "allocated_bytes.all.peak": 5000}
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {k: v * (i + 1) for k, v in stats.items()})
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (70, 80))
        with obs.span("fit/root"):
            pass
        obs.shutdown()
        (wm,) = [r for r in load_run(telemetry) if r["event"] == "hbm_watermark"]
        assert wm["available"] is True and wm["peak_bytes_in_use"] == 10000 and wm["bytes_in_use"] == 2000
        assert [d["bytes_limit"] for d in wm["devices"]] == [80, 80]
        assert REGISTRY.snapshot("hbm.")["gauges"]["hbm.peak_bytes_in_use"] == 10000.0

    def test_layout_pack_recorded_once_per_new_layout(self, telemetry):
        from photon_ml_tpu_torch.convert import sparse_batch_from_numpy
        from photon_ml_tpu_torch.ops import tile_cache

        tile_cache.clear()
        rng = np.random.default_rng(2)
        idx = rng.integers(0, 30, size=(40, 3)).astype(np.int32)
        val = rng.normal(size=(40, 3)).astype(np.float32)
        batch = sparse_batch_from_numpy(idx, val, np.zeros(40, np.float32), num_features=30, device="cpu")
        tile_cache.tiled_layout_for(batch)
        tile_cache.tiled_layout_for(batch)  # a hit: no second pack
        obs.shutdown()
        packs = [r for r in load_run(telemetry) if r["event"] == "tile_layout_pack"]
        assert len(packs) == 1 and packs[0]["nbytes"] > 0 and packs[0]["knobs"]["kernel_dtype"] == "f32"
        tile_cache.clear()
