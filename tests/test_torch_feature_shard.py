"""Feature-range sharding of the streamed fixed effect (``PHOTON_FE_SHARD``)
in the port, against the JAX package on the same numpy inputs.

- the planner (``data/index_map.py``): boundaries and weights equal to the
  reference's on Zipf, width, all-zero and one-column histograms, the
  refusals, and the strict knob parses;
- ``_fe_nnz_histogram`` / ``_fe_restrict_chunks`` equal to the
  reference's, with labels, offsets and weights shared;
- the range in the layout cache's key;
- knob off: unset, ``"0"`` and ``"1"`` on one process bitwise equal over
  every contract, both scorers, host L-BFGS, OWL-QN and TRON, untiled and
  through K3's plain version; padded chunks at rtol 1e-5 / atol 1e-6;
- every refusal (dense, ``cross_process``, ``norm``, FULL, a chunk swap,
  ``checkpoint_dir``);
- K3's plain version on a range-restricted layout (``lo > 0``, a width that
  is no multiple of a tile) in its three directions against the dense
  partial;
- gloo loopback at P = 2 and 4: workers run the port, the parent runs the
  JAX package on one process. Every rank bitwise the others; value rtol
  1e-6, gradient 1e-5 / 1e-6, L-BFGS (4 iterations) 1e-4 / 1e-5, scores
  1e-4 / 1e-5; TRON run to a tolerance where every run stops at the same
  iteration (a float64 witness shows the stop sits far from the float32
  floor), then 2e-3 / 5e-4; ``train_glm_streamed`` at P = 2 against the
  reference's one-process sweep.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.data.index_map as jim
from photon_ml_tpu.config import OptimizerConfig as JConfig
from photon_ml_tpu.config import RegularizationContext as JReg
from photon_ml_tpu.ops import streaming as jstreaming
from photon_ml_tpu.ops.losses import logistic_loss as jlogistic
from photon_ml_tpu.optim.host_lbfgs import host_lbfgs_minimize as jlbfgs
from photon_ml_tpu.optim.host_tron import host_tron_minimize as jtron
from photon_ml_tpu.supervised import training as jtraining
from photon_ml_tpu.types import RegularizationType as JRegType
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
import photon_ml_tpu_torch.data.index_map as im
from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.convert import normalization_from_numpy
from photon_ml_tpu_torch.data import FeatureRangePlan, plan_feature_ranges
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.ops import sparse_tiled as st
from photon_ml_tpu_torch.ops import streaming, tile_cache
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optim.host_lbfgs import host_lbfgs_minimize, host_owlqn_minimize
from photon_ml_tpu_torch.optim.host_tron import host_tron_minimize
from photon_ml_tpu_torch.supervised.training import train_glm_streamed
from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS = loss_for_task(TaskType.LOGISTIC_REGRESSION)
D, N, CHUNKS = 96, 64, 3
N_ROWS = N * CHUNKS
L2 = 0.25
LBFGS = dict(max_iterations=4, tolerance=1e-12)
TRON_TRUNCATED = dict(max_iterations=3, tolerance=1e-12)  # the knob-off bitwise arm only
# TRON held against other runs only to a stop well above the float32 floor
# (the witness below: the stopping test's ratio at each iterate in float64)
TRON_TO_STOP = dict(max_iterations=30, tolerance=1e-4)
WORKER_TIMEOUT_S = 120


def zipf_hist(d: int, draws: int = 200_000, a: float = 1.3) -> np.ndarray:
    rng = np.random.default_rng(7)
    idx = (rng.zipf(a, size=draws).astype(np.int64) - 1) % d
    return np.bincount(idx, minlength=d).astype(np.int64)


def make_chunks(rng, n_chunks=CHUNKS, n=N, d=D, k=5, pad_zeros=False) -> list[dict]:
    """The reference test's sparse chunks: Zipf-skewed columns, all-live
    values unless ``pad_zeros`` zeroes each row's last slot."""
    chunks = []
    for _ in range(n_chunks):
        idx = ((rng.zipf(1.4, size=(n, k)).astype(np.int64) - 1) % d).astype(np.int32)
        val = rng.standard_normal((n, k)).astype(np.float32)
        val = np.where(val == 0.0, np.float32(0.5), val)
        if pad_zeros:
            val[:, -1] = 0.0
        chunks.append({
            "indices": idx, "values": val,
            "labels": (rng.uniform(size=n) < 0.5).astype(np.float32),
            "offsets": rng.standard_normal(n).astype(np.float32) * 0.1,
            "weights": np.ones(n, np.float32),
        })
    return chunks


# ---------------------------------------------------------------------------
# the planner and the knobs
# ---------------------------------------------------------------------------
HISTOGRAMS = {
    "zipf_4096": lambda: zipf_hist(4096),
    "zipf_100k": lambda: zipf_hist(100_000, draws=500_000),
    "zeros": lambda: np.zeros(100),
    "one_column": lambda: np.where(np.arange(64) == 40, 1e6, 0.0),
    "ones": lambda: np.ones(16),
}


@pytest.mark.parametrize("mode", ["nnz", "width"])
@pytest.mark.parametrize("name", list(HISTOGRAMS))
def test_plan_equals_the_references(name, mode):
    hist = HISTOGRAMS[name]()
    for p in (1, 2, 3, 4, 7):
        if p > len(hist):
            continue
        plan = plan_feature_ranges(hist, p, mode=mode)
        ref = jim.plan_feature_ranges(hist, p, mode=mode)
        assert plan.boundaries == ref.boundaries and plan.weights == ref.weights, (name, mode, p)
        assert plan.balance == ref.balance and plan.num_ranges == p and plan.num_features == len(hist)
        b = plan.boundaries
        assert b[0] == 0 and b[-1] == len(hist) and all(hi > lo for lo, hi in zip(b, b[1:]))
        assert [plan.range_of(q) for q in range(p)] == [ref.range_of(q) for q in range(p)]
        assert sum(plan.weights) == float(np.sum(hist))


def test_plan_cases_the_reference_pins():
    """The reference test's fixed cases: Zipf balance within 1.15 at P = 2
    and 4, width quarters, the all-zero fallback, the hot column's balance
    of P, and the refusals."""
    hist = zipf_hist(100_000, draws=500_000)
    assert all(plan_feature_ranges(hist, p).balance <= 1.15 for p in (2, 4))
    assert plan_feature_ranges(zipf_hist(1000), 4, mode="width").boundaries == (0, 250, 500, 750, 1000)
    zero = plan_feature_ranges(np.zeros(100), 4)
    assert zero.boundaries == (0, 25, 50, 75, 100) and zero.balance == 1.0
    assert plan_feature_ranges(HISTOGRAMS["one_column"](), 4).balance == pytest.approx(4.0)
    assert isinstance(zero, FeatureRangePlan)
    with pytest.raises(ValueError, match="positive"):
        plan_feature_ranges(np.ones(8), 0)
    with pytest.raises(ValueError, match="cannot split"):
        plan_feature_ranges(np.ones(3), 4)
    with pytest.raises(ValueError, match="split mode"):
        plan_feature_ranges(np.ones(8), 2, mode="rows")


@pytest.mark.parametrize("value", [None, "", "0", "1", "00", "2", "-1", "yes", " 1"])
def test_fe_shard_knob_parses_as_the_reference(value, monkeypatch):
    """The strict int parse: ``"00"`` is off, a typo raises, in both."""
    for mod in (im, jim):
        monkeypatch.setattr(mod, "FE_SHARD", 0)
    if value is None:
        monkeypatch.delenv("PHOTON_FE_SHARD", raising=False)
    else:
        monkeypatch.setenv("PHOTON_FE_SHARD", value)
    outcomes = []
    for fn in (im.fe_shard_enabled, jim.fe_shard_enabled):
        try:
            outcomes.append(fn())
        except ValueError:
            outcomes.append("raises")
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] == {None: False, "": False, "0": False, "00": False, "yes": "raises"}.get(value, True)


def test_fe_knobs_module_globals_and_split_weight(monkeypatch):
    monkeypatch.delenv("PHOTON_FE_SHARD", raising=False)
    monkeypatch.setattr(im, "FE_SHARD", 1)
    assert im.fe_shard_enabled() is True
    monkeypatch.setenv("PHOTON_FE_SHARD", "0")
    assert im.fe_shard_enabled() is False
    monkeypatch.delenv("PHOTON_FE_SPLIT_WEIGHT", raising=False)
    assert im.fe_split_weight() == "nnz"
    monkeypatch.setenv("PHOTON_FE_SPLIT_WEIGHT", "width")
    assert im.fe_split_weight() == "width"
    assert plan_feature_ranges(zipf_hist(1000), 4).boundaries == (0, 250, 500, 750, 1000)
    monkeypatch.setenv("PHOTON_FE_SPLIT_WEIGHT", "bytes")
    with pytest.raises(ValueError, match="PHOTON_FE_SPLIT_WEIGHT"):
        im.fe_split_weight()


def test_telemetry_knobs_carry_fe_shard(monkeypatch):
    from photon_ml_tpu_torch.obs import devcost, sink

    monkeypatch.setenv("PHOTON_FE_SHARD", "1")
    monkeypatch.setenv("PHOTON_FE_SPLIT_WEIGHT", "width")
    knobs = sink._knob_snapshot()
    assert knobs["fe_shard"] == 1 and knobs["fe_split_weight"] == "width"
    assert devcost.knob_key()["fe_split_weight"] == "width"
    monkeypatch.setenv("PHOTON_FE_SPLIT_WEIGHT", "nnz")
    assert devcost.knob_key()["fe_split_weight"] == "nnz"  # a flip is seen at once


# ---------------------------------------------------------------------------
# the restriction and the cache key
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pad_zeros", [False, True])
def test_restricted_chunks_equal_the_references(pad_zeros):
    chunks = make_chunks(np.random.default_rng(3), pad_zeros=pad_zeros)
    hist = streaming._fe_nnz_histogram(chunks, D)
    np.testing.assert_array_equal(hist, jstreaming._fe_nnz_histogram(chunks, D))
    assert hist.sum() == sum(int((c["values"] != 0).sum()) for c in chunks)
    plan = plan_feature_ranges(hist, 3)
    live = 0
    for pid in range(3):
        lo, hi = plan.range_of(pid)
        got, k = streaming._fe_restrict_chunks(chunks, lo, hi)
        ref, k_ref = jstreaming._fe_restrict_chunks(chunks, lo, hi)
        assert k == k_ref
        for g, r, c in zip(got, ref, chunks):
            np.testing.assert_array_equal(g["indices"], r["indices"])
            np.testing.assert_array_equal(g["values"], r["values"])
            assert g["indices"].dtype == r["indices"].dtype and g["values"].dtype == r["values"].dtype
            for key in ("labels", "offsets", "weights"):
                assert g[key] is c[key]
            live += int((g["values"] != 0).sum())
    assert live == hist.sum()
    ident, k = streaming._fe_restrict_chunks(chunks, 0, D)
    if not pad_zeros:
        assert k == chunks[0]["values"].shape[1]
        for a, c in zip(ident, chunks):
            np.testing.assert_array_equal(a["indices"], c["indices"])
            np.testing.assert_array_equal(a["values"], c["values"])


def test_fe_range_joins_the_layout_cache_key():
    c = make_chunks(np.random.default_rng(4), n_chunks=1)[0]
    b = streaming._host_sparse_batch(c, D)
    tile_cache.clear()
    tb0 = tile_cache.tiled_layout_for(b, device="cpu")
    tb1 = tile_cache.tiled_layout_for(b, device="cpu", fe_range=(0, 0, D, 2))
    tb2 = tile_cache.tiled_layout_for(b, device="cpu", fe_range=(0, 0, D, 4))
    assert tile_cache.stats()["misses"] == 3 and tile_cache.stats()["entries"] == 3
    assert tb0.fe_range is None and tb1.fe_range == (0, 0, D, 2) and tb2.fe_range == (0, 0, D, 4)
    tile_cache.tiled_layout_for(b, device="cpu", fe_range=(0, 0, D, 2))
    assert tile_cache.stats()["hits"] == 1
    tile_cache.clear()


def test_restricted_k3_plain_version_matches_the_dense_partial():
    """K3's plain version on the layouts of a chunk restricted to ranges
    with lo > 0 and widths that are no multiple of a tile (one range with
    no nonzero in some rows), in its three directions, against the dense
    partial X[:, lo:hi] in float64, f32 rtol = atol = 1e-5."""
    rng = np.random.default_rng(5)
    d, n, k = 1000, 700, 4
    chunk = make_chunks(rng, n_chunks=1, n=n, d=d, k=k)[0]
    dense, dense_sq = np.zeros((n, d)), np.zeros((n, d))  # a repeated (row, column) squares per entry
    np.add.at(dense, (np.arange(n)[:, None], chunk["indices"]), chunk["values"].astype(np.float64))
    np.add.at(dense_sq, (np.arange(n)[:, None], chunk["indices"]), chunk["values"].astype(np.float64) ** 2)
    plan = plan_feature_ranges(streaming._fe_nnz_histogram([chunk], d), 4)
    for pid in range(4):
        lo, hi = plan.range_of(pid)
        r = streaming._fe_restrict_chunks([chunk], lo, hi)[0][0]
        tb = st.tile_sparse_batch(streaming._host_sparse_batch(r, hi - lo), fe_range=(pid, lo, hi, 4))
        assert tb.fe_range == (pid, lo, hi, 4) and tb.num_features == hi - lo
        w = rng.standard_normal(hi - lo).astype(np.float32)
        y = rng.standard_normal(n).astype(np.float32)
        part = dense[:, lo:hi]
        for got, want in ((tb.matvec(torch.from_numpy(w)), part @ w),
                          (tb.rmatvec(torch.from_numpy(y)), part.T @ y),
                          (tb.rmatvec_sq(torch.from_numpy(y)), dense_sq[:, lo:hi].T @ y)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert plan.range_of(1)[0] > 0 and any((hi - lo) % st.TILE_NNZ for lo, hi in map(plan.range_of, range(4)))


# ---------------------------------------------------------------------------
# knob off, and one process
# ---------------------------------------------------------------------------
def _objective(chunks, tile_sparse, **kw):
    return streaming.StreamingGLMObjective(chunks, LOSS, D, l2_weight=L2, tile_sparse=tile_sparse,
                                           device="cpu", **kw)


def _consume(obj, w, v, chunks, tile_sparse) -> list[np.ndarray]:
    """Every contract, both scorers and the three host solvers, as host
    arrays of the full width (segments gathered)."""
    sl = obj.fe_slice if obj.fe_active else (lambda x: x)
    full = obj.fe_gather if obj.fe_active else (lambda x: np.asarray(x))
    val, g = obj.value_and_grad(sl(w))
    out = [val.numpy(), full(g), full(obj.hvp(sl(w), sl(v))), full(obj.hessian_diag(sl(w))),
           obj.value(sl(w)).numpy(), obj.stream_scores(sl(w), N_ROWS),
           streaming.stream_scores(chunks, w, N_ROWS, num_features=D, tile_sparse=tile_sparse, device="cpu")]
    w0 = sl(np.zeros(D, np.float32))
    for res in (host_lbfgs_minimize(obj, w0, OptimizerConfig(**LBFGS)),
                host_owlqn_minimize(obj, w0, OptimizerConfig(**LBFGS), 0.05),
                host_tron_minimize(obj, w0, OptimizerConfig(**TRON_TRUNCATED))):
        out += [full(res.w), np.asarray([res.iterations, float(res.value), float(res.grad_norm)])]
    return out


@pytest.mark.parametrize("tile_sparse", [False, True], ids=["untiled", "k3_plain"])
def test_knob_off_unset_and_one_range_are_bitwise(tile_sparse, monkeypatch):
    rng = np.random.default_rng(6)
    chunks = make_chunks(rng)
    w = (rng.standard_normal(D) * 0.1).astype(np.float32)
    v = rng.standard_normal(D).astype(np.float32)
    monkeypatch.delenv("PHOTON_FE_SHARD", raising=False)
    obj = _objective(chunks, tile_sparse)
    assert not obj.fe_active and obj.tiled == tile_sparse
    ref = _consume(obj, w, v, chunks, tile_sparse)
    for knob in ("0", "00", "1"):
        monkeypatch.setenv("PHOTON_FE_SHARD", knob)
        obj = _objective(chunks, tile_sparse)
        assert obj.fe_active is (knob == "1")
        for i, (got, want) in enumerate(zip(_consume(obj, w, v, chunks, tile_sparse), ref)):
            np.testing.assert_array_equal(got, want, err_msg=f"knob {knob}, output {i}")


@pytest.mark.parametrize("tile_sparse", [False, True], ids=["untiled", "k3_plain"])
def test_one_range_on_padded_chunks_is_close(tile_sparse, monkeypatch):
    """Zero slots compact away under the restriction, so the one-range path
    sums the same nonzeros in another row layout: rtol 1e-5 / atol 1e-6
    (the value 1e-6)."""
    rng = np.random.default_rng(8)
    chunks = make_chunks(rng, pad_zeros=True)
    w = (rng.standard_normal(D) * 0.1).astype(np.float32)
    v = rng.standard_normal(D).astype(np.float32)
    monkeypatch.delenv("PHOTON_FE_SHARD", raising=False)
    ref = _consume(_objective(chunks, tile_sparse), w, v, chunks, tile_sparse)[:7]
    monkeypatch.setenv("PHOTON_FE_SHARD", "1")
    got = _consume(_objective(chunks, tile_sparse), w, v, chunks, tile_sparse)[:7]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
    np.testing.assert_allclose(got[4], ref[4], rtol=1e-6)
    for i in (1, 2, 3, 5, 6):
        np.testing.assert_allclose(got[i], ref[i], rtol=1e-5, atol=1e-6, err_msg=str(i))


def test_one_range_against_the_reference_on_one_process(monkeypatch):
    """The port's knob-on objective on one process against the JAX
    package's knob-on objective (both one range) at the streaming tests'
    tolerances, and its gauges."""
    rng = np.random.default_rng(9)
    chunks = make_chunks(rng)
    w = (rng.standard_normal(D) * 0.1).astype(np.float32)
    v = rng.standard_normal(D).astype(np.float32)
    monkeypatch.setenv("PHOTON_FE_SHARD", "1")
    REGISTRY.reset("fe_shard.")
    obj = _objective(chunks, False)
    gauges = REGISTRY.snapshot("fe_shard.")["gauges"]
    assert gauges["fe_shard.ranges"] == 1.0 and gauges["fe_shard.width"] == float(D)
    assert gauges["fe_shard.nnz_local"] == float(sum(int((c["values"] != 0).sum()) for c in chunks))
    assert gauges["fe_shard.nnz_balance"] == 1.0
    jobj = jstreaming.StreamingGLMObjective(chunks=chunks, loss=jlogistic, num_features=D, l2_weight=L2,
                                            tile_sparse=False)
    assert jobj.fe_active
    val, g = obj.value_and_grad(w)
    jval, jg = jobj.value_and_grad(jnp.asarray(w))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(obj.hvp(w, v).numpy(), np.asarray(jobj.hvp(jnp.asarray(w), jnp.asarray(v))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(obj.hessian_diag(w).numpy(), np.asarray(jobj.hessian_diag(jnp.asarray(w))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(obj.stream_scores(w, N_ROWS), np.asarray(jobj.stream_scores(jnp.asarray(w), N_ROWS)),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def test_refusals(monkeypatch, tmp_path):
    rng = np.random.default_rng(10)
    chunks = make_chunks(rng, n_chunks=2)
    monkeypatch.setenv("PHOTON_FE_SHARD", "1")
    dense = [{"X": rng.standard_normal((8, 4)).astype(np.float32), "labels": np.ones(8, np.float32),
              "offsets": np.zeros(8, np.float32), "weights": np.ones(8, np.float32)}]
    # the knob passes dense chunks by (they fit one card); forcing it raises
    assert not streaming.StreamingGLMObjective(dense, LOSS, 4, device="cpu").fe_active
    with pytest.raises(ValueError, match="sparse"):
        streaming.StreamingGLMObjective(dense, LOSS, 4, fe_shard=True, device="cpu")
    with pytest.raises(ValueError, match="cross_process"):
        streaming.StreamingGLMObjective(chunks, LOSS, D, cross_process=True, device="cpu")
    norm = normalization_from_numpy(np.ones(D, np.float32), np.zeros(D, np.float32), None, device="cpu")
    with pytest.raises(NotImplementedError, match="normalization"):
        streaming.StreamingGLMObjective(chunks, LOSS, D, norm=norm, device="cpu")
    obj = streaming.StreamingGLMObjective(chunks, LOSS, D, device="cpu")
    with pytest.raises(NotImplementedError, match="FULL"):
        obj.hessian(np.zeros(D, np.float32))
    with pytest.raises(ValueError, match="chunk swap"):
        obj.chunks = [dict(c) for c in chunks]
    assert not streaming.StreamingGLMObjective(chunks, LOSS, D, fe_shard=False, device="cpu").fe_active
    with pytest.raises(NotImplementedError, match="checkpoint_dir"):
        train_glm_streamed(chunks, TaskType.LOGISTIC_REGRESSION, D, checkpoint_dir=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="FULL"):
        train_glm_streamed(chunks, TaskType.LOGISTIC_REGRESSION, D,
                           variance_computation=VarianceComputationType.FULL, device="cpu")


# ---------------------------------------------------------------------------
# across processes (gloo loopback)
# ---------------------------------------------------------------------------
_WORKER = textwrap.dedent(
    """
    import json, os, sys
    root, port, rank, nproc, work = sys.argv[1:6]
    rank, nproc = int(rank), int(nproc)
    sys.path.insert(0, root)
    os.environ["PHOTON_FE_SHARD"] = "1"
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from photon_ml_tpu_torch.config import OptimizerConfig, RegularizationContext
    from photon_ml_tpu_torch.obs.metrics import REGISTRY
    from photon_ml_tpu_torch.ops.losses import loss_for_task
    from photon_ml_tpu_torch.ops.streaming import StreamingGLMObjective, stream_scores
    from photon_ml_tpu_torch.optim.host_lbfgs import host_lbfgs_minimize
    from photon_ml_tpu_torch.optim.host_tron import host_tron_minimize
    from photon_ml_tpu_torch.parallel import multihost as mh
    from photon_ml_tpu_torch.supervised.training import train_glm_streamed
    from photon_ml_tpu_torch.types import RegularizationType, TaskType, VarianceComputationType

    spec = json.load(open(os.path.join(work, "spec.json")))
    data = np.load(os.path.join(work, "data.npz"))

    def chunks_of(prefix):
        return [{k: data[f"{prefix}{i}_{k}"] for k in ("indices", "values", "labels", "offsets", "weights")}
                for i in range(spec[prefix])]

    chunks, d = chunks_of("train"), spec["d"]
    mh.initialize_multihost(f"127.0.0.1:{port}", nproc, rank, timeout_s=90)
    REGISTRY.reset("fe_shard.")
    obj = StreamingGLMObjective(chunks, loss_for_task(TaskType.LOGISTIC_REGRESSION), d,
                                l2_weight=spec["l2"], tile_sparse=False, device="cpu")
    gauges = REGISTRY.snapshot("fe_shard.")["gauges"]
    wp = obj.fe_slice(data["w_probe"])
    v, g = obj.value_and_grad(wp)
    zero = obj.fe_slice(np.zeros(d, np.float32))
    lb = host_lbfgs_minimize(obj, zero, OptimizerConfig(**spec["lbfgs"]))
    seen = []
    tr = host_tron_minimize(obj, zero, OptimizerConfig(**spec["tron"]),
                            iteration_callback=lambda it, w, f: seen.append(obj.fe_gather(w)))
    out = dict(probe_value=v.numpy(), grad=obj.fe_gather(g), hvp=obj.fe_gather(obj.hvp(wp, obj.fe_slice(data["v_probe"]))),
               hdiag=obj.fe_gather(obj.hessian_diag(wp)), w_lbfgs=obj.fe_gather(lb.w),
               lbfgs=np.asarray([lb.iterations, float(lb.value)]), w_tron=obj.fe_gather(tr.w),
               tron=np.asarray([tr.iterations, tr.reason, float(tr.value)]), tron_iterates=np.stack(seen),
               scores_method=obj.stream_scores(lb.w, spec["rows"]),
               scores_module=stream_scores(chunks, obj.fe_gather(lb.w), spec["rows"], num_features=d,
                                           tile_sparse=False, device="cpu"))
    if spec["train"] and nproc == 2:
        res = train_glm_streamed(
            chunks, TaskType.LOGISTIC_REGRESSION, d, OptimizerConfig(**spec["lbfgs"]),
            RegularizationContext(RegularizationType.L2), regularization_weights=spec["lambdas"],
            validation_chunks=chunks_of("val"), evaluators=["AUC"],
            variance_computation=VarianceComputationType.SIMPLE, device="cpu")
        for lam in spec["lambdas"]:
            m = res.models[lam].coefficients
            out[f"model_{lam}"] = m.means.numpy()
            out[f"var_{lam}"] = m.variances.numpy()
            out[f"auc_{lam}"] = np.asarray(res.validation[lam].primary)
    np.savez(os.path.join(work, f"rank{nproc}-{rank}.npz"), **out)
    json.dump(gauges, open(os.path.join(work, f"rank{nproc}-{rank}.json"), "w"))
    mh.shutdown_multihost()
    print("WORKER DONE", rank)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(nproc: int, work) -> list:
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
           and not k.startswith("PHOTON_")}
    env["OMP_NUM_THREADS"] = "1"
    port = str(_free_port())
    return [subprocess.Popen([sys.executable, "-c", _WORKER, ROOT, port, str(r), str(nproc), str(work)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
            for r in range(nproc)]


def _collect(procs, nproc: int, work) -> list[tuple[dict, dict]]:
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=WORKER_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0 and f"WORKER DONE {r}" in out, f"worker {r} of {nproc} failed:\n{err[-4000:]}"
    return [(dict(np.load(os.path.join(work, f"rank{nproc}-{r}.npz"))),
             json.load(open(os.path.join(work, f"rank{nproc}-{r}.json")))) for r in range(nproc)]


def _logistic64(chunks):
    """A float64 twin of the objective over the same rows (the witness)."""
    X = np.zeros((N_ROWS, D))
    for i, c in enumerate(chunks):
        np.add.at(X[i * N:(i + 1) * N], (np.arange(N)[:, None], c["indices"]), c["values"].astype(np.float64))
    y = np.concatenate([c["labels"] for c in chunks]).astype(np.float64)
    off = np.concatenate([c["offsets"] for c in chunks]).astype(np.float64)

    def grad(w):
        m = X @ np.asarray(w, np.float64) + off
        return X.T @ (1.0 / (1.0 + np.exp(-m)) - y) + L2 * np.asarray(w, np.float64)

    return grad


LAMBDAS = [0.5, 2.0]


def test_loopback_p2_p4_lockstep_and_against_the_reference(tmp_path, monkeypatch):
    """P = 2 and P = 4 gloo groups run together while the parent runs the
    JAX package (and the port) on one process over the same chunks."""
    rng = np.random.default_rng(1218)
    chunks = make_chunks(rng)
    w_probe = (rng.standard_normal(D) * 0.1).astype(np.float32)
    v_probe = rng.standard_normal(D).astype(np.float32)
    val_chunks = make_chunks(rng, n_chunks=2)
    arrays = {"w_probe": w_probe, "v_probe": v_probe}
    for prefix, cs in (("train", chunks), ("val", val_chunks)):
        for i, c in enumerate(cs):
            arrays.update({f"{prefix}{i}_{k}": a for k, a in c.items()})
    np.savez(tmp_path / "data.npz", **arrays)
    spec = dict(train=len(chunks), val=len(val_chunks), d=D, l2=L2, rows=N_ROWS, lbfgs=LBFGS,
                tron=TRON_TO_STOP, lambdas=LAMBDAS)
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    groups = {p: _spawn(p, tmp_path) for p in (2, 4)}

    # the references, on one process, while the workers run
    monkeypatch.delenv("PHOTON_FE_SHARD", raising=False)
    jobj = jstreaming.StreamingGLMObjective(chunks=chunks, loss=jlogistic, num_features=D, l2_weight=L2,
                                            tile_sparse=False)
    jv, jg = jobj.value_and_grad(jnp.asarray(w_probe))
    jhv = jobj.hvp(jnp.asarray(w_probe), jnp.asarray(v_probe))
    jhd = jobj.hessian_diag(jnp.asarray(w_probe))
    j_lb = jlbfgs(jobj, np.zeros(D, np.float32), JConfig(**LBFGS))
    j_tr = jtron(jobj, np.zeros(D, np.float32), JConfig(**TRON_TO_STOP))
    j_scores = np.asarray(jobj.stream_scores(jnp.asarray(j_lb.w), num_rows=N_ROWS))
    j_fit = jtraining.train_glm_streamed(
        chunks, JTask.LOGISTIC_REGRESSION, D, JConfig(**LBFGS), JReg(JRegType.L2), regularization_weights=LAMBDAS,
        validation_chunks=val_chunks, evaluators=["AUC"], variance_computation=JVar.SIMPLE)
    port_tron = host_tron_minimize(_objective(chunks, False), np.zeros(D, np.float32), OptimizerConfig(**TRON_TO_STOP))

    live = float(sum(int((c["values"] != 0).sum()) for c in chunks))
    for nproc, procs in groups.items():
        ranks = _collect(procs, nproc, tmp_path)
        r0, _ = ranks[0]
        tag = f"P={nproc}"
        for r, (arrs, gauges) in enumerate(ranks):
            assert set(arrs) == set(r0)
            for key in r0:  # lock step: every process holds the same bits
                np.testing.assert_array_equal(arrs[key], r0[key], err_msg=f"{tag} rank {r} {key}")
            assert gauges["fe_shard.ranges"] == float(nproc) and gauges["fe_shard.nnz_balance"] >= 1.0
        assert sum(g["fe_shard.width"] for _, g in ranks) == float(D)
        assert sum(g["fe_shard.nnz_local"] for _, g in ranks) == live
        np.testing.assert_allclose(r0["probe_value"], float(jv), rtol=1e-6, err_msg=tag)
        np.testing.assert_allclose(r0["grad"], np.asarray(jg), rtol=1e-5, atol=1e-6, err_msg=tag)
        np.testing.assert_allclose(r0["hvp"], np.asarray(jhv), rtol=1e-5, atol=1e-6, err_msg=tag)
        np.testing.assert_allclose(r0["hdiag"], np.asarray(jhd), rtol=1e-5, atol=1e-6, err_msg=tag)
        np.testing.assert_allclose(r0["w_lbfgs"], np.asarray(j_lb.w), rtol=1e-4, atol=1e-5, err_msg=tag)
        assert int(r0["lbfgs"][0]) == int(j_lb.iterations)
        np.testing.assert_allclose(r0["scores_method"], j_scores, rtol=1e-4, atol=1e-5, err_msg=tag)
        np.testing.assert_allclose(r0["scores_module"], j_scores, rtol=1e-4, atol=1e-5, err_msg=tag)
        # TRON: every run stops at the same iteration, for the same reason
        assert int(r0["tron"][0]) == int(j_tr.iterations) == port_tron.iterations, tag
        assert int(r0["tron"][1]) == int(j_tr.reason) == port_tron.reason, tag
        np.testing.assert_allclose(r0["w_tron"], np.asarray(j_tr.w), rtol=2e-3, atol=5e-4, err_msg=tag)
        # the float64 witness: at the P-process run's iterates the stopping
        # test's ratio ||g|| / (tol · max(1, ||g0||)) is far from 1 on both
        # sides of the stop, so no float32 rounding decides it
        grad64 = _logistic64(chunks)
        g0 = np.linalg.norm(grad64(np.zeros(D)))
        ratios = [np.linalg.norm(grad64(w)) / (TRON_TO_STOP["tolerance"] * max(1.0, g0))
                  for w in r0["tron_iterates"]]
        assert ratios[-1] < 0.9 and all(x > 1.1 for x in ratios[:-1]), (tag, ratios)
        if nproc == 2:
            for lam in LAMBDAS:
                jm = j_fit.models[lam].coefficients
                np.testing.assert_allclose(r0[f"model_{lam}"], np.asarray(jm.means), rtol=1e-4, atol=1e-5)
                np.testing.assert_allclose(r0[f"var_{lam}"], np.asarray(jm.variances), rtol=1e-4, atol=1e-5)
                assert abs(float(r0[f"auc_{lam}"]) - float(j_fit.validation[lam].primary)) <= 1e-4
