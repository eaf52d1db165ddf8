"""The port's out-of-core objective (``ops/streaming.py``) against the JAX
package's on the same numpy chunks: the chunk builders bit for bit; the
value rtol 1e-5 and the vectors rtol = atol 1e-4 for ``value_and_grad``,
``hvp``, ``hessian_diag`` and the FULL ``hessian``, dense and sparse, with
normalization and with a Gaussian prior; ``stream_scores`` at 1e-4;
``fits_in_memory``; the chunk-swap guard; K3's chunk layouts (the plain
version, ``tile_sparse=True``) against the reference's tiled chunks in
interpret mode; the routing: dense chunks reach K1 / K2's plain versions
and tiled ones K3's, on the CPU; and the bf16 rung's transfer of the raw
feature columns."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.normalization import NormalizationContext as JNorm
from photon_ml_tpu.ops import streaming as jstreaming
from photon_ml_tpu.ops.losses import loss_for_task as jloss_for_task
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.convert import normalization_from_numpy
from photon_ml_tpu_torch.ops import glm as tglm
from photon_ml_tpu_torch.ops import sparse_tiled as st
from photon_ml_tpu_torch.ops import streaming, tile_cache
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.types import TaskType

RTOL_V, TOL_VEC = 1e-5, 1e-4
TASKS = [TaskType.LOGISTIC_REGRESSION, TaskType.LINEAR_REGRESSION, TaskType.POISSON_REGRESSION]


def _labels(rng, task, n):
    if task is TaskType.LINEAR_REGRESSION:
        return rng.normal(size=n).astype(np.float32)
    if task is TaskType.POISSON_REGRESSION:
        return rng.poisson(1.0, size=n).astype(np.float32)
    return (rng.uniform(size=n) < 0.5).astype(np.float32)


def _dense(rng, task, n=700, d=9, chunk_rows=256):
    X = rng.normal(size=(n, d)).astype(np.float32) * 0.5
    X[:, 0] = 1.0  # intercept column
    y = _labels(rng, task, n)
    off = (0.1 * rng.normal(size=n)).astype(np.float32)
    wt = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    return (X, y, off, wt), chunk_rows


def _sparse(rng, task, n=600, d=300, k=5, chunk_rows=256):
    idx = rng.integers(1, d, size=(n, k)).astype(np.int32)
    idx[:, -1] = 0  # intercept slot
    val = (0.5 * rng.normal(size=(n, k))).astype(np.float32)
    val[:, -1] = 1.0
    val[::5, 1] = 0.0  # padding-like zero slots
    y = _labels(rng, task, n)
    off = (0.1 * rng.normal(size=n)).astype(np.float32)
    wt = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    return (idx, val, y, off, wt), chunk_rows


def _chunks(kind, rng, task):
    if kind == "dense":
        (X, y, off, wt), rows = _dense(rng, task)
        return (streaming.dense_chunks(X, y, rows, off, wt),
                jstreaming.dense_chunks(X, y, rows, off, wt), X.shape[1])
    (idx, val, y, off, wt), rows = _sparse(rng, task)
    return (streaming.sparse_chunks(idx, val, y, rows, off, wt),
            jstreaming.sparse_chunks(idx, val, y, rows, off, wt), 300)


def _close(got, ref, rtol, atol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("padded", [False, True], ids=["whole", "padded"])
def test_chunk_builders_match_the_reference(kind, padded):
    rng = np.random.default_rng(1)
    n = 512 if not padded else 531
    if kind == "dense":
        X = rng.normal(size=(n, 4)).astype(np.float32)
        y = rng.normal(size=n).astype(np.float32)
        got = streaming.dense_chunks(X, y, 128)
        ref = jstreaming.dense_chunks(X, y, 128)
    else:
        idx = rng.integers(0, 50, size=(n, 3)).astype(np.int32)
        val = rng.normal(size=(n, 3)).astype(np.float32)
        y = rng.normal(size=n).astype(np.float32)
        w = rng.uniform(size=n).astype(np.float32)
        got = streaming.sparse_chunks(idx, val, y, 128, weights=w)
        ref = jstreaming.sparse_chunks(idx, val, y, 128, weights=w)
    assert len(got) == len(ref) == -(-n // 128)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            assert g[k].dtype == r[k].dtype and np.array_equal(g[k], r[k]), k
    assert got[-1]["weights"][n % 128 or 128:].sum() == 0.0


def _objectives(kind, task, rng, variant):
    tch, jch, d = _chunks(kind, rng, task)
    kw, jkw = {}, {}
    if variant == "normalization":
        factors = rng.uniform(0.5, 2.0, size=d).astype(np.float32)
        shifts = (0.1 * rng.normal(size=d)).astype(np.float32)
        factors[0], shifts[0] = 1.0, 0.0
        kw["norm"] = normalization_from_numpy(factors, shifts, 0, device="cpu")
        jkw["norm"] = JNorm(jnp.asarray(factors), jnp.asarray(shifts), 0)
    elif variant == "prior":
        mean = (0.2 * rng.normal(size=d)).astype(np.float32)
        prec = rng.uniform(0.5, 3.0, size=d).astype(np.float32)
        kw.update(prior_mean=torch.from_numpy(mean), prior_precision=torch.from_numpy(prec))
        jkw.update(prior_mean=jnp.asarray(mean), prior_precision=jnp.asarray(prec))
    t = streaming.StreamingGLMObjective(tch, loss_for_task(task), d, l2_weight=0.7, intercept_index=0,
                                        tile_sparse=False, device="cpu", **kw)
    j = jstreaming.StreamingGLMObjective(jch, jloss_for_task(JTask(task.value)), d, l2_weight=0.7,
                                         intercept_index=0, tile_sparse=False, **jkw)
    return t, j, d


@pytest.mark.parametrize("variant", ["plain", "normalization", "prior"])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("task", TASKS, ids=lambda t: t.value)
def test_objective_matches_the_reference(task, kind, variant):
    rng = np.random.default_rng(7)
    t, j, d = _objectives(kind, task, rng, variant)
    w = (0.1 * rng.normal(size=d)).astype(np.float32)
    v = (rng.normal(size=d) / np.sqrt(d)).astype(np.float32)
    jw, jv = jnp.asarray(w), jnp.asarray(v)

    val, g = t.value_and_grad(w)
    jval, jg = j.value_and_grad(jw)
    _close(val, jval, RTOL_V, 0)
    _close(g, jg, TOL_VEC, TOL_VEC)
    _close(t.value(w), j.value(jw), RTOL_V, 0)
    _close(t.hvp(w, v), j.hvp(jw, jv), TOL_VEC, TOL_VEC)
    _close(t.hessian_diag(w), j.hessian_diag(jw), TOL_VEC, TOL_VEC)
    _close(t.hessian(w), j.hessian(jw), TOL_VEC, TOL_VEC)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_stream_scores_match_the_reference(kind):
    rng = np.random.default_rng(3)
    tch, jch, d = _chunks(kind, rng, TaskType.LOGISTIC_REGRESSION)
    w = rng.normal(size=d).astype(np.float32)
    n = 650
    ref = jstreaming.stream_scores(jch, w, n, num_features=d)
    _close(streaming.stream_scores(tch, w, n, num_features=d, device="cpu"), ref, TOL_VEC, TOL_VEC)
    obj = streaming.StreamingGLMObjective(tch, loss_for_task(TaskType.LOGISTIC_REGRESSION), d,
                                          device="cpu")
    got = obj.stream_scores(w, n)
    assert got.shape == (n,)
    _close(got, ref, TOL_VEC, TOL_VEC)


def test_fits_in_memory_and_the_budget():
    assert streaming.fits_in_memory(1000, 1000, hbm_budget_bytes=4e6)
    assert not streaming.fits_in_memory(1001, 1000, hbm_budget_bytes=4e6)
    assert streaming.fits_in_memory(1000, 1000, itemsize=2, hbm_budget_bytes=2e6)
    assert jstreaming.fits_in_memory(1000, 1000, hbm_budget_bytes=4e6)
    # without CUDA the reference's default budget applies
    assert streaming.device_hbm_budget_bytes(device="cpu") == 8e9
    assert streaming.device_hbm_budget_bytes(default=3e9, device="cpu") == 3e9
    assert streaming.fits_in_memory(10**6, 2000, device="cpu")  # 8 GB exactly
    assert not streaming.fits_in_memory(10**6, 2001, device="cpu")


def _tiled_objective(chunks, d):
    return streaming.StreamingGLMObjective(chunks, loss_for_task(TaskType.LOGISTIC_REGRESSION), d,
                                           l2_weight=1.0, tile_sparse=True, device="cpu")


def test_chunk_swap_guard():
    rng = np.random.default_rng(5)
    (idx, val, y, off, wt), rows = _sparse(rng, TaskType.LOGISTIC_REGRESSION)
    chunks = streaming.sparse_chunks(idx, val, y, rows, off, wt)
    obj = _tiled_objective(chunks, 300)
    assert obj.tiled
    w = (0.1 * rng.normal(size=300)).astype(np.float32)
    before = obj.value(w)
    # offsets (and labels / weights) may change: fresh dicts over the same arrays
    obj.chunks = [dict(c, offsets=c["offsets"] + 1.0) for c in chunks]
    assert not torch.equal(obj.value(w), before)
    # equal contents in fresh storage pass the fingerprint check
    obj.chunks = [dict(c, indices=c["indices"].copy()) for c in chunks]
    assert torch.equal(obj.value(w), before)
    bad = [dict(c) for c in chunks]
    bad[1] = dict(bad[1], indices=np.roll(bad[1]["indices"], 1, axis=0))
    with pytest.raises(ValueError, match="changed indices/values"):
        obj.chunks = bad
    with pytest.raises(ValueError, match="chunk count"):
        obj.chunks = chunks[:-1]
    # an untiled objective swaps freely
    plain = streaming.StreamingGLMObjective(chunks, loss_for_task(TaskType.LOGISTIC_REGRESSION), 300,
                                            device="cpu")
    plain.chunks = bad


def test_what_waits_for_multi_gpu_raises(monkeypatch):
    """Feature-range sharding runs (one range on a lone process, the knob
    read strictly); only its combination with ``cross_process`` raises,
    as the reference's does."""
    rng = np.random.default_rng(0)
    tch, _, d = _chunks("sparse", rng, TaskType.LOGISTIC_REGRESSION)
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    with pytest.raises(ValueError, match="cross_process"):
        streaming.StreamingGLMObjective(tch, loss, d, fe_shard=True, cross_process=True, device="cpu")
    assert streaming.StreamingGLMObjective(tch, loss, d, fe_shard=True, device="cpu").fe_active
    w = (0.1 * rng.normal(size=d)).astype(np.float32)
    off = streaming.stream_scores(tch, w, 10, num_features=d, device="cpu")
    monkeypatch.setenv("PHOTON_FE_SHARD", "1")
    assert streaming.StreamingGLMObjective(tch, loss, d, device="cpu").fe_active
    np.testing.assert_allclose(streaming.stream_scores(tch, w, 10, num_features=d, device="cpu"), off,
                               rtol=1e-6, atol=1e-7)
    monkeypatch.setenv("PHOTON_FE_SHARD", "on")
    with pytest.raises(ValueError):
        streaming.StreamingGLMObjective(tch, loss, d, device="cpu")


def test_empty_chunks_and_cuda_default(monkeypatch):
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    with pytest.raises(ValueError, match="at least one chunk"):
        streaming.StreamingGLMObjective([], loss, 3, device="cpu")
    assert streaming.stream_scores([], np.zeros(3), 4, device="cpu").tolist() == [0.0] * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chunks = streaming.dense_chunks(np.ones((4, 3), np.float32), np.ones(4, np.float32), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        streaming.StreamingGLMObjective(chunks, loss, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        streaming.stream_scores(chunks, np.zeros(3), 4)


def test_dense_chunks_reach_k1_k2_and_tiled_chunks_k3(monkeypatch):
    """On the CPU the streamed contracts run the kernels' plain versions:
    value_and_grad through K1's, hvp through K2's, every product of a tiled
    chunk through K3's; value-only passes are a matrix product."""
    calls = {"vg": 0, "hvp": 0, "k3": 0}
    vg, hvp, k3 = tglm.fused_value_grad, tglm.fused_hvp, st.tiled_apply_reference

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tglm, "fused_value_grad", count("vg", vg))
    monkeypatch.setattr(tglm, "fused_hvp", count("hvp", hvp))
    monkeypatch.setattr(st, "tiled_apply_reference", count("k3", k3))
    rng = np.random.default_rng(2)
    tch, _, d = _chunks("dense", rng, TaskType.LOGISTIC_REGRESSION)
    obj = streaming.StreamingGLMObjective(tch, loss_for_task(TaskType.LOGISTIC_REGRESSION), d,
                                          device="cpu")
    w = np.zeros(d, np.float32)
    obj.value_and_grad(w)
    obj.hvp(w, w)
    obj.value(w)
    assert calls == {"vg": len(tch), "hvp": len(tch), "k3": 0}
    (idx, val, y, off, wt), rows = _sparse(rng, TaskType.LOGISTIC_REGRESSION)
    sch = streaming.sparse_chunks(idx, val, y, rows, off, wt)
    tiled = _tiled_objective(sch, 300)
    tiled.value_and_grad(np.zeros(300, np.float32))
    assert calls["k3"] == 2 * len(sch)  # margins and gradient per chunk


@pytest.mark.kernel
def test_tiled_chunks_match_the_reference_interpret_mode():
    """K3's chunk layouts (the plain version) against the reference's
    tile-COO chunks (Pallas in interpret mode), small."""
    rng = np.random.default_rng(11)
    n, d, k, rows = 512, 4096, 3, 256
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    tile_cache.clear()
    t = _tiled_objective(streaming.sparse_chunks(idx, val, y, rows), d)
    j = jstreaming.StreamingGLMObjective(
        jstreaming.sparse_chunks(idx, val, y, rows), jloss_for_task(JTask.LOGISTIC_REGRESSION), d,
        l2_weight=1.0, tile_sparse=True,
    )
    assert t.tiled and j._tile_layouts is not None
    w = (0.1 * rng.normal(size=d)).astype(np.float32)
    val_t, g_t = t.value_and_grad(w)
    val_j, g_j = j.value_and_grad(jnp.asarray(w))
    _close(val_t, val_j, RTOL_V, 0)
    _close(g_t, g_j, TOL_VEC, TOL_VEC)
    _close(t.hessian_diag(w), j.hessian_diag(jnp.asarray(w)), TOL_VEC, TOL_VEC)
    _close(t.stream_scores(w, n), j.stream_scores(jnp.asarray(w), n), TOL_VEC, TOL_VEC)
    with pytest.raises(NotImplementedError, match="K3 streamed chunks"):
        t.hessian(w)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_reduced_rung_transfers_features_in_bf16(monkeypatch, kind):
    """On the bf16 rung of PHOTON_KERNEL_DTYPE the raw feature columns cross
    in bfloat16, at both depths alike, and the objective agrees with the
    reference's on the same rung (bf16 tolerances: value 2e-3, vectors
    2e-2)."""
    from photon_ml_tpu_torch.ops import prefetch

    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", "bf16")
    rng = np.random.default_rng(9)
    tch, jch, d = _chunks(kind, rng, TaskType.LOGISTIC_REGRESSION)
    w = (0.1 * rng.normal(size=d)).astype(np.float32)
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    out = {}
    for depth in ("0", "2"):
        monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", depth)
        prefetch.clear_cache()
        obj = streaming.StreamingGLMObjective(tch, loss, d, l2_weight=0.5, tile_sparse=False, device="cpu")
        out[depth] = obj.value_and_grad(w)
    assert all(torch.equal(a, b) for a, b in zip(out["0"], out["2"]))
    j = jstreaming.StreamingGLMObjective(jch, jloss_for_task(JTask.LOGISTIC_REGRESSION), d, l2_weight=0.5,
                                         tile_sparse=False)
    jv, jg = j.value_and_grad(jnp.asarray(w))
    _close(out["2"][0], jv, 2e-3, 0)
    _close(out["2"][1], jg, 2e-2, 2e-2)
    key = "X" if kind == "dense" else "values"
    packed = prefetch.cached_device_put({key: tch[0][key]}, "cpu")[key]
    assert packed.dtype == torch.bfloat16
    prefetch.clear_cache()
