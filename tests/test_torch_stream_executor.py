"""The port's stream executor (``photon_ml_tpu_torch/ops/stream_executor.py``)
against the JAX package's (``photon_ml_tpu/ops/stream_executor.py``) on the
CPU, with numpy-seeded inputs and ``PHOTON_CHUNK_CACHE_BUDGET`` set in
every test.

Held to:

- the arbiter: one sequence of puts (two consumers, content-equal fresh
  copies, a ``PHOTON_STREAM_SHARE`` cap, the device budget overflowing, on
  the f32 and bf16 rungs) replayed through both packages gives equal
  ``cache_stats()`` and equal ``stream.*`` counters;
- the knobs: priority and share specs parse to the reference's values and
  refuse what it refuses, with its messages;
- the schedule: items in order under preemption, ``.yields`` counted
  while a serve window is active, a worker's error raised at its item;
- the seven consumers: each one's output with the knob on is bitwise its
  output with the knob off, and within the reference's tolerances of the
  reference's knob-on output (f32 value rtol 1e-5, gradient rtol = atol
  1e-4, scores 1e-5, GAME at the streamed-trainer tolerances, refresh at
  the lane tolerance);
- a validation stream over fresh copies of the training chunks transfers
  nothing: shared hits only; ``prefetch.quiesce()`` empties the arbiter
  and keeps its registrations.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_game_streaming import FIXED_TOL, _both, _fixed, _jconfig, _port
from test_torch_game_streaming import LANE_TOL as GAME_LANE_TOL
from test_torch_serve import (
    GAME_TOL,
    LANE_TOL,
    _arrays,
    _events,
    _FakeClock,
    _jax_model,
    _port_model,
    _requests,
    _serve,
    _u32,
)

from photon_ml_tpu.obs.metrics import REGISTRY as JREGISTRY
from photon_ml_tpu.ops import prefetch as jprefetch
from photon_ml_tpu.ops import stream_executor as jse
from photon_ml_tpu.ops.losses import loss_for_task as jloss_for_task
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.convert import streamed_game_data_from_numpy
from photon_ml_tpu_torch.game.streaming import StreamedGameTrainer
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.ops import prefetch, tile_cache
from photon_ml_tpu_torch.ops import stream_executor as se
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.streaming import StreamingGLMObjective, dense_chunks, sparse_chunks, stream_scores
from photon_ml_tpu_torch.types import TaskType

LOSS = loss_for_task(TaskType.LOGISTIC_REGRESSION)
JLOSS = jloss_for_task(JTask.LOGISTIC_REGRESSION)
VALUE_RTOL = 1e-5  # tests/test_fused.py: float32 value
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_fused.py: float32 gradient
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_sparse_tiled.py


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("PHOTON_CHUNK_CACHE_BUDGET", str(1 << 30))
    for knob in ("PHOTON_STREAM_EXECUTOR", "PHOTON_STREAM_PRIORITY", "PHOTON_STREAM_SHARE",
                 "PHOTON_KERNEL_DTYPE", "PHOTON_FE_SHARD"):
        monkeypatch.delenv(knob, raising=False)
    for mod in (prefetch, jprefetch):
        mod.clear_cache()
    for mod in (se, jse):
        mod.clear()
    tile_cache.clear()
    REGISTRY.reset(prefix="stream")
    JREGISTRY.reset(prefix="stream")
    yield
    for mod in (prefetch, jprefetch):
        mod.clear_cache()
    for mod in (se, jse):
        mod.clear()
    tile_cache.clear()


def _counters(registry, prefix: str = "stream") -> dict:
    return {k: v["value"] for k, v in registry.snapshot(prefix=prefix)["counters"].items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(_np(x), np.float32), np.asarray(_np(y), np.float32)
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))


def _knob_arms(run, monkeypatch, *, warm: bool = False):
    """``run()`` with the knob off, then on (cold, and warm when asked)."""
    monkeypatch.setenv("PHOTON_STREAM_EXECUTOR", "0")
    off = run()
    monkeypatch.setenv("PHOTON_STREAM_EXECUTOR", "1")
    se.clear()
    on = run()
    _assert_bitwise(on, off)
    if warm:
        _assert_bitwise(run(), off)
    return off, on


# ---------------------------------------------------------------------------
# the arbiter's accounting, against the reference's
# ---------------------------------------------------------------------------
def _put_sequence(rng):
    """(consumer, {name: array}, context) puts: two consumers sharing
    content through fresh copies, over their shares and the budget."""
    X = [rng.normal(size=(8, 8)).astype(np.float32) for _ in range(6)]  # 256 B (128 B packed)
    y = [rng.normal(size=16).astype(np.float32) for _ in range(6)]  # 64 B, never packed
    puts = []
    for i in range(3):
        puts.append(("a", {"X": X[i], "labels": y[i]}, None))
    for i in range(3):
        puts.append(("b", {"X": np.array(X[i]), "labels": np.array(y[i])}, None))  # fresh copies
    puts.append(("b", {"X": np.array(X[0])}, (0, 0, 8, 2)))  # another context: another entry
    for i in range(3, 6):
        puts.append(("a", {"X": X[i], "labels": y[i]}, None))  # a passes its share
    for i in range(3):
        puts.append(("b", {"X": np.array(X[i])}, None))
    for i in range(6):
        puts.append(("c", {"X": X[i], "labels": y[i]}, None))  # the budget overflows
    return puts


@pytest.mark.parametrize("rung", ["f32", "bf16"])
@pytest.mark.parametrize("budget,share", [
    (1 << 20, ""),
    (2048, "a=0.25,b=0.0625"),
    (1024, "c=0.5"),
    (768, ""),
])
def test_arbiter_accounting_equals_the_references(rung, budget, share, monkeypatch):
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", rung)
    monkeypatch.setenv("PHOTON_CHUNK_CACHE_BUDGET", str(budget))
    monkeypatch.setenv("PHOTON_STREAM_SHARE", share)
    seen = []
    for name, tree, ctx in _put_sequence(np.random.default_rng(3)):
        got = se.cached_device_put(name, tree, "cpu", context=ctx)
        want = jse.cached_device_put(name, tree, ctx)
        for k in tree:
            np.testing.assert_array_equal(_np(got[k].float()), np.asarray(want[k], np.float32))
        seen.append(se.cache_stats())
        assert seen[-1] == jse.cache_stats()
    assert _counters(REGISTRY) == _counters(JREGISTRY)
    assert seen[-1]["misses"] > 0 and seen[-1]["shared_hits"] > 0
    if budget < (1 << 20):
        assert seen[-1]["evictions"] > 0 and seen[-1]["bytes"] <= budget


def test_shared_entry_leaves_with_its_last_holder(monkeypatch):
    """One consumer's share pressure drops its hold, not a shared entry:
    the neighbour keeps hitting resident bytes until it releases too."""
    monkeypatch.setenv("PHOTON_CHUNK_CACHE_BUDGET", "4096")
    monkeypatch.setenv("PHOTON_STREAM_SHARE", "a=0.25,b=0.0625")  # a: 1024 B, b: 256 B
    rng = np.random.default_rng(3)
    arrs = [rng.normal(size=64).astype(np.float32) for _ in range(5)]
    first = se.cached_device_put("a", {"x": arrs[0]}, "cpu")["x"]
    assert se.cached_device_put("b", {"x": np.array(arrs[0])}, "cpu")["x"] is first
    for a in arrs[1:]:
        se.cached_device_put("a", {"x": a}, "cpu")
    s = se.cache_stats()
    assert s["evictions"] == 0 and s["charges"]["a"] <= 1024
    assert se.cached_device_put("b", {"x": np.array(arrs[0])}, "cpu")["x"] is first
    assert se.cache_stats()["misses"] == s["misses"]
    se.cached_device_put("b", {"x": rng.normal(size=64).astype(np.float32)}, "cpu")
    assert se.cache_stats()["evictions"] == 1


def test_fresh_copies_of_training_chunks_transfer_nothing(monkeypatch):
    """A validation stream over a loader's own copies of the training
    chunks (fresh host arrays, equal content) hits the resident entries."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(400, 8)).astype(np.float32)
    y = (rng.uniform(size=400) < 0.5).astype(np.float32)
    chunks = dense_chunks(X, y, 128)
    copies = [{k: np.array(v) for k, v in c.items()} for c in chunks]
    w = rng.normal(size=8).astype(np.float32)
    monkeypatch.setenv("PHOTON_STREAM_EXECUTOR", "1")
    StreamingGLMObjective(chunks, LOSS, 8, device="cpu").value(w)
    before = se.cache_stats()
    got = stream_scores(copies, w, 400, device="cpu")
    np.testing.assert_array_equal(_u32(got), _u32(stream_scores(chunks, w, 400, device="cpu")))
    s = se.cache_stats()
    # every array of both scoring passes was a hit; each entry (the training
    # stream's, equal offsets and weights chunks deduplicated) shared once
    assert s["misses"] == before["misses"] and s["hits"] - before["hits"] == 2 * len(chunks) * len(chunks[0])
    assert s["shared_hits"] == s["entries"] == before["entries"]
    assert s["charges"]["scores"] == s["charges"]["objective"] == s["bytes"]
    c = _counters(REGISTRY)
    assert c["stream.objective.items"] == len(chunks) and c["stream.scores.items"] == 2 * len(chunks)
    assert "stream.scores.miss_bytes" not in c


def test_quiesce_empties_the_arbiter_and_keeps_registrations(monkeypatch):
    se.register("mine", priority=77)
    se.cached_device_put("mine", {"x": np.ones(16, np.float32)}, "cpu")
    assert se.cache_stats()["entries"] == 1
    prefetch.quiesce()
    s = se.cache_stats()
    assert s["entries"] == 0 and s["bytes"] == 0 and s["charges"] == {}
    assert se.priority_of("mine") == 77
    se.clear()
    assert se.priority_of("mine") == 77 and not se.traffic_seen()


def test_fingerprint_is_memoized_by_storage():
    a = np.arange(32, dtype=np.float32)
    assert se._content_fingerprint(a) == se._content_fingerprint(a) == se._content_fingerprint(np.array(a))
    assert se._content_fingerprint(a) == jse._content_fingerprint(a)
    assert se._content_fingerprint(a) != se._content_fingerprint(a.astype(np.int32))
    assert se._content_fingerprint(a[:16]) != se._content_fingerprint(a[16:])


# ---------------------------------------------------------------------------
# the knobs, against the reference's parsing
# ---------------------------------------------------------------------------
def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("spec", ["", "refresh=200", " serve = 5 , cv=70,", "garbage", "=3", "cv=x", "cv=1.5"])
def test_priority_spec_equals_the_references(spec, monkeypatch):
    monkeypatch.setenv("PHOTON_STREAM_PRIORITY", spec)
    for name in ("serve", "objective", "scores", "re_gather", "re_scores", "cv", "refresh", "other"):
        assert _outcome(se.priority_of, name) == _outcome(jse.priority_of, name)
    assert se.stream_priority_spec() == spec


@pytest.mark.parametrize("spec", ["", "a=0.5", "a=1", "a=1.5", "a=0", "a=-0.1", "a", "a=half"])
def test_share_spec_equals_the_references(spec, monkeypatch):
    monkeypatch.setenv("PHOTON_STREAM_SHARE", spec)
    for name in ("a", "other"):
        assert _outcome(se.share_fraction, name) == _outcome(jse.share_fraction, name)


def test_module_globals_under_the_environment(monkeypatch):
    monkeypatch.setattr(se, "STREAM_EXECUTOR", 1)
    monkeypatch.setattr(se, "STREAM_PRIORITY", "cv=3")
    monkeypatch.setattr(se, "STREAM_SHARE", "cv=0.5")
    assert se.stream_executor_enabled() and se.priority_of("cv") == 3 and se.share_fraction("cv") == 0.5
    monkeypatch.setenv("PHOTON_STREAM_EXECUTOR", "0")
    monkeypatch.setenv("PHOTON_STREAM_PRIORITY", "")
    assert not se.stream_executor_enabled() and se.priority_of("cv") == 50


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------
def test_preemption_never_reorders_and_counts_yields(monkeypatch):
    monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", "4")
    with se.active_stream("serve"), se.active_stream("serve"):  # re-entrant
        assert list(se.stream("refresh", 12, lambda i: i * i)) == [i * i for i in range(12)]
        yields = _counters(REGISTRY)["stream.refresh.yields"]
    assert yields > 0
    REGISTRY.reset(prefix="stream")
    assert list(se.stream("refresh", 12, lambda i: i * i)) == [i * i for i in range(12)]
    assert "stream.refresh.yields" not in _counters(REGISTRY)
    with se.active_stream("refresh"):  # a lower priority never throttles a higher one
        assert list(se.stream("serve", 6, lambda i: -i)) == [-i for i in range(6)]
    assert "stream.serve.yields" not in _counters(REGISTRY)


@pytest.mark.parametrize("depth", [0, 2])
def test_worker_error_is_raised_at_its_item(depth):
    def prep(i):
        if i == 3:
            raise RuntimeError("prep failed at 3")
        return i

    got = []
    with pytest.raises(RuntimeError, match="prep failed at 3"):
        for v in se.stream("objective", 8, prep, depth=depth):
            got.append(v)
    assert got == [0, 1, 2]
    assert list(se.stream("objective", 3, lambda i: i, depth=depth)) == [0, 1, 2]  # the pool still serves


def test_a_worker_never_nests_a_pipeline():
    import threading

    def prep(i):
        return list(se.stream("scores", 3, lambda j: threading.current_thread().name))

    for names in se.stream("objective", 2, prep, depth=2):
        assert all(n.startswith("photon-prefetch") for n in names)


def test_spans_and_counters_of_a_stream(tmp_path):
    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.obs.report import load_run

    path = obs.configure(str(tmp_path))
    try:
        assert list(se.stream("cv", 3, lambda i: i, depth=1)) == [0, 1, 2]
    finally:
        obs.shutdown()
    records = load_run(path)
    assert [r["name"] for r in records if r["event"] == "span"] == ["stream/cv"]
    c = _counters(REGISTRY)
    assert c["stream.streams"] == 1 and c["stream.cv.items"] == 3
    assert "stream.cv.wait_s" in REGISTRY.snapshot(prefix="stream")["timers"]


# ---------------------------------------------------------------------------
# the consumers: knob on bitwise knob off, and near the reference's knob on
# ---------------------------------------------------------------------------
def _dense(rng, n=400, d=8):
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, d - 1] = 1.0
    w_true = (rng.normal(size=d) * 0.5).astype(np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-X @ w_true))).astype(np.float32)
    return X, y


def _objective_outputs(obj, w, n):
    v, g = obj.value_and_grad(w)
    return (v, g, obj.hvp(w, w + 0.5), obj.hessian_diag(w), obj.value(w), obj.stream_scores(w, n))


def test_objective_and_scorers_dense(monkeypatch):
    from photon_ml_tpu.ops.streaming import StreamingGLMObjective as JObjective
    from photon_ml_tpu.ops.streaming import stream_scores as jstream_scores

    rng = np.random.default_rng(0)
    X, y = _dense(rng)
    chunks = dense_chunks(X, y, 128)
    w = rng.normal(size=8).astype(np.float32)

    def run():
        obj = StreamingGLMObjective(chunks, LOSS, 8, l2_weight=0.7, intercept_index=7, device="cpu")
        return (*_objective_outputs(obj, w, 400), stream_scores(chunks, w, 400, device="cpu"))

    _, on = _knob_arms(run, monkeypatch, warm=True)
    assert se.cache_stats()["hits"] > 0
    jobj = JObjective(chunks, JLOSS, num_features=8, l2_weight=0.7, intercept_index=7)
    jv, jg = jobj.value_and_grad(w)
    np.testing.assert_allclose(float(on[0]), float(jv), rtol=VALUE_RTOL)
    np.testing.assert_allclose(_np(on[1]), np.asarray(jg), **GRAD_TOL)
    np.testing.assert_allclose(_np(on[2]), np.asarray(jobj.hvp(w, w + 0.5)), **GRAD_TOL)
    np.testing.assert_allclose(_np(on[5]), np.asarray(jobj.stream_scores(w, num_rows=400)), **SCORE_TOL)
    np.testing.assert_allclose(_np(on[6]), np.asarray(jstream_scores(chunks, w, num_rows=400)), **SCORE_TOL)


def _sparse(rng, n=300, d=50, k=5):
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return sparse_chunks(idx, val, y, 97), d, n


@pytest.mark.parametrize("tiled", [False, True])
def test_objective_and_scorers_sparse(tiled, monkeypatch):
    from photon_ml_tpu.ops.streaming import stream_scores as jstream_scores

    rng = np.random.default_rng(1)
    chunks, d, n = _sparse(rng)
    w = rng.normal(size=d).astype(np.float32)

    def run():
        obj = StreamingGLMObjective(chunks, LOSS, d, tile_sparse=tiled, device="cpu")
        assert obj.tiled == tiled
        v, g = obj.value_and_grad(w)
        return (v, g, obj.stream_scores(w, n),
                stream_scores(chunks, w, n, num_features=d, tile_sparse=tiled, device="cpu"))

    monkeypatch.setenv("PHOTON_STREAM_EXECUTOR", "1")
    want = jstream_scores(chunks, w, num_rows=n)
    _, on = _knob_arms(run, monkeypatch)
    np.testing.assert_allclose(_np(on[3]), np.asarray(want), **SCORE_TOL)
    # the objective's scorer hits the objective's entries; tiled, the slim keys alone ride the arbiter
    assert se.cache_stats()["hits"] > 0 and _counters(REGISTRY)["stream.scores.items"] == 2 * len(chunks)
    assert tiled == all(k[0] != se._content_fingerprint(chunks[0]["indices"]) for k in se._entries)


def test_feature_range_rides_the_key(monkeypatch):
    """Under ``PHOTON_FE_SHARD`` (one process: one range) the restricted
    chunks ride the arbiter under their range: bitwise knob off."""
    rng = np.random.default_rng(2)
    chunks, d, n = _sparse(rng)
    w = rng.normal(size=d).astype(np.float32)
    monkeypatch.setenv("PHOTON_FE_SHARD", "1")
    ranges = []

    def run():
        obj = StreamingGLMObjective(chunks, LOSS, d, tile_sparse=False, device="cpu")
        ranges.append(obj._fe_range)
        v, g = obj.value_and_grad(w)
        return v, g, stream_scores(chunks, w, n, num_features=d, tile_sparse=False, device="cpu")

    _knob_arms(run, monkeypatch)
    assert ranges[-1] is not None and {k[2] for k in se._entries} == {ranges[-1]}
    assert se.cache_stats()["shared_hits"] > 0  # the scorer's restricted chunks are the objective's content


def test_streamed_game_fit(monkeypatch):
    """The out-of-core GAME fit: the fixed effect's passes ("objective"),
    the bucket gathers ("re_gather") and the per-visit scoring
    ("re_scores")."""
    from test_game_streaming import _data

    from photon_ml_tpu.game.streaming import StreamedGameData as JData

    rng = np.random.default_rng(0)
    X, Xr, ids, y, _ = _data(rng)
    train = JData(labels=y, features={"g": X, "r": Xr}, id_tags={"uid": ids})
    monkeypatch.setenv("PHOTON_STREAM_EXECUTOR", "1")
    (jm, _, _), (pm, _, _) = _both(train, _jconfig(2))
    c = _counters(REGISTRY)
    assert c["stream.re_gather.items"] > 0 and c["stream.re_scores.items"] > 0 and c["stream.objective.items"] > 0
    np.testing.assert_allclose(_np(_fixed(pm).means), np.asarray(_fixed(jm).means), **FIXED_TOL)
    np.testing.assert_allclose(_np(pm.models["user"].coefficients), np.asarray(jm.models["user"].coefficients),
                               **GAME_LANE_TOL)

    def run():
        m, _ = StreamedGameTrainer(_port(_jconfig(2)), chunk_rows=128, device="cpu").fit(
            streamed_game_data_from_numpy(train))
        return _fixed(m).means, m.models["user"].coefficients

    _knob_arms(run, monkeypatch, warm=True)


def test_cross_validation(monkeypatch):
    import jax.numpy as jnp

    from photon_ml_tpu.config import OptimizerConfig as JOptimizerConfig
    from photon_ml_tpu.ops.batch import DenseBatch as JDense
    from photon_ml_tpu.supervised.cross_validation import cross_validate_glm as jcv
    from photon_ml_tpu.types import TaskType as JTask
    from photon_ml_tpu_torch.convert import dense_batch_from_numpy
    from photon_ml_tpu_torch.supervised.cross_validation import cross_validate_glm

    rng = np.random.default_rng(5)
    X, y = _dense(rng, n=240, d=6)
    kw = dict(k=3, regularization_weights=[0.5, 5.0], seed=3)

    def run():
        res = cross_validate_glm(dense_batch_from_numpy(X, y, device="cpu"), TaskType.LOGISTIC_REGRESSION,
                                 optimizer_config=OptimizerConfig(max_iterations=40, tolerance=1e-8), device="cpu",
                                 **kw)
        return (np.asarray(res.metric_values[0.5]), np.asarray(res.metric_values[5.0]),
                res.final.models[res.best_weight].coefficients.means)

    _, on = _knob_arms(run, monkeypatch)
    assert _counters(REGISTRY)["stream.cv.items"] == 3
    jb = JDense(X=jnp.asarray(X), labels=jnp.asarray(y), offsets=jnp.zeros(240, jnp.float32),
                weights=jnp.ones(240, jnp.float32))
    ref = jcv(jb, JTask.LOGISTIC_REGRESSION, optimizer_config=JOptimizerConfig(max_iterations=40, tolerance=1e-8),
              **kw)
    np.testing.assert_allclose(on[0], ref.metric_values[0.5], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(on[1], ref.metric_values[5.0], rtol=1e-4, atol=1e-4)


def test_serve_windows(monkeypatch):
    from photon_ml_tpu.serve.router import MicroWindowServer as JServer
    from photon_ml_tpu.serve.router import ScoreRequest as JRequest
    from photon_ml_tpu.serve.store import HotModelStore as JStore
    from photon_ml_tpu_torch.serve.store import HotModelStore

    arrays = _arrays(E=16, d_fe=6, d_re=4, seed=9)
    ents = np.random.default_rng(5).integers(-2, 18, size=77)
    seen = []

    def run():
        reqs = _requests(_port_model(arrays), 77, seed=6, entities=ents)
        store = HotModelStore(_port_model(arrays), budget_bytes=64, device="cpu")
        real = se.active_stream.__enter__

        def spy(self):
            seen.append(self.name)
            return real(self)

        monkeypatch.setattr(se.active_stream, "__enter__", spy)
        try:
            return (_serve(store, reqs, 8),)
        finally:
            monkeypatch.setattr(se.active_stream, "__enter__", real)

    _, on = _knob_arms(run, monkeypatch)
    assert seen == ["serve"] * 10  # every window of the knob-on arm, none of the off arm's
    out = []
    js = JServer(JStore(_jax_model(arrays), budget_bytes=64), on_scores=lambda w, s: out.append(np.asarray(s)),
                 max_batch=8, max_wait_ms=1000.0, clock=_FakeClock())
    for r in _requests(_port_model(arrays), 77, seed=6, entities=ents, cls=JRequest):
        js.submit(r)
    js.drain()
    np.testing.assert_allclose(on[0], np.concatenate(out), **GAME_TOL)


def test_refresh_stream(monkeypatch):
    from photon_ml_tpu.config import OptimizerConfig as JOptimizerConfig
    from photon_ml_tpu.serve.refresh import refresh_stream as jrefresh_stream
    from photon_ml_tpu_torch.serve.refresh import refresh_stream

    arrays = _arrays(E=16, d_re=3, seed=5)
    rng = np.random.default_rng(11)
    items = []
    for j, ent in enumerate((2, 5, 5, 9)):
        X, y = _events(k=6 + j, seed=20 + j)
        items.append(("per_member", ent, X, y, None if j % 2 else rng.normal(size=6 + j).astype(np.float32), None))
    kw = dict(max_iterations=30, tolerance=1e-7)

    def run():
        model, results = refresh_stream(_port_model(arrays), items, OptimizerConfig(**kw), l2_weight=1.0,
                                        device="cpu")
        return (model["per_member"].coefficients, *[r.w for r in results])

    monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", "2")
    _, on = _knob_arms(run, monkeypatch)
    assert _counters(REGISTRY)["stream.refresh.items"] == 4
    jmodel, _ = jrefresh_stream(_jax_model(arrays), items, JOptimizerConfig(**kw), l2_weight=1.0)
    np.testing.assert_allclose(_np(on[0]), np.asarray(jmodel["per_member"].coefficients), **LANE_TOL)
