"""The out-of-core GAME trainer (``photon_ml_tpu_torch/game/streaming.py``)
against the JAX package's ``StreamedGameTrainer`` on the same host arrays
(the fixtures of ``test_game_streaming.py``: n = 440 in chunks of 128, a
ragged last chunk, d = 6, 8 entities), and against the port's in-memory
estimator: every option, checkpoints and their resume across packages,
warm starts, sparse shards, the chunk cache across visits, the eager
bucket solve and the host bucket gather.

Parity runs at optimizer tolerance 1e-4 (above the float32 floor of the
stopping rules, ROADMAP queue 3): fixed coefficients at rtol 1e-3 / atol
2e-4, random-effect coefficients at the lane tolerance atol 2e-3 / rtol
1e-2, validation metrics within 1e-3. Streamed against in-memory uses the
reference's own tolerances (rtol 0.1 / atol 5e-2 fixed, 0.2 / 0.1 random
effects)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from test_game_streaming import _config as _ref_config
from test_game_streaming import _data

from photon_ml_tpu.checkpoint import load_checkpoint as ref_load_checkpoint
from photon_ml_tpu.game import data as jdata
from photon_ml_tpu.game import random_effect as jre
from photon_ml_tpu.game.data import SparseFeatures as JSparse
from photon_ml_tpu.game.streaming import StreamedGameData as JData
from photon_ml_tpu.game.streaming import StreamedGameTrainer as JTrainer
from photon_ml_tpu.ops.losses import loss_for_task as jloss_for_task
from photon_ml_tpu.optim.common import select_minimize_fn as jselect
from photon_ml_tpu.types import NormalizationType as JNorm
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch.checkpoint import load_checkpoint
from photon_ml_tpu_torch.config import parse_config
from photon_ml_tpu_torch.convert import game_model_from_numpy, streamed_game_data_from_numpy
from photon_ml_tpu_torch.estimators import GameEstimator
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.game import make_game_batch
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer, _ChunkedShard
from photon_ml_tpu_torch.ops import prefetch
from photon_ml_tpu_torch.ops.batch import DenseBatch
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.streaming import StreamingGLMObjective, dense_chunks
from photon_ml_tpu_torch.optim.common import select_minimize_fn
from photon_ml_tpu_torch.types import TaskType

FIXED_TOL = dict(rtol=1e-3, atol=2e-4)
LANE_TOL = dict(rtol=1e-2, atol=2e-3)
EVALUATORS = ("AUC", "MULTI_AUC(uid)")


def _jconfig(iters=2, tol=1e-4, **kw):
    """The reference fixture's configuration at optimizer tolerance ``tol``."""
    cfg = _ref_config(iters)

    def at(c):
        opt = c.optimization
        return dataclasses.replace(c, optimization=dataclasses.replace(
            opt, optimizer=dataclasses.replace(opt.optimizer, tolerance=tol)))

    return dataclasses.replace(
        cfg,
        fixed_effect_coordinates={k: at(c) for k, c in cfg.fixed_effect_coordinates.items()},
        random_effect_coordinates={k: at(c) for k, c in cfg.random_effect_coordinates.items()},
        **kw,
    )


def _with_re(cfg, **fields):
    return dataclasses.replace(cfg, random_effect_coordinates={
        "user": dataclasses.replace(cfg.random_effect_coordinates["user"], **fields)})


def _with_fixed_opt(cfg, **fields):
    c = cfg.fixed_effect_coordinates["fixed"]
    return dataclasses.replace(cfg, fixed_effect_coordinates={
        "fixed": dataclasses.replace(c, optimization=dataclasses.replace(c.optimization, **fields))})


def _port(cfg):
    return parse_config(cfg.to_dict())


def _fixed(m):
    return m.models["fixed"].model.coefficients


def _arr(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _to_port_model(jmodel):
    """A JAX ``GameModel`` carried across as numpy."""
    out = {}
    for cid, sub in jmodel.models.items():
        if hasattr(sub, "random_effect_type"):
            out[cid] = dict(coefficients=np.asarray(sub.coefficients), random_effect_type=sub.random_effect_type,
                            feature_shard_id=sub.feature_shard_id,
                            variances=None if sub.variances is None else np.asarray(sub.variances))
        else:
            co = sub.model.coefficients
            out[cid] = dict(means=np.asarray(co.means), feature_shard_id=sub.feature_shard_id,
                            variances=None if co.variances is None else np.asarray(co.variances))
    return game_model_from_numpy(out, jmodel.task_type.value, device="cpu")


def _assert_models_close(got, want, var=False, var_tol=None):
    np.testing.assert_allclose(_arr(_fixed(got).means), _arr(_fixed(want).means), **FIXED_TOL)
    np.testing.assert_allclose(_arr(got.models["user"].coefficients), _arr(want.models["user"].coefficients),
                               **LANE_TOL)
    if var:
        np.testing.assert_allclose(_arr(_fixed(got).variances), _arr(_fixed(want).variances), **var_tol)
        np.testing.assert_allclose(_arr(got.models["user"].variances), _arr(want.models["user"].variances),
                                   **var_tol)


def _both(jdata_, cfg, chunk_rows=128, validation=None, initial_model=None, **kw):
    """The reference's and the port's streamed fits of one configuration on
    the same arrays: ((model, info, trainer), (model, info, trainer))."""
    jt = JTrainer(cfg, chunk_rows=chunk_rows, **kw)
    jm, ji = jt.fit(jdata_, validation=validation, initial_model=initial_model)
    pt = StreamedGameTrainer(_port(cfg), chunk_rows=chunk_rows, device="cpu", **kw)
    pm, pi = pt.fit(
        streamed_game_data_from_numpy(jdata_),
        validation=None if validation is None else streamed_game_data_from_numpy(validation),
        initial_model=None if initial_model is None else _to_port_model(initial_model),
    )
    return (jm, ji, jt), (pm, pi, pt)


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    X, Xr, ids, y, _ = _data(rng)
    Xv, Xrv, idsv, yv, _ = _data(rng, n=300)
    idsv = idsv.astype(np.int64)
    idsv[:20] = -1  # validation rows of entities unseen in training score 0 there
    train = JData(labels=y, features={"g": X, "r": Xr}, id_tags={"uid": ids})
    val = JData(labels=yv, features={"g": Xv, "r": Xrv}, id_tags={"uid": idsv})
    return train, val


@pytest.fixture(scope="module")
def parity(arrays):
    train, val = arrays
    return _both(train, _jconfig(2), validation=val, evaluators=EVALUATORS)


def test_streamed_trainer_matches_reference(parity):
    (jm, ji, jt), (pm, pi, pt) = parity
    _assert_models_close(pm, jm)
    assert list(pi) == list(ji)
    for cid in ji:
        assert pi[cid].final_loss == pytest.approx(ji[cid].final_loss, rel=1e-4)
    flat = lambda hist: [(cid, name, v) for e in hist for cid, r in e.items()  # noqa: E731
                         for name, v in r.metrics.items()]
    got, want = flat(pt.validation_history), flat(jt.validation_history)
    assert [g[:2] for g in got] == [w[:2] for w in want] and len(got) == 2 * 2 * len(EVALUATORS)
    for (_, _, a), (_, _, b) in zip(got, want):
        assert abs(a - b) <= 1e-3


def test_streamed_trainer_matches_in_memory(arrays):
    train, _ = arrays
    cfg = _port(_ref_config(2))
    data = streamed_game_data_from_numpy(train)
    batch = make_game_batch(train.labels, {"g": train.features["g"], "r": train.features["r"]},
                            id_tags={"uid": train.id_tags["uid"]}, device="cpu")
    mem = GameEstimator(cfg, device="cpu").fit(batch)[0].model
    st, info = StreamedGameTrainer(cfg, chunk_rows=128, device="cpu").fit(data)
    assert info["fixed"].iterations > 0
    np.testing.assert_allclose(_arr(_fixed(st).means), _arr(_fixed(mem).means), rtol=0.1, atol=5e-2)
    np.testing.assert_allclose(_arr(st.models["user"].coefficients), _arr(mem.models["user"].coefficients),
                               rtol=0.2, atol=0.1)


def test_chunking_invariance(arrays):
    data = streamed_game_data_from_numpy(arrays[0])
    cfg = _port(_ref_config(1))
    m1, _ = StreamedGameTrainer(cfg, chunk_rows=64, device="cpu").fit(data)
    m2, _ = StreamedGameTrainer(cfg, chunk_rows=440, device="cpu").fit(data)
    np.testing.assert_allclose(_arr(_fixed(m1).means), _arr(_fixed(m2).means), rtol=1e-2, atol=2e-3)
    np.testing.assert_allclose(_arr(m1.models["user"].coefficients), _arr(m2.models["user"].coefficients),
                               rtol=1e-2, atol=2e-3)


def _bitwise(a, b):
    np.testing.assert_array_equal(_arr(_fixed(a).means), _arr(_fixed(b).means))
    np.testing.assert_array_equal(_arr(a.models["user"].coefficients), _arr(b.models["user"].coefficients))


def test_checkpoint_resume_is_bitwise(arrays, tmp_path):
    data = streamed_game_data_from_numpy(arrays[0])
    ref, _ = StreamedGameTrainer(_port(_ref_config(3)), chunk_rows=128, device="cpu").fit(data)
    ck = str(tmp_path / "ck")
    StreamedGameTrainer(_port(_ref_config(1)), chunk_rows=128, checkpoint_dir=ck, device="cpu").fit(data)
    t = StreamedGameTrainer(_port(_ref_config(3)), chunk_rows=128, checkpoint_dir=ck, device="cpu")
    resumed, _ = t.fit(data)
    assert t.resumed_from == (1, 0)
    _bitwise(resumed, ref)


def test_checkpoint_cadence_resume(arrays, tmp_path):
    data = streamed_game_data_from_numpy(arrays[0])
    ref, _ = StreamedGameTrainer(_port(_ref_config(3)), chunk_rows=128, device="cpu").fit(data)
    ck = str(tmp_path / "ck")
    StreamedGameTrainer(_port(_ref_config(2)), chunk_rows=128, checkpoint_dir=ck, checkpoint_every_n_visits=3,
                        device="cpu").fit(data)
    saved = load_checkpoint(ck, device="cpu")  # 4 visits at cadence 3: only visit 3 saved
    assert (saved.next_iteration, saved.next_coordinate) == (1, 1)
    t = StreamedGameTrainer(_port(_ref_config(3)), chunk_rows=128, checkpoint_dir=ck, checkpoint_every_n_visits=3,
                            device="cpu")
    resumed, _ = t.fit(data)
    assert t.resumed_from == (1, 1)
    _bitwise(resumed, ref)


def test_fingerprint_guard(arrays, tmp_path):
    data = streamed_game_data_from_numpy(arrays[0])
    ck = str(tmp_path / "ck")
    StreamedGameTrainer(_port(_ref_config(1)), chunk_rows=128, checkpoint_dir=ck, device="cpu").fit(data)
    other = _port(_with_fixed_opt(_ref_config(1), regularization_weight=7.5))
    t = StreamedGameTrainer(other, chunk_rows=128, checkpoint_dir=ck, device="cpu")
    got, _ = t.fit(data)
    assert t.resumed_from is None
    fresh, _ = StreamedGameTrainer(other, chunk_rows=128, device="cpu").fit(data)
    _bitwise(got, fresh)


def test_fingerprint_is_the_reference_string(arrays, parity):
    train, _ = arrays
    (jm, _, _), (pm, _, _) = parity
    cfg = _jconfig(2)
    for warm_j, warm_p in ((None, None), (jm, _to_port_model(jm))):
        jt = JTrainer(cfg, chunk_rows=128, num_entities={"uid": 9})
        pt = StreamedGameTrainer(_port(cfg), chunk_rows=128, num_entities={"uid": 9}, device="cpu")
        want = jt._fingerprint(train, train.num_rows, (train.num_rows,), initial_model=warm_j)
        assert pt._fingerprint(streamed_game_data_from_numpy(train), initial_model=warm_p) == want


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_either_package_resumes_the_others_checkpoint(arrays, parity, tmp_path, writer):
    """One outer iteration written by one package, resumed to two by the
    other: it starts at the stored visit and ends at the two-iteration
    parity fit's model."""
    train, _ = arrays
    (jm, _, _), _ = parity
    ck = str(tmp_path / "ck")
    if writer == "reference":
        JTrainer(_jconfig(1), chunk_rows=128, checkpoint_dir=ck).fit(train)
        t = StreamedGameTrainer(_port(_jconfig(2)), chunk_rows=128, checkpoint_dir=ck, device="cpu")
        got, _ = t.fit(streamed_game_data_from_numpy(train))
    else:
        StreamedGameTrainer(_port(_jconfig(1)), chunk_rows=128, checkpoint_dir=ck,
                            device="cpu").fit(streamed_game_data_from_numpy(train))
        assert ref_load_checkpoint(ck).next_iteration == 1
        t = JTrainer(_jconfig(2), chunk_rows=128, checkpoint_dir=ck)
        got, _ = t.fit(train)
        got = _to_port_model(got)
    assert t.resumed_from == (1, 0)
    _assert_models_close(got, _to_port_model(jm))


def _sparse_arrays(rng, n=400, d=8, E=6, dr=4, k=3):
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    X = np.zeros((n, d), np.float32)
    np.add.at(X, (np.arange(n)[:, None], idx), val)
    Xr = rng.normal(size=(n, dr)).astype(np.float32)
    ids = rng.integers(0, E, size=n).astype(np.int32)
    w = (rng.normal(size=d) * 0.5).astype(np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ w)))).astype(np.float32)
    return idx, val, X, Xr, ids, y


def test_sparse_shards(rng):
    """A sparse fixed shard against the reference's and against the port's
    own dense twin; a sparse random-effect shard scores and solves too."""
    idx, val, X, Xr, ids, y = _sparse_arrays(rng)
    d = X.shape[1]
    sparse = JData(labels=y, features={"g": JSparse(indices=idx, values=val, num_features=d), "r": Xr},
                   id_tags={"uid": ids})
    (jm, _, _), (pm, _, _) = _both(sparse, _jconfig(1))
    _assert_models_close(pm, jm)
    dense, _ = StreamedGameTrainer(_port(_jconfig(1)), chunk_rows=128, device="cpu").fit(
        StreamedGameData(labels=y, features={"g": X, "r": Xr}, id_tags={"uid": ids}))
    np.testing.assert_allclose(_arr(_fixed(pm).means), _arr(_fixed(dense).means), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_arr(pm.models["user"].coefficients), _arr(dense.models["user"].coefficients),
                               rtol=5e-2, atol=5e-3)
    # the per-entity shard as padded sparse rows: the same solve as its dense form
    r_idx = np.tile(np.arange(Xr.shape[1], dtype=np.int32), (len(y), 1))
    both_sparse = StreamedGameData(labels=y, features={
        "g": tdata.SparseFeatures(indices=idx, values=val, num_features=d),
        "r": tdata.SparseFeatures(indices=r_idx, values=Xr, num_features=Xr.shape[1])}, id_tags={"uid": ids})
    sp, _ = StreamedGameTrainer(_port(_jconfig(1)), chunk_rows=128, device="cpu").fit(both_sparse)
    np.testing.assert_allclose(_arr(sp.models["user"].coefficients), _arr(pm.models["user"].coefficients),
                               **LANE_TOL)


def test_honest_random_effect_diagnostics(arrays):
    data = streamed_game_data_from_numpy(arrays[0])
    cfg = _ref_config(1)
    opt = cfg.random_effect_coordinates["user"].optimization
    tight = _with_re(cfg, optimization=dataclasses.replace(
        opt, optimizer=dataclasses.replace(opt.optimizer, max_iterations=1)))
    t = StreamedGameTrainer(_port(tight), chunk_rows=128, device="cpu")
    _, info = t.fit(data)
    assert info["user"].iterations == 1 and info["user"].converged is False
    _, info2 = StreamedGameTrainer(_port(cfg), chunk_rows=128, device="cpu").fit(data)
    assert info2["user"].iterations > 1 and info2["user"].converged is True
    fixed, visit = t.visit_stats
    assert fixed["coordinate"] == "fixed" and fixed["objective_passes"] > 0
    assert visit["coordinate"] == "user" and visit["result_readbacks"] == visit["buckets"] >= 1
    assert visit["bytes_copied"] > 0


def test_warm_start_continues_the_descent(arrays):
    data = streamed_game_data_from_numpy(arrays[0])
    cold, _ = StreamedGameTrainer(_port(_ref_config(1)), chunk_rows=128, device="cpu").fit(data)
    warm, _ = StreamedGameTrainer(_port(_ref_config(1)), chunk_rows=128, device="cpu").fit(data, initial_model=cold)
    straight, _ = StreamedGameTrainer(_port(_ref_config(2)), chunk_rows=128, device="cpu").fit(data)
    np.testing.assert_allclose(_arr(_fixed(warm).means), _arr(_fixed(straight).means), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(_arr(warm.models["user"].coefficients), _arr(straight.models["user"].coefficients),
                               rtol=1e-3, atol=1e-4)


def test_warm_start_keeps_absent_entities(rng):
    X, Xr, ids, y, _ = _data(rng, n=300, E=3)
    data = StreamedGameData(labels=y, features={"g": X, "r": Xr}, id_tags={"uid": ids})
    cfg = _port(_ref_config(1))
    cold, _ = StreamedGameTrainer(cfg, chunk_rows=128, device="cpu").fit(data)
    sub = cold.models["user"]
    pad = torch.as_tensor(rng.normal(size=(2, sub.coefficients.shape[1])).astype(np.float32))
    W5 = torch.cat([sub.coefficients, pad])
    warm = cold.updated("user", dataclasses.replace(sub, coefficients=W5, variances=None))
    out, _ = StreamedGameTrainer(cfg, chunk_rows=128, device="cpu").fit(data, initial_model=warm)
    W_out = _arr(out.models["user"].coefficients)
    assert W_out.shape[0] == 5
    np.testing.assert_allclose(W_out[3:], _arr(W5)[3:], rtol=1e-6, atol=1e-6)
    floor, _ = StreamedGameTrainer(cfg, chunk_rows=128, num_entities={"uid": 5}, device="cpu").fit(data)
    assert floor.models["user"].coefficients.shape[0] == 5


def _normalization_arrays(rng, n=500):
    X, Xr, ids, y, _ = _data(rng, n=n)
    X = X.copy()
    X[:, 0] = X[:, 0] * 7.0 + 2.0  # a badly scaled feature
    X[:, -1] = 1.0  # the fixed shard's intercept column
    return JData(labels=y, features={"g": X, "r": Xr}, id_tags={"uid": ids})


VAR_TOL = dict(rtol=1e-2, atol=1e-6)


@pytest.mark.parametrize("option", [
    "normalization_simple_variances", "full_variances", "down_sampling", "random_projection",
    "subspace_projection",
])
def test_option_matches_reference(rng, option):
    """One case per option, the port against the reference on the same
    arrays (the random-effect shard has no intercept, so STANDARDIZATION
    degrades to scale-only there, in both packages)."""
    kw = {}
    if option == "normalization_simple_variances":
        data = _normalization_arrays(rng)
        cfg = _jconfig(2, normalization=JNorm.STANDARDIZATION, variance_computation=JVar.SIMPLE)
        kw["intercept_indices"] = {"g": 5}
    elif option == "full_variances":
        data = _normalization_arrays(rng)
        cfg = _jconfig(2, variance_computation=JVar.FULL)
    else:
        X, Xr, ids, y, _ = _data(rng, n=500, dr=6)
        if option == "subspace_projection":
            Xr = Xr.copy()
            Xr[rng.uniform(size=Xr.shape) < 0.5] = 0.0
        data = JData(labels=y, features={"g": X, "r": Xr}, id_tags={"uid": ids})
        cfg = {
            "down_sampling": lambda: _with_fixed_opt(_jconfig(1), down_sampling_rate=0.5),
            "random_projection": lambda: _with_re(_jconfig(2), random_projection_dim=3),
            "subspace_projection": lambda: _with_re(_jconfig(1), features_to_samples_ratio_upper_bound=0.05),
        }[option]()
    (jm, _, _), (pm, _, _) = _both(data, cfg, **kw)
    has_var = option.endswith("variances")
    _assert_models_close(pm, jm, var=has_var, var_tol=VAR_TOL)
    if option == "subspace_projection":
        np.testing.assert_array_equal(_arr(pm.models["user"].coefficients) == 0.0,
                                      np.asarray(jm.models["user"].coefficients) == 0.0)
    if option == "random_projection":
        assert pm.models["user"].coefficients.shape == (8, 6) and pm.models["user"].variances is None


def test_incremental_prior_matches_reference(rng):
    X, Xr, ids, y, _ = _data(rng, n=320)
    data = JData(labels=y, features={"g": X, "r": Xr}, id_tags={"uid": ids})
    base = _jconfig(2, variance_computation=JVar.SIMPLE)
    gen0, _ = JTrainer(base, chunk_rows=80).fit(data)
    (jm, _, _), (pm, _, _) = _both(data, dataclasses.replace(base, incremental=True), chunk_rows=80,
                                   initial_model=gen0)
    _assert_models_close(pm, jm, var=True, var_tol=VAR_TOL)
    plain, _ = StreamedGameTrainer(_port(base), chunk_rows=80, device="cpu").fit(
        streamed_game_data_from_numpy(data), initial_model=_to_port_model(gen0))
    assert not np.allclose(_arr(_fixed(pm).means), _arr(_fixed(plain).means), atol=1e-4)  # the prior pulls


def test_construction_time_rejections(monkeypatch, arrays):
    cfg = _ref_config(1)
    projected = _port(_with_re(cfg, random_projection_dim=4))
    StreamedGameTrainer(projected, device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        StreamedGameTrainer(projected, checkpoint_dir="unused", device="cpu")
    with pytest.raises(NotImplementedError, match="random projection"):
        StreamedGameTrainer(_port(dataclasses.replace(_with_re(cfg, random_projection_dim=4),
                                                      normalization=JNorm.STANDARDIZATION)), device="cpu")
    with pytest.raises(NotImplementedError, match="subspace"):
        StreamedGameTrainer(_port(dataclasses.replace(_with_re(cfg, features_to_samples_ratio_upper_bound=1.0),
                                                      normalization=JNorm.SCALE_WITH_STANDARD_DEVIATION)),
                            device="cpu")
    # multihost is ported: outside a process group it raises the initialization error
    with pytest.raises(RuntimeError, match="multihost initialization failed"):
        StreamedGameTrainer(_port(cfg), multihost=True, device="cpu")
    data = streamed_game_data_from_numpy(arrays[0])
    monkeypatch.setenv("PHOTON_RE_SHARD", "1")
    with pytest.raises(NotImplementedError, match="item 12d"):
        StreamedGameTrainer(_port(cfg), device="cpu").fit(data)
    monkeypatch.delenv("PHOTON_RE_SHARD")
    monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "1")
    with pytest.raises(NotImplementedError, match="item 15"):
        StreamedGameTrainer(_port(cfg), device="cpu").fit(data)


def test_grouped_metric_dropped_fraction_is_logged(rng, arrays):
    X, Xr, ids, y, _ = _data(rng, n=200)
    vtag = rng.integers(0, 4, size=200).astype(np.int64)
    vtag[:150] = -1
    vdata = StreamedGameData(labels=y, features={"g": X, "r": Xr},
                             id_tags={"uid": np.minimum(ids, 7).astype(np.int64), "vtag": vtag})
    logs: list[str] = []
    t = StreamedGameTrainer(_port(_ref_config(1)), chunk_rows=128, evaluators=("AUC", "MULTI_AUC(vtag)"),
                            logger=logs.append, device="cpu")
    with pytest.warns(RuntimeWarning, match="vtag.*75.0%"):
        t.fit(streamed_game_data_from_numpy(arrays[0]), validation=vdata)
    assert any("vtag" in m and "150/200" in m for m in logs)
    assert set(t.validation_history[-1]["user"].metrics) == {"AUC", "MULTI_AUC(vtag)"}


def test_fixed_visits_keep_the_feature_chunks_on_the_device(rng, monkeypatch):
    """The cache hazard: two visits with different residual offsets give
    what freshly built objectives give, and the second visit misses the
    chunk cache only for its offsets, the padded last chunk's features
    included. The budget holds the chunks only if the feature chunks,
    views of one host array, pin that array once."""
    monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", "0")
    X, _, _, y, _ = _data(rng)
    monkeypatch.setenv("PHOTON_CHUNK_CACHE_BUDGET", str(4 * X.nbytes))
    w = np.ones(len(y), np.float32)
    shard = _ChunkedShard(tdata.DenseFeatures(X=X), y, w, 128)
    loss = loss_for_task(TaskType.LOGISTIC_REGRESSION)
    v = torch.as_tensor(rng.normal(size=X.shape[1]).astype(np.float32))
    prefetch.clear_cache()
    offs1 = rng.normal(size=len(y)).astype(np.float32)
    obj = StreamingGLMObjective(shard.chunks(offs1), loss, X.shape[1], l2_weight=1.0, device="cpu")
    first = obj.value_and_grad(v)
    misses = prefetch.cache_stats()["misses"]
    offs2 = offs1 + rng.normal(size=len(y)).astype(np.float32)  # a fresh array, never the old one written
    obj.chunks = shard.chunks(offs2)
    second = obj.value_and_grad(v)
    stats = prefetch.cache_stats()
    assert stats["misses"] - misses == len(shard.ranges) and stats["evictions"] == 0  # one offsets array a chunk
    for offs, got in ((offs1, first), (offs2, second)):
        fresh = StreamingGLMObjective(dense_chunks(X, y, 128, offsets=offs, weights=w), loss, X.shape[1],
                                      l2_weight=1.0, device="cpu").value_and_grad(v)
        torch.testing.assert_close(got[0], fresh[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1], fresh[1], rtol=0, atol=0)
    prefetch.clear_cache()


@pytest.mark.parametrize("solver", ["LBFGS", "NEWTON_CHOLESKY"])
def test_solve_bucket_lanes_matches_reference(rng, solver, monkeypatch):
    """The eager bucket solve on one gathered bucket, against the
    reference's ``solve_bucket_lanes`` (lane tolerance). The entity
    iterations are counted with ``PHOTON_RE_ITER_ACCOUNTING=1`` (with no
    telemetry sink the iterations are not read back for them)."""
    monkeypatch.setenv("PHOTON_RE_ITER_ACCOUNTING", "1")
    X, Xr, ids, y, _ = _data(rng, n=200)
    grouping = jdata.group_by_entity(ids.astype(np.int64))
    buckets = jdata.bucket_entities(grouping, target_buckets=1, max_padded_ratio=1e6)
    rows = buckets.row_indices[0]
    offs = rng.normal(size=len(y)).astype(np.float32)
    w0 = rng.normal(size=(rows.shape[0], Xr.shape[1])).astype(np.float32) * 0.1
    jcfg = dataclasses.replace(_ref_config(1).random_effect_coordinates["user"].optimization.optimizer,
                               optimizer_type=JOpt(solver), tolerance=1e-4)
    jb = jdata.gather_bucket(jdata.DenseFeatures(X=Xr), y, offs, np.ones_like(y), rows)
    fn, extra = jselect(jcfg, 0.0)
    want = jre.solve_bucket_lanes(jb, w0, 1.0, None, None, None, minimize_fn=fn,
                                  loss=jloss_for_task(JTask.LOGISTIC_REGRESSION), config=jcfg,
                                  intercept_index=None, variance_computation=JVar.SIMPLE, **extra)
    pcfg = _port(_ref_config(1)).random_effect_coordinates["user"].optimization.optimizer
    pcfg = dataclasses.replace(pcfg, optimizer_type=type(pcfg.optimizer_type)(solver), tolerance=1e-4)
    pb = tdata.gather_bucket(tdata.DenseFeatures(X=Xr), y, offs, np.ones_like(y), rows)
    assert isinstance(pb, DenseBatch) and pb.X.shape == tuple(np.asarray(jb.X).shape)
    fn, extra = select_minimize_fn(pcfg, 0.0)
    tre.reset_launch_counts()
    acct = tre.DeferredLaunchAccounting()
    got = tre.solve_bucket_lanes(pb, torch.as_tensor(w0), torch.tensor(1.0), None, None, None, minimize_fn=fn,
                                 loss=loss_for_task(TaskType.LOGISTIC_REGRESSION), config=pcfg,
                                 intercept_index=None, variance_computation=tre.VarianceComputationType.SIMPLE,
                                 accounting=acct, **extra)
    acct.flush()
    it = got[2].numpy()  # every lane steps until the slowest converges
    assert tre.launch_counts == {"launches": 1, "useful_entity_iterations": int(it.sum()),
                                 "executed_entity_iterations": int(it.max()) * len(it)}
    np.testing.assert_allclose(_arr(got[0]), np.asarray(want[0]), **LANE_TOL)  # coefficients
    np.testing.assert_allclose(_arr(got[4]), np.asarray(want[4]), rtol=1e-2, atol=1e-5)  # variances
    np.testing.assert_allclose(_arr(got[1]), np.asarray(want[1]), rtol=1e-4, atol=1e-5)  # objective


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_host_bucket_gather_matches_reference(rng, sparse):
    n, d = 60, 5
    ids = rng.integers(0, 4, size=n).astype(np.int64)
    rows = jdata.bucket_entities(jdata.group_by_entity(ids), target_buckets=1, max_padded_ratio=1e6).row_indices[0]
    y, off, wt = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    cols = None
    if sparse:
        idx = rng.integers(0, d, size=(n, 3)).astype(np.int32)
        val = rng.normal(size=(n, 3)).astype(np.float32)
        jf, tf = JSparse(indices=idx, values=val, num_features=d), tdata.SparseFeatures(idx, val, d)
    else:
        X = rng.normal(size=(n, d)).astype(np.float32)
        jf, tf = jdata.DenseFeatures(X=X), tdata.DenseFeatures(X=X)
        cols = np.sort(rng.permuted(np.tile(np.arange(d), (rows.shape[0], 1)), axis=1)[:, :3], axis=1)
    want = jdata.gather_bucket(jf, y, off, wt, rows, columns=cols)
    got = tdata.gather_bucket_host(tf, y, off, wt, rows, columns=cols)
    keys = ("indices", "values") if sparse else ("X",)
    for k in (*keys, "labels", "offsets", "weights"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(getattr(want, k)))
