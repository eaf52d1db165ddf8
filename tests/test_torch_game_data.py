"""GAME data: the port's synthetic GAME data, entity grouping and
bucketing against the JAX package's, bit for bit (the same seeded host
numpy on both sides), over several seeds and skews; the device gather of
the buckets' static tensors against the reference's host ``gather_bucket``;
the batch builders, data validation and down-sampling."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.synthetic import synthetic_game_data as jax_game_data
from photon_ml_tpu.data.validation import DataValidationError as JValidationError
from photon_ml_tpu.data.validation import validate_game_batch as jax_validate
from photon_ml_tpu.game import data as jdata
from photon_ml_tpu.sampling import down_sample as jax_down_sample
from photon_ml_tpu.types import DataValidationType as JVal
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.convert import game_batch_from_numpy
from photon_ml_tpu_torch.data.synthetic import synthetic_game_data
from photon_ml_tpu_torch.data.validation import DataValidationError, validate_game_batch
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.game.random_effect import prepare_buckets
from photon_ml_tpu_torch.sampling import down_sample
from photon_ml_tpu_torch.types import DataValidationType, TaskType

SEEDS = [0, 1, 7]
SKEWS = [0.0, 1.0, 1.5, 2.5]


def _zipf_ids(seed: int, skew: float, n: int = 600, E: int = 20) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, E + 1) ** skew
    return rng.choice(E, size=n, p=p / p.sum()).astype(np.int32)


def _assert_buckets_equal(tb, jb) -> None:
    assert tb.capacities == jb.capacities
    assert len(tb.entity_ids) == len(jb.entity_ids)
    for te, je, tr, jr in zip(tb.entity_ids, jb.entity_ids, tb.row_indices, jb.row_indices):
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(tr, jr)
        assert te.dtype == je.dtype and tr.dtype == jr.dtype


@pytest.mark.parametrize("task", [TaskType.LOGISTIC_REGRESSION, TaskType.LINEAR_REGRESSION,
                                  TaskType.POISSON_REGRESSION])
def test_synthetic_game_data_bitwise(task):
    effects = {"userId": (20, 3), "itemId": (7, 2)}
    j = jax_game_data(np.random.default_rng(3), 300, 5, effects, task=JTask(task.value))
    t = synthetic_game_data(np.random.default_rng(3), 300, 5, effects, task=task)
    for a, b in [(j.X, t.X), (j.y, t.y), (j.w_fixed, t.w_fixed)]:
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for k in effects:
        for attr in ("entity_ids", "entity_X", "w_entity"):
            np.testing.assert_array_equal(getattr(j, attr)[k], getattr(t, attr)[k])
    assert j.intercept_index == t.intercept_index


def test_synthetic_game_data_on_a_device_from_a_seed():
    effects = {"userId": (50, 4)}
    t = synthetic_game_data(5, 4000, 6, effects, device="cpu")
    assert t.X.shape == (4000, 7) and bool((t.X[:, 6] == 1.0).all())
    ids = t.entity_ids["userId"]
    assert ids.dtype == torch.int64 and int(ids.min()) >= 0 and int(ids.max()) < 50
    # Zipf 1.5: entity 0 draws about 1/zeta-like share, far above uniform
    assert float((ids == 0).double().mean()) > 0.3
    assert set(torch.unique(t.y).tolist()) <= {0.0, 1.0}
    again = synthetic_game_data(5, 4000, 6, effects, device="cpu")
    assert torch.equal(t.X, again.X) and torch.equal(t.y, again.y)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("skew", SKEWS)
@pytest.mark.parametrize("bound", [None, 5, 40])
def test_grouping_and_bucketing_bitwise(seed, skew, bound):
    ids = _zipf_ids(seed, skew)
    jg = jdata.group_by_entity(ids, num_entities=22, active_upper_bound=bound, seed=seed)
    tg = tdata.group_by_entity(ids, num_entities=22, active_upper_bound=bound, seed=seed)
    assert tg.num_entities == jg.num_entities
    np.testing.assert_array_equal(tg.counts, jg.counts)
    np.testing.assert_array_equal(tg.active_counts, jg.active_counts)
    for a, b in zip(tg.active_rows, jg.active_rows):
        np.testing.assert_array_equal(a, b)
    for kw in ({}, {"target_buckets": 4, "max_padded_ratio": 4.0},
               {"target_buckets": 1, "max_padded_ratio": 100.0}, {"target_buckets": 100}):
        _assert_buckets_equal(tdata.bucket_entities(tg, **kw), jdata.bucket_entities(jg, **kw))
        assert tdata.capacity_classes(tg.active_counts, **kw) == jdata.capacity_classes(
            jg.active_counts, **kw
        )


@pytest.mark.parametrize("capacities", [(4, 8), (64,), (2, 16, 128)])
def test_explicit_capacities_never_merge(capacities):
    ids = np.repeat(np.arange(20, dtype=np.int32), 3)
    ids = np.concatenate([ids, np.zeros(9, np.int32)])  # entity 0: 12 rows
    tg, jg = tdata.group_by_entity(ids), jdata.group_by_entity(ids)
    if max(capacities) < 12:
        with pytest.raises(ValueError, match="largest bucket capacity"):
            tdata.bucket_entities(tg, capacities=capacities)
        return
    tb = tdata.bucket_entities(tg, capacities=capacities, target_buckets=1)
    _assert_buckets_equal(tb, jdata.bucket_entities(jg, capacities=capacities, target_buckets=1))
    assert set(tb.capacities) <= set(capacities)


def test_grouping_refuses_bad_ids():
    with pytest.raises(ValueError, match="negative entity ids"):
        tdata.group_by_entity(np.array([0, -1, 2]))
    with pytest.raises(ValueError, match="num_entities"):
        tdata.group_by_entity(np.array([0, 5]), num_entities=3)
    empty = tdata.bucket_entities(tdata.group_by_entity(np.zeros(0, np.int64), num_entities=0))
    assert empty.capacities == () and empty.num_entities == 0


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_gather_bucket_matches_reference(rng, sparse):
    n, d = 40, 3
    ids = rng.integers(0, 6, size=n).astype(np.int32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    off = rng.normal(size=n).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    b = jdata.bucket_entities(jdata.group_by_entity(ids), capacities=(4, 16))
    if sparse:
        idx = rng.integers(0, 9, size=(n, 2))
        jf = jdata.SparseFeatures(jnp.asarray(idx), jnp.asarray(X[:, :2]), 9)
        tf = tdata.SparseFeatures(torch.as_tensor(idx), torch.as_tensor(X[:, :2]), 9)
    else:
        jf, tf = jdata.DenseFeatures(X=jnp.asarray(X)), tdata.DenseFeatures(X=torch.as_tensor(X))
    for rows in b.row_indices:
        jb = jdata.gather_bucket(jf, y, off, wt, rows)
        tb = tdata.gather_bucket(tf, y, off, wt, rows)
        for name in ("labels", "offsets", "weights") + (("indices", "values") if sparse else ("X",)):
            np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))
        # padded slots carry weight 0
        np.testing.assert_array_equal((tb.weights != 0).sum(1).numpy(), (rows >= 0).sum(1))


def test_prepare_buckets_gathers_on_the_device_as_the_host_does(rng):
    n, d = 60, 4
    ids = rng.integers(0, 9, size=n).astype(np.int32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    b = tdata.bucket_entities(tdata.group_by_entity(ids))
    feats = tdata.DenseFeatures(X=torch.as_tensor(X))
    prepared = prepare_buckets(feats, torch.as_tensor(y), torch.as_tensor(wt), b)
    zeros = np.zeros(n, np.float32)
    for pb, rows, ents in zip(prepared, b.row_indices, b.entity_ids):
        host = tdata.gather_bucket(feats, y, zeros, wt, rows)
        for name in ("X", "labels", "weights", "offsets"):
            assert torch.equal(getattr(pb.static, name), getattr(host, name))
        np.testing.assert_array_equal(pb.entity_ids, ents)
        assert pb.capacity == rows.shape[1] and pb.num_real == len(ents)


def test_game_batch_from_numpy_and_device_default(rng):
    n = 8
    X = rng.normal(size=(n, 3)).astype(np.float32)
    idx = rng.integers(0, 5, size=(n, 2))
    val = rng.normal(size=(n, 2)).astype(np.float32)
    b = game_batch_from_numpy(
        np.ones(n), {"d": X, "s": {"indices": idx, "values": val, "num_features": 5}},
        id_tags={"u": np.arange(n, dtype=np.int32)}, device="cpu",
    )
    assert isinstance(b.features["s"], tdata.SparseFeatures) and b.features["s"].num_features == 5
    assert b.id_tags["u"].dtype == torch.int64
    assert torch.equal(b.offsets, torch.zeros(n)) and torch.equal(b.weights, torch.ones(n))
    w = torch.arange(5, dtype=torch.float32)
    np.testing.assert_allclose(b.features["s"].score(w).numpy(), (val * np.arange(5)[idx]).sum(1),
                               rtol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdata.make_game_batch(np.ones(n), {"d": X})
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            game_batch_from_numpy(np.ones(n), {"d": X})


@pytest.mark.parametrize("mode", [DataValidationType.VALIDATE_FULL, DataValidationType.VALIDATE_SAMPLE])
@pytest.mark.parametrize("fault", ["none", "nan_feature", "label", "negative_weight", "inf_offset"])
def test_validation_agrees_with_reference(rng, mode, fault):
    n = 3000
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    off, wt = np.zeros(n, np.float32), np.ones(n, np.float32)
    bad = np.arange(0, n, 2)  # every other row, so a sample finds it too
    if fault == "nan_feature":
        X[bad, 1] = np.nan
    elif fault == "label":
        y[bad] = 2.0
    elif fault == "negative_weight":
        wt[bad] = -1.0
    elif fault == "inf_offset":
        off[bad] = np.inf
    jb = jdata.make_game_batch(y, {"g": X}, offsets=off, weights=wt)
    tb = tdata.make_game_batch(y, {"g": X}, offsets=off, weights=wt, device="cpu")
    task = TaskType.LOGISTIC_REGRESSION
    if fault == "none":
        jax_validate(jb, JTask(task.value), JVal(mode.value), seed=3)
        validate_game_batch(tb, task, mode, seed=3)
        return
    with pytest.raises(JValidationError) as je:
        jax_validate(jb, JTask(task.value), JVal(mode.value), seed=3)
    with pytest.raises(DataValidationError) as te:
        validate_game_batch(tb, task, mode, seed=3)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("task", [TaskType.LOGISTIC_REGRESSION, TaskType.LINEAR_REGRESSION])
def test_down_sample_bitwise(rng, task):
    labels = (rng.uniform(size=500) < 0.3).astype(np.float32)
    rows, scale = down_sample(task, labels, 0.4, seed=5)
    jrows, jscale = jax_down_sample(JTask(task.value), labels, 0.4, seed=5)
    np.testing.assert_array_equal(rows, jrows)
    if jscale is None:
        assert scale is None
    else:
        np.testing.assert_array_equal(scale, jscale)
