"""Random effects: the port's ``train_random_effects`` (device-gathered
buckets, lane-batched damped Newton, scatter into the (E, d) matrix)
against the JAX package's on the same buckets, at atol 1e-4; warm starts
that keep untrained entities, per-entity diagnostics, priors,
normalization, variances, scoring with out-of-range ids; L-BFGS, TRON and
OWL-QN over lanes and sparse shards, and what Newton refuses."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.config import OptimizerConfig as JConfig
from photon_ml_tpu.game import data as jdata
from photon_ml_tpu.game.models import RandomEffectModel as JREModel
from photon_ml_tpu.game.random_effect import train_random_effects as j_train
from photon_ml_tpu.normalization import NormalizationContext as JNorm
from photon_ml_tpu.ops.losses import loss_for_task as j_loss_for_task
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.convert import game_batch_from_numpy
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.game.models import RandomEffectModel
from photon_ml_tpu_torch.game.random_effect import random_effect_scores, train_random_effects
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

# Stopping tolerances above each task's float32 floor on these fixtures
# (as tests/test_torch_optim.py sets them). Below them, lanes flip between
# the gradient test and the reference's Newton-decrement plateau stop, or
# an unregularized intercept's last step turns on float32 rounding, and the
# two packages part by up to 1.6e-4 (ROADMAP queue 3).
TOLERANCE = {
    TaskType.LOGISTIC_REGRESSION: 1e-3,
    TaskType.LINEAR_REGRESSION: 1e-5,
    TaskType.POISSON_REGRESSION: 1e-3,
}
NEWTON = dict(optimizer_type="NEWTON_CHOLESKY", max_iterations=30)
ONE_BUCKET = {"target_buckets": 1, "max_padded_ratio": 100.0}


def _configs(**kw):
    cfg = {**NEWTON, **kw}
    return (JConfig(**{**cfg, "optimizer_type": JOpt(cfg["optimizer_type"])}),
            OptimizerConfig(**{**cfg, "optimizer_type": OptimizerType(cfg["optimizer_type"])}))


def _problem(task: TaskType, seed: int, n=400, d=4, E=20, present=None):
    """Zipf-skewed entity ids (only the first ``present`` entities appear),
    per-entity coefficients, offsets and weights."""
    rng = np.random.default_rng(seed)
    present = present or E
    p = 1.0 / np.arange(1, present + 1) ** 1.2
    ids = rng.choice(present, size=n, p=p / p.sum()).astype(np.int32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, -1] = 1.0
    W = (0.7 * rng.normal(size=(E, d))).astype(np.float32)
    off = (0.2 * rng.normal(size=n)).astype(np.float32)
    m = np.sum(W[ids] * X, axis=1) + off
    if task is TaskType.LOGISTIC_REGRESSION:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    elif task is TaskType.LINEAR_REGRESSION:
        y = (m + 0.1 * rng.normal(size=n)).astype(np.float32)
    else:
        y = rng.poisson(np.exp(np.clip(m, -5, 2))).astype(np.float32)
    wt = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    return ids, X, y, off, wt


def _train_both(task, ids, X, y, off, wt, E, *, bucket_kw=None, **kw):
    jc, tc = _configs(tolerance=TOLERANCE[task], **kw.pop("config", {}))
    bucket_kw = bucket_kw or {}
    jb = jdata.bucket_entities(jdata.group_by_entity(ids, num_entities=E), **bucket_kw)
    tb = tdata.bucket_entities(tdata.group_by_entity(ids, num_entities=E), **bucket_kw)
    jkw, tkw = dict(kw), dict(kw)
    for key in ("initial_coefficients", "prior_coefficients", "prior_variances"):
        if key in kw:
            jkw[key] = jnp.asarray(kw[key])
            tkw[key] = torch.as_tensor(kw[key])
    if "variance_computation" in kw:
        jkw["variance_computation"] = JVar(kw["variance_computation"].value)
    if "norm" in kw:
        f, s, ic = kw["norm"]
        jkw["norm"] = JNorm(jnp.asarray(f), jnp.asarray(s), ic)
        tkw["norm"] = NormalizationContext(torch.as_tensor(f), torch.as_tensor(s), ic)
    jres = j_train(jdata.DenseFeatures(X=jnp.asarray(X)), y, off, wt, jb, E,
                   j_loss_for_task(JTask(task.value)), jc, **jkw)
    tres = train_random_effects(tdata.DenseFeatures(X=torch.as_tensor(X)), y, off, wt, tb, E,
                                loss_for_task(task), tc, device="cpu", **tkw)
    return jres, tres


def _assert_results_agree(jres, tres, atol=1e-4):
    np.testing.assert_allclose(tres.coefficients.numpy(), np.asarray(jres.coefficients), atol=atol)
    trained = ~np.isnan(np.asarray(jres.loss_values))
    np.testing.assert_array_equal(~np.isnan(tres.loss_values), trained)
    np.testing.assert_allclose(tres.loss_values[trained], jres.loss_values[trained], rtol=1e-4, atol=1e-4)
    assert np.all(np.abs(tres.iterations - jres.iterations) <= 1)
    np.testing.assert_array_equal(tres.converged, jres.converged)


@pytest.mark.parametrize("task", [TaskType.LOGISTIC_REGRESSION, TaskType.LINEAR_REGRESSION,
                                  TaskType.POISSON_REGRESSION])
def test_matches_reference(task):
    ids, X, y, off, wt = _problem(task, seed=1)
    jres, tres = _train_both(task, ids, X, y, off, wt, 20, l2_weight=1.0, intercept_index=3,
                             bucket_kw=ONE_BUCKET)
    _assert_results_agree(jres, tres)


@pytest.mark.parametrize("variance", [VarianceComputationType.SIMPLE, VarianceComputationType.FULL])
def test_variances_and_explicit_capacities(variance):
    task = TaskType.LOGISTIC_REGRESSION
    ids, X, y, off, wt = _problem(task, seed=2, n=300)
    jres, tres = _train_both(task, ids, X, y, off, wt, 20, bucket_kw={"capacities": (32, 512)},
                             l2_weight=0.5, variance_computation=variance)
    _assert_results_agree(jres, tres)
    np.testing.assert_allclose(tres.variances.numpy(), np.asarray(jres.variances), rtol=1e-3, atol=1e-5)


def test_warm_start_keeps_untrained_entities():
    """Only entities 0..3 of 8 have rows: the others keep their warm-start
    rows exactly, and their loss values are NaN."""
    task = TaskType.LINEAR_REGRESSION
    ids, X, y, off, wt = _problem(task, seed=3, n=50, d=3, E=8, present=4)
    W0 = np.random.default_rng(4).normal(size=(8, 3)).astype(np.float32)
    jres, tres = _train_both(task, ids, X, y, off, wt, 8, bucket_kw=ONE_BUCKET, l2_weight=1.0,
                             initial_coefficients=W0)
    _assert_results_agree(jres, tres)
    np.testing.assert_array_equal(tres.coefficients[4:].numpy(), W0[4:])
    assert np.isnan(tres.loss_values[4:]).all() and not np.isnan(tres.loss_values[:4]).any()
    assert (tres.iterations[4:] == 0).all()


def test_prior_normalization_and_active_bound():
    task = TaskType.LOGISTIC_REGRESSION
    ids, X, y, off, wt = _problem(task, seed=5, n=500, E=12)
    rng = np.random.default_rng(6)
    mu = (0.3 * rng.normal(size=(12, 4))).astype(np.float32)
    var = rng.uniform(0.2, 2.0, size=(12, 4)).astype(np.float32)
    norm = (np.array([0.5, 2.0, 1.5, 1.0], np.float32), np.array([0.1, 0.0, -0.3, 0.0], np.float32), 3)
    jc, tc = _configs(tolerance=TOLERANCE[task])
    jg = jdata.group_by_entity(ids, num_entities=12, active_upper_bound=30, seed=2)
    tg = tdata.group_by_entity(ids, num_entities=12, active_upper_bound=30, seed=2)
    jres = j_train(
        jdata.DenseFeatures(X=jnp.asarray(X)), y, off, wt, jdata.bucket_entities(jg), 12,
        j_loss_for_task(JTask(task.value)), jc, l2_weight=0.8, intercept_index=3,
        norm=JNorm(jnp.asarray(norm[0]), jnp.asarray(norm[1]), 3), initial_coefficients=jnp.asarray(mu),
        prior_coefficients=jnp.asarray(mu), prior_variances=jnp.asarray(var),
    )
    tres = train_random_effects(
        tdata.DenseFeatures(X=torch.as_tensor(X)), y, off, wt, tdata.bucket_entities(tg), 12,
        loss_for_task(task), tc, l2_weight=0.8, intercept_index=3,
        norm=NormalizationContext(torch.as_tensor(norm[0]), torch.as_tensor(norm[1]), 3),
        initial_coefficients=torch.as_tensor(mu), prior_coefficients=torch.as_tensor(mu),
        prior_variances=torch.as_tensor(var), device="cpu",
    )
    _assert_results_agree(jres, tres)


def test_scores_with_out_of_range_ids(rng):
    n, d, E = 12, 3, 4
    X = rng.normal(size=(n, d)).astype(np.float32)
    W = rng.normal(size=(E, d)).astype(np.float32)
    ids = np.array([0, 1, 2, 3, 3, 2, 4, 9, -1, -5, 0, 1], np.int32)
    jb = jdata.make_game_batch(np.zeros(n, np.float32), {"s": X}, id_tags={"u": ids})
    tb = game_batch_from_numpy(np.zeros(n, np.float32), {"s": X}, id_tags={"u": ids}, device="cpu")
    jm = JREModel(coefficients=jnp.asarray(W), variances=None, random_effect_type="u",
                  feature_shard_id="s", task_type=JTask.LINEAR_REGRESSION)
    tm = RandomEffectModel(coefficients=torch.as_tensor(W), variances=None, random_effect_type="u",
                           feature_shard_id="s", task_type=TaskType.LINEAR_REGRESSION)
    s = tm.score(tb).numpy()
    np.testing.assert_allclose(s, np.asarray(jm.score(jb)), rtol=1e-5, atol=1e-6)
    assert (s[6:10] == 0.0).all()
    valid = ids[:6]
    raw = random_effect_scores(tdata.DenseFeatures(X=torch.as_tensor(X[:6])),
                               torch.as_tensor(valid, dtype=torch.int64), torch.as_tensor(W))
    np.testing.assert_allclose(raw.numpy(), np.sum(W[valid] * X[:6], axis=1), rtol=1e-5)
    assert tm.model_for_entity(2).coefficients.means.tolist() == W[2].tolist()


def test_diagnostics_release():
    task = TaskType.LINEAR_REGRESSION
    ids, X, y, off, wt = _problem(task, seed=7, n=100, d=3, E=6)
    b = tdata.bucket_entities(tdata.group_by_entity(ids))

    def train():
        return train_random_effects(tdata.DenseFeatures(X=torch.as_tensor(X)), y, off, wt, b, 6,
                                    loss_for_task(task), _configs()[1], l2_weight=1.0, device="cpu")

    tres = train()
    loss = tres.loss_values.copy()
    tres.release_device_diagnostics()
    np.testing.assert_array_equal(tres.loss_values, loss)  # read before release: kept
    assert tres.coefficients is None and tres.diag_refs == ()
    other = train()
    other.release_device_diagnostics()
    with pytest.raises(RuntimeError, match="released"):
        other.loss_values


@pytest.mark.parametrize("solver,l1", [("LBFGS", 0.0), ("TRON", 0.0), ("LBFGS", 0.5)])
def test_refuses_other_lane_solvers(solver, l1):
    """L-BFGS, TRON and OWL-QN (LBFGS under an L1 weight) over entity
    lanes train as the reference's do; Newton still refuses L1. Logistic:
    on the linear problem of this seed, entity 3 (3 rows) under OWL-QN
    turns on the sign of an intercept pseudo-gradient of ±5e-8, and TRON's
    stopping tests on float32 rounding (ROADMAP queue 3)."""
    task = TaskType.LOGISTIC_REGRESSION
    ids, X, y, off, wt = _problem(task, seed=8, n=60, d=3, E=5)
    jres, tres = _train_both(task, ids, X, y, off, wt, 5, config=dict(optimizer_type=solver),
                             l2_weight=1.0, l1_weight=l1, intercept_index=2)
    _assert_results_agree(jres, tres)
    b = tdata.bucket_entities(tdata.group_by_entity(ids))
    with pytest.raises(ValueError, match="L1"):
        train_random_effects(
            tdata.DenseFeatures(X=torch.as_tensor(X)), y, off, wt, b, 5,
            loss_for_task(TaskType.LINEAR_REGRESSION),
            OptimizerConfig(optimizer_type=OptimizerType.NEWTON_CHOLESKY), l1_weight=0.5,
            device="cpu",
        )


def test_refuses_sparse_shards_and_a_missing_card():
    """A sparse shard trains under L-BFGS to the dense shard's solution;
    Newton and FULL variances on it raise the reference's message."""
    ids = np.array([0, 0, 0, 1, 1, 1], np.int32)
    b = tdata.bucket_entities(tdata.group_by_entity(ids))
    rng = np.random.default_rng(9)
    X = rng.normal(size=(6, 3)).astype(np.float32)
    sparse = tdata.SparseFeatures(torch.arange(3).repeat(6, 1), torch.as_tensor(X), 3)
    dense = tdata.DenseFeatures(X=torch.as_tensor(X))
    y = rng.normal(size=6).astype(np.float32)
    args = (y, np.zeros(6), np.ones(6), b, 2, loss_for_task(TaskType.LINEAR_REGRESSION))
    lbfgs = OptimizerConfig(tolerance=1e-6)
    got = train_random_effects(sparse, *args, lbfgs, l2_weight=0.5, device="cpu")
    want = train_random_effects(dense, *args, lbfgs, l2_weight=0.5, device="cpu")
    np.testing.assert_allclose(got.coefficients.numpy(), want.coefficients.numpy(), atol=1e-5)
    newton = OptimizerConfig(optimizer_type=OptimizerType.NEWTON_CHOLESKY)
    with pytest.raises(NotImplementedError, match="full Hessian requires a DenseBatch"):
        train_random_effects(sparse, *args, newton, device="cpu")
    with pytest.raises(NotImplementedError, match="full Hessian requires a DenseBatch"):
        train_random_effects(sparse, *args, lbfgs, device="cpu",
                             variance_computation=VarianceComputationType.FULL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_random_effects(dense, *args, newton)
