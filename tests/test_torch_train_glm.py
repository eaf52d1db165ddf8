"""The slice end to end: ``train_glm``'s warm-started λ sweep, the CLI twin
on a LIBSVM file, and models carried across from the JAX package with
``photon_ml_tpu_torch.convert``."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli.train_glm import run as jax_run
from photon_ml_tpu.config import OptimizerConfig as JConfig
from photon_ml_tpu.data.synthetic import synthetic_glm_data as jax_synthetic
from photon_ml_tpu.normalization import build_normalization as jax_build_normalization
from photon_ml_tpu.ops.batch import DenseBatch as JDense
from photon_ml_tpu.supervised.training import train_glm as jax_train_glm
from photon_ml_tpu.types import NormalizationType as JNorm
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch.cli.train_glm import main as cli_main
from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.convert import (
    dense_batch_from_numpy,
    glm_from_numpy,
    normalization_from_numpy,
)
from photon_ml_tpu_torch.data.libsvm import read_libsvm
from photon_ml_tpu_torch.data.synthetic import synthetic_glm_data
from photon_ml_tpu_torch.supervised.training import train_glm
from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

WEIGHTS = [0.1, 1.0, 10.0]
METRIC = {TaskType.LOGISTIC_REGRESSION: "AUC", TaskType.LINEAR_REGRESSION: "RMSE"}
TOLERANCE = {TaskType.LOGISTIC_REGRESSION: 1e-3, TaskType.LINEAR_REGRESSION: 1e-5}


def _split(task: TaskType, seed: int = 5):
    jb, intercept, _ = jax_synthetic(np.random.default_rng(seed), 500, 9, JTask(task.value))
    X, y = np.asarray(jb.X), np.asarray(jb.labels)
    tr, va = slice(0, 350), slice(350, None)

    def both(rows):
        return (
            JDense(X=jnp.asarray(X[rows]), labels=jnp.asarray(y[rows]),
                   offsets=jnp.zeros(len(y[rows]), jnp.float32),
                   weights=jnp.ones(len(y[rows]), jnp.float32)),
            dense_batch_from_numpy(X[rows], y[rows], device="cpu"),
        )

    return both(tr), both(va), intercept, X[tr]


@pytest.mark.parametrize("task", list(METRIC))
def test_sweep_selects_the_same_lambda(task):
    (jtr, ttr), (jva, tva), intercept, Xtr = _split(task)
    d = Xtr.shape[1]
    stats = (Xtr.mean(0), Xtr.var(0), np.abs(Xtr).max(0))
    jnorm = jax_build_normalization(JNorm.STANDARDIZATION, *stats, intercept_index=intercept)
    tnorm = normalization_from_numpy(
        np.asarray(jnorm.factors), np.asarray(jnorm.shifts), intercept, device="cpu"
    )
    kw = dict(max_iterations=60, tolerance=TOLERANCE[task])
    rj = jax_train_glm(
        jtr, JTask(task.value), optimizer_config=JConfig(**kw), regularization_weights=WEIGHTS,
        normalization=jnorm, intercept_index=intercept, validation_batch=jva,
        variance_computation=JVar.SIMPLE,
    )
    rt = train_glm(
        ttr, task, optimizer_config=OptimizerConfig(**kw), regularization_weights=WEIGHTS,
        normalization=tnorm, intercept_index=intercept, validation_batch=tva,
        variance_computation=VarianceComputationType.SIMPLE, device="cpu",
    )
    assert rt.best_weight == rj.best_weight
    assert list(rt.models) == list(rj.models) == sorted(WEIGHTS)
    metric = METRIC[task]
    for lam in WEIGHTS:
        assert abs(rt.validation[lam].metrics[metric] - rj.validation[lam].metrics[metric]) <= 1e-4
        assert rt.trackers[lam].reason == int(rj.trackers[lam].reason)
        assert abs(rt.trackers[lam].iterations - int(rj.trackers[lam].iterations)) <= 1
        coef_t, coef_j = rt.models[lam].coefficients, rj.models[lam].coefficients
        np.testing.assert_allclose(coef_t.means.numpy(), np.asarray(coef_j.means), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(
            coef_t.variances.numpy(), np.asarray(coef_j.variances), rtol=1e-3, atol=1e-6
        )
    assert rt.best_model is rt.models[rt.best_weight]
    assert d == rt.best_model.coefficients.dim


def test_incremental_prior_matches_reference():
    task = TaskType.LOGISTIC_REGRESSION
    (jtr, ttr), _, intercept, _ = _split(task, seed=8)
    d = ttr.num_features
    rng = np.random.default_rng(3)
    means = (0.2 * rng.normal(size=d)).astype(np.float32)
    variances = rng.uniform(0.05, 1.0, size=d).astype(np.float32)
    from photon_ml_tpu.models import Coefficients as JCoef
    from photon_ml_tpu.models import GeneralizedLinearModel as JGLM

    jprior = JGLM(JCoef(jnp.asarray(means), jnp.asarray(variances)), JTask(task.value))
    tprior = glm_from_numpy(means, variances, task, device="cpu")
    kw = dict(max_iterations=60, tolerance=1e-3)
    rj = jax_train_glm(jtr, JTask(task.value), JConfig(**kw), regularization_weights=[2.0],
                       intercept_index=intercept, initial_model=jprior, incremental=True)
    rt = train_glm(ttr, task, OptimizerConfig(**kw), regularization_weights=[2.0],
                   intercept_index=intercept, initial_model=tprior, incremental=True, device="cpu")
    np.testing.assert_allclose(
        rt.models[2.0].coefficients.means.numpy(), np.asarray(rj.models[2.0].coefficients.means),
        rtol=1e-4, atol=1e-4,
    )
    with pytest.raises(ValueError, match="initial_model"):
        train_glm(ttr, task, incremental=True, device="cpu")


def test_weights_without_a_regularization_type_are_refused():
    from photon_ml_tpu_torch.config import RegularizationContext

    (_, ttr), *_ = _split(TaskType.LINEAR_REGRESSION)
    with pytest.raises(ValueError, match="silently ignored"):
        train_glm(ttr, TaskType.LINEAR_REGRESSION, regularization=RegularizationContext(),
                  regularization_weights=[1.0], device="cpu")


def _write_libsvm(path, X, y, rng):
    with open(path, "w") as f:
        for row, label in zip(X, y):
            cols = np.flatnonzero(rng.uniform(size=len(row)) < 0.6)
            feats = " ".join(f"{j + 1}:{row[j]:.5f}" for j in cols)
            f.write(f"{'+1' if label > 0 else '-1'} {feats}\n")


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_cli_twin_writes_the_reference_report(tmp_path, optimizer):
    rng = np.random.default_rng(21)
    X = rng.normal(size=(240, 7)).astype(np.float32)
    y = (rng.uniform(size=240) < 1 / (1 + np.exp(-X @ rng.normal(size=7)))).astype(np.float32)
    train, val = tmp_path / "train.libsvm", tmp_path / "val.libsvm"
    _write_libsvm(train, X[:180], y[:180], rng)
    _write_libsvm(val, X[180:], y[180:], rng)
    from photon_ml_tpu.types import NormalizationType as JN
    from photon_ml_tpu.types import OptimizerType as JO
    from photon_ml_tpu.types import RegularizationType as JR

    jax_run(
        JTask.LOGISTIC_REGRESSION, [str(train)], str(tmp_path / "jax"),
        validation_data=[str(val)], regularization=JR.L2, weights=[0.5, 5.0],
        optimizer=JO(optimizer), max_iterations=50, tolerance=1e-3,
        normalization=JN.SCALE_WITH_STANDARD_DEVIATION,
    )
    cli_main([
        "--task", "LOGISTIC_REGRESSION", "--train-data", str(train),
        "--validation-data", str(val), "--weights", "0.5", "5.0", "--optimizer", optimizer,
        "--max-iterations", "50", "--tolerance", "1e-3",
        "--normalization", "SCALE_WITH_STANDARD_DEVIATION", "--device", "cpu",
        "--output-dir", str(tmp_path / "port"),
    ])
    ref = json.loads((tmp_path / "jax" / "report.json").read_text())
    got = json.loads((tmp_path / "port" / "report.json").read_text())
    assert got.keys() == ref.keys()
    assert (got["task"], got["weights"], got["best_weight"]) == (
        ref["task"], ref["weights"], ref["best_weight"]
    )
    for lam, metrics in ref["validation"].items():
        assert abs(got["validation"][lam]["AUC"] - metrics["AUC"]) <= 1e-4
        assert got["trackers"][lam]["converged"] == ref["trackers"][lam]["converged"]
        assert abs(got["trackers"][lam]["iterations"] - ref["trackers"][lam]["iterations"]) <= 1
    assert (tmp_path / "port" / "_stage").read_text() == "VALIDATED"


def test_cli_rejects_avro(tmp_path):
    with pytest.raises(ValueError, match="Avro"):
        cli_main(["--task", "LOGISTIC_REGRESSION", "--train-data", "x.avro", "--format", "avro",
                  "--device", "cpu", "--output-dir", str(tmp_path)])


def test_read_libsvm_matches_reference(tmp_path):
    from photon_ml_tpu.data.libsvm import read_libsvm as jax_read_libsvm

    path = tmp_path / "d.libsvm"
    path.write_text("+1 1:0.5 3:2.0 3:1.0\n-1 2:-1.5\n# comment\n+1 4:0.25\n")
    for dense in (False, True):
        jb, ji = jax_read_libsvm(str(path), dense=dense)
        tb, ti = read_libsvm(str(path), dense=dense)
        assert ti == ji
        w = np.arange(1, 6, dtype=np.float32)
        np.testing.assert_allclose(tb.matvec(torch.as_tensor(w)).numpy(), np.asarray(jb.matvec(jnp.asarray(w))))
        np.testing.assert_array_equal(tb.labels.numpy(), np.asarray(jb.labels))
    with pytest.raises(ValueError, match="out of range"):
        read_libsvm(str(path), num_features=2)


@pytest.mark.parametrize("task", list(TaskType))
def test_converted_jax_model_scores_the_same(task):
    jb, intercept, _ = jax_synthetic(np.random.default_rng(4), 200, 6, JTask(task.value))
    rj = jax_train_glm(jb, JTask(task.value), JConfig(max_iterations=30), regularization_weights=[1.0],
                       intercept_index=intercept, variance_computation=JVar.SIMPLE)
    jmodel = rj.models[1.0]
    model = glm_from_numpy(
        np.asarray(jmodel.coefficients.means), np.asarray(jmodel.coefficients.variances),
        jmodel.task_type, device="cpu",
    )
    assert model.task_type is task
    batch = dense_batch_from_numpy(np.asarray(jb.X), np.asarray(jb.labels), device="cpu")
    np.testing.assert_allclose(model.score(batch).numpy(), np.asarray(jmodel.score(jb)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(model.predict(batch).numpy(), np.asarray(jmodel.predict(jb)), rtol=1e-5, atol=1e-5)


def test_synthetic_data_from_a_numpy_generator_matches_reference():
    for task in TaskType:
        jb, ji, jw = jax_synthetic(np.random.default_rng(9), 50, 4, JTask(task.value))
        tb, ti, tw = synthetic_glm_data(np.random.default_rng(9), 50, 4, task, device="cpu")
        assert ti == ji
        np.testing.assert_array_equal(tb.X.numpy(), np.asarray(jb.X))
        np.testing.assert_array_equal(tb.labels.numpy(), np.asarray(jb.labels))
        np.testing.assert_array_equal(tw.numpy(), jw)


def test_synthetic_data_from_a_seed_is_reproducible():
    a, ia, wa = synthetic_glm_data(3, 64, 5, TaskType.POISSON_REGRESSION, dtype=torch.bfloat16, device="cpu")
    b, _, wb = synthetic_glm_data(3, 64, 5, TaskType.POISSON_REGRESSION, dtype=torch.bfloat16, device="cpu")
    assert ia == 5 and a.X.dtype == torch.bfloat16 and a.X.shape == (64, 6)
    assert torch.equal(a.X, b.X) and torch.equal(a.labels, b.labels) and torch.equal(wa, wb)
    assert bool((a.X[:, 5] == 1).all()) and bool((a.labels >= 0).all())
