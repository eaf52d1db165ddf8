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


def test_cli_variance_flag_and_its_alias(tmp_path, monkeypatch):
    """The reference's ``--variance SIMPLE`` and the port's older
    ``--variance-computation SIMPLE`` both reach the solve as SIMPLE and
    write the same report."""
    from photon_ml_tpu_torch.cli import train_glm as cli_mod

    rng = np.random.default_rng(22)
    X = rng.normal(size=(120, 5)).astype(np.float32)
    y = (rng.uniform(size=120) < 1 / (1 + np.exp(-X @ rng.normal(size=5)))).astype(np.float32)
    train = tmp_path / "train.libsvm"
    _write_libsvm(train, X, y, rng)
    seen = []
    real_run = cli_mod.run

    def spy(*args, **kw):
        seen.append(kw["variance_computation"])
        return real_run(*args, **kw)

    monkeypatch.setattr(cli_mod, "run", spy)
    reports = []
    for flag in ("--variance", "--variance-computation"):
        out = tmp_path / flag.strip("-")
        cli_main(["--task", "LOGISTIC_REGRESSION", "--train-data", str(train), "--weights", "1.0",
                  "--max-iterations", "30", "--tolerance", "1e-3", flag, "SIMPLE",
                  "--device", "cpu", "--output-dir", str(out)])
        reports.append(json.loads((out / "report.json").read_text()))
    assert seen == [VarianceComputationType.SIMPLE] * 2
    assert reports[0] == reports[1]


def test_cli_rejects_avro(tmp_path):
    """``--format avro`` reads Avro now; what it rejects is a file that is not
    an Avro container, with the reader's error."""
    bad = tmp_path / "x.avro"
    bad.write_bytes(b"1 1:0.5\n")
    with pytest.raises(ValueError, match="not an Avro container"):
        cli_main(["--task", "LOGISTIC_REGRESSION", "--train-data", str(bad), "--format", "avro",
                  "--device", "cpu", "--output-dir", str(tmp_path / "out")])


def test_read_libsvm_matches_reference(tmp_path):
    from photon_ml_tpu.data.libsvm import read_libsvm as jax_read_libsvm

    path = tmp_path / "d.libsvm"
    path.write_text("+1 1:0.5 3:2.0 3:1.0\n-1 2:-1.5\n# comment\n+1 4:0.25\n")
    for dense in (False, True):
        jb, ji = jax_read_libsvm(str(path), dense=dense)
        tb, ti = read_libsvm(str(path), dense=dense, device="cpu")
        assert ti == ji
        w = np.arange(1, 6, dtype=np.float32)
        np.testing.assert_allclose(tb.matvec(torch.as_tensor(w)).numpy(), np.asarray(jb.matvec(jnp.asarray(w))))
        np.testing.assert_array_equal(tb.labels.numpy(), np.asarray(jb.labels))
    with pytest.raises(ValueError, match="out of range"):
        read_libsvm(str(path), num_features=2, device="cpu")


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


def _write_avro_glm(path, X, y):
    from photon_ml_tpu.io.avro import write_avro_file as ref_write
    from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA

    recs = [
        {"uid": f"r{i}", "response": float(label), "offset": None, "weight": None,
         "features": [{"name": "x", "term": str(j), "value": float(row[j])} for j in range(len(row))
                      if row[j] != 0.0],
         "metadataMap": None}
        for i, (row, label) in enumerate(zip(X, y))
    ]
    ref_write(str(path), TRAINING_EXAMPLE_SCHEMA, recs)


def _model_files(root):
    import os

    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f.endswith(".avro"))


@pytest.mark.parametrize("fmt", ["avro", "libsvm"])
def test_cli_twin_writes_the_reference_model_files(tmp_path, fmt):
    """``--format avro`` (the ``global`` shard of the Avro reader) and LIBSVM:
    the per-λ and best model files of the reference, by layout and records,
    with coefficients within atol 1e-4."""
    from photon_ml_tpu.io.avro import read_avro_file as ref_read
    from photon_ml_tpu.io.model_io import load_glm as ref_load_glm
    from photon_ml_tpu_torch.io.model_io import load_glm

    rng = np.random.default_rng(23)
    X = rng.normal(size=(200, 6)).astype(np.float32)
    X[rng.uniform(size=X.shape) < 0.2] = 0.0
    y = (rng.uniform(size=200) < 1 / (1 + np.exp(-X @ rng.normal(size=6)))).astype(np.float32)
    ext = "avro" if fmt == "avro" else "libsvm"
    train, val = tmp_path / f"train.{ext}", tmp_path / f"val.{ext}"
    if fmt == "avro":
        _write_avro_glm(train, X[:150], y[:150])
        _write_avro_glm(val, X[150:], y[150:])
    else:
        _write_libsvm(train, X[:150], y[:150], rng)
        _write_libsvm(val, X[150:], y[150:], rng)
    jax_run(JTask.LOGISTIC_REGRESSION, [str(train)], str(tmp_path / "jax"), data_format=fmt,
            validation_data=[str(val)], weights=[0.1, 1.0, 10.0], max_iterations=60, tolerance=1e-3)
    cli_main(["--task", "LOGISTIC_REGRESSION", "--train-data", str(train), "--format", fmt,
              "--validation-data", str(val), "--weights", "0.1", "1.0", "10.0",
              "--max-iterations", "60", "--tolerance", "1e-3", "--device", "cpu",
              "--output-dir", str(tmp_path / "port")])
    files = _model_files(tmp_path / "jax")
    assert _model_files(tmp_path / "port") == files
    assert files == ["best/model.avro", "models/lambda-0.1/model.avro", "models/lambda-1/model.avro",
                     "models/lambda-10/model.avro"]
    ref = json.loads((tmp_path / "jax" / "report.json").read_text())
    assert json.loads((tmp_path / "port" / "report.json").read_text())["best_weight"] == ref["best_weight"]
    for f in files:
        got = ref_read(str(tmp_path / "port" / f))[1][0]
        want = ref_read(str(tmp_path / "jax" / f))[1][0]
        assert {k: got[k] for k in ("modelId", "modelClass", "lossFunction", "variances")} == \
            {k: want[k] for k in ("modelId", "modelClass", "lossFunction", "variances")}
        assert [(r["name"], r["term"]) for r in got["means"]] == [(r["name"], r["term"]) for r in want["means"]]
        np.testing.assert_allclose([r["value"] for r in got["means"]], [r["value"] for r in want["means"]],
                                   atol=1e-4)
    # the port's loader reads the reference's best model as the reference does
    d = len(ref_read(str(tmp_path / "jax" / "best" / "model.avro"))[1][0]["means"])
    if fmt == "libsvm":
        np.testing.assert_array_equal(
            load_glm(str(tmp_path / "jax" / "best" / "model.avro"), num_features=d, device="cpu")
            .coefficients.means.numpy(),
            np.asarray(ref_load_glm(str(tmp_path / "jax" / "best" / "model.avro"), num_features=d)
                       .coefficients.means),
        )
    if fmt == "avro":
        names = {r["name"] for r in ref_read(str(tmp_path / "port" / "best" / "model.avro"))[1][0]["means"]}
        assert names == {"x", "(INTERCEPT)"}


def _stages(out_dir) -> list[str]:
    return [line.split("stage → ")[1].strip() for line in (out_dir / "photon.log").read_text().splitlines()
            if "stage → " in line]


@pytest.mark.parametrize("fmt", ["avro", "libsvm"])
def test_cli_twin_flags_match_the_reference(tmp_path, fmt):
    """``--summarize-features``, ``--validate VALIDATE_FULL``,
    ``--diagnostics`` and ``--prior-model`` (the reference driver's best
    model of a first run) against the reference's driver on the same files:
    the same files, the same ``_stage`` sequence, the summary's records
    within rtol 1e-5, the models within atol 1e-4, the diagnostics report's
    λ entries and best λ; a label outside {0, 1} fails validation in both."""
    from photon_ml_tpu.data.validation import DataValidationError as JValidationError
    from photon_ml_tpu.io.avro import read_avro_file as ref_read
    from photon_ml_tpu.types import DataValidationType as JValidate
    from photon_ml_tpu_torch.data.validation import DataValidationError

    rng = np.random.default_rng(29)
    X = rng.normal(size=(220, 5)).astype(np.float32)
    X[rng.uniform(size=X.shape) < 0.2] = 0.0
    y = (rng.uniform(size=220) < 1 / (1 + np.exp(-X @ rng.normal(size=5)))).astype(np.float32)
    ext = "avro" if fmt == "avro" else "libsvm"
    write = _write_avro_glm if fmt == "avro" else (lambda p, a, b: _write_libsvm(p, a, b, rng))
    first, train, val = tmp_path / f"first.{ext}", tmp_path / f"train.{ext}", tmp_path / f"val.{ext}"
    write(first, X[:80], y[:80])
    write(train, X[80:180], y[80:180])
    write(val, X[180:], y[180:])
    common = dict(data_format=fmt, validation_data=[str(val)], weights=[0.1, 1.0, 10.0], max_iterations=60,
                  tolerance=1e-3)
    jax_run(JTask.LOGISTIC_REGRESSION, [str(first)], str(tmp_path / "prior"), **common)
    prior = str(tmp_path / "prior" / "best" / "model.avro")
    jax_run(JTask.LOGISTIC_REGRESSION, [str(train)], str(tmp_path / "jax"), summarize_features=True,
            validate=JValidate.VALIDATE_FULL, prior_model_path=prior, diagnostics=True, **common)
    cli_main(["--task", "LOGISTIC_REGRESSION", "--train-data", str(train), "--format", fmt,
              "--validation-data", str(val), "--weights", "0.1", "1.0", "10.0", "--max-iterations", "60",
              "--tolerance", "1e-3", "--summarize-features", "--validate", "VALIDATE_FULL", "--diagnostics",
              "--prior-model", prior, "--device", "cpu", "--output-dir", str(tmp_path / "port")])

    def listing(root):
        import os

        return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)

    assert listing(tmp_path / "port") == listing(tmp_path / "jax")
    assert {"summary/part-00000.avro", "diagnostics.json", "diagnostics.html", "_stage"} <= \
        set(listing(tmp_path / "port"))
    assert _stages(tmp_path / "port") == _stages(tmp_path / "jax") == \
        ["INIT", "PROCESSED", "TRAINED", "VALIDATED"]
    got, want = (ref_read(str(tmp_path / d / "summary" / "part-00000.avro"))[1] for d in ("port", "jax"))
    assert [(r["featureName"], r["featureTerm"]) for r in got] == [(r["featureName"], r["featureTerm"])
                                                                   for r in want]
    for g, w in zip(got, want):
        assert g["metrics"].keys() == w["metrics"].keys()
        np.testing.assert_allclose([g["metrics"][k] for k in w["metrics"]],
                                   [w["metrics"][k] for k in w["metrics"]], rtol=1e-5, atol=1e-7)
    for f in _model_files(tmp_path / "jax"):
        if f.startswith("summary/"):
            continue
        g, w = ref_read(str(tmp_path / "port" / f))[1][0], ref_read(str(tmp_path / "jax" / f))[1][0]
        assert [(r["name"], r["term"]) for r in g["means"]] == [(r["name"], r["term"]) for r in w["means"]]
        np.testing.assert_allclose([r["value"] for r in g["means"]], [r["value"] for r in w["means"]], atol=1e-4)
    got, want = (json.loads((tmp_path / d / "diagnostics.json").read_text()) for d in ("port", "jax"))
    assert got.keys() == want.keys() and got["best_regularization_weight"] == want["best_regularization_weight"]
    assert [e["regularization_weight"] for e in got["entries"]] == [e["regularization_weight"]
                                                                     for e in want["entries"]]
    for g, w in zip(got["entries"], want["entries"]):
        assert g.keys() == w.keys() and g["coefficients"].keys() == w["coefficients"].keys()
        assert abs(g["validation"]["AUC"] - w["validation"]["AUC"]) <= 1e-4

    bad = tmp_path / f"bad.{ext}"
    if fmt == "avro":
        y_bad = y[80:180].copy()
        y_bad[3] = 2.0
        write(bad, X[80:180], y_bad)
    else:  # the LIBSVM writer maps labels to ±1
        bad.write_text("+1 1:0.5 2:1.0\n2 1:0.25\n-1 2:0.5\n")
    with pytest.raises(JValidationError, match="binary labels"):
        jax_run(JTask.LOGISTIC_REGRESSION, [str(bad)], str(tmp_path / "jax-bad"), data_format=fmt,
                validate=JValidate.VALIDATE_FULL)
    with pytest.raises(DataValidationError, match="binary labels"):
        cli_main(["--task", "LOGISTIC_REGRESSION", "--train-data", str(bad), "--format", fmt, "--validate",
                  "VALIDATE_FULL", "--device", "cpu", "--output-dir", str(tmp_path / "port-bad")])
