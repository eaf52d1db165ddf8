"""The sparse high-dimensional GLM slice end to end: the objective, the
L-BFGS solve, variances, scoring, ``train_glm`` and the CLI twin on the
port's ``TiledSparseBatch`` (K3's plain version on the CPU), against the
JAX package on the same data as a ``SparseBatch`` (XLA gather/scatter) or,
for the solver's pass count, on its own tiled batch in interpret mode."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.ops.sparse_tiled as jst
from photon_ml_tpu.config import OptimizerConfig as JConfig
from photon_ml_tpu.data.libsvm import read_libsvm as jax_read_libsvm
from photon_ml_tpu.evaluation.evaluators import auc_roc as jax_auc_roc
from photon_ml_tpu.models import Coefficients as JCoef
from photon_ml_tpu.models import GeneralizedLinearModel as JGLM
from photon_ml_tpu.ops import glm as jglm
from photon_ml_tpu.ops.batch import SparseBatch as JSparse
from photon_ml_tpu.ops.losses import loss_for_task as jax_loss_for_task
from photon_ml_tpu.optim import lbfgs_minimize as jax_lbfgs
from photon_ml_tpu.supervised.training import train_glm as jax_train_glm
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch.cli import train_glm as cli
from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.convert import glm_from_numpy, sparse_batch_from_numpy
from photon_ml_tpu_torch.evaluation import auc_roc
from photon_ml_tpu_torch.ops import glm as tglm
from photon_ml_tpu_torch.ops import sparse_tiled as st
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optim import lbfgs_minimize
from photon_ml_tpu_torch.supervised.training import train_glm
from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

TASK = TaskType.LOGISTIC_REGRESSION
LOSS, JLOSS = loss_for_task(TASK), jax_loss_for_task(JTask.LOGISTIC_REGRESSION)
# tests/test_kernel_dtype.py's documented rung quality gates
RUNG_GATES = {"bf16": (0.005, 1e-3), "int8": (0.01, 5e-3)}


def _problem(seed=42, n=1100, d=4608, k=5, wt=None):
    """tests/test_sparse_tiled.py's ``_sparse_problem`` shape, as a JAX
    ``SparseBatch`` and the port's tiled batch (f32 rung)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    val[rng.uniform(size=(n, k)) < 0.1] = 0.0
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    wt = np.ones(n, np.float32) if wt is None else wt
    jb = JSparse(indices=jnp.asarray(idx), values=jnp.asarray(val), labels=jnp.asarray(y),
                 offsets=jnp.asarray(off), weights=jnp.asarray(wt), num_features=d)
    tb = sparse_batch_from_numpy(idx, val, y, off, wt, num_features=d, device="cpu")
    return jb, tb


def _tiled(tb):
    """The port's tiled batch on the default (f32) rung."""
    return st.tile_sparse_batch(tb)


@pytest.fixture(autouse=True)
def _f32_rung(monkeypatch):
    monkeypatch.delenv("PHOTON_KERNEL_DTYPE", raising=False)


def _close(got, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# 5. objective, solve, variances
# ---------------------------------------------------------------------------
def test_objective_value_and_grad_match_reference():
    jb, tb = _problem()
    d = tb.num_features
    obj = tglm.make_objective(_tiled(tb), LOSS, l2_weight=1.0, device="cpu")
    jobj = jglm.make_objective(jb, JLOSS, l2_weight=1.0)
    assert not obj.fused and obj.one_pass_value_grad
    w = np.full(d, 0.01, np.float32)
    v, g = obj.value_and_grad(torch.as_tensor(w))
    jv, jg = jobj.value_and_grad(jnp.asarray(w))
    _close(float(v), float(jv), rtol=1e-5)
    _close(g, jg, rtol=1e-4, atol=1e-5)
    _close(obj.value(torch.as_tensor(w)), float(jobj.value(jnp.asarray(w))), rtol=1e-5)


def test_hvp_and_hessian_diag_match_reference():
    rng = np.random.default_rng(3)
    wt = rng.uniform(0.5, 1.5, size=1100).astype(np.float32)
    wt[::9] = 0.0
    jb, tb = _problem(seed=5, wt=wt)
    d = tb.num_features
    obj = tglm.make_objective(_tiled(tb), LOSS, l2_weight=0.7, intercept_index=d - 1, device="cpu")
    jobj = jglm.make_objective(jb, JLOSS, l2_weight=0.7, intercept_index=d - 1)
    w = (0.1 * rng.normal(size=d)).astype(np.float32)
    v = rng.normal(size=d).astype(np.float32)
    _close(obj.hvp(torch.as_tensor(w), torch.as_tensor(v)), jobj.hvp(jnp.asarray(w), jnp.asarray(v)),
           rtol=1e-4, atol=1e-5)
    _close(obj.hessian_diag(torch.as_tensor(w)), jobj.hessian_diag(jnp.asarray(w)), rtol=1e-5)
    var = tglm.compute_variances(obj, torch.as_tensor(w), VarianceComputationType.SIMPLE)
    _close(var, jglm.compute_variances(jobj, jnp.asarray(w), JVar.SIMPLE), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="DenseBatch"):
        tglm.compute_variances(obj, torch.as_tensor(w), VarianceComputationType.FULL)


def test_lbfgs_on_tiled_batch_matches_reference_solve():
    """tests/test_sparse_tiled.py::test_objective_and_solve_match: the
    same 8 iterations land on the same optimum as the XLA sparse path."""
    jb, tb = _problem()
    d = tb.num_features
    cfg_kw = dict(max_iterations=8, tolerance=1e-8)
    res = lbfgs_minimize(tglm.make_objective(_tiled(tb), LOSS, l2_weight=1.0, device="cpu"),
                         torch.zeros(d), OptimizerConfig(**cfg_kw))
    jres = jax_lbfgs(jglm.make_objective(jb, JLOSS, l2_weight=1.0), jnp.zeros(d, jnp.float32),
                     JConfig(**cfg_kw))
    _close(float(res.value), float(jres.value), rtol=1e-5)
    _close(res.w, jres.w, rtol=1e-2, atol=1e-3)


@pytest.mark.kernel
def test_solve_on_tiled_batches_takes_the_reference_passes():
    """On a tiled batch both packages evaluate value and gradient at every
    line-search trial (``one_pass_value_grad``), so the port's solve on its
    tiled batch counts the objective passes of the reference's solve on
    its own tiled batch (Pallas kernels in interpret mode)."""
    jb, tb = _problem(seed=11)
    d = tb.num_features
    cfg_kw = dict(max_iterations=8, tolerance=1e-8)
    jobj = jglm.make_objective(jst.tile_sparse_batch(jb), JLOSS, l2_weight=1.0)
    assert jobj.one_pass_value_grad
    jres = jax_lbfgs(jobj, jnp.zeros(d, jnp.float32), JConfig(**cfg_kw))
    res = lbfgs_minimize(tglm.make_objective(_tiled(tb), LOSS, l2_weight=1.0, device="cpu"),
                         torch.zeros(d), OptimizerConfig(**cfg_kw))
    assert res.iterations == int(jres.iterations)
    assert res.objective_passes == int(jres.objective_passes)
    _close(float(res.value), float(jres.value), rtol=1e-5)


def test_one_pass_policy_only_for_fused_or_tiled_batches():
    jb, tb = _problem()
    assert tglm.make_objective(_tiled(tb), LOSS, device="cpu").one_pass_value_grad
    assert not tglm.make_objective(tb, LOSS, device="cpu").one_pass_value_grad
    assert not jglm.make_objective(jb, JLOSS).one_pass_value_grad


# ---------------------------------------------------------------------------
# 6. the reduced rungs' quality gates
# ---------------------------------------------------------------------------
def _fit():
    """tests/test_kernel_dtype.py::TestLadderQualityGates's fit: n = 640,
    d = 1037, k = 3, 6 L-BFGS iterations on one rung; AUC on the plain
    gather/scatter margins."""
    rng = np.random.default_rng(17)
    n, d, k = 640, 1037, 3
    idx = rng.integers(0, d, size=(n, k))
    val = rng.normal(size=(n, k)).astype(np.float32)
    w_true = (rng.normal(size=d) * 0.5).astype(np.float32)
    m = (val * w_true[idx]).sum(axis=1)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    batch = sparse_batch_from_numpy(idx, val, y, num_features=d, device="cpu")
    obj = tglm.make_objective(_tiled(batch), LOSS, l2_weight=1.0, device="cpu")
    res = lbfgs_minimize(obj, torch.zeros(d), OptimizerConfig(max_iterations=6, tolerance=1e-8))
    return float(auc_roc(batch.matvec(res.w), batch.labels)), float(res.value)


@pytest.mark.parametrize("rung", list(RUNG_GATES))
def test_reduced_rung_quality_within_documented_tolerances(monkeypatch, rung):
    auc32, loss32 = _fit()
    monkeypatch.setenv("PHOTON_KERNEL_DTYPE", rung)
    auc, loss = _fit()
    auc_tol, loss_rtol = RUNG_GATES[rung]
    assert abs(auc - auc32) <= auc_tol
    assert abs(loss - loss32) <= loss_rtol * abs(loss32)


# ---------------------------------------------------------------------------
# models, evaluation and train_glm on the tiled batch
# ---------------------------------------------------------------------------
def test_model_scores_tiled_batch_like_reference():
    jb, tb = _problem(seed=21)
    rng = np.random.default_rng(2)
    means = (0.3 * rng.normal(size=tb.num_features)).astype(np.float32)
    model = glm_from_numpy(means, None, TASK, device="cpu")
    jmodel = JGLM(JCoef(jnp.asarray(means), None), JTask.LOGISTIC_REGRESSION)
    scores = model.score(_tiled(tb))
    _close(scores, jmodel.score(jb), rtol=1e-5, atol=1e-5)
    _close(model.predict(_tiled(tb)), jmodel.predict(jb), rtol=1e-5, atol=1e-6)
    _close(float(auc_roc(scores, tb.labels)), float(jax_auc_roc(jmodel.score(jb), jb.labels)),
           rtol=0, atol=1e-6)


def test_train_glm_on_tiled_batch_matches_reference():
    jb, tb = _problem(seed=23)
    jv, tv = _problem(seed=24, n=400)
    kw = dict(max_iterations=30, tolerance=1e-4)
    weights = [0.5, 5.0]
    rj = jax_train_glm(jb, JTask.LOGISTIC_REGRESSION, optimizer_config=JConfig(**kw),
                       regularization_weights=weights, validation_batch=jv,
                       variance_computation=JVar.SIMPLE)
    rt = train_glm(_tiled(tb), TASK, optimizer_config=OptimizerConfig(**kw),
                   regularization_weights=weights, validation_batch=tv,
                   variance_computation=VarianceComputationType.SIMPLE, device="cpu")
    assert rt.best_weight == rj.best_weight
    for lam in weights:
        assert abs(rt.validation[lam].metrics["AUC"] - rj.validation[lam].metrics["AUC"]) <= 1e-4
        assert abs(rt.trackers[lam].iterations - int(rj.trackers[lam].iterations)) <= 1
        coef, jcoef = rt.models[lam].coefficients, rj.models[lam].coefficients
        _close(coef.means, jcoef.means, rtol=1e-2, atol=1e-3)
        _close(coef.variances, jcoef.variances, rtol=1e-3, atol=1e-6)


# ---------------------------------------------------------------------------
# 8. the CLI twin on high-dimensional LIBSVM data
# ---------------------------------------------------------------------------
def _write_libsvm(path, rng, n, d, k, w_true):
    with open(path, "w") as f:
        for _ in range(n):
            cols = np.unique(rng.integers(0, d, size=k))
            vals = rng.normal(size=len(cols)).astype(np.float32)
            y = rng.uniform() < 1 / (1 + np.exp(-float(vals @ w_true[cols])))
            feats = " ".join(f"{j + 1}:{v:.5f}" for j, v in zip(cols, vals))
            f.write(f"{'+1' if y else '-1'} {feats}\n")


def test_cli_routes_high_d_libsvm_to_the_tiled_batch(tmp_path, monkeypatch):
    rng = np.random.default_rng(31)
    d = 5000
    w_true = rng.normal(size=d).astype(np.float32)
    train, val = tmp_path / "train.libsvm", tmp_path / "val.libsvm"
    _write_libsvm(train, rng, 1200, d, 6, w_true)
    _write_libsvm(val, rng, 300, d, 6, w_true)
    # a low budget: the dense form (1200 x 5001 float32) must not fit
    monkeypatch.setattr(cli, "_hbm_budget_bytes", lambda dev: 1e6)
    seen = []

    def spy(batch, *args, **kw):
        seen.append(batch)
        return train_glm(batch, *args, **kw)

    monkeypatch.setattr(cli, "train_glm", spy)
    weights, iters, tol = [0.5, 5.0], 40, 1e-4
    cli.main([
        "--task", "LOGISTIC_REGRESSION", "--train-data", str(train), "--validation-data", str(val),
        "--weights", *map(str, weights), "--max-iterations", str(iters), "--tolerance", str(tol),
        "--device", "cpu", "--output-dir", str(tmp_path / "port"),
    ])
    assert len(seen) == 1 and isinstance(seen[0], st.TiledSparseBatch)
    got = json.loads((tmp_path / "port" / "report.json").read_text())
    assert (tmp_path / "port" / "_stage").read_text() == "VALIDATED"

    jb, intercept = jax_read_libsvm(str(train))
    jv, _ = jax_read_libsvm(str(val), num_features=jb.num_features - 1)
    assert isinstance(jb, JSparse) and jst.supports_tiling(jb)  # the reference would tile it too
    from photon_ml_tpu.config import RegularizationContext as JReg
    from photon_ml_tpu.types import RegularizationType as JRT

    rj = jax_train_glm(jb, JTask.LOGISTIC_REGRESSION,
                       optimizer_config=JConfig(max_iterations=iters, tolerance=tol),
                       regularization=JReg(JRT.L2), regularization_weights=weights,
                       intercept_index=intercept, validation_batch=jv)
    assert got["best_weight"] == rj.best_weight
    for lam in weights:
        key = str(lam)
        assert abs(got["validation"][key]["AUC"] - rj.validation[lam].metrics["AUC"]) <= 1e-4
        assert got["trackers"][key]["converged"] == bool(rj.trackers[lam].converged)
        assert abs(got["trackers"][key]["iterations"] - int(rj.trackers[lam].iterations)) <= 1
