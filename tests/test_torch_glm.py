"""``GLMObjective`` and what feeds it (batches, normalization, summary,
prior, variances): the port against the JAX package on the same float32
state, carried across with ``photon_ml_tpu_torch.convert``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.summary import summarize as jax_summarize
from photon_ml_tpu.normalization import build_normalization as jax_build_normalization
from photon_ml_tpu.ops import batch as jbatch_mod
from photon_ml_tpu.ops import glm as jglm
from photon_ml_tpu.ops.losses import loss_for_task as jax_loss_for_task
from photon_ml_tpu.types import NormalizationType as JNorm
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch.convert import dense_batch_from_numpy, normalization_from_numpy
from photon_ml_tpu_torch.data.summary import summarize
from photon_ml_tpu_torch.normalization import build_normalization, require_intercept_for_shifts
from photon_ml_tpu_torch.ops import batch as tbatch_mod
from photon_ml_tpu_torch.ops import glm as tglm
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.types import NormalizationType, TaskType, VarianceComputationType

RTOL_VALUE, TOL_GRAD = 1e-5, 1e-4  # tests/test_fused.py's float32 tolerances


def _problem(task: TaskType, n: int = 160, d: int = 12, seed: int = 3):
    """float32 numpy data with an intercept column at d - 1, offsets and
    weights (a few zero), and a standardization from its statistics."""
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, size=d) + rng.normal(size=d)).astype(
        np.float32
    )
    X[:, d - 1] = 1.0
    margin = X @ (0.2 * rng.normal(size=d)).astype(np.float32)
    if task is TaskType.LINEAR_REGRESSION:
        y = margin + 0.1 * rng.normal(size=n)
    elif task is TaskType.POISSON_REGRESSION:
        y = rng.poisson(np.exp(np.clip(margin, -5, 2)))
    else:
        y = rng.uniform(size=n) < 1 / (1 + np.exp(-margin))
    y = y.astype(np.float32)
    off = (0.1 * rng.normal(size=n)).astype(np.float32)
    wt = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    wt[::11] = 0.0
    return X, y, off, wt


def _pair(task, *, norm_type=NormalizationType.STANDARDIZATION, prior=True, fused=False):
    X, y, off, wt = _problem(task)
    d = X.shape[1]
    jb = jbatch_mod.DenseBatch(
        X=jnp.asarray(X), labels=jnp.asarray(y), offsets=jnp.asarray(off), weights=jnp.asarray(wt)
    )
    tb = dense_batch_from_numpy(X, y, off, wt, device="cpu")
    jnorm = jax_build_normalization(
        JNorm(norm_type.value), X.mean(0), X.var(0), np.abs(X).max(0), intercept_index=d - 1
    )
    tnorm = normalization_from_numpy(
        np.asarray(jnorm.factors), np.asarray(jnorm.shifts), d - 1, device="cpu"
    )
    rng = np.random.default_rng(99)
    means = (0.3 * rng.normal(size=d)).astype(np.float32)
    variances = rng.uniform(0.1, 2.0, size=d).astype(np.float32)
    variances[2] = 0.0  # non-positive variance: uninformative
    jprior = tprior = None
    if prior:
        jprior = jglm.GaussianPrior.from_coefficients(means, variances, jnorm)
        tprior = tglm.GaussianPrior.from_coefficients(
            torch.as_tensor(means), torch.as_tensor(variances), tnorm
        )
    jobj = jglm.make_objective(
        jb, jax_loss_for_task(JTask(task.value)), l2_weight=0.8, norm=jnorm,
        intercept_index=d - 1, fused=False, prior=jprior,
    )
    tobj = tglm.make_objective(
        tb, loss_for_task(task), l2_weight=0.8, norm=tnorm, intercept_index=d - 1,
        fused=fused, prior=tprior, device="cpu",
    )
    w = (0.2 * rng.normal(size=d)).astype(np.float32)
    v = rng.normal(size=d).astype(np.float32)
    return jobj, tobj, w, v


def _close(got: torch.Tensor, ref, rtol=TOL_GRAD, atol=TOL_GRAD):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


TASKS = list(TaskType)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_plain"])
@pytest.mark.parametrize("task", TASKS)
def test_value_and_grad(task, fused):
    jobj, tobj, w, _ = _pair(task, fused=fused)
    jv, jg = jobj.value_and_grad(jnp.asarray(w))
    tv, tg = tobj.value_and_grad(torch.as_tensor(w))
    np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL_VALUE)
    np.testing.assert_allclose(float(tobj.value(torch.as_tensor(w))), float(jv), rtol=RTOL_VALUE)
    _close(tg, jg)
    _close(tobj.grad(torch.as_tensor(w)), jg)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_plain"])
@pytest.mark.parametrize("task", TASKS)
def test_hvp(task, fused):
    jobj, tobj, w, v = _pair(task, fused=fused)
    _close(tobj.hvp(torch.as_tensor(w), torch.as_tensor(v)), jobj.hvp(jnp.asarray(w), jnp.asarray(v)))


@pytest.mark.parametrize("task", TASKS)
def test_hessian_diag_and_full(task):
    jobj, tobj, w, _ = _pair(task)
    jw, tw = jnp.asarray(w), torch.as_tensor(w)
    _close(tobj.hessian_diag(tw), jobj.hessian_diag(jw))
    H = tobj.hessian(tw)
    _close(H, jobj.hessian(jw), rtol=TOL_GRAD, atol=1e-3)
    assert torch.allclose(H, H.T, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("task", TASKS)
def test_ray_values_and_margin_api(task):
    jobj, tobj, w, v = _pair(task)
    jw, tw, jv, tv = jnp.asarray(w), torch.as_tensor(w), jnp.asarray(v), torch.as_tensor(v)
    ts = np.asarray([0.0, 0.25, 0.5, 1.0, 2.0], np.float32)
    _close(tobj.ray_values(tw, tv, torch.as_tensor(ts)), jobj.ray_values(jw, jv, jnp.asarray(ts)),
           rtol=RTOL_VALUE, atol=TOL_GRAD)
    _close(tobj.margins(tw), jobj.margins(jw))
    _close(tobj.direction_margins(tv), jobj.direction_margins(jv))
    m = tobj.margins(tw)
    fv, g = tobj.value_and_grad_from_margins(m, tw)
    jfv, jg = jobj.value_and_grad_from_margins(jobj.margins(jw), jw)
    np.testing.assert_allclose(float(fv), float(jfv), rtol=RTOL_VALUE)
    _close(g, jg)
    _close(tobj.hessian_from_margins(m, tw), jobj.hessian(jw), atol=1e-3)


def test_objective_without_normalization_or_prior():
    jobj, tobj, w, v = _pair(TaskType.LOGISTIC_REGRESSION, norm_type=NormalizationType.NONE, prior=False)
    assert tobj.prior_mean is None and tobj.prior_precision is None
    jv, jg = jobj.value_and_grad(jnp.asarray(w))
    tv, tg = tobj.value_and_grad(torch.as_tensor(w))
    np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL_VALUE)
    _close(tg, jg)


def test_prior_precisions_treat_nonpositive_variance_as_uninformative():
    prior = tglm.GaussianPrior(means=torch.zeros(3), variances=torch.tensor([0.5, 0.0, -1.0]))
    assert prior.precisions.tolist() == [2.0, 1.0, 1.0]
    assert tglm.GaussianPrior(means=torch.zeros(2)).precisions is None


@pytest.mark.parametrize("kind", ["SIMPLE", "FULL"])
def test_compute_variances(kind):
    jobj, tobj, w, _ = _pair(TaskType.LOGISTIC_REGRESSION)
    ref = jglm.compute_variances(jobj, jnp.asarray(w), JVar(kind))
    got = tglm.compute_variances(tobj, torch.as_tensor(w), VarianceComputationType(kind))
    _close(got, ref, rtol=1e-3, atol=1e-5)
    assert tglm.compute_variances(tobj, torch.as_tensor(w), VarianceComputationType.NONE) is None


@pytest.mark.parametrize("norm_type", list(NormalizationType))
def test_build_normalization_and_space_maps(norm_type):
    X, *_ = _problem(TaskType.LINEAR_REGRESSION)
    d = X.shape[1]
    stats = (X.mean(0), X.var(0), np.abs(X).max(0))
    jn = jax_build_normalization(JNorm(norm_type.value), *stats, intercept_index=d - 1)
    tn = build_normalization(norm_type, *stats, intercept_index=d - 1, device="cpu")
    _close(tn.factors, jn.factors, rtol=0, atol=0)
    _close(tn.shifts, jn.shifts, rtol=0, atol=0)
    w = np.random.default_rng(1).normal(size=d).astype(np.float32)
    tu, tdelta = tn.model_to_original_space(torch.as_tensor(w))
    ju, jdelta = jn.model_to_original_space(jnp.asarray(w))
    _close(tu, ju, rtol=1e-6, atol=1e-5)
    _close(tn.model_from_original_space(tu), jn.model_from_original_space(ju), rtol=1e-5, atol=1e-5)
    r = np.random.default_rng(2).normal(size=d).astype(np.float32)
    _close(tn.grad_to_model_space(torch.as_tensor(r), torch.tensor(0.7)),
           jn.grad_to_model_space(jnp.asarray(r), jnp.float32(0.7)), rtol=1e-6, atol=1e-6)


def test_shifts_need_an_intercept():
    X, *_ = _problem(TaskType.LINEAR_REGRESSION)
    norm = build_normalization(NormalizationType.STANDARDIZATION, X.mean(0), X.var(0), X.max(0),
                               device="cpu")
    with pytest.raises(ValueError, match="intercept"):
        require_intercept_for_shifts(norm)
    require_intercept_for_shifts(None)


def _sparse_pair(seed=4, n=40, d=9, k=4):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, k))
    val = rng.normal(size=(n, k)).astype(np.float32)
    val[:, -1] = 0.0  # padding slots
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    wt = np.ones(n, np.float32)
    wt[::5] = 0.0
    jb = jbatch_mod.SparseBatch(
        indices=jnp.asarray(idx, jnp.int32), values=jnp.asarray(val), labels=jnp.asarray(y),
        offsets=jnp.zeros(n, jnp.float32), weights=jnp.asarray(wt), num_features=d,
    )
    tb = tbatch_mod.SparseBatch(
        indices=torch.as_tensor(idx), values=torch.as_tensor(val), labels=torch.as_tensor(y),
        offsets=torch.zeros(n), weights=torch.as_tensor(wt), num_features=d,
    )
    return jb, tb


def test_sparse_batch_contracts_and_densify():
    jb, tb = _sparse_pair()
    rng = np.random.default_rng(8)
    w = rng.normal(size=tb.num_features).astype(np.float32)
    r = rng.normal(size=tb.num_rows).astype(np.float32)
    _close(tb.matvec(torch.as_tensor(w)), jb.matvec(jnp.asarray(w)), rtol=1e-6, atol=1e-6)
    _close(tb.rmatvec(torch.as_tensor(r)), jb.rmatvec(jnp.asarray(r)), rtol=1e-5, atol=1e-5)
    _close(tb.rmatvec_sq(torch.as_tensor(r)), jb.rmatvec_sq(jnp.asarray(r)), rtol=1e-5, atol=1e-5)
    _close(tbatch_mod.densify(tb).X, jbatch_mod.densify(jb).X, rtol=0, atol=0)
    assert isinstance(tbatch_mod.maybe_densify(tb), tbatch_mod.DenseBatch)
    assert tbatch_mod.maybe_densify(tb, hbm_budget_bytes=10) is tb
    dense = tbatch_mod.optimize_batch_layout(tb)
    _close(dense.X, jbatch_mod.optimize_batch_layout(jb).X, rtol=0, atol=0)


def test_bf16_matvec_rounds_the_vector_like_the_reference():
    X, *_ = _problem(TaskType.LINEAR_REGRESSION)
    w = np.random.default_rng(5).normal(size=X.shape[1]).astype(np.float32)
    jb = jbatch_mod.DenseBatch(X=jnp.asarray(X, jnp.bfloat16), labels=None, offsets=None, weights=None)
    tb = tbatch_mod.DenseBatch(X=torch.as_tensor(X).bfloat16(), labels=None, offsets=None, weights=None)
    got = tb.matvec(torch.as_tensor(w))
    assert got.dtype == torch.float32
    _close(got, jb.matvec(jnp.asarray(w)), rtol=1e-5, atol=1e-5)


def test_high_dimensional_sparse_layout_is_refused_until_k3_lands():
    # K3 has landed: the shapes the reference tiles now get the port's
    # sparse-kernel layout instead of NotImplementedError
    n, d, k = 1024, 8192, 2
    rng = np.random.default_rng(0)
    batch = tbatch_mod.SparseBatch(
        indices=torch.as_tensor(rng.integers(0, d, size=(n, k))),
        values=torch.ones((n, k)), labels=torch.zeros(n), offsets=torch.zeros(n),
        weights=torch.ones(n), num_features=d,
    )
    out = tbatch_mod.optimize_batch_layout(batch, hbm_budget_bytes=1.0)
    assert isinstance(out, tbatch_mod.TiledSparseBatch)
    w = torch.as_tensor(rng.normal(size=d).astype(np.float32))
    _close(out.matvec(w), batch.matvec(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sparse", [False, True])
def test_summarize_matches_reference(sparse):
    if sparse:
        jb, tb = _sparse_pair()
    else:
        X, y, off, wt = _problem(TaskType.LOGISTIC_REGRESSION)
        jb = jbatch_mod.DenseBatch(
            X=jnp.asarray(X), labels=jnp.asarray(y), offsets=jnp.asarray(off), weights=jnp.asarray(wt)
        )
        tb = dense_batch_from_numpy(X, y, off, wt, device="cpu")
    ref, got = jax_summarize(jb), summarize(tb)
    for field in ("mean", "variance", "min", "max", "max_magnitude", "num_nonzeros"):
        np.testing.assert_allclose(getattr(got, field), getattr(ref, field), rtol=1e-9, atol=1e-12)
    assert got.count == ref.count
