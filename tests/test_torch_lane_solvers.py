"""L-BFGS, OWL-QN and TRON over entity lanes: the port's lock-step lane
solvers against ``jax.vmap`` of the JAX package's ``lbfgs_minimize``,
``owlqn_minimize`` and ``tron_minimize`` on ``make_objective`` lanes, on
logistic, linear and Poisson buckets, cold and with normalization, a warm
start and a per-lane prior. Held to: w within rtol = atol = 1e-4, the same
``ConvergenceReason``, iterations within ±1 per lane and equal
``objective_passes`` where the iterations are equal (the reference's count
for a lane objective, which is not one-pass: 1 + Σ (2 + line-search
steps) for L-BFGS and OWL-QN, 1 + Σ (CG steps + 1) for TRON).

Also: one lane equals the port's single-GLM solver within 1e-5; sparse
lanes equal dense lanes on the same values within 1e-5; the sparse lane
objective equals the dense one; ``train_random_effects`` on a sparse shard
equals the reference's; and a GLMM fit whose random effects keep the
default optimizer (L-BFGS) matches the reference's at atol 1e-3.

Stopping tolerances: 1e-3 for logistic and Poisson, 1e-4 for linear, above
the float32 floor of these fixtures. At 1e-5 a linear lane (noise 0.1,
objective about 0.2) reaches its gradient tolerance only after the decrease
a step can still make falls below 1e-7·|f|, where L-BFGS stops on the
"hopeless" test: lanes then flip between GRADIENT_CONVERGED and
LINE_SEARCH_FAILED with the order of a sum, between the port's own sparse
and dense lanes as between the port and the reference (ROADMAP queue 3)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.config import OptimizerConfig as JConfig
from photon_ml_tpu.game import data as jdata
from photon_ml_tpu.game.random_effect import train_random_effects as j_train
from photon_ml_tpu.normalization import NormalizationContext as JNorm
from photon_ml_tpu.ops.batch import DenseBatch as JDense
from photon_ml_tpu.ops.glm import GaussianPrior as JPrior
from photon_ml_tpu.ops.glm import make_objective as j_make_objective
from photon_ml_tpu.ops.losses import loss_for_task as j_loss_for_task
from photon_ml_tpu.optim.lbfgs import lbfgs_minimize as j_lbfgs
from photon_ml_tpu.optim.lbfgs import owlqn_minimize as j_owlqn
from photon_ml_tpu.optim.tron import tron_minimize as j_tron
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.game.random_effect import train_random_effects
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.batch import DenseBatch, SparseBatch
from photon_ml_tpu_torch.ops.glm import make_lane_objective, make_objective
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optim import lbfgs_minimize, owlqn_minimize, select_minimize_fn, tron_minimize
from photon_ml_tpu_torch.optim.newton import newton_minimize
from photon_ml_tpu_torch.types import OptimizerType, TaskType

TASKS = [TaskType.LOGISTIC_REGRESSION, TaskType.LINEAR_REGRESSION, TaskType.POISSON_REGRESSION]
TOLERANCE = {
    TaskType.LOGISTIC_REGRESSION: 1e-3,
    TaskType.LINEAR_REGRESSION: 1e-4,
    TaskType.POISSON_REGRESSION: 1e-3,
}
L1 = 0.3
# solver name → (reference, port, extra keyword arguments)
SOLVERS = {
    "LBFGS": (j_lbfgs, lbfgs_minimize, {}),
    "OWLQN": (j_owlqn, owlqn_minimize, {"l1_weight": L1}),
    "TRON": (j_tron, tron_minimize, {}),
}


def _bucket(task: TaskType, seed: int, k: int = 6, C: int = 24, d: int = 4):
    """(X, y, offsets, weights) of shape (k, C, d) / (k, C): k entity lanes
    with their own coefficients, lane i keeping C - 3i rows and the last
    lane all padding."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(k, C, d)).astype(np.float32)
    X[:, :, -1] = 1.0  # an intercept column
    w = (rng.normal(size=(k, d)) * 0.5).astype(np.float32)
    off = (0.1 * rng.normal(size=(k, C))).astype(np.float32)
    m = np.einsum("kcd,kd->kc", X, w) + off
    if task is TaskType.LOGISTIC_REGRESSION:
        y = (rng.uniform(size=(k, C)) < 1 / (1 + np.exp(-m))).astype(np.float32)
    elif task is TaskType.LINEAR_REGRESSION:
        y = (m + 0.1 * rng.normal(size=(k, C))).astype(np.float32)
    else:
        y = rng.poisson(np.exp(np.clip(m, -5, 2))).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=(k, C)).astype(np.float32)
    for i in range(k):
        keep = max(C - 3 * i, 0) if i < k - 1 else 0
        for a in (wt, y, off):
            a[i, keep:] = 0.0
        X[i, keep:] = 0.0
    return X, y, off, wt


def _variant(task: TaskType, variant: str):
    """The bucket and the solve's settings: "cold" (λ 1, intercept 3, zero
    start), "ring" (the same with a history of 3 pairs, so each lane's
    ring wraps) or "warm" (normalization, warm start and a per-lane prior,
    λ 0.7, intercept 2)."""
    if variant in ("cold", "ring"):
        X, y, off, wt = _bucket(task, seed=21)
        return dict(data=(X, y, off, wt), l2=1.0, intercept=3, w0=np.zeros((6, 4), np.float32),
                    norm=None, prior=None, history=3 if variant == "ring" else 10)
    X, y, off, wt = _bucket(task, seed=22, k=5, C=16, d=3)
    rng = np.random.default_rng(3)
    w0 = (0.3 * rng.normal(size=(5, 3))).astype(np.float32)
    mu = (0.2 * rng.normal(size=(5, 3))).astype(np.float32)
    var = rng.uniform(0.1, 2.0, size=(5, 3)).astype(np.float32)
    norm = (np.array([0.5, 2.0, 1.0], np.float32), np.array([0.1, -0.2, 0.0], np.float32))
    return dict(data=(X, y, off, wt), l2=0.7, intercept=2, w0=w0, norm=norm, prior=(mu, var),
                history=10)


def _config(task: TaskType, solver: str, history: int = 10) -> dict:
    opt = "TRON" if solver == "TRON" else "LBFGS"
    return dict(optimizer_type=opt, max_iterations=50, tolerance=TOLERANCE[task],
                history_length=history)


def _jax_lanes(task, solver, v):
    j_fn, _, extra = SOLVERS[solver]
    cfg = _config(task, solver, v["history"])
    jcfg = JConfig(**{**cfg, "optimizer_type": JOpt(cfg["optimizer_type"])})
    loss = j_loss_for_task(JTask(task.value))
    norm = None if v["norm"] is None else JNorm(jnp.asarray(v["norm"][0]), jnp.asarray(v["norm"][1]),
                                                v["intercept"])

    def one(Xe, ye, oe, we, w0e, mu, var):
        pr = None if mu is None else JPrior(means=mu, variances=var)
        obj = j_make_objective(JDense(X=Xe, labels=ye, offsets=oe, weights=we), loss,
                               l2_weight=v["l2"], norm=norm, intercept_index=v["intercept"], prior=pr)
        return j_fn(obj, w0e, jcfg, **extra)

    mu, var = (None, None) if v["prior"] is None else v["prior"]
    axes = (0, 0, 0, 0, 0, None if mu is None else 0, None if var is None else 0)
    args = [jnp.asarray(a) for a in (*v["data"], v["w0"])]
    args += [None if a is None else jnp.asarray(a) for a in (mu, var)]
    return jax.vmap(one, in_axes=axes)(*args)


def _lane_objective(task, v, sparse: bool = False):
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    X, y, off, wt = v["data"]
    if sparse:
        batch = _as_sparse(X, y, off, wt)
    else:
        batch = DenseBatch(X=t(X), labels=t(y), offsets=t(off), weights=t(wt))
    norm = None if v["norm"] is None else NormalizationContext(t(v["norm"][0]), t(v["norm"][1]),
                                                               v["intercept"])
    mu, var = (None, None) if v["prior"] is None else v["prior"]
    return make_lane_objective(batch, loss_for_task(task), l2_weight=v["l2"], norm=norm,
                               intercept_index=v["intercept"], prior_mean=t(mu),
                               prior_variances=t(var))


def _as_sparse(X, y, off, wt):
    """The same values as a (k, C, d + 1) ``SparseBatch``: every column in
    a shuffled order per row, plus one padding entry (index 0, value 0)."""
    k, C, d = X.shape
    rng = np.random.default_rng(5)
    order = np.argsort(rng.uniform(size=(k, C, d)), axis=-1)
    idx = np.concatenate([order, np.zeros((k, C, 1), np.int64)], axis=-1)
    val = np.concatenate([np.take_along_axis(X, order, axis=-1), np.zeros((k, C, 1), np.float32)],
                         axis=-1)
    t = torch.as_tensor
    return SparseBatch(indices=t(idx), values=t(val), labels=t(y), offsets=t(off), weights=t(wt),
                       num_features=d)


@pytest.fixture(scope="module")
def reference():
    """Vmapped reference solves, each compiled once for the module."""
    cache = {}

    def get(task, solver, variant):
        key = (task, solver, variant)
        if key not in cache:
            cache[key] = _jax_lanes(task, solver, _variant(task, variant))
        return cache[key]

    return get


def _assert_lanes_agree(jres, tres):
    np.testing.assert_allclose(tres.w.numpy(), np.asarray(jres.w), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tres.reason.numpy(), np.asarray(jres.reason))
    it_j, it_t = np.asarray(jres.iterations), tres.iterations.numpy()
    assert np.all(np.abs(it_j - it_t) <= 1), (it_j, it_t)
    same = it_j == it_t
    np.testing.assert_array_equal(tres.objective_passes.numpy()[same],
                                  np.asarray(jres.objective_passes)[same])
    lh_j, lh_t = np.asarray(jres.loss_history), tres.loss_history.numpy()
    for lane, it in enumerate(it_t):
        assert np.isfinite(lh_t[lane, : it + 1]).all() and np.isnan(lh_t[lane, it + 1:]).all()
        common = min(it, it_j[lane]) + 1
        np.testing.assert_allclose(lh_t[lane, :common], lh_j[lane, :common], rtol=1e-4, atol=1e-4)


# TRON keeps no curvature history: no "ring" case
@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("solver,variant", [
    (solver, variant) for solver in SOLVERS for variant in ("cold", "warm", "ring")
    if (solver, variant) != ("TRON", "ring")
])
def test_lanes_match_vmapped_reference(reference, solver, variant, task):
    v = _variant(task, variant)
    _, fn, extra = SOLVERS[solver]
    tres = fn(_lane_objective(task, v), torch.as_tensor(v["w0"]), _port_config(task, solver, v["history"]),
              **extra)
    _assert_lanes_agree(reference(task, solver, variant), tres)
    if variant == "ring":
        assert int(tres.iterations.max()) > 3  # some lane's ring wrapped
    if variant == "cold":
        # the fully padded lane is converged at its start
        assert int(tres.iterations[-1]) == 0 and int(tres.reason[-1]) == 1
        assert int(tres.objective_passes[-1]) == 1


def _port_config(task, solver, history: int = 10) -> OptimizerConfig:
    cfg = _config(task, solver, history)
    return OptimizerConfig(**{**cfg, "optimizer_type": OptimizerType(cfg["optimizer_type"])})


@pytest.mark.parametrize("history", [10, 2])
@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_one_lane_equals_the_single_glm_solver(solver, task, history):
    """A one-lane bucket against the port's single-GLM solver on the same
    rows: the lane's history ring (also wrapping, with 2 pairs), line
    search and CG are the single solver's."""
    X, y, off, wt = _bucket(task, seed=23, k=1, C=64, d=5)
    _, fn, extra = SOLVERS[solver]
    cfg = _port_config(task, solver, history)
    lane = fn(make_lane_objective(
        DenseBatch(X=torch.as_tensor(X), labels=torch.as_tensor(y), offsets=torch.as_tensor(off),
                   weights=torch.as_tensor(wt)),
        loss_for_task(task), l2_weight=0.5, intercept_index=4), torch.zeros((1, 5)), cfg, **extra)
    single = fn(make_objective(
        DenseBatch(X=torch.as_tensor(X[0]), labels=torch.as_tensor(y[0]),
                   offsets=torch.as_tensor(off[0]), weights=torch.as_tensor(wt[0])),
        loss_for_task(task), l2_weight=0.5, intercept_index=4, device="cpu"), torch.zeros(5), cfg,
        **extra)
    np.testing.assert_allclose(lane.w[0].numpy(), single.w.numpy(), rtol=1e-5, atol=1e-5)
    assert int(lane.iterations[0]) == single.iterations and int(lane.reason[0]) == single.reason
    assert int(lane.objective_passes[0]) == single.objective_passes
    np.testing.assert_allclose(lane.loss_history[0].numpy(), single.loss_history.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_sparse_lanes_equal_dense_lanes(solver, task):
    v = _variant(task, "warm")
    _, fn, extra = SOLVERS[solver]
    cfg = _port_config(task, solver)
    dense = fn(_lane_objective(task, v), torch.as_tensor(v["w0"]), cfg, **extra)
    sparse = fn(_lane_objective(task, v, sparse=True), torch.as_tensor(v["w0"]), cfg, **extra)
    np.testing.assert_allclose(sparse.w.numpy(), dense.w.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(sparse.reason, dense.reason)
    assert torch.all((sparse.iterations - dense.iterations).abs() <= 1)


def test_sparse_lane_objective_equals_dense():
    """Every contract of the sparse lane objective (with normalization and
    a prior) against the dense one on the same values; the full Hessian
    raises the reference's message."""
    task = TaskType.POISSON_REGRESSION
    v = _variant(task, "warm")
    dense, sparse = _lane_objective(task, v), _lane_objective(task, v, sparse=True)
    rng = np.random.default_rng(4)
    w = torch.as_tensor((0.3 * rng.normal(size=(5, 3))).astype(np.float32))
    p = torch.as_tensor(rng.normal(size=(5, 3)).astype(np.float32))
    for name, args in (("value", (w,)), ("value_and_grad", (w,)), ("hvp", (w, p)),
                       ("hessian_diag", (w,)), ("margins", (w,)), ("direction_margins", (p,))):
        got, want = getattr(sparse, name)(*args), getattr(dense, name)(*args)
        for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    with pytest.raises(NotImplementedError, match="full Hessian requires a DenseBatch"):
        sparse.hessian(w)
    with pytest.raises(NotImplementedError, match="full Hessian requires a DenseBatch"):
        newton_minimize(sparse, w, OptimizerConfig(optimizer_type=OptimizerType.NEWTON_CHOLESKY))


def test_selection_rule():
    """``select_minimize_fn``: TRON when configured (refusing L1), OWL-QN
    under L1, L-BFGS otherwise, Newton refusing L1; each takes lanes."""
    lbfgs, tron = OptimizerConfig(), OptimizerConfig(optimizer_type=OptimizerType.TRON)
    assert select_minimize_fn(lbfgs) == (lbfgs_minimize, {})
    assert select_minimize_fn(lbfgs, 0.5) == (owlqn_minimize, {"l1_weight": 0.5})
    assert select_minimize_fn(tron) == (tron_minimize, {})
    with pytest.raises(ValueError, match="L1"):
        select_minimize_fn(tron, 0.5)
    with pytest.raises(ValueError, match="L1"):
        select_minimize_fn(OptimizerConfig(optimizer_type=OptimizerType.NEWTON_CHOLESKY), 0.5)
    obj = make_objective(DenseBatch(X=torch.ones((4, 2)), labels=torch.zeros(4),
                                    offsets=torch.zeros(4), weights=torch.ones(4)),
                         loss_for_task(TaskType.LINEAR_REGRESSION), device="cpu")
    with pytest.raises(TypeError, match="LaneGLMObjective"):
        lbfgs_minimize(obj, torch.zeros((2, 2)), lbfgs)


def _re_problem(seed, n=240, d=4, E=12, nnz_pad=2):
    """Zipf-skewed entity ids and a sparse shard of d features a row
    (shuffled) plus ``nnz_pad`` padding entries, logistic labels."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, E + 1) ** 1.2
    ids = rng.choice(E, size=n, p=p / p.sum()).astype(np.int32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, -1] = 1.0
    W = (0.7 * rng.normal(size=(E, d))).astype(np.float32)
    off = (0.2 * rng.normal(size=n)).astype(np.float32)
    m = np.sum(W[ids] * X, axis=1) + off
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    wt = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    order = np.argsort(rng.uniform(size=(n, d)), axis=-1)
    idx = np.concatenate([order, np.zeros((n, nnz_pad), np.int64)], axis=-1)
    val = np.concatenate([np.take_along_axis(X, order, -1), np.zeros((n, nnz_pad), np.float32)], -1)
    return ids, idx, val, X, y, off, wt


@pytest.mark.parametrize("solver,l1", [("LBFGS", 0.0), ("TRON", 0.0), ("LBFGS", 0.5)],
                         ids=["lbfgs", "tron", "owlqn"])
def test_sparse_random_effects_match_reference(solver, l1):
    ids, idx, val, X, y, off, wt = _re_problem(seed=31)
    E, d = 12, 4
    cfg = dict(max_iterations=50, tolerance=1e-3)
    jb = jdata.bucket_entities(jdata.group_by_entity(ids, num_entities=E))
    tb = tdata.bucket_entities(tdata.group_by_entity(ids, num_entities=E))
    loss = TaskType.LOGISTIC_REGRESSION
    jres = j_train(jdata.SparseFeatures(jnp.asarray(idx.astype(np.int32)), jnp.asarray(val), d),
                   y, off, wt, jb, E, j_loss_for_task(JTask(loss.value)),
                   JConfig(optimizer_type=JOpt(solver), **cfg), l2_weight=1.0, l1_weight=l1,
                   intercept_index=3)
    tres = train_random_effects(tdata.SparseFeatures(torch.as_tensor(idx), torch.as_tensor(val), d),
                                y, off, wt, tb, E, loss_for_task(loss),
                                OptimizerConfig(optimizer_type=OptimizerType(solver), **cfg),
                                l2_weight=1.0, l1_weight=l1, intercept_index=3, device="cpu")
    np.testing.assert_allclose(tres.coefficients.numpy(), np.asarray(jres.coefficients), atol=1e-4)
    np.testing.assert_allclose(tres.loss_values, np.asarray(jres.loss_values), rtol=1e-4, atol=1e-4)
    assert np.all(np.abs(tres.iterations - jres.iterations) <= 1)
    np.testing.assert_array_equal(tres.converged, jres.converged)
    # the same shard handed over dense trains to the same coefficients
    dense = train_random_effects(tdata.DenseFeatures(torch.as_tensor(X)), y, off, wt, tb, E,
                                 loss_for_task(loss),
                                 OptimizerConfig(optimizer_type=OptimizerType(solver), **cfg),
                                 l2_weight=1.0, l1_weight=l1, intercept_index=3, device="cpu")
    np.testing.assert_allclose(tres.coefficients.numpy(), dense.coefficients.numpy(), atol=1e-5)
