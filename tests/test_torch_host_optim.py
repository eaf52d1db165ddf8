"""The port's host-driven solvers (``optim/host_lbfgs.py``,
``optim/host_tron.py``) against the JAX package's host twins on the same
streamed chunks: the same stopping reason, iterations within one, and
coefficients within 1e-4, with the stopping tolerance above the float32
floor of ROADMAP queue 3 (1e-3 for logistic and Poisson, whose float32
gradients decide a tighter test by rounding). Also the selection rule's
host branch and its rejections, and the per-iteration callback."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from photon_ml_tpu.config import OptimizerConfig as JConfig
from photon_ml_tpu.ops import streaming as jstreaming
from photon_ml_tpu.ops.losses import loss_for_task as jloss_for_task
from photon_ml_tpu.optim.host_lbfgs import host_lbfgs_minimize as ref_lbfgs
from photon_ml_tpu.optim.host_lbfgs import host_owlqn_minimize as ref_owlqn
from photon_ml_tpu.optim.host_tron import host_tron_minimize as ref_tron
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.ops import streaming
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optim import (
    host_lbfgs_minimize,
    host_owlqn_minimize,
    host_tron_minimize,
    select_minimize_fn,
)
from photon_ml_tpu_torch.types import OptimizerType, TaskType

TOLERANCE = {TaskType.LOGISTIC_REGRESSION: 1e-3, TaskType.POISSON_REGRESSION: 1e-3,
             TaskType.LINEAR_REGRESSION: 1e-5}


def _objectives(task: TaskType, seed: int = 0, n: int = 800, d: int = 8, l2: float = 1.0):
    rng = np.random.default_rng(seed)
    X = (0.5 * rng.normal(size=(n, d))).astype(np.float32)
    X[:, 0] = 1.0
    w_true = rng.normal(size=d)
    m = X @ w_true
    if task is TaskType.LOGISTIC_REGRESSION:
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-m))).astype(np.float32)
    elif task is TaskType.POISSON_REGRESSION:
        y = rng.poisson(np.exp(0.3 * m)).astype(np.float32)
    else:
        y = (m + 0.3 * rng.normal(size=n)).astype(np.float32)
    t = streaming.StreamingGLMObjective(streaming.dense_chunks(X, y, 256), loss_for_task(task), d,
                                        l2_weight=l2, intercept_index=0, device="cpu")
    j = jstreaming.StreamingGLMObjective(jstreaming.dense_chunks(X, y, 256),
                                         jloss_for_task(JTask(task.value)), d, l2_weight=l2,
                                         intercept_index=0)
    return t, j, d


def _agree(got, ref):
    assert got.reason == int(ref.reason)
    assert abs(got.iterations - int(ref.iterations)) <= 1
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0, atol=1e-4)
    assert got.w.dtype == torch.float32 and got.objective_passes >= got.iterations + 1


@pytest.mark.parametrize("task", list(TOLERANCE), ids=lambda t: t.value)
def test_host_lbfgs_matches_the_reference(task):
    t, j, d = _objectives(task)
    tol = TOLERANCE[task]
    got = host_lbfgs_minimize(t, np.zeros(d), OptimizerConfig(max_iterations=50, tolerance=tol))
    ref = ref_lbfgs(j, np.zeros(d), JConfig(max_iterations=50, tolerance=tol))
    _agree(got, ref)
    assert np.isfinite(got.loss_history[: got.iterations + 1].numpy()).all()


@pytest.mark.parametrize("task", [TaskType.LOGISTIC_REGRESSION, TaskType.LINEAR_REGRESSION],
                         ids=lambda t: t.value)
def test_host_owlqn_matches_the_reference(task):
    t, j, d = _objectives(task, seed=3, l2=0.0)
    tol = TOLERANCE[task]
    got = host_owlqn_minimize(t, np.zeros(d), OptimizerConfig(max_iterations=60, tolerance=tol), 8.0)
    ref = ref_owlqn(j, np.zeros(d), JConfig(max_iterations=60, tolerance=tol), 8.0)
    _agree(got, ref)
    assert got.w[0] != 0.0  # the intercept is free of L1
    assert (got.w == 0.0).any() == (np.asarray(ref.w) == 0.0).any()


@pytest.mark.parametrize("task", list(TOLERANCE), ids=lambda t: t.value)
def test_host_tron_matches_the_reference(task):
    t, j, d = _objectives(task, seed=5)
    tol = TOLERANCE[task]
    got = host_tron_minimize(t, np.zeros(d), OptimizerConfig(
        optimizer_type=OptimizerType.TRON, max_iterations=20, tolerance=tol))
    ref = ref_tron(j, np.zeros(d), JConfig(optimizer_type=JOpt.TRON, max_iterations=20, tolerance=tol))
    _agree(got, ref)


def test_iteration_callback_and_warm_start():
    t, _, d = _objectives(TaskType.LOGISTIC_REGRESSION, seed=2)
    seen = []
    cfg = OptimizerConfig(max_iterations=5, tolerance=0.0)
    res = host_lbfgs_minimize(t, np.zeros(d), cfg, iteration_callback=lambda it, w, f: seen.append((it, w, f)))
    assert [s[0] for s in seen] == list(range(1, res.iterations + 1))
    assert all(s[1].dtype == np.float64 for s in seen)
    np.testing.assert_allclose(seen[-1][1].astype(np.float32), res.w.numpy())
    tron_seen = []
    host_tron_minimize(t, res.w, OptimizerConfig(optimizer_type=OptimizerType.TRON, max_iterations=2,
                                                 tolerance=0.0),
                       iteration_callback=lambda it, w, f: tron_seen.append(it))
    assert tron_seen == [1, 2]


def test_host_selection_rule():
    lbfgs = OptimizerConfig()
    tron = OptimizerConfig(optimizer_type=OptimizerType.TRON)
    assert select_minimize_fn(lbfgs, host=True) == (host_lbfgs_minimize, {})
    assert select_minimize_fn(lbfgs, 0.5, host=True) == (host_owlqn_minimize, {"l1_weight": 0.5})
    assert select_minimize_fn(tron, host=True) == (host_tron_minimize, {})
    with pytest.raises(ValueError, match="TRON does not support L1"):
        select_minimize_fn(tron, 0.5, host=True)
    with pytest.raises(ValueError, match="device-resident small-d solver"):
        select_minimize_fn(OptimizerConfig(optimizer_type=OptimizerType.NEWTON_CHOLESKY), host=True)
    fn, _ = select_minimize_fn(lbfgs)
    assert fn is not host_lbfgs_minimize
