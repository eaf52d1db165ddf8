"""L-BFGS, OWL-QN and TRON: the port's host loops against the JAX package's
device loops on the same small problems. Held to: the same
``ConvergenceReason``, iteration counts within ±1 and w within
rtol = atol = 1e-4.

The tolerances keep each solve's stopping test above the float32
resolution of its objective. Below it, whether a step is accepted turns on
the last bit of a sum whose order differs between XLA and PyTorch, and the
two packages may stop at different iterations (or for different reasons)
at equally good points."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.config import OptimizerConfig as JConfig
from photon_ml_tpu.data.synthetic import synthetic_glm_data as jax_synthetic
from photon_ml_tpu.ops.glm import make_objective as jax_make_objective
from photon_ml_tpu.ops.losses import loss_for_task as jax_loss_for_task
from photon_ml_tpu.optim import lbfgs_minimize as j_lbfgs
from photon_ml_tpu.optim import owlqn_minimize as j_owlqn
from photon_ml_tpu.optim import tron_minimize as j_tron
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.convert import dense_batch_from_numpy
from photon_ml_tpu_torch.ops.glm import make_objective
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optim import (
    ConvergenceReason,
    lbfgs_minimize,
    owlqn_minimize,
    select_minimize_fn,
    tron_minimize,
)
from photon_ml_tpu_torch.types import OptimizerType, TaskType

SOLVERS = {
    "lbfgs": (j_lbfgs, lbfgs_minimize, {}),
    "owlqn": (j_owlqn, owlqn_minimize, {"l1_weight": 0.5}),
    "tron": (j_tron, tron_minimize, {}),
}
TOLERANCE = {
    TaskType.LOGISTIC_REGRESSION: 1e-3,
    TaskType.LINEAR_REGRESSION: 1e-5,
    TaskType.POISSON_REGRESSION: 1e-3,
}


def _objectives(task: TaskType, seed: int, fused: bool = False):
    jb, intercept, _ = jax_synthetic(np.random.default_rng(seed), 300, 11, JTask(task.value))
    tb = dense_batch_from_numpy(np.asarray(jb.X), np.asarray(jb.labels), device="cpu")
    jobj = jax_make_objective(
        jb, jax_loss_for_task(JTask(task.value)), l2_weight=1.0, intercept_index=intercept,
        fused=fused,
    )
    tobj = make_objective(
        tb, loss_for_task(task), l2_weight=1.0, intercept_index=intercept, fused=fused,
        device="cpu",
    )
    return jobj, tobj, jb.num_features


def _assert_same_solve(rj, rt):
    assert rt.reason == int(rj.reason), (rt.reason, int(rj.reason))
    assert abs(rt.iterations - int(rj.iterations)) <= 1, (rt.iterations, int(rj.iterations))
    np.testing.assert_allclose(rt.w.numpy(), np.asarray(rj.w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(rt.value), float(rj.value), rtol=1e-5)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("task", list(TOLERANCE))
def test_solver_matches_reference(task, solver, seed):
    jobj, tobj, d = _objectives(task, seed)
    jf, tf, extra = SOLVERS[solver]
    kw = dict(max_iterations=60, tolerance=TOLERANCE[task])
    rj = jf(jobj, jnp.zeros(d, jnp.float32), JConfig(**kw), **extra)
    rt = tf(tobj, torch.zeros(d), OptimizerConfig(**kw), **extra)
    _assert_same_solve(rj, rt)
    assert rt.objective_passes >= rt.iterations + 1
    hist = rt.loss_history.numpy()
    assert hist.shape == (61,)
    assert np.all(np.isfinite(hist[: rt.iterations + 1])) and np.all(np.isnan(hist[rt.iterations + 1:]))


@pytest.mark.parametrize("solver", ["lbfgs", "tron"])
def test_fused_objective_solves_like_the_pallas_path(solver):
    """``fused=True`` changes L-BFGS's line search to one value+gradient
    pass per trial (``one_pass_value_grad``); the JAX side runs its Pallas
    kernels in interpret mode, the port its kernels' plain versions."""
    task = TaskType.LOGISTIC_REGRESSION
    jobj, tobj, d = _objectives(task, 1, fused=True)
    assert tobj.one_pass_value_grad and jobj.one_pass_value_grad
    jf, tf, extra = SOLVERS[solver]
    kw = dict(max_iterations=40, tolerance=TOLERANCE[task])
    rj = jf(jobj, jnp.zeros(d, jnp.float32), JConfig(**kw), **extra)
    rt = tf(tobj, torch.zeros(d), OptimizerConfig(**kw), **extra)
    _assert_same_solve(rj, rt)
    assert rt.objective_passes == int(rj.objective_passes)


def test_converged_at_start_reports_gradient_converged():
    _, tobj, d = _objectives(TaskType.LINEAR_REGRESSION, 1)
    w = lbfgs_minimize(tobj, torch.zeros(d), OptimizerConfig(tolerance=1e-5)).w
    for fn in (lbfgs_minimize, tron_minimize):
        r = fn(tobj, w, OptimizerConfig(tolerance=1e-2))
        assert r.iterations == 0 and r.reason == ConvergenceReason.GRADIENT_CONVERGED
        assert r.converged and r.objective_passes == 1


def test_select_minimize_fn_rule():
    fn, extra = select_minimize_fn(OptimizerConfig())
    assert fn is lbfgs_minimize and extra == {}
    fn, extra = select_minimize_fn(OptimizerConfig(), l1_weight=0.3)
    assert fn is owlqn_minimize and extra == {"l1_weight": 0.3}
    fn, _ = select_minimize_fn(OptimizerConfig(optimizer_type=OptimizerType.TRON))
    assert fn is tron_minimize
    with pytest.raises(ValueError, match="L1"):
        select_minimize_fn(OptimizerConfig(optimizer_type=OptimizerType.TRON), l1_weight=0.3)
