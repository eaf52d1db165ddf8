"""Host-driven L-BFGS and OWL-QN for streamed objectives (port of
``photon_ml_tpu/optim/host_lbfgs.py``).

The reference's optimizer loop is host-driven (Breeze L-BFGS / OWL-QN on
the Spark driver, each value-and-gradient evaluation fanned out over the
executors). This loop exists for objectives that stream the data through
the card on every evaluation (``ops/streaming.py``
``StreamingGLMObjective``); data that fits the card takes
``optim/lbfgs.py``.

The math is ``lbfgs.py``'s: the ring-buffer two-loop recursion, Armijo
backtracking on the (orthant-projected) actual step with a safeguarded
quadratic interpolation, OWL-QN's pseudo-gradient, orthant-constrained
direction and sign-projected trial points, the same convergence tests and
``OptimizationResult``. The recursion runs in float64 numpy on the host,
as in the reference; each evaluation reads the value and the gradient back
once, as one float32 vector. Each iteration emits an ``optim_iter``
telemetry record and each solve an ``optim_result`` (``obs``; no-ops with
no sink).

Over a feature-range-sharded objective (``PHOTON_FE_SHARD``) the vectors
are this process's segment, and every dot, norm and L1 sum the loop
branches on is the objective's global ``fe_dot``, the same on every
process, so the processes' line searches stay in lock step. Other
objectives keep plain local numpy, bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.obs import REGISTRY, emit_event
from photon_ml_tpu_torch.optim.common import ConvergenceReason, OptimizationResult

_ARMIJO_C1 = 1e-4
_BACKTRACK = 0.5
_CURVATURE_EPS = 1e-10


def global_dot(objective: Any):
    """The objective's global inner product when its vectors are a
    feature-range segment (``fe_active``), else None."""
    return objective.fe_dot if getattr(objective, "fe_active", False) else None


def scalar_reductions(objective: Any):
    """(dot, norm) for the host loops: plain numpy on full-space vectors;
    the global ``fe_dot`` and the norm through it on segments."""
    fe_dot = global_dot(objective)
    if fe_dot is None:
        return (lambda a, b: float(np.dot(a, b))), (lambda x: float(np.linalg.norm(x)))
    return fe_dot, (lambda x: float(np.sqrt(max(fe_dot(x, x), 0.0))))


def objective_device(objective: Any) -> torch.device:
    """Where the objective computes: its ``device``, else its batch's."""
    dev = getattr(objective, "device", None)
    return torch.device(dev) if dev is not None else objective.batch.device


def to_device(w: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(w, np.float32), device=dev)


def read_value_and_grad(objective: Any, w: np.ndarray, dev: torch.device) -> tuple[float, np.ndarray]:
    """One evaluation, read back once: (value, gradient in float64)."""
    v, g = objective.value_and_grad(to_device(w, dev))
    host = torch.cat([v.reshape(1).float(), g.float()]).cpu().numpy().astype(np.float64)
    return float(host[0]), host[1:]


def result_record(w, f, gnorm, it, reason, loss_hist, gnorm_hist, passes, dev,
                  algorithm: str) -> OptimizationResult:
    """The solve's result on ``dev``, and its telemetry: the
    ``optim.iterations`` histogram, the ``optim.reason.<NAME>`` counter and
    one ``optim_result`` event (from the host's values: no read-back)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    REGISTRY.histogram_observe("optim.iterations", it)
    REGISTRY.counter_inc(f"optim.reason.{reason.name}")
    emit_event("optim_result", algorithm=algorithm, reason=reason.name, iterations=int(it),
               value=float(np.float32(f)), grad_norm=float(np.float32(gnorm)), objective_passes=int(passes))
    return OptimizationResult(
        w=f32(w), value=f32(f), grad_norm=f32(gnorm), iterations=int(it), reason=int(reason),
        loss_history=f32(loss_hist), grad_norm_history=f32(gnorm_hist), objective_passes=passes,
    )


def _pseudo_gradient(w: np.ndarray, g: np.ndarray, l1w: np.ndarray) -> np.ndarray:
    """OWL-QN pseudo-gradient (minimal-norm subgradient of f + Σ l1ⱼ|wⱼ|)."""
    gp = g + l1w
    gm = g - l1w
    at_zero = np.where(gp < 0.0, gp, np.where(gm > 0.0, gm, 0.0))
    return np.where(w > 0.0, gp, np.where(w < 0.0, gm, at_zero))


def host_lbfgs_minimize(
    objective: Any,
    w0,
    config: OptimizerConfig,
    history: int | None = None,
    iteration_callback: Any = None,
    l1_weight: np.ndarray | None = None,
) -> OptimizationResult:
    """Minimize ``objective`` (anything with ``value_and_grad(w)``, e.g. a
    ``StreamingGLMObjective``) by L-BFGS driven from the host; with
    ``l1_weight`` (a per-coordinate L1 vector) the loop is OWL-QN. Each
    line-search trial costs one value-and-gradient pass (usually one per
    iteration: the accepted trial's gradient is the next iterate's).

    ``iteration_callback(it, w, value)`` fires after every accepted
    iteration with the host float64 ``w`` (the streamed sweep's checkpoint
    hook). A resume restarts from a saved ``w`` with a fresh history."""
    dev = objective_device(objective)
    w = np.asarray(torch.as_tensor(w0).cpu().numpy() if isinstance(w0, torch.Tensor) else w0, np.float64)
    d = w.shape[0]
    max_iter = config.max_iterations
    tol = config.tolerance
    history = config.history_length if history is None else history
    max_ls = config.max_line_search_steps
    use_l1 = l1_weight is not None
    algorithm = "owlqn" if use_l1 else "lbfgs"
    l1w = np.asarray(l1_weight, np.float64) if use_l1 else None
    passes = 0
    dot, nrm = scalar_reductions(objective)
    fe_dot = global_dot(objective)
    l1sum = ((lambda w_: float(np.sum(l1w * np.abs(w_)))) if fe_dot is None
             else (lambda w_: fe_dot(l1w, np.abs(w_))))

    def vg(w_):
        nonlocal passes
        passes += 1
        f_, g_ = read_value_and_grad(objective, w_, dev)
        if use_l1:
            f_ += l1sum(w_)
            pg_ = _pseudo_gradient(np.asarray(w_, np.float64), g_, l1w)
        else:
            pg_ = g_
        return f_, g_, pg_

    f, g, pg = vg(w)
    g0_norm = nrm(pg)
    loss_hist = np.full(max_iter + 1, np.nan)
    gnorm_hist = np.full(max_iter + 1, np.nan)
    loss_hist[0], gnorm_hist[0] = f, g0_norm

    S = np.zeros((history, d))
    Y = np.zeros((history, d))
    rho = np.zeros(history)
    count = 0

    def converged_grad(gn):
        return gn <= tol * max(1.0, g0_norm)

    reason = ConvergenceReason.MAX_ITERATIONS
    it = 0
    if converged_grad(g0_norm):
        reason = ConvergenceReason.GRADIENT_CONVERGED
        max_iter = 0

    while it < max_iter:
        # two-loop recursion over the ring buffer, on the pseudo-gradient
        q = pg.copy()
        m = min(count, history)
        alphas = np.zeros(history)
        for j in range(m):
            i = (count - 1 - j) % history
            alphas[i] = rho[i] * dot(S[i], q)
            q -= alphas[i] * Y[i]
        if m > 0:
            last = (count - 1) % history
            gamma = dot(S[last], Y[last]) / max(dot(Y[last], Y[last]), 1e-300)
            q *= gamma
        for j in range(m - 1, -1, -1):
            i = (count - 1 - j) % history
            beta = rho[i] * dot(Y[i], q)
            q += (alphas[i] - beta) * S[i]
        p = -q

        if use_l1:
            p = np.where(p * (-pg) > 0.0, p, 0.0)  # the descent orthant
        if dot(p, pg) >= 0:  # not a descent direction: steepest descent
            p = -pg

        if use_l1:
            xi = np.where(w != 0.0, np.sign(w), np.sign(-pg))

            def trial_point(t):
                x = w + t * p
                return np.where(np.sign(x) == xi, x, 0.0)
        else:

            def trial_point(t):
                return w + t * p

        # the first iteration's identity Hessian guess: a unit-length step
        step = 1.0 if count > 0 else 1.0 / max(1.0, nrm(p))

        # Armijo backtracking on the actual (projected) step: the first
        # trial and up to max_ls refinements by the safeguarded quadratic
        # interpolation of optim/lbfgs.py, every trial a value-and-gradient
        # pass (its gradient is needed at acceptance anyway)
        accepted = False
        slope0 = dot(pg, p)
        for _ in range(max_ls + 1):
            w_try = trial_point(step)
            f_try, g_try, pg_try = vg(w_try)
            rhs = f + _ARMIJO_C1 * dot(pg, w_try - w)
            if f_try <= rhs and not np.isnan(f_try):
                accepted = True
                break
            denom = 2.0 * (f_try - f - slope0 * step)
            t_q = -slope0 * step * step / denom if denom > 0 else _BACKTRACK * step
            if not np.isfinite(t_q):
                t_q = _BACKTRACK * step
            step = min(max(t_q, 0.1 * step), _BACKTRACK * step)
        if not accepted:
            reason = ConvergenceReason.LINE_SEARCH_FAILED
            break

        s, y = w_try - w, g_try - g
        sy = dot(s, y)
        if sy > _CURVATURE_EPS:
            i = count % history
            S[i], Y[i], rho[i] = s, y, 1.0 / sy
            count += 1
        f_prev = f
        w, f, g, pg = w_try, f_try, g_try, pg_try
        it += 1
        gn = nrm(pg)
        loss_hist[it], gnorm_hist[it] = f, gn
        # one record an iteration (a no-op with no sink)
        emit_event("optim_iter", algorithm=algorithm, it=it, loss=f, grad_norm=gn)
        if iteration_callback is not None:
            iteration_callback(it, w, f)
        if converged_grad(gn):
            reason = ConvergenceReason.GRADIENT_CONVERGED
            break
        if abs(f_prev - f) <= tol * max(1.0, abs(f_prev)):
            reason = ConvergenceReason.OBJECTIVE_CONVERGED
            break

    return result_record(w, f, nrm(pg), it, reason, loss_hist, gnorm_hist, passes, dev, algorithm)


def host_owlqn_minimize(
    objective: Any,
    w0,
    config: OptimizerConfig,
    l1_weight: float,
    history: int | None = None,
    iteration_callback: Any = None,
) -> OptimizationResult:
    """OWL-QN driven from the host, with the device ``owlqn_minimize``'s
    call shape: scalar ``l1_weight`` over ``objective.reg_mask`` (the
    intercept stays free of L1)."""
    mask = objective.reg_mask
    mask = mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
    return host_lbfgs_minimize(
        objective, w0, config, history=history, iteration_callback=iteration_callback,
        l1_weight=float(l1_weight) * mask.astype(np.float64),
    )
