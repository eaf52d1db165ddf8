"""Damped Newton with exact Cholesky solves, over lanes of small-d GLMs
(port of ``photon_ml_tpu/optim/newton.py``).

The reference runs one ``lax.while_loop`` per GLM and ``jax.vmap``s it over
a bucket's entity lanes. Here one host loop steps all k lanes in lockstep:
each iteration builds every lane's (d, d) Hessian with one batched product,
factors them with one batched ``torch.linalg.cholesky_ex``, evaluates the
whole K-step Armijo ladder from stored margins, and freezes the lanes that
are done with ``torch.where``, as the vmapped loop does. The loop ends when
every lane is done or T iterations have run; it reads back one boolean per
iteration. Each lane keeps the reference's per-lane results: iterations,
reason, ``loss_history`` / ``grad_norm_history`` (NaN past the lane's last
iterate) and ``objective_passes`` (1 + 3 per iteration: the Hessian
contraction, the direction's matvec and the gradient's contraction; the
ladder reads stored margins only).

Semantics as the reference: the first Armijo-acceptable step of
t ∈ {1, 1/2, ..., 2^-(K-1)} wins; no acceptable step stops the lane with
LINE_SEARCH_FAILED; the Newton decrement test −gᵀp <= 1e-7·max(1, |f|)
stops it with OBJECTIVE_CONVERGED (after the step is taken); a Levenberg
jitter of 1e-8 keeps the factorization positive definite without L2; a
lane whose factorization fails, or whose step is not finite, steps along
−g. The reference's unrolled small-d Cholesky was a workaround for the
TPU's linear-algebra custom calls and is not carried over.
"""

from __future__ import annotations

from typing import Any

import torch

from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.ops.glm import FULL_HESSIAN_NEEDS_DENSE, LaneGLMObjective, lanes_of
from photon_ml_tpu_torch.optim.common import ConvergenceReason, OptimizationResult

Tensor = torch.Tensor

_JITTER = 1e-8  # Levenberg floor: keeps the Cholesky PD without L2


def newton_minimize(objective: Any, w0: Tensor, config: OptimizerConfig) -> OptimizationResult:
    """Minimize with damped Newton. ``objective`` is a ``LaneGLMObjective``
    with ``w0`` of shape (k, d): the result's fields are then per lane
    (``w`` (k, d), ``value`` (k,), ``iterations`` / ``reason`` /
    ``objective_passes`` (k,) int64 tensors, histories (k, T + 1)). A
    dense single-GLM objective (``GLMObjective``) with ``w0`` of shape (d,)
    is solved as one lane and returns the single-solve result (Python ints,
    (d,) ``w``)."""
    if w0.dim() == 1:
        res = _newton_lanes(lanes_of(objective), w0.unsqueeze(0), config)
        return OptimizationResult(
            w=res.w[0], value=res.value[0], grad_norm=res.grad_norm[0],
            iterations=int(res.iterations[0]), reason=int(res.reason[0]),
            loss_history=res.loss_history[0], grad_norm_history=res.grad_norm_history[0],
            objective_passes=int(res.objective_passes[0]),
        )
    if not isinstance(objective, LaneGLMObjective):
        raise TypeError("a (k, d) start needs a LaneGLMObjective")
    if not objective.dense:
        raise NotImplementedError(FULL_HESSIAN_NEEDS_DENSE)
    return _newton_lanes(objective, w0, config)


def _newton_lanes(obj: LaneGLMObjective, w0: Tensor, config: OptimizerConfig) -> OptimizationResult:
    T = int(config.max_iterations)
    K = max(int(config.max_line_search_steps), 1)
    k, d = w0.shape
    dev, dtype = w0.device, w0.dtype
    ts = 0.5 ** torch.arange(K, dtype=dtype, device=dev)
    eye = torch.eye(d, dtype=dtype, device=dev)
    tol = config.tolerance

    w = w0
    m = obj.margins(w)
    f, g = obj.value_and_grad_from_margins(m, w)
    g0_norm = torch.linalg.norm(g, dim=-1)
    g_tol = tol * torch.clamp_min(g0_norm, 1.0)
    loss_hist = torch.full((k, T + 1), float("nan"), dtype=dtype, device=dev)
    gnorm_hist = torch.full((k, T + 1), float("nan"), dtype=dtype, device=dev)
    loss_hist[:, 0] = f
    gnorm_hist[:, 0] = g0_norm
    it = torch.zeros(k, dtype=torch.int64, device=dev)
    reason = torch.full((k,), int(ConvergenceReason.MAX_ITERATIONS), dtype=torch.int64, device=dev)
    done = g0_norm <= g_tol

    step = 0
    while step < T and not bool(done.all()):
        active = ~done
        H = obj.hessian_from_margins(m, w) + _JITTER * eye
        L, info = torch.linalg.cholesky_ex(H)
        p = -torch.cholesky_solve(g.unsqueeze(-1), L).squeeze(-1)
        # a failed factorization falls back to steepest descent
        bad = (info != 0) | ~torch.isfinite(p).all(dim=-1)
        p = torch.where(bad.unsqueeze(-1), -g, p)
        gTp = torch.sum(g * p, dim=-1)
        # the quadratic model promises ~(-gTp)/2 of decrease: below the
        # float32 resolution of f further steps only walk the rounding plateau
        plateau = -gTp <= 1e-7 * torch.clamp_min(torch.abs(f), 1.0)

        dm = obj.direction_margins(p)
        fs = obj.ray_values_from_margins(m, dm, w, p, ts)  # (k, K)
        armijo = fs <= f.unsqueeze(-1) + 1e-4 * ts * gTp.unsqueeze(-1)
        ok_any = armijo.any(dim=-1)
        t = ts[torch.argmax(armijo.to(torch.int8), dim=-1)]  # first acceptable step
        w_new = w + t.unsqueeze(-1) * p
        m_new = m + t.unsqueeze(-1) * dm
        f_new, g_new = obj.value_and_grad_from_margins(m_new, w_new)

        take = ok_any & active  # done lanes stay frozen, as under vmap
        w = torch.where(take.unsqueeze(-1), w_new, w)
        m = torch.where(take.unsqueeze(-1), m_new, m)
        f = torch.where(take, f_new, f)
        g = torch.where(take.unsqueeze(-1), g_new, g)
        g_norm = torch.linalg.norm(g, dim=-1)
        converged = g_norm <= g_tol
        new_reason = torch.where(
            ~ok_any,
            int(ConvergenceReason.LINE_SEARCH_FAILED),
            torch.where(
                converged,
                int(ConvergenceReason.GRADIENT_CONVERGED),
                torch.where(
                    plateau,
                    int(ConvergenceReason.OBJECTIVE_CONVERGED),
                    int(ConvergenceReason.MAX_ITERATIONS),
                ),
            ),
        )
        reason = torch.where(active, new_reason, reason)
        it = it + active.to(it.dtype)
        # every lane still active has taken exactly `step` iterations
        loss_hist[:, step + 1] = torch.where(active, f, loss_hist[:, step + 1])
        gnorm_hist[:, step + 1] = torch.where(active, g_norm, gnorm_hist[:, step + 1])
        done = done | (active & (~ok_any | converged | plateau))
        step += 1

    # a lane whose initial point already passed the gradient test
    reason = torch.where((it == 0) & done, int(ConvergenceReason.GRADIENT_CONVERGED), reason)
    return OptimizationResult(
        w=w,
        value=f,
        grad_norm=torch.linalg.norm(g, dim=-1),
        iterations=it,
        reason=reason,
        loss_history=loss_hist,
        grad_norm_history=gnorm_hist,
        objective_passes=1 + 3 * it,
    )
