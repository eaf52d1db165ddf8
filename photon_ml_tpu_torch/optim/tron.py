"""TRON: trust-region truncated Newton (port of ``photon_ml_tpu/optim/tron.py``).

An outer trust-radius loop around an inner conjugate-gradient solve of
``H·s = -g`` truncated at the trust boundary, with LIBLINEAR's η/σ
radius-update constants. The reference compiles both loops into one
``lax.while_loop`` program; here they run on the host over tensors on the
objective's device, with the same stopping rules and pass count. Each CG
step is one ``objective.hvp`` (the fused Hv kernel on a dense CUDA batch).
"""

from __future__ import annotations

from typing import Any

import torch

from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.optim.common import (
    ConvergenceReason,
    OptimizationResult,
    grad_converged,
)
from photon_ml_tpu_torch.optim.lbfgs import _history

Tensor = torch.Tensor

# LIBLINEAR tron.cpp constants
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0
_CG_XI = 0.1  # inner CG relative residual tolerance


def _trcg(hvp, g: Tensor, delta: Tensor, max_cg: int) -> tuple[Tensor, Tensor, int]:
    """Truncated CG for H·s = -g within ‖s‖ ≤ delta. Returns (s, r, cg_iters)
    with r the final residual -g - H·s."""
    r = -g
    cg_tol = _CG_XI * torch.linalg.norm(g)
    s = torch.zeros_like(g)
    d = r
    rtr = torch.dot(r, r)
    k = 0
    while k < max_cg and bool(torch.sqrt(rtr) > cg_tol):
        hd = hvp(d)
        dhd = torch.dot(d, hd)
        alpha = rtr / torch.clamp_min(dhd, 1e-30)
        outside = bool(torch.linalg.norm(s + alpha * d) > delta)
        if outside:
            # boundary intersection: τ ≥ 0 with ‖s + τ·d‖ = delta
            std = torch.dot(s, d)
            dd = torch.dot(d, d)
            ss = torch.dot(s, s)
            rad = torch.sqrt(torch.clamp_min(std * std + dd * (delta * delta - ss), 0.0))
            step = torch.where(
                std >= 0.0,
                (delta * delta - ss) / torch.clamp_min(std + rad, 1e-30),
                (rad - std) / torch.clamp_min(dd, 1e-30),
            )
        else:
            step = alpha
        s = s + step * d
        r = r - step * hd
        rtr_new = torch.dot(r, r)
        if not outside:
            d = r + (rtr_new / torch.clamp_min(rtr, 1e-30)) * d
        rtr = rtr_new
        k += 1
        if outside:
            break
    return s, r, k


def tron_minimize(objective: Any, w0: Tensor, config: OptimizerConfig) -> OptimizationResult:
    """Minimize a twice-differentiable objective with TRON. ``objective``
    exposes ``value(w)``, ``value_and_grad(w)`` and ``hvp(w, v)`` (e.g.
    ``GLMObjective``)."""
    T = config.max_iterations
    dtype, dev = w0.dtype, w0.device
    w = w0
    f, g = objective.value_and_grad(w0)
    g0_norm = torch.linalg.norm(g)
    delta = g0_norm
    it = 0
    passes = 1  # the initial value_and_grad
    reason = ConvergenceReason.MAX_ITERATIONS
    done = grad_converged(g0_norm, g0_norm, config.tolerance)
    loss_hist = [f]
    gnorm_hist = [g0_norm]

    while it < T and not done:
        f_old = f
        s, r, cg_k = _trcg(lambda v, w=w: objective.hvp(w, v), g, delta, config.max_cg_iterations)
        gs = torch.dot(g, s)
        # r = -g - H·s ⇒ sᵀHs = -gs - s·r ⇒ predicted reduction:
        prered = -0.5 * (gs - torch.dot(s, r))
        w_new = w + s
        # one pass: the value feeds the acceptance ratio, the gradient is
        # used iff the step is accepted
        f_new, g_new = objective.value_and_grad(w_new)
        actred = f_old - f_new
        snorm = torch.linalg.norm(s)

        # first-iteration radius calibration (LIBLINEAR)
        if it == 0:
            delta = torch.minimum(delta, snorm)

        # interpolated step scale
        denom = f_new - f_old - gs
        alpha = torch.where(
            denom <= 0.0,
            torch.full_like(denom, _SIGMA3),
            torch.clamp_min(-0.5 * gs / denom, _SIGMA1),
        )
        delta = torch.where(
            actred < _ETA0 * prered,
            torch.minimum(torch.clamp_min(alpha, _SIGMA1) * snorm, _SIGMA2 * delta),
            torch.where(
                actred < _ETA1 * prered,
                torch.maximum(_SIGMA1 * delta, torch.minimum(alpha * snorm, _SIGMA2 * delta)),
                torch.where(
                    actred < _ETA2 * prered,
                    torch.maximum(_SIGMA1 * delta, torch.minimum(alpha * snorm, _SIGMA3 * delta)),
                    torch.maximum(delta, torch.minimum(alpha * snorm, _SIGMA3 * delta)),
                ),
            ),
        )

        accept = bool(actred > _ETA0 * prered)
        if accept:
            w, f, g = w_new, f_new, g_new
        g_norm = torch.linalg.norm(g)
        converged = accept and grad_converged(g_norm, g0_norm, config.tolerance)

        # stagnation guards (LIBLINEAR): no progress possible
        tiny = 1e-12 * torch.abs(f_old)
        stalled = bool(
            ((torch.abs(actred) <= 0.0) & (prered <= 0.0))
            | ((torch.abs(actred) <= tiny) & (torch.abs(prered) <= tiny))
        )
        unbounded = bool(f < -1e32)
        if converged:
            reason = ConvergenceReason.GRADIENT_CONVERGED
        elif stalled or unbounded:
            reason = ConvergenceReason.OBJECTIVE_CONVERGED
        else:
            reason = ConvergenceReason.MAX_ITERATIONS
        done = converged or stalled or unbounded

        it += 1
        # each CG step is one Hv pass over the data; the acceptance
        # value_and_grad is one more
        passes += cg_k + 1
        loss_hist.append(f)
        gnorm_hist.append(g_norm)

    if it == 0 and done:
        reason = ConvergenceReason.GRADIENT_CONVERGED
    return OptimizationResult(
        w=w,
        value=f,
        grad_norm=torch.linalg.norm(g),
        iterations=it,
        reason=int(reason),
        loss_history=_history(loss_hist, T, dtype, dev),
        grad_norm_history=_history(gnorm_hist, T, dtype, dev),
        objective_passes=passes,
    )
