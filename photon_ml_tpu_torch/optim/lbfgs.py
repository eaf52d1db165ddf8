"""L-BFGS and OWL-QN (port of ``photon_ml_tpu/optim/lbfgs.py``).

The reference runs the whole solve as one ``lax.while_loop`` on the device.
Here the loop runs on the host over tensors on the objective's device, with
the same stopping rules, line search and ``objective_passes`` count: every
vector stays on the device and the host reads one boolean per test
(line-search step, acceptance, convergence). The history is the same
fixed ``(m, d)`` ring buffer. The chunked entry points (``lbfgs_chunk_*``)
wait for the GAME slice.
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

Tensor = torch.Tensor

_ARMIJO_C1 = 1e-4
_CURVATURE_EPS = 1e-10


def _pseudo_gradient(w: Tensor, g: Tensor, l1w: Tensor) -> Tensor:
    """OWL-QN pseudo-gradient: the minimal-norm subgradient of
    f(w) + Σ l1wⱼ·|wⱼ|."""
    gp = g + l1w
    gm = g - l1w
    zero = torch.zeros_like(g)
    at_zero = torch.where(gp < 0.0, gp, torch.where(gm > 0.0, gm, zero))
    return torch.where(w > 0.0, gp, torch.where(w < 0.0, gm, at_zero))


def _two_loop(pg: Tensor, S: Tensor, Y: Tensor, rho: Tensor, count: int, m: int) -> Tensor:
    """Two-loop recursion: r ≈ H⁻¹·pg from the ring-buffer history (the
    newest ``min(count, m)`` pairs)."""
    valid_n = min(count, m)
    q = pg
    alpha = [None] * m
    for i in range(valid_n):  # newest to oldest
        slot = (count - 1 - i) % m
        a = rho[slot] * torch.dot(S[slot], q)
        q = q - a * Y[slot]
        alpha[slot] = a
    if count > 0:
        newest = (count - 1) % m
        yy = torch.dot(Y[newest], Y[newest])
        gamma = torch.dot(S[newest], Y[newest]) / torch.clamp_min(yy, 1e-30)
        r = gamma * q
    else:
        r = q
    for i in range(valid_n):  # oldest to newest
        slot = (count - valid_n + i) % m
        beta = rho[slot] * torch.dot(Y[slot], r)
        r = r + (alpha[slot] - beta) * S[slot]
    return r


def _lbfgs_impl(
    objective: Any, w0: Tensor, config: OptimizerConfig, l1w: Tensor | None
) -> OptimizationResult:
    m = config.history_length
    T = config.max_iterations
    use_l1 = l1w is not None
    fused_eval = bool(
        getattr(objective, "one_pass_value_grad", getattr(objective, "fused", False))
    )

    def full_value(w: Tensor) -> Tensor:
        v = objective.value(w)
        if use_l1:
            v = v + torch.sum(l1w * torch.abs(w))
        return v

    def value_and_grads(w: Tensor):
        f, g = objective.value_and_grad(w)
        if use_l1:
            f = f + torch.sum(l1w * torch.abs(w))
            pg = _pseudo_gradient(w, g, l1w)
        else:
            pg = g
        return f, g, pg

    d = w0.shape[0]
    dtype, dev = w0.dtype, w0.device
    w = w0
    f, g, pg = value_and_grads(w0)
    g0_norm = torch.linalg.norm(pg)
    S = torch.zeros((m, d), dtype=dtype, device=dev)
    Y = torch.zeros((m, d), dtype=dtype, device=dev)
    rho = torch.zeros((m,), dtype=dtype, device=dev)
    count = 0
    it = 0
    evals = 1  # the initial value_and_grads
    reason = ConvergenceReason.MAX_ITERATIONS
    done = grad_converged(g0_norm, g0_norm, config.tolerance)
    loss_hist = [f]
    gnorm_hist = [g0_norm]

    while it < T and not done:
        p = -_two_loop(pg, S, Y, rho, count, m)
        if use_l1:
            # constrain the search direction to the descent orthant
            p = torch.where(p * (-pg) > 0.0, p, torch.zeros_like(p))
        # fall back to steepest descent if the direction isn't a descent dir
        p = torch.where(torch.dot(p, pg) < 0.0, p, -pg)

        if use_l1:
            xi = torch.where(w != 0.0, torch.sign(w), torch.sign(-pg))

            def trial_point(t, w=w, p=p, xi=xi):
                x = w + t * p
                return torch.where(torch.sign(x) == xi, x, torch.zeros_like(x))

        else:

            def trial_point(t, w=w, p=p):
                return w + t * p

        # First iteration: the Hessian guess is the identity, so scale the
        # initial step to unit length.
        p_norm = torch.linalg.norm(p)
        t = 1.0 / torch.clamp_min(p_norm, 1.0) if count == 0 else torch.ones_like(p_norm)

        def armijo_rhs(w_new, f=f, w=w, pg=pg):
            return f + _ARMIJO_C1 * torch.dot(pg, w_new - w)

        def hopeless(w_new, f=f, w=w, pg=pg):
            # achievable decrease below the f32 resolution of f: no
            # representable improvement is possible
            return torch.abs(torch.dot(pg, w_new - w)) < 1e-7 * torch.abs(f)

        def ls_should_continue(f_new, w_new, k) -> bool:
            insufficient = (f_new > armijo_rhs(w_new)) | torch.isnan(f_new)
            return k < config.max_line_search_steps and bool(
                insufficient & ~hopeless(w_new)
            )

        slope0 = torch.dot(pg, p)  # directional derivative at t = 0

        def next_t(t, f_t, f=f, slope0=slope0):
            # safeguarded quadratic interpolation through f(0), f'(0), f(t),
            # clamped to [t/10, t/2]
            denom = 2.0 * (f_t - f - slope0 * t)
            t_q = -slope0 * t * t / torch.where(denom != 0.0, denom, torch.ones_like(denom))
            t_q = torch.where(torch.isfinite(t_q) & (denom > 0.0), t_q, 0.5 * t)
            return torch.minimum(torch.maximum(t_q, 0.1 * t), 0.5 * t)

        w_new = trial_point(t)
        ls_k = 0
        if fused_eval:
            # value_and_grad costs one X read, like value alone: each trial
            # evaluates both and an accepted step needs no extra pass
            f2, g2, pg2 = value_and_grads(w_new)
            while ls_should_continue(f2, w_new, ls_k):
                t = next_t(t, f2)
                w_new = trial_point(t)
                f2, g2, pg2 = value_and_grads(w_new)
                ls_k += 1
            evals += 1 + ls_k
        else:
            f_new = full_value(w_new)
            while ls_should_continue(f_new, w_new, ls_k):
                t = next_t(t, f_new)
                w_new = trial_point(t)
                f_new = full_value(w_new)
                ls_k += 1
            f2, g2, pg2 = value_and_grads(w_new)
            evals += 2 + ls_k

        # Armijo acceptance, except the degenerate terminal case: a
        # fully-backtracked below-resolution step that does not decrease f
        # means converged within arithmetic precision (LINE_SEARCH_FAILED).
        degenerate = hopeless(w_new) & (f2 >= f)
        ls_ok = bool((f2 <= armijo_rhs(w_new)) & ~degenerate & ~torch.isnan(f2))
        if ls_ok:
            s = w_new - w
            y = g2 - g
            sy = torch.dot(s, y)
            if bool(sy > _CURVATURE_EPS):
                slot = count % m
                S[slot] = s
                Y[slot] = y
                rho[slot] = 1.0 / torch.clamp_min(sy, _CURVATURE_EPS)
                count += 1
            w, f, g, pg = w_new, f2, g2, pg2
            g2_norm = torch.linalg.norm(pg2)
            if grad_converged(g2_norm, g0_norm, config.tolerance):
                reason, done = ConvergenceReason.GRADIENT_CONVERGED, True
        else:
            # keep the old iterate and stop
            reason, done = ConvergenceReason.LINE_SEARCH_FAILED, True
        it += 1
        loss_hist.append(f)
        gnorm_hist.append(torch.linalg.norm(pg))

    if it == 0 and done:
        # the initial point already satisfied the test
        reason = ConvergenceReason.GRADIENT_CONVERGED
    return OptimizationResult(
        w=w,
        value=f,
        grad_norm=torch.linalg.norm(pg),
        iterations=it,
        reason=int(reason),
        loss_history=_history(loss_hist, T, dtype, dev),
        grad_norm_history=_history(gnorm_hist, T, dtype, dev),
        objective_passes=evals,
    )


def _history(values: list, T: int, dtype, device) -> Tensor:
    """(T + 1,) history: the recorded values, NaN after the last iterate."""
    out = torch.full((T + 1,), float("nan"), dtype=dtype, device=device)
    out[: len(values)] = torch.stack(values).to(dtype)
    return out


def lbfgs_minimize(objective: Any, w0: Tensor, config: OptimizerConfig) -> OptimizationResult:
    """Minimize a smooth objective with L-BFGS. ``objective`` exposes
    ``value(w)`` and ``value_and_grad(w)`` (e.g. ``GLMObjective``)."""
    return _lbfgs_impl(objective, w0, config, None)


def owlqn_minimize(
    objective: Any, w0: Tensor, config: OptimizerConfig, l1_weight: float | Tensor
) -> OptimizationResult:
    """Minimize objective(w) + λ₁·Σ|wⱼ| (over the objective's regularized
    coordinates) with OWL-QN. Requires ``objective.reg_mask``."""
    l1w = torch.as_tensor(l1_weight, dtype=w0.dtype, device=w0.device) * objective.reg_mask
    return _lbfgs_impl(objective, w0, config, l1w)
