"""TRON: trust-region truncated Newton (port of ``photon_ml_tpu/optim/tron.py``).

An outer trust-radius loop around an inner conjugate-gradient solve of
``H·s = -g`` truncated at the trust boundary, with LIBLINEAR's η/σ
radius-update constants. The reference compiles both loops into one
``lax.while_loop`` program; here they run on the host over tensors on the
objective's device, with the same stopping rules and pass count. Each CG
step is one ``objective.hvp`` (the fused Hv kernel on a dense CUDA batch).

With a (k, d) start on a ``LaneGLMObjective`` (a random-effect bucket) the
solve runs over the lanes in lock step, as the reference's loop does under
``jax.vmap`` (``_tron_lanes``): per-lane trust radius, acceptance ratio and
stopping reason, and one truncated-CG loop for the bucket in which each
lane stops on its own (residual below ξ·‖g‖, or the boundary step with its
own τ). Each CG step is one lane ``hvp`` from the margins stored at the
iterate; the host reads one boolean per CG step and one per iteration.
The lane loop is a state (``TronLaneState``), ``init``, ``run`` to an
iteration bound and ``finalize``, which lane compaction runs in chunks
(``tron_chunk_*``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.optim.common import (
    ConvergenceReason,
    LaneState,
    OptimizationResult,
    grad_converged,
)
from photon_ml_tpu_torch.optim.lbfgs import _history, _lanes

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
    ``GLMObjective``); with a (k, d) ``w0`` it is a ``LaneGLMObjective``
    solved lane by lane."""
    if _lanes(objective, w0):
        return _tron_lanes(objective, w0, config)
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


def _lane_trcg(hvp, g: Tensor, delta: Tensor, max_cg: int, active: Tensor):
    """``_trcg`` per lane: (k, d) s and r, (k,) CG steps. A lane runs while
    it is active, not stopped at the boundary and its residual is above
    ξ·‖g‖; the others keep their state."""
    r = -g
    cg_tol = _CG_XI * torch.linalg.norm(g, dim=-1)
    s = torch.zeros_like(g)
    d = r
    rtr = torch.sum(r * r, dim=-1)
    steps = torch.zeros(g.shape[0], dtype=torch.int64, device=g.device)
    running = active & (torch.sqrt(rtr) > cg_tol)
    n = 0
    while n < max_cg and bool(running.any()):
        hd = hvp(d)
        alpha = rtr / torch.clamp_min(torch.sum(d * hd, dim=-1), 1e-30)
        outside = torch.linalg.norm(s + alpha.unsqueeze(-1) * d, dim=-1) > delta
        # boundary intersection: τ ≥ 0 with ‖s + τ·d‖ = delta
        std = torch.sum(s * d, dim=-1)
        dd = torch.sum(d * d, dim=-1)
        ss = torch.sum(s * s, dim=-1)
        rad = torch.sqrt(torch.clamp_min(std * std + dd * (delta * delta - ss), 0.0))
        tau = torch.where(
            std >= 0.0,
            (delta * delta - ss) / torch.clamp_min(std + rad, 1e-30),
            (rad - std) / torch.clamp_min(dd, 1e-30),
        )
        step = torch.where(outside, tau, alpha).unsqueeze(-1)
        s_new = s + step * d
        r_new = r - step * hd
        rtr_new = torch.sum(r_new * r_new, dim=-1)
        beta = rtr_new / torch.clamp_min(rtr, 1e-30)
        d_new = torch.where(outside.unsqueeze(-1), d, r_new + beta.unsqueeze(-1) * d)
        lane = running.unsqueeze(-1)
        s = torch.where(lane, s_new, s)
        r = torch.where(lane, r_new, r)
        d = torch.where(lane, d_new, d)
        rtr = torch.where(running, rtr_new, rtr)
        steps = steps + running.to(steps.dtype)
        n += 1
        running = running & ~outside & (torch.sqrt(rtr) > cg_tol)
    return s, r, steps


@dataclass
class TronLaneState(LaneState):
    """The TRON lane loop's state between chunks: the iterate, its
    margins, value and gradient, each lane's gradient tolerance and trust
    radius, iterations, objective passes, stopping reason, done flag and
    (T + 1) histories; ``step`` is the shared iteration count."""

    w: Tensor
    mg: Tensor
    f: Tensor
    g: Tensor
    g_tol: Tensor
    delta: Tensor
    it: Tensor
    passes: Tensor
    reason: Tensor
    done: Tensor
    loss_hist: Tensor
    gnorm_hist: Tensor
    step: int = 0


def _tron_lane_init(obj, w0: Tensor, config: OptimizerConfig) -> TronLaneState:
    T = config.max_iterations
    k = w0.shape[0]
    dtype, dev = w0.dtype, w0.device
    mg = obj.margins(w0)
    f, g = obj.value_and_grad_from_margins(mg, w0)
    g0_norm = torch.linalg.norm(g, dim=-1)
    g_tol = config.tolerance * torch.clamp_min(g0_norm, 1.0)
    loss_hist = torch.full((k, T + 1), float("nan"), dtype=dtype, device=dev)
    gnorm_hist = torch.full((k, T + 1), float("nan"), dtype=dtype, device=dev)
    loss_hist[:, 0] = f
    gnorm_hist[:, 0] = g0_norm
    return TronLaneState(
        w=w0, mg=mg, f=f, g=g, g_tol=g_tol, delta=g0_norm,
        it=torch.zeros(k, dtype=torch.int64, device=dev),
        passes=torch.ones(k, dtype=torch.int64, device=dev),  # the initial value_and_grad
        reason=torch.full((k,), int(ConvergenceReason.MAX_ITERATIONS), dtype=torch.int64, device=dev),
        done=g0_norm <= g_tol, loss_hist=loss_hist, gnorm_hist=gnorm_hist,
    )


def _tron_lane_run(obj, st: TronLaneState, config: OptimizerConfig, it_bound: int) -> TronLaneState:
    """TRON over k lanes in lock step until every lane is done or the
    shared step reaches min(``it_bound``, max_iterations); per-lane
    iterations, reason, histories and ``objective_passes`` (1 + Σ (CG
    steps + 1)) as the reference's loop gives them under ``vmap``."""
    bound = min(int(it_bound), config.max_iterations)
    w, mg, f, g, g_tol, delta = st.w, st.mg, st.f, st.g, st.g_tol, st.delta
    it, passes, reason, done = st.it, st.passes, st.reason, st.done
    loss_hist, gnorm_hist = st.loss_hist, st.gnorm_hist

    step = st.step
    while step < bound and not bool(done.all()):
        active = ~done
        s, r, cg_k = _lane_trcg(
            lambda v, mg=mg: obj.hvp_from_margins(mg, v), g, delta, config.max_cg_iterations, active
        )
        gs = torch.sum(g * s, dim=-1)
        # r = -g - H·s ⇒ sᵀHs = -gs - s·r ⇒ predicted reduction:
        prered = -0.5 * (gs - torch.sum(s * r, dim=-1))
        w_new = w + s
        m_new = obj.margins(w_new)
        f_new, g_new = obj.value_and_grad_from_margins(m_new, w_new)
        actred = f - f_new
        snorm = torch.linalg.norm(s, dim=-1)
        # first-iteration radius calibration (LIBLINEAR); every active lane
        # has taken exactly `step` iterations
        rad = torch.minimum(delta, snorm) if step == 0 else delta
        denom = f_new - f - gs
        alpha = torch.where(denom <= 0.0, _SIGMA3, torch.clamp_min(-0.5 * gs / denom, _SIGMA1))
        rad = torch.where(
            actred < _ETA0 * prered,
            torch.minimum(torch.clamp_min(alpha, _SIGMA1) * snorm, _SIGMA2 * rad),
            torch.where(
                actred < _ETA1 * prered,
                torch.maximum(_SIGMA1 * rad, torch.minimum(alpha * snorm, _SIGMA2 * rad)),
                torch.where(
                    actred < _ETA2 * prered,
                    torch.maximum(_SIGMA1 * rad, torch.minimum(alpha * snorm, _SIGMA3 * rad)),
                    torch.maximum(rad, torch.minimum(alpha * snorm, _SIGMA3 * rad)),
                ),
            ),
        )
        delta = torch.where(active, rad, delta)

        accept = actred > _ETA0 * prered
        take = active & accept
        lane = take.unsqueeze(-1)
        # stagnation guards (LIBLINEAR): no progress possible
        tiny = 1e-12 * torch.abs(f)
        stalled = ((torch.abs(actred) <= 0.0) & (prered <= 0.0)) | (
            (torch.abs(actred) <= tiny) & (torch.abs(prered) <= tiny)
        )
        w = torch.where(lane, w_new, w)
        mg = torch.where(lane, m_new, mg)
        g = torch.where(lane, g_new, g)
        f = torch.where(take, f_new, f)
        g_norm = torch.linalg.norm(g, dim=-1)
        converged = accept & (g_norm <= g_tol)
        unbounded = f < -1e32
        new_reason = torch.where(
            converged,
            int(ConvergenceReason.GRADIENT_CONVERGED),
            torch.where(
                stalled | unbounded,
                int(ConvergenceReason.OBJECTIVE_CONVERGED),
                int(ConvergenceReason.MAX_ITERATIONS),
            ),
        )
        reason = torch.where(active, new_reason, reason)
        done = done | (active & (converged | stalled | unbounded))
        it = it + active.to(it.dtype)
        # each CG step is one Hv pass over the data; the acceptance
        # value_and_grad is one more
        passes = passes + active.to(passes.dtype) * (cg_k + 1)
        loss_hist[:, step + 1] = torch.where(active, f, loss_hist[:, step + 1])
        gnorm_hist[:, step + 1] = torch.where(active, g_norm, gnorm_hist[:, step + 1])
        step += 1

    return TronLaneState(w=w, mg=mg, f=f, g=g, g_tol=g_tol, delta=delta, it=it, passes=passes, reason=reason,
                         done=done, loss_hist=loss_hist, gnorm_hist=gnorm_hist, step=step)


def _tron_lane_result(st: TronLaneState) -> OptimizationResult:
    reason = torch.where((st.it == 0) & st.done, int(ConvergenceReason.GRADIENT_CONVERGED), st.reason)
    return OptimizationResult(
        w=st.w,
        value=st.f,
        grad_norm=torch.linalg.norm(st.g, dim=-1),
        iterations=st.it,
        reason=reason,
        loss_history=st.loss_hist,
        grad_norm_history=st.gnorm_hist,
        objective_passes=st.passes,
    )


def _tron_lanes(obj, w0: Tensor, config: OptimizerConfig) -> OptimizationResult:
    """TRON over k lanes in lock step: the chunked pieces run once to the
    iteration bound."""
    return _tron_lane_result(_tron_lane_run(obj, _tron_lane_init(obj, w0, config), config, config.max_iterations))


# -- chunked entry points (lane compaction; optim/common.py ChunkedSolver) ----
def tron_chunk_init(objective, w0: Tensor, config: OptimizerConfig) -> TronLaneState:
    """The TRON lane state at the (k, d) start (the initial pass)."""
    return _tron_lane_init(objective, w0, config)


def tron_chunk_run(objective, state: TronLaneState, config: OptimizerConfig, it_bound: int) -> TronLaneState:
    """Step until every lane is done or ``state.step`` reaches the
    absolute bound ``it_bound``."""
    return _tron_lane_run(objective, state, config, it_bound)


def tron_chunk_finalize(state: TronLaneState) -> OptimizationResult:
    return _tron_lane_result(state)
