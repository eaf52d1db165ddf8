"""TRON: trust-region truncated Newton (port of ``photon_ml_tpu/optim/tron.py``).

An outer trust-radius loop around an inner conjugate-gradient solve of
``H·s = -g`` truncated at the trust boundary, with LIBLINEAR's η/σ
radius-update constants. The reference compiles both loops into one
``lax.while_loop`` program with a nested CG ``while_loop``. Here the
iteration and the CG step are each one body over state tensors on the
objective's device, written in place, with the same stopping rules and
pass count: the CG body takes the boundary step in the reference's masked
form (the step τ where the full step leaves the region, the direction kept
there, and the CG stop flag set), and the radius, acceptance and stopping
reason are device ``where``s. ``ops/graphs.py``'s ``loop`` runs each body
(the CG loop nested in the iteration): it reads one flag a trip on the
host, or, inside a captured CUDA graph, leaves the trips to the device.
Each CG step is one ``objective.hvp`` (the fused Hv kernel on a dense
CUDA batch).

With a (k, d) start on a ``LaneGLMObjective`` (a random-effect bucket) the
solve runs over the lanes in lock step, as the reference's loop does under
``jax.vmap`` (``_tron_lanes``): per-lane trust radius, acceptance ratio and
stopping reason, and one truncated-CG loop for the bucket in which each
lane stops on its own (residual below ξ·‖g‖, or the boundary step with its
own τ). Each CG step is one lane ``hvp`` from the margins stored at the
iterate; the eager driver reads one flag a CG step and one an iteration
for the whole bucket. The lane loop is a state (``TronLaneState``),
``init``, ``run`` to an iteration bound and ``finalize``, which lane
compaction runs in chunks (``tron_chunk_*``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.ops import graphs
from photon_ml_tpu_torch.optim.common import ConvergenceReason, LaneState, OptimizationResult
from photon_ml_tpu_torch.optim.lbfgs import _lanes

Tensor = torch.Tensor

# LIBLINEAR tron.cpp constants
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0
_CG_XI = 0.1  # inner CG relative residual tolerance


def _boundary_step(s: Tensor, d: Tensor, delta: Tensor, dot: Callable[[Tensor, Tensor], Tensor]) -> Tensor:
    """τ ≥ 0 with ‖s + τ·d‖ = delta (the boundary intersection)."""
    std, dd, ss = dot(s, d), dot(d, d), dot(s, s)
    rad = torch.sqrt(torch.clamp_min(std * std + dd * (delta * delta - ss), 0.0))
    return torch.where(
        std >= 0.0,
        (delta * delta - ss) / torch.clamp_min(std + rad, 1e-30),
        (rad - std) / torch.clamp_min(dd, 1e-30),
    )


def _radius(delta: Tensor, actred: Tensor, prered: Tensor, gs: Tensor, f_new: Tensor, f: Tensor,
            snorm: Tensor) -> Tensor:
    """LIBLINEAR's radius update from the interpolated step scale."""
    denom = f_new - f - gs
    alpha = torch.where(denom <= 0.0, _SIGMA3, torch.clamp_min(-0.5 * gs / denom, _SIGMA1))
    return torch.where(
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


def _stalled(actred: Tensor, prered: Tensor, f: Tensor) -> Tensor:
    """LIBLINEAR's stagnation guard at the old value ``f``: no progress
    possible."""
    tiny = 1e-12 * torch.abs(f)
    return ((torch.abs(actred) <= 0.0) & (prered <= 0.0)) | (
        (torch.abs(actred) <= tiny) & (torch.abs(prered) <= tiny)
    )


def _reason(converged: Tensor, stopped: Tensor) -> Tensor:
    return torch.where(
        converged,
        int(ConvergenceReason.GRADIENT_CONVERGED),
        torch.where(stopped, int(ConvergenceReason.OBJECTIVE_CONVERGED), int(ConvergenceReason.MAX_ITERATIONS)),
    )


def _trcg(hvp, g: Tensor, delta: Tensor, max_cg: int) -> tuple[Tensor, Tensor, Tensor]:
    """Truncated CG for H·s = -g within ‖s‖ ≤ delta: one body a CG step
    over state tensors made here, run by ``graphs.loop`` while the step
    stays inside the region and the residual is above ξ·‖g‖. Returns
    (s, r, CG steps) with r the final residual -g - H·s and the steps a
    0-d device count."""
    cg_tol = _CG_XI * torch.linalg.norm(g)
    r = -g
    s = torch.zeros_like(g)
    d = r.clone()
    rtr = torch.dot(r, r)
    k = torch.zeros((), dtype=torch.int64, device=g.device)
    cg_go = torch.sqrt(rtr) > cg_tol

    def cg_step(_trip) -> None:
        hd = hvp(d)
        alpha = rtr / torch.clamp_min(torch.dot(d, hd), 1e-30)
        outside = torch.linalg.norm(s + alpha * d) > delta
        step = torch.where(outside, _boundary_step(s, d, delta, torch.dot), alpha)
        s_new = s + step * d
        r_new = r - step * hd
        rtr_new = torch.dot(r_new, r_new)
        d_new = torch.where(outside, d, r_new + (rtr_new / torch.clamp_min(rtr, 1e-30)) * d)
        s.copy_(s_new)
        r.copy_(r_new)
        d.copy_(d_new)
        rtr.copy_(rtr_new)
        k.add_(1)
        cg_go.copy_(~outside & (torch.sqrt(rtr) > cg_tol))

    graphs.loop(max_cg, cg_go, cg_step)
    return s, r, k


def _tron_impl(objective: Any, w0: Tensor, config: OptimizerConfig) -> OptimizationResult:
    """One GLM's solve. Its iteration and its CG step are bodies over
    state tensors written in place, run by ``graphs.loop`` (module
    docstring). The iteration and pass counts and the stopping reason live
    on the device; the result's counts are read once at the end (under
    ``graphs.deferring`` they stay tensors for the deferred run's one
    read)."""
    T = config.max_iterations
    dtype, dev = w0.dtype, w0.device
    f0, g0 = objective.value_and_grad(w0)
    g0_norm = torch.linalg.norm(g0)
    g_tol = config.tolerance * torch.clamp_min(g0_norm, 1.0)
    # the state, written in place by each iteration
    w, f, g, delta = w0.clone(), f0.clone(), g0.clone(), g0_norm.clone()
    it = torch.zeros((), dtype=torch.int64, device=dev)
    passes = torch.ones((), dtype=torch.int64, device=dev)  # the initial value_and_grad
    reason = torch.full((), int(ConvergenceReason.MAX_ITERATIONS), dtype=torch.int64, device=dev)
    done = g0_norm <= g_tol
    go = ~done
    loss_hist = torch.full((T + 1,), float("nan"), dtype=dtype, device=dev)
    gnorm_hist = torch.full((T + 1,), float("nan"), dtype=dtype, device=dev)
    loss_hist[0] = f0
    gnorm_hist[0] = g0_norm

    def iteration(_trip) -> None:
        s, r, cg_k = _trcg(lambda v: objective.hvp(w, v), g, delta, config.max_cg_iterations)
        gs = torch.dot(g, s)
        # r = -g - H·s ⇒ sᵀHs = -gs - s·r ⇒ predicted reduction:
        prered = -0.5 * (gs - torch.dot(s, r))
        w_new = w + s
        # one pass: the value feeds the acceptance ratio, the gradient is
        # used iff the step is accepted
        f_new, g_new = objective.value_and_grad(w_new)
        actred = f - f_new
        snorm = torch.linalg.norm(s)
        # first-iteration radius calibration (LIBLINEAR)
        rad = torch.where(it == 0, torch.minimum(delta, snorm), delta)
        accept = actred > _ETA0 * prered
        # the guards and the radius read the old value; then the state moves
        stalled = _stalled(actred, prered, f)
        delta.copy_(_radius(rad, actred, prered, gs, f_new, f, snorm))
        w.copy_(torch.where(accept, w_new, w))
        f.copy_(torch.where(accept, f_new, f))
        g.copy_(torch.where(accept, g_new, g))
        g_norm = torch.linalg.norm(g)
        converged = accept & (g_norm <= g_tol)
        stopped = stalled | (f < -1e32)  # unbounded at the new value
        reason.copy_(_reason(converged, stopped))
        done.copy_(converged | stopped)
        # each CG step is one Hv pass over the data; the acceptance
        # value_and_grad is one more
        passes.add_(cg_k + 1)
        loss_hist.index_copy_(0, (it + 1).view(1), f.view(1))
        gnorm_hist.index_copy_(0, (it + 1).view(1), g_norm.view(1))
        it.add_(1)
        go.copy_(~done)

    graphs.loop(T, go, iteration)
    # the initial point already satisfied the test
    reason = torch.where((it == 0) & done, int(ConvergenceReason.GRADIENT_CONVERGED), reason)
    counts = it, reason, passes
    if not graphs.is_deferring():  # a deferred run reads them at its end
        counts = tuple(int(c) for c in graphs.read_all([torch.stack(counts)])[0])
    return OptimizationResult(
        w=w,
        value=f,
        grad_norm=torch.linalg.norm(g),
        iterations=counts[0],
        reason=counts[1],
        loss_history=loss_hist,
        grad_norm_history=gnorm_hist,
        objective_passes=counts[2],
    )


def tron_minimize(objective: Any, w0: Tensor, config: OptimizerConfig) -> OptimizationResult:
    """Minimize a twice-differentiable objective with TRON. ``objective``
    exposes ``value(w)``, ``value_and_grad(w)`` and ``hvp(w, v)`` (e.g.
    ``GLMObjective``); with a (k, d) ``w0`` it is a ``LaneGLMObjective``
    solved lane by lane."""
    if _lanes(objective, w0):
        return _tron_lanes(objective, w0, config)
    return _tron_impl(objective, w0, config)


def _lane_dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def _lane_trcg(hvp, g: Tensor, delta: Tensor, max_cg: int, active: Tensor):
    """``_trcg`` per lane: (k, d) s and r, (k,) CG steps. A lane runs while
    it is active, not stopped at the boundary and its residual is above
    ξ·‖g‖; the others keep their state. The loop goes on while any lane
    runs."""
    cg_tol = _CG_XI * torch.linalg.norm(g, dim=-1)
    r = -g
    s = torch.zeros_like(g)
    d = r.clone()
    rtr = _lane_dot(r, r)
    steps = torch.zeros(g.shape[0], dtype=torch.int64, device=g.device)
    running = active & (torch.sqrt(rtr) > cg_tol)
    any_running = running.any()

    def cg_step(_trip) -> None:
        hd = hvp(d)
        alpha = rtr / torch.clamp_min(_lane_dot(d, hd), 1e-30)
        outside = torch.linalg.norm(s + alpha.unsqueeze(-1) * d, dim=-1) > delta
        step = torch.where(outside, _boundary_step(s, d, delta, _lane_dot), alpha).unsqueeze(-1)
        s_new = s + step * d
        r_new = r - step * hd
        rtr_new = _lane_dot(r_new, r_new)
        beta = rtr_new / torch.clamp_min(rtr, 1e-30)
        d_new = torch.where(outside.unsqueeze(-1), d, r_new + beta.unsqueeze(-1) * d)
        lane = running.unsqueeze(-1)
        s.copy_(torch.where(lane, s_new, s))
        r.copy_(torch.where(lane, r_new, r))
        d.copy_(torch.where(lane, d_new, d))
        rtr.copy_(torch.where(running, rtr_new, rtr))
        steps.add_(running.to(steps.dtype))
        running.copy_(running & ~outside & (torch.sqrt(rtr) > cg_tol))
        any_running.copy_(running.any())

    graphs.loop(max_cg, any_running, cg_step)
    return s, r, steps


@dataclass
class TronLaneState(LaneState):
    """The TRON lane loop's state between chunks: the iterate, its
    margins, value and gradient, each lane's gradient tolerance and trust
    radius, iterations, objective passes, stopping reason, done flag and
    (T + 1) histories; ``step`` is the shared iteration count. A run
    writes the tensors in place."""

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
    """The lane state at the (k, d) start ``w0`` (one value-and-gradient
    pass), in tensors of its own."""
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
        w=w0.clone(), mg=mg, f=f, g=g, g_tol=g_tol, delta=g0_norm.clone(),
        it=torch.zeros(k, dtype=torch.int64, device=dev),
        passes=torch.ones(k, dtype=torch.int64, device=dev),  # the initial value_and_grad
        reason=torch.full((k,), int(ConvergenceReason.MAX_ITERATIONS), dtype=torch.int64, device=dev),
        done=g0_norm <= g_tol, loss_hist=loss_hist, gnorm_hist=gnorm_hist,
    )


def _tron_lane_run(obj, st: TronLaneState, config: OptimizerConfig, it_bound: int) -> TronLaneState:
    """TRON over k lanes in lock step until every lane is done or the
    shared step reaches min(``it_bound``, max_iterations), writing ``st``'s
    tensors in place; per-lane iterations, reason, histories and
    ``objective_passes`` (1 + Σ (CG steps + 1)) as the reference's loop
    gives them under ``vmap``. The iteration and the CG step are bodies
    run by ``graphs.loop`` (one flag read each under the eager driver);
    inside a capture the returned state's ``step`` is the bound (the
    device decided the trips)."""
    bound = min(int(it_bound), config.max_iterations)
    k = st.w.shape[0]
    w, mg, f, g, g_tol, delta = st.w, st.mg, st.f, st.g, st.g_tol, st.delta
    it, passes, reason, done = st.it, st.passes, st.reason, st.done
    loss_hist, gnorm_hist = st.loss_hist, st.gnorm_hist
    # every active lane has taken exactly `step` iterations, so the history
    # column and the first-iteration test below are the same for each lane
    step = torch.full((k, 1), st.step, dtype=torch.int64, device=st.w.device)
    go = ~done.all()

    def iteration(_trip) -> None:
        active = ~done
        s, r, cg_k = _lane_trcg(lambda v: obj.hvp_from_margins(mg, v), g, delta, config.max_cg_iterations,
                                active)
        gs = _lane_dot(g, s)
        # r = -g - H·s ⇒ sᵀHs = -gs - s·r ⇒ predicted reduction:
        prered = -0.5 * (gs - _lane_dot(s, r))
        w_new = w + s
        m_new = obj.margins(w_new)
        f_new, g_new = obj.value_and_grad_from_margins(m_new, w_new)
        actred = f - f_new
        snorm = torch.linalg.norm(s, dim=-1)
        # first-iteration radius calibration (LIBLINEAR)
        rad = torch.where(step.squeeze(-1) == 0, torch.minimum(delta, snorm), delta)
        accept = actred > _ETA0 * prered
        take = active & accept
        lane = take.unsqueeze(-1)
        # the guards and the radius read the old value; then the state moves
        stalled = _stalled(actred, prered, f)
        delta.copy_(torch.where(active, _radius(rad, actred, prered, gs, f_new, f, snorm), delta))
        w.copy_(torch.where(lane, w_new, w))
        mg.copy_(torch.where(lane, m_new, mg))
        g.copy_(torch.where(lane, g_new, g))
        f.copy_(torch.where(take, f_new, f))
        g_norm = torch.linalg.norm(g, dim=-1)
        converged = accept & (g_norm <= g_tol)
        stopped = stalled | (f < -1e32)  # unbounded at the new value
        reason.copy_(torch.where(active, _reason(converged, stopped), reason))
        done.copy_(done | (active & (converged | stopped)))
        it.add_(active.to(it.dtype))
        # each CG step is one Hv pass over the data; the acceptance
        # value_and_grad is one more
        passes.add_(active.to(passes.dtype) * (cg_k + 1))
        col = step + 1
        loss_hist.scatter_(1, col, torch.where(active, f, loss_hist.gather(1, col).squeeze(1)).unsqueeze(1))
        gnorm_hist.scatter_(1, col, torch.where(active, g_norm, gnorm_hist.gather(1, col).squeeze(1)).unsqueeze(1))
        step.add_(1)
        go.copy_(~done.all())

    trips = graphs.loop(bound - st.step, go, iteration)
    return dataclasses.replace(st, step=bound if trips is None else st.step + trips)


def _tron_lane_result(st: TronLaneState) -> OptimizationResult:
    # a lane whose initial point already passed the gradient test
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
