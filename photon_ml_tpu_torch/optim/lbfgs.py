"""L-BFGS and OWL-QN (port of ``photon_ml_tpu/optim/lbfgs.py``).

The reference runs the whole solve as one ``lax.while_loop`` on the device.
Here the loop runs on the host over tensors on the objective's device, with
the same stopping rules, line search and ``objective_passes`` count: every
vector stays on the device and the host reads one boolean per test
(line-search step, acceptance, convergence). The history is the same
fixed ``(m, d)`` ring buffer.

With a (k, d) start on a ``LaneGLMObjective`` (a random-effect bucket of k
entities) both solvers run over the lanes in lock step, as the reference's
loop does under ``jax.vmap`` (``_lbfgs_lanes``): every lane keeps its own
history ring, line search, acceptance and stopping reason, done lanes are
frozen with ``torch.where``, and the host reads back one boolean per
line-search step and one per iteration for the whole bucket. The lane loop
is three pieces, a state (``LbfgsLaneState``), ``init``, ``run`` to an
iteration bound and ``finalize``: the one-shot lane solve runs them once,
and lane compaction runs them in chunks through the public twins
(``lbfgs_chunk_*``, ``owlqn_chunk_*``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.ops.glm import LaneGLMObjective
from photon_ml_tpu_torch.optim.common import (
    ConvergenceReason,
    LaneState,
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


def _lane_two_loop(
    pg: Tensor, S: Tensor, Y: Tensor, rho: Tensor, count: Tensor, m: int, bound: int
) -> Tensor:
    """``_two_loop`` per lane: (k, d) r ≈ H⁻¹·pg from each lane's newest
    min(count, m) pairs of its (k, m, d) ring, gathered newest first (slot
    (count − 1 − j) mod m at step j). α and β are masked where
    j ≥ min(count, m), and γ is 1 where count = 0; the forward loop walks
    the steps back, so each lane meets its unused steps first, adds 0 for
    them, then its pairs oldest to newest, as the reference's loop does.
    ``bound`` is a host-side upper bound on every lane's count (the
    iterations run so far): the loops take min(bound, m) steps and read
    nothing back."""
    steps = min(bound, m)
    if steps == 0:
        return pg  # no pairs in any lane: γ = 1, r = pg
    k, _, d = S.shape
    j = torch.arange(m, device=pg.device)
    valid = j < torch.clamp_max(count, m).unsqueeze(-1)  # (k, m)
    newest_first = torch.remainder(count.unsqueeze(-1) - 1 - j, m)
    idx = newest_first.unsqueeze(-1).expand(k, m, d)
    S_o, Y_o, rho_o = S.gather(1, idx), Y.gather(1, idx), rho.gather(1, newest_first)
    q = pg
    alpha = []
    for i in range(steps):
        a = torch.where(valid[:, i], rho_o[:, i] * torch.sum(S_o[:, i] * q, dim=-1), 0.0)
        q = q - a.unsqueeze(-1) * Y_o[:, i]
        alpha.append(a)
    yy = torch.sum(Y_o[:, 0] * Y_o[:, 0], dim=-1)
    gamma = torch.where(
        count > 0, torch.sum(S_o[:, 0] * Y_o[:, 0], dim=-1) / torch.clamp_min(yy, 1e-30), 1.0
    )
    r = gamma.unsqueeze(-1) * q
    for i in reversed(range(steps)):
        beta = rho_o[:, i] * torch.sum(Y_o[:, i] * r, dim=-1)
        r = r + torch.where(valid[:, i], alpha[i] - beta, 0.0).unsqueeze(-1) * S_o[:, i]
    return r


@dataclass
class LbfgsLaneState(LaneState):
    """The L-BFGS / OWL-QN lane loop's state between chunks: the iterate,
    its margins, value, gradient and (pseudo-)gradient, each lane's
    gradient tolerance, its (m, d) history ring with ρ and pair count,
    iterations, objective passes, stopping reason, done flag and
    (T + 1) histories; ``step`` is the shared iteration count."""

    w: Tensor
    mg: Tensor
    f: Tensor
    g: Tensor
    pg: Tensor
    g_tol: Tensor
    S: Tensor
    Y: Tensor
    rho: Tensor
    count: Tensor
    it: Tensor
    evals: Tensor
    reason: Tensor
    done: Tensor
    loss_hist: Tensor
    gnorm_hist: Tensor
    step: int = 0


def _l1_terms(l1w: Tensor | None, f: Tensor, g: Tensor, w: Tensor) -> tuple[Tensor, Tensor]:
    if l1w is None:
        return f, g
    return f + torch.sum(l1w * torch.abs(w), dim=-1), _pseudo_gradient(w, g, l1w)


def _lbfgs_lane_init(obj: LaneGLMObjective, w0: Tensor, config: OptimizerConfig,
                     l1w: Tensor | None) -> LbfgsLaneState:
    """The lane state at the (k, d) start ``w0`` (one value-and-gradient
    pass)."""
    m = config.history_length
    T = config.max_iterations
    k, d = w0.shape
    dtype, dev = w0.dtype, w0.device
    mg = obj.margins(w0)
    f, g = obj.value_and_grad_from_margins(mg, w0)
    f, pg = _l1_terms(l1w, f, g, w0)
    g0_norm = torch.linalg.norm(pg, dim=-1)
    g_tol = config.tolerance * torch.clamp_min(g0_norm, 1.0)
    loss_hist = torch.full((k, T + 1), float("nan"), dtype=dtype, device=dev)
    gnorm_hist = torch.full((k, T + 1), float("nan"), dtype=dtype, device=dev)
    loss_hist[:, 0] = f
    gnorm_hist[:, 0] = g0_norm
    return LbfgsLaneState(
        w=w0, mg=mg, f=f, g=g, pg=pg, g_tol=g_tol,
        S=torch.zeros((k, m, d), dtype=dtype, device=dev),
        Y=torch.zeros((k, m, d), dtype=dtype, device=dev),
        rho=torch.zeros((k, m), dtype=dtype, device=dev),
        count=torch.zeros(k, dtype=torch.int64, device=dev),
        it=torch.zeros(k, dtype=torch.int64, device=dev),
        evals=torch.ones(k, dtype=torch.int64, device=dev),  # the initial value_and_grads
        reason=torch.full((k,), int(ConvergenceReason.MAX_ITERATIONS), dtype=torch.int64, device=dev),
        done=g0_norm <= g_tol,
        loss_hist=loss_hist, gnorm_hist=gnorm_hist,
    )


def _lbfgs_lane_run(obj: LaneGLMObjective, st: LbfgsLaneState, config: OptimizerConfig, it_bound: int,
                    l1w: Tensor | None) -> LbfgsLaneState:
    """Step the lanes in lock step until every lane is done or the shared
    step reaches min(``it_bound``, max_iterations).

    Each lane follows the reference's loop under ``vmap``: its own
    curvature pairs (a pair with sᵀy ≤ 1e-10 is skipped, so ``count`` is
    per lane), first step scaled to 1/max(1, ‖p‖) while its count is 0,
    descent-orthant projection and steepest-descent fallback, and its own
    step t in one line-search loop for the bucket: a ``searching`` lane
    takes the safeguarded quadratic step clamped to [t/10, t/2] until its
    trial is sufficient (NaN is not), hopeless, or the step bound is hit;
    a lane whose search has ended keeps its trial point. Plain L-BFGS
    evaluates trials from stored margins m + t·dm (one matvec for dm, none
    per trial); OWL-QN's orthant projection is not linear in t, so each of
    its trials takes a matvec. ``objective_passes`` is the reference's count
    for a lane objective, which is not one-pass: 1 + Σ (2 + line-search
    steps)."""
    m = config.history_length
    bound = min(int(it_bound), config.max_iterations)
    max_ls = config.max_line_search_steps
    use_l1 = l1w is not None
    k = st.w.shape[0]
    dev = st.w.device
    w, mg, f, g, pg, g_tol = st.w, st.mg, st.f, st.g, st.pg, st.g_tol
    S, Y, rho, count, it, evals, reason, done = st.S, st.Y, st.rho, st.count, st.it, st.evals, st.reason, st.done
    loss_hist, gnorm_hist = st.loss_hist, st.gnorm_hist
    slots = torch.arange(m, device=dev)

    step = st.step
    while step < bound and not bool(done.all()):
        active = ~done
        # every active lane has taken exactly `step` iterations, so the
        # two-loop bound and the history column below are the same for
        # each lane in any front
        p = -_lane_two_loop(pg, S, Y, rho, count, m, step)
        if use_l1:
            # constrain the search direction to the descent orthant
            p = torch.where(p * (-pg) > 0.0, p, 0.0)
        # fall back to steepest descent if the direction isn't a descent dir
        slope0 = torch.sum(p * pg, dim=-1)
        p = torch.where((slope0 < 0.0).unsqueeze(-1), p, -pg)
        slope0 = torch.sum(pg * p, dim=-1)  # directional derivative at t = 0
        t = torch.where(count == 0, 1.0 / torch.clamp_min(torch.linalg.norm(p, dim=-1), 1.0), 1.0)

        if use_l1:
            xi = torch.where(w != 0.0, torch.sign(w), torch.sign(-pg))

            def trial(t, w=w, p=p, xi=xi):
                x = w + t.unsqueeze(-1) * p
                w_t = torch.where(torch.sign(x) == xi, x, 0.0)
                m_t = obj.margins(w_t)
                f_t = obj.value_from_margins(m_t, w_t) + torch.sum(l1w * torch.abs(w_t), dim=-1)
                return w_t, m_t, f_t

        else:
            dm = obj.direction_margins(p)

            def trial(t, w=w, p=p, dm=dm, mg=mg):
                w_t = w + t.unsqueeze(-1) * p
                m_t = mg + t.unsqueeze(-1) * dm
                return w_t, m_t, obj.value_from_margins(m_t, w_t)

        def decrease(w_t, w=w, pg=pg):
            return torch.sum(pg * (w_t - w), dim=-1)

        def hopeless(dec, f=f):
            # achievable decrease below the f32 resolution of f
            return torch.abs(dec) < 1e-7 * torch.abs(f)

        def keep_searching(f_t, w_t, f=f):
            dec = decrease(w_t)
            insufficient = (f_t > f + _ARMIJO_C1 * dec) | torch.isnan(f_t)
            return insufficient & ~hopeless(dec)

        w_t, m_t, f_t = trial(t)
        ls_k = torch.zeros(k, dtype=torch.int64, device=dev)
        searching = active & keep_searching(f_t, w_t)
        n = 0
        while n < max_ls and bool(searching.any()):
            # safeguarded quadratic interpolation through f(0), f'(0), f(t),
            # clamped to [t/10, t/2], per lane
            denom = 2.0 * (f_t - f - slope0 * t)
            t_q = -slope0 * t * t / torch.where(denom != 0.0, denom, 1.0)
            t_q = torch.where(torch.isfinite(t_q) & (denom > 0.0), t_q, 0.5 * t)
            t = torch.where(searching, torch.minimum(torch.maximum(t_q, 0.1 * t), 0.5 * t), t)
            w_n, m_n, f_n = trial(t)
            lane = searching.unsqueeze(-1)
            w_t = torch.where(lane, w_n, w_t)
            m_t = torch.where(lane, m_n, m_t)
            f_t = torch.where(searching, f_n, f_t)
            ls_k = ls_k + searching.to(ls_k.dtype)
            n += 1
            searching = searching & keep_searching(f_t, w_t)

        f2, g2 = obj.value_and_grad_from_margins(m_t, w_t)
        f2, pg2 = _l1_terms(l1w, f2, g2, w_t)
        dec = decrease(w_t)
        # Armijo acceptance, except the degenerate terminal case (a
        # below-resolution step that does not decrease f: LINE_SEARCH_FAILED)
        degenerate = hopeless(dec) & (f2 >= f)
        ls_ok = (f2 <= f + _ARMIJO_C1 * dec) & ~degenerate & ~torch.isnan(f2)
        s = w_t - w
        y = g2 - g
        sy = torch.sum(s * y, dim=-1)
        store = active & ls_ok & (sy > _CURVATURE_EPS)
        put = (slots == torch.remainder(count, m).unsqueeze(-1)) & store.unsqueeze(-1)  # (k, m)
        S = torch.where(put.unsqueeze(-1), s.unsqueeze(1), S)
        Y = torch.where(put.unsqueeze(-1), y.unsqueeze(1), Y)
        rho = torch.where(put, (1.0 / torch.clamp_min(sy, _CURVATURE_EPS)).unsqueeze(-1), rho)
        count = count + store.to(count.dtype)

        converged = torch.linalg.norm(pg2, dim=-1) <= g_tol
        take = active & ls_ok  # a failed search keeps the old iterate; done lanes stay frozen
        lane = take.unsqueeze(-1)
        w = torch.where(lane, w_t, w)
        mg = torch.where(lane, m_t, mg)
        g = torch.where(lane, g2, g)
        pg = torch.where(lane, pg2, pg)
        f = torch.where(take, f2, f)
        new_reason = torch.where(
            ~ls_ok,
            int(ConvergenceReason.LINE_SEARCH_FAILED),
            torch.where(
                converged,
                int(ConvergenceReason.GRADIENT_CONVERGED),
                int(ConvergenceReason.MAX_ITERATIONS),
            ),
        )
        reason = torch.where(active, new_reason, reason)
        done = done | (active & (~ls_ok | converged))
        it = it + active.to(it.dtype)
        evals = evals + active.to(evals.dtype) * (2 + ls_k)
        loss_hist[:, step + 1] = torch.where(active, f, loss_hist[:, step + 1])
        gnorm_hist[:, step + 1] = torch.where(
            active, torch.linalg.norm(pg, dim=-1), gnorm_hist[:, step + 1]
        )
        step += 1

    return LbfgsLaneState(w=w, mg=mg, f=f, g=g, pg=pg, g_tol=g_tol, S=S, Y=Y, rho=rho, count=count, it=it,
                          evals=evals, reason=reason, done=done, loss_hist=loss_hist, gnorm_hist=gnorm_hist,
                          step=step)


def _lbfgs_lane_result(st: LbfgsLaneState) -> OptimizationResult:
    # a lane whose initial point already passed the gradient test
    reason = torch.where((st.it == 0) & st.done, int(ConvergenceReason.GRADIENT_CONVERGED), st.reason)
    return OptimizationResult(
        w=st.w,
        value=st.f,
        grad_norm=torch.linalg.norm(st.pg, dim=-1),
        iterations=st.it,
        reason=reason,
        loss_history=st.loss_hist,
        grad_norm_history=st.gnorm_hist,
        objective_passes=st.evals,
    )


def _lbfgs_lanes(
    obj: LaneGLMObjective, w0: Tensor, config: OptimizerConfig, l1w: Tensor | None
) -> OptimizationResult:
    """L-BFGS (``l1w`` None) or OWL-QN over k lanes in lock step: the
    chunked pieces run once to the iteration bound."""
    st = _lbfgs_lane_run(obj, _lbfgs_lane_init(obj, w0, config, l1w), config, config.max_iterations, l1w)
    return _lbfgs_lane_result(st)


# -- chunked entry points (lane compaction; optim/common.py ChunkedSolver) ----
def lbfgs_chunk_init(objective: LaneGLMObjective, w0: Tensor, config: OptimizerConfig) -> LbfgsLaneState:
    """The L-BFGS lane state at the (k, d) start (the initial pass)."""
    return _lbfgs_lane_init(objective, w0, config, None)


def lbfgs_chunk_run(objective: LaneGLMObjective, state: LbfgsLaneState, config: OptimizerConfig,
                    it_bound: int) -> LbfgsLaneState:
    """Step until every lane is done or ``state.step`` reaches the
    absolute bound ``it_bound``."""
    return _lbfgs_lane_run(objective, state, config, it_bound, None)


def lbfgs_chunk_finalize(state: LbfgsLaneState) -> OptimizationResult:
    return _lbfgs_lane_result(state)


def _owlqn_l1w(objective: LaneGLMObjective, dtype, l1_weight) -> Tensor:
    return torch.as_tensor(l1_weight, dtype=dtype, device=objective.reg_mask.device) * objective.reg_mask


def owlqn_chunk_init(objective: LaneGLMObjective, w0: Tensor, config: OptimizerConfig,
                     l1_weight) -> LbfgsLaneState:
    return _lbfgs_lane_init(objective, w0, config, _owlqn_l1w(objective, w0.dtype, l1_weight))


def owlqn_chunk_run(objective: LaneGLMObjective, state: LbfgsLaneState, config: OptimizerConfig, it_bound: int,
                    l1_weight) -> LbfgsLaneState:
    return _lbfgs_lane_run(objective, state, config, it_bound, _owlqn_l1w(objective, state.w.dtype, l1_weight))


def owlqn_chunk_finalize(state: LbfgsLaneState) -> OptimizationResult:
    return _lbfgs_lane_result(state)


def _lanes(objective: Any, w0: Tensor) -> bool:
    """Is this a lane solve? A (k, d) start needs a ``LaneGLMObjective``;
    its result's fields are then per lane (``w`` (k, d), ``value`` (k,),
    ``iterations`` / ``reason`` / ``objective_passes`` (k,) int64 tensors,
    histories (k, T + 1))."""
    if w0.dim() == 1:
        return False
    if not isinstance(objective, LaneGLMObjective):
        raise TypeError("a (k, d) start needs a LaneGLMObjective")
    return True


def lbfgs_minimize(objective: Any, w0: Tensor, config: OptimizerConfig) -> OptimizationResult:
    """Minimize a smooth objective with L-BFGS. ``objective`` exposes
    ``value(w)`` and ``value_and_grad(w)`` (e.g. ``GLMObjective``); with a
    (k, d) ``w0`` it is a ``LaneGLMObjective`` solved lane by lane."""
    if _lanes(objective, w0):
        return _lbfgs_lanes(objective, w0, config, None)
    return _lbfgs_impl(objective, w0, config, None)


def owlqn_minimize(
    objective: Any, w0: Tensor, config: OptimizerConfig, l1_weight: float | Tensor
) -> OptimizationResult:
    """Minimize objective(w) + λ₁·Σ|wⱼ| (over the objective's regularized
    coordinates) with OWL-QN. Requires ``objective.reg_mask``; with a
    (k, d) ``w0`` the objective is a ``LaneGLMObjective``."""
    l1w = torch.as_tensor(l1_weight, dtype=w0.dtype, device=w0.device) * objective.reg_mask
    if _lanes(objective, w0):
        return _lbfgs_lanes(objective, w0, config, l1w)
    return _lbfgs_impl(objective, w0, config, l1w)
