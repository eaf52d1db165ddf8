"""L-BFGS and OWL-QN (port of ``photon_ml_tpu/optim/lbfgs.py``).

The reference runs the whole solve as one ``lax.while_loop`` on the device.
Here the iteration and the line-search trial are each one body over state
tensors on the objective's device, written in place, with the same
stopping rules, line search and ``objective_passes`` count; the pair
count, the iteration and trial counts and the stopping reason stay on the
device, and the two-loop recursion runs all m ring slots, masked past the
count. ``ops/graphs.py``'s ``loop`` runs each body: it reads one flag a
trip on the host, or, inside a captured CUDA graph, leaves the trips to
the device. The history is the same fixed ``(m, d)`` ring buffer.

With a (k, d) start on a ``LaneGLMObjective`` (a random-effect bucket of k
entities) both solvers run over the lanes in lock step, as the reference's
loop does under ``jax.vmap`` (``_lbfgs_lanes``): every lane keeps its own
history ring, line search, acceptance and stopping reason, done lanes are
frozen under their masks, and the eager loop reads one flag a line-search
trial and one an iteration for the whole bucket. The lane loop
is three pieces, a state (``LbfgsLaneState``), ``init``, ``run`` to an
iteration bound and ``finalize``: the one-shot lane solve runs them once,
and lane compaction runs them in chunks through the public twins
(``lbfgs_chunk_*``, ``owlqn_chunk_*``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.ops import graphs
from photon_ml_tpu_torch.ops.glm import LaneGLMObjective, device_scalar
from photon_ml_tpu_torch.optim.common import ConvergenceReason, LaneState, OptimizationResult

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


def _two_loop(pg: Tensor, S: Tensor, Y: Tensor, rho: Tensor, count: Tensor, m: int, steps: int) -> Tensor:
    """Two-loop recursion: r ≈ H⁻¹·pg from the ring-buffer history (the
    newest ``min(count, m)`` pairs), with the pair count on the device: the
    ring is gathered newest first (slot (count − 1 − j) mod m at step j)
    and ``steps`` (≥ min(count, m)) steps run, each masked where
    j ≥ min(count, m), so a masked step leaves q and r exactly as they
    were; γ is 1 while count is 0."""
    j = torch.arange(m, device=pg.device)
    valid = j < torch.clamp_max(count, m)
    newest_first = torch.remainder(count - 1 - j, m)
    S_o, Y_o, rho_o = S[newest_first], Y[newest_first], rho[newest_first]
    q = pg
    alpha = []
    for i in range(steps):  # newest to oldest
        a = rho_o[i] * torch.dot(S_o[i], q)
        q = torch.where(valid[i], q - a * Y_o[i], q)
        alpha.append(a)
    yy = torch.dot(Y_o[0], Y_o[0])
    gamma = torch.where(count > 0, torch.dot(S_o[0], Y_o[0]) / torch.clamp_min(yy, 1e-30), 1.0)
    r = gamma * q
    for i in reversed(range(steps)):  # oldest to newest
        beta = rho_o[i] * torch.dot(Y_o[i], r)
        r = torch.where(valid[i], r + (alpha[i] - beta) * S_o[i], r)
    return r


def _lbfgs_impl(
    objective: Any, w0: Tensor, config: OptimizerConfig, l1w: Tensor | None
) -> OptimizationResult:
    """One GLM's solve. Its iteration and its line-search trial are bodies
    over state tensors written in place, run by ``graphs.loop``: the eager
    driver reads one flag before each iteration and each trial, and inside
    a capture the device decides. The pair count, the iteration and trial
    counts and the stopping reason live on the device; the result's counts
    are read once at the end (under ``graphs.deferring`` they stay tensors
    for the deferred run's one read)."""
    m = config.history_length
    T = config.max_iterations
    max_ls = config.max_line_search_steps
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
    f0, g0, pg0 = value_and_grads(w0)
    g0_norm = torch.linalg.norm(pg0)
    g_tol = config.tolerance * torch.clamp_min(g0_norm, 1.0)
    # the state, written in place by each iteration
    w, f, g, pg = w0.clone(), f0.clone(), g0.clone(), pg0.clone()
    S = torch.zeros((m, d), dtype=dtype, device=dev)
    Y = torch.zeros((m, d), dtype=dtype, device=dev)
    rho = torch.zeros((m,), dtype=dtype, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    evals = torch.ones((), dtype=torch.int64, device=dev)  # the initial value_and_grads
    reason = torch.full((), int(ConvergenceReason.MAX_ITERATIONS), dtype=torch.int64, device=dev)
    done = g0_norm <= g_tol
    go = ~done
    loss_hist = torch.full((T + 1,), float("nan"), dtype=dtype, device=dev)
    gnorm_hist = torch.full((T + 1,), float("nan"), dtype=dtype, device=dev)
    loss_hist[0] = f0
    gnorm_hist[0] = g0_norm
    slots = torch.arange(m, device=dev)

    def iteration(trip: int | None) -> None:
        # the pairs held are at most the iterations run (the trip's index);
        # inside a capture all m slots run, masked
        p = -_two_loop(pg, S, Y, rho, count, m, m if trip is None else min(trip, m))
        if use_l1:
            # constrain the search direction to the descent orthant
            p = torch.where(p * (-pg) > 0.0, p, torch.zeros_like(p))
        # fall back to steepest descent if the direction isn't a descent dir
        p = torch.where(torch.dot(p, pg) < 0.0, p, -pg)

        if use_l1:
            xi = torch.where(w != 0.0, torch.sign(w), torch.sign(-pg))

            def trial_point(t):
                x = w + t * p
                return torch.where(torch.sign(x) == xi, x, torch.zeros_like(x))

        else:

            def trial_point(t):
                return w + t * p

        # First iteration: the Hessian guess is the identity, so scale the
        # initial step to unit length.
        p_norm = torch.linalg.norm(p)
        t = torch.where(count == 0, 1.0 / torch.clamp_min(p_norm, 1.0), torch.ones_like(p_norm))

        def armijo_rhs(w_new):
            return f + _ARMIJO_C1 * torch.dot(pg, w_new - w)

        def hopeless(w_new):
            # achievable decrease below the f32 resolution of f: no
            # representable improvement is possible
            return torch.abs(torch.dot(pg, w_new - w)) < 1e-7 * torch.abs(f)

        def insufficient(f_new, w_new):
            return ((f_new > armijo_rhs(w_new)) | torch.isnan(f_new)) & ~hopeless(w_new)

        slope0 = torch.dot(pg, p)  # directional derivative at t = 0

        def next_t(f_t):
            # safeguarded quadratic interpolation through f(0), f'(0), f(t),
            # clamped to [t/10, t/2]
            denom = 2.0 * (f_t - f - slope0 * t)
            t_q = -slope0 * t * t / torch.where(denom != 0.0, denom, torch.ones_like(denom))
            t_q = torch.where(torch.isfinite(t_q) & (denom > 0.0), t_q, 0.5 * t)
            return torch.minimum(torch.maximum(t_q, 0.1 * t), 0.5 * t)

        w_new = trial_point(t)
        ls_k = torch.zeros((), dtype=torch.int64, device=dev)
        if fused_eval:
            # value_and_grad costs one X read, like value alone: each trial
            # evaluates both and an accepted step needs no extra pass
            f2, g2, pg2 = (v.clone() for v in value_and_grads(w_new))
            searching = insufficient(f2, w_new)

            def trial(_trip) -> None:
                t.copy_(next_t(f2))
                w_new.copy_(trial_point(t))
                for buf, v in zip((f2, g2, pg2), value_and_grads(w_new)):
                    buf.copy_(v)
                ls_k.add_(1)
                searching.copy_(insufficient(f2, w_new))

            graphs.loop(max_ls, searching, trial)
            evals.add_(1 + ls_k)
        else:
            f_new = full_value(w_new)
            searching = insufficient(f_new, w_new)

            def trial(_trip) -> None:
                t.copy_(next_t(f_new))
                w_new.copy_(trial_point(t))
                f_new.copy_(full_value(w_new))
                ls_k.add_(1)
                searching.copy_(insufficient(f_new, w_new))

            graphs.loop(max_ls, searching, trial)
            f2, g2, pg2 = value_and_grads(w_new)
            evals.add_(2 + ls_k)

        # Armijo acceptance, except the degenerate terminal case: a
        # fully-backtracked below-resolution step that does not decrease f
        # means converged within arithmetic precision (LINE_SEARCH_FAILED).
        degenerate = hopeless(w_new) & (f2 >= f)
        ls_ok = (f2 <= armijo_rhs(w_new)) & ~degenerate & ~torch.isnan(f2)
        s = w_new - w
        y = g2 - g
        sy = torch.dot(s, y)
        store = ls_ok & (sy > _CURVATURE_EPS)
        put = (slots == torch.remainder(count, m)) & store
        S.copy_(torch.where(put.unsqueeze(-1), s, S))
        Y.copy_(torch.where(put.unsqueeze(-1), y, Y))
        rho.copy_(torch.where(put, 1.0 / torch.clamp_min(sy, _CURVATURE_EPS), rho))
        count.add_(store.to(count.dtype))
        # a failed search keeps the old iterate and stops
        w.copy_(torch.where(ls_ok, w_new, w))
        f.copy_(torch.where(ls_ok, f2, f))
        g.copy_(torch.where(ls_ok, g2, g))
        pg.copy_(torch.where(ls_ok, pg2, pg))
        converged = torch.linalg.norm(pg2) <= g_tol
        reason.copy_(torch.where(
            ls_ok,
            torch.where(converged, int(ConvergenceReason.GRADIENT_CONVERGED), reason),
            int(ConvergenceReason.LINE_SEARCH_FAILED),
        ))
        done.copy_(~ls_ok | converged)
        loss_hist.index_copy_(0, (it + 1).view(1), f.view(1))
        gnorm_hist.index_copy_(0, (it + 1).view(1), torch.linalg.norm(pg).view(1))
        it.add_(1)
        go.copy_(~done)

    graphs.loop(T, go, iteration)
    # the initial point already satisfied the test
    reason = torch.where((it == 0) & done, int(ConvergenceReason.GRADIENT_CONVERGED), reason)
    counts = it, reason, evals
    if not graphs.is_deferring():  # a deferred run reads them at its end
        counts = tuple(int(c) for c in graphs.read_all([torch.stack(counts)])[0])
    return OptimizationResult(
        w=w,
        value=f,
        grad_norm=torch.linalg.norm(pg),
        iterations=counts[0],
        reason=counts[1],
        loss_history=loss_hist,
        grad_norm_history=gnorm_hist,
        objective_passes=counts[2],
    )


def _lane_two_loop(pg: Tensor, S: Tensor, Y: Tensor, rho: Tensor, count: Tensor, m: int, steps: int) -> Tensor:
    """``_two_loop`` per lane: (k, d) r ≈ H⁻¹·pg from each lane's newest
    min(count, m) pairs of its (k, m, d) ring, gathered newest first (slot
    (count − 1 − j) mod m at step j). ``steps`` (≥ every lane's
    min(count, m)) steps run, each masked where j ≥ min(count, m), so a
    masked step leaves a lane's q and r exactly as they were, and γ is 1
    where count = 0; the forward loop walks the steps back, so each lane
    meets its unused steps first, then its pairs oldest to newest, as the
    reference's loop does. Nothing is read back: the counts stay on the
    device."""
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
        r = torch.where(valid[:, i].unsqueeze(-1), r + (alpha[i] - beta).unsqueeze(-1) * S_o[:, i], r)
    return r


@dataclass
class LbfgsLaneState(LaneState):
    """The L-BFGS / OWL-QN lane loop's state between chunks: the iterate,
    its margins, value, gradient and (pseudo-)gradient, each lane's
    gradient tolerance, its (m, d) history ring with ρ and pair count,
    iterations, objective passes, stopping reason, done flag and
    (T + 1) histories; ``step`` is the shared iteration count. A run
    writes the tensors in place."""

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
    pass), in tensors of its own."""
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
        w=w0.clone(), mg=mg, f=f, g=g, pg=pg.clone() if pg is g else pg, g_tol=g_tol,
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
    step reaches min(``it_bound``, max_iterations), writing ``st``'s
    tensors in place.

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
    steps). The iteration and the trial are bodies run by ``graphs.loop``
    (one flag read each under the eager driver); inside a capture the
    returned state's ``step`` is the bound (the device decided the trips)."""
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
    # every active lane has taken exactly `step` iterations, so the history
    # column below is the same for each lane in any front
    step = torch.full((k, 1), st.step, dtype=torch.int64, device=dev)
    go = ~done.all()

    def iteration(trip: int | None) -> None:
        active = ~done
        # every lane holds at most `st.step + trip` pairs; inside a capture
        # all m slots run, masked
        p = -_lane_two_loop(pg, S, Y, rho, count, m, m if trip is None else min(st.step + trip, m))
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

            def trial(t):
                x = w + t.unsqueeze(-1) * p
                w_t = torch.where(torch.sign(x) == xi, x, 0.0)
                m_t = obj.margins(w_t)
                f_t = obj.value_from_margins(m_t, w_t) + torch.sum(l1w * torch.abs(w_t), dim=-1)
                return w_t, m_t, f_t

        else:
            dm = obj.direction_margins(p)

            def trial(t):
                w_t = w + t.unsqueeze(-1) * p
                m_t = mg + t.unsqueeze(-1) * dm
                return w_t, m_t, obj.value_from_margins(m_t, w_t)

        def decrease(w_t):
            return torch.sum(pg * (w_t - w), dim=-1)

        def hopeless(dec):
            # achievable decrease below the f32 resolution of f
            return torch.abs(dec) < 1e-7 * torch.abs(f)

        def keep_searching(f_t, w_t):
            dec = decrease(w_t)
            insufficient = (f_t > f + _ARMIJO_C1 * dec) | torch.isnan(f_t)
            return insufficient & ~hopeless(dec)

        w_t, m_t, f_t = trial(t)
        ls_k = torch.zeros(k, dtype=torch.int64, device=dev)
        searching = active & keep_searching(f_t, w_t)
        any_searching = searching.any()

        def line_search_trial(_trip) -> None:
            # safeguarded quadratic interpolation through f(0), f'(0), f(t),
            # clamped to [t/10, t/2], per lane
            denom = 2.0 * (f_t - f - slope0 * t)
            t_q = -slope0 * t * t / torch.where(denom != 0.0, denom, 1.0)
            t_q = torch.where(torch.isfinite(t_q) & (denom > 0.0), t_q, 0.5 * t)
            t.copy_(torch.where(searching, torch.minimum(torch.maximum(t_q, 0.1 * t), 0.5 * t), t))
            w_n, m_n, f_n = trial(t)
            lane = searching.unsqueeze(-1)
            w_t.copy_(torch.where(lane, w_n, w_t))
            m_t.copy_(torch.where(lane, m_n, m_t))
            f_t.copy_(torch.where(searching, f_n, f_t))
            ls_k.add_(searching.to(ls_k.dtype))
            searching.copy_(searching & keep_searching(f_t, w_t))
            any_searching.copy_(searching.any())

        graphs.loop(max_ls, any_searching, line_search_trial)

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
        S.copy_(torch.where(put.unsqueeze(-1), s.unsqueeze(1), S))
        Y.copy_(torch.where(put.unsqueeze(-1), y.unsqueeze(1), Y))
        rho.copy_(torch.where(put, (1.0 / torch.clamp_min(sy, _CURVATURE_EPS)).unsqueeze(-1), rho))
        count.add_(store.to(count.dtype))

        converged = torch.linalg.norm(pg2, dim=-1) <= g_tol
        take = active & ls_ok  # a failed search keeps the old iterate; done lanes stay frozen
        lane = take.unsqueeze(-1)
        w.copy_(torch.where(lane, w_t, w))
        mg.copy_(torch.where(lane, m_t, mg))
        g.copy_(torch.where(lane, g2, g))
        pg.copy_(torch.where(lane, pg2, pg))
        f.copy_(torch.where(take, f2, f))
        new_reason = torch.where(
            ~ls_ok,
            int(ConvergenceReason.LINE_SEARCH_FAILED),
            torch.where(
                converged,
                int(ConvergenceReason.GRADIENT_CONVERGED),
                int(ConvergenceReason.MAX_ITERATIONS),
            ),
        )
        reason.copy_(torch.where(active, new_reason, reason))
        done.copy_(done | (active & (~ls_ok | converged)))
        it.add_(active.to(it.dtype))
        evals.add_(active.to(evals.dtype) * (2 + ls_k))
        col = step + 1
        loss_hist.scatter_(1, col, torch.where(active, f, loss_hist.gather(1, col).squeeze(1)).unsqueeze(1))
        gnorm_hist.scatter_(1, col, torch.where(
            active, torch.linalg.norm(pg, dim=-1), gnorm_hist.gather(1, col).squeeze(1)).unsqueeze(1))
        step.add_(1)
        go.copy_(~done.all())

    trips = graphs.loop(bound - st.step, go, iteration)
    return dataclasses.replace(st, step=bound if trips is None else st.step + trips)


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
    return device_scalar(l1_weight, objective.reg_mask.device, dtype) * objective.reg_mask


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
    l1w = device_scalar(l1_weight, w0.device, w0.dtype) * objective.reg_mask
    if _lanes(objective, w0):
        return _lbfgs_lanes(objective, w0, config, l1w)
    return _lbfgs_impl(objective, w0, config, l1w)
