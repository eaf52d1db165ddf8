"""Shared optimizer machinery (port of ``photon_ml_tpu/optim/common.py``):
convergence reasons, the result record, the relative gradient test and the
optimizer-selection rule, which also picks the host-driven twins of the
streamed objectives, the chunked twins of the lane solvers
(``select_chunked_solver``, which lane compaction runs) and the signed-hash
folds of the capacity-class projection (``hash_fold_*``,
``hash_expand_*``)."""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.types import OptimizerType

Tensor = torch.Tensor


class ConvergenceReason(enum.IntEnum):
    """Why the optimizer stopped."""

    MAX_ITERATIONS = 0
    GRADIENT_CONVERGED = 1
    OBJECTIVE_CONVERGED = 2  # relative function decrease below tolerance
    LINE_SEARCH_FAILED = 3


@dataclass(frozen=True)
class OptimizationResult:
    """Solve output + per-iteration tracking. ``loss_history[i]`` /
    ``grad_norm_history[i]`` hold the value at iterate i for
    i <= iterations (i = 0 is the initial point); other slots are NaN.
    ``objective_passes`` counts objective evaluations over the data
    (value or value+grad passes and Hv passes, line-search trials
    included)."""

    w: Tensor
    value: Tensor
    grad_norm: Tensor
    iterations: int
    reason: int  # a ConvergenceReason value
    loss_history: Tensor
    grad_norm_history: Tensor
    objective_passes: int | None = None

    @property
    def converged(self) -> bool:
        return self.reason != ConvergenceReason.MAX_ITERATIONS

    def telemetry_record(self, **extra) -> dict:
        """The solve as one JSON-plain telemetry record: the reason's enum
        name, the iteration count, the final value and gradient norm (a
        read-back each when they lie on the card: called only while a sink
        is active), the objective passes where counted; ``extra`` tags it
        (coordinate, λ, fold)."""
        rec = {
            "reason": ConvergenceReason(int(self.reason)).name,
            "iterations": int(self.iterations),
            "value": float(self.value),
            "grad_norm": float(self.grad_norm),
        }
        if self.objective_passes is not None:
            rec["objective_passes"] = int(self.objective_passes)
        rec.update(extra)
        return rec


def grad_converged(g_norm: Tensor, g0_norm: Tensor, tolerance: float) -> bool:
    """Relative gradient-norm test: ||g|| <= tol·max(1, ||g0||)."""
    return bool(g_norm <= tolerance * torch.clamp_min(g0_norm, 1.0))


def select_minimize_fn(
    config: OptimizerConfig, l1_weight: float = 0.0, host: bool = False
) -> tuple[Callable, dict]:
    """The optimizer-selection rule: NEWTON_CHOLESKY or TRON if configured
    (each rejecting L1, as the reference does), else OWL-QN when L1 is
    active, else L-BFGS. Returns (fn, extra_kwargs);
    ``fn(objective, w0, config, **extra)`` runs the solve. ``host=True``
    picks the host-driven twins for streamed objectives (the same rule and
    rejections; NEWTON_CHOLESKY has no twin)."""
    if host:
        from photon_ml_tpu_torch.optim.host_lbfgs import host_lbfgs_minimize as lbfgs_fn
        from photon_ml_tpu_torch.optim.host_lbfgs import host_owlqn_minimize as owlqn_fn
        from photon_ml_tpu_torch.optim.host_tron import host_tron_minimize as tron_fn
    else:
        from photon_ml_tpu_torch.optim.lbfgs import lbfgs_minimize as lbfgs_fn
        from photon_ml_tpu_torch.optim.lbfgs import owlqn_minimize as owlqn_fn
        from photon_ml_tpu_torch.optim.tron import tron_minimize as tron_fn

    if config.optimizer_type is OptimizerType.NEWTON_CHOLESKY:
        if l1_weight > 0.0:
            raise ValueError(
                "NEWTON_CHOLESKY does not support L1 regularization "
                "(non-smooth; use LBFGS, which routes through OWL-QN)"
            )
        if host:
            raise ValueError(
                "NEWTON_CHOLESKY is a device-resident small-d solver; the "
                "streamed/out-of-core objectives use LBFGS or TRON"
            )
        from photon_ml_tpu_torch.optim.newton import newton_minimize

        return newton_minimize, {}
    if config.optimizer_type is OptimizerType.TRON:
        if l1_weight > 0.0:
            raise ValueError("TRON does not support L1 regularization (reference parity)")
        return tron_fn, {}
    if l1_weight > 0.0:
        return owlqn_fn, {"l1_weight": l1_weight}
    return lbfgs_fn, {}


# ---------------------------------------------------------------------------
# Signed-hash subspace folds (PHOTON_RE_PROJECT=hash): how a support-width
# warm start and diagonal Gaussian MAP prior become the hashed problem's,
# and how its solution comes back. ``S`` is the class's (d_e, m) signed
# fold (``game/projector.py`` ``ClassProjection.hash_matrix``) as a tensor.
# ---------------------------------------------------------------------------
def hash_fold_warm_start(w: Tensor, S: Tensor) -> Tensor:
    """Fold support-width warm starts ``w (…, d_e)`` through ``S``:
    w_h[t] = Σ_{j→t} sign_j·w_j / count_t, the least-squares inverse of
    w = S w_h, so the fold of an expansion gives it back. Empty slots
    stay 0."""
    return (w @ S) / torch.clamp_min(S.abs().sum(0), 1.0)


def hash_fold_prior(mu: Tensor, var: Tensor, S: Tensor) -> tuple[Tensor, Tensor]:
    """Fold a diagonal Gaussian prior (mu, var) through ``S`` by
    precision: 1/v_t = Σ_{j→t} 1/var_j and m_t = v_t·Σ_{j→t} sign_j·mu_j/var_j,
    the diagonal prior whose penalty on w_h is the full one restricted to
    the hashed subspace (up to a constant). Empty slots get the inert
    (0, 1) prior."""
    prec = 1.0 / var
    prec_h = prec @ S.abs()
    empty = prec_h <= 0.0
    var_h = torch.where(empty, 1.0, 1.0 / torch.where(empty, 1.0, prec_h))
    return torch.where(empty, 0.0, ((mu * prec) @ S) * var_h), var_h


def hash_expand_coefficients(w_h: Tensor, S: Tensor) -> Tensor:
    """Hashed coefficients ``w_h (…, m)`` back at the support:
    w_j = sign_j·w_h[slot_j] (= w_h Sᵀ), score-exact: (X S) w_h = X (S w_h)."""
    return w_h @ S.T


def hash_expand_variances(v_h: Tensor, S: Tensor) -> Tensor:
    """Hashed variances back at the support: each column takes its slot's
    variance (v_h |S|ᵀ; the signs square away)."""
    return v_h @ S.abs().T


# ---------------------------------------------------------------------------
# Chunked lane solvers (convergence-aware lane compaction)
# ---------------------------------------------------------------------------
class LaneState:
    """The state of a chunked lane solve between chunks: every tensor
    field has the lane as its first axis, and ``step`` is the iteration
    count every still-active lane has reached (active lanes step together,
    so ``it == step`` on each of them). ``take`` gathers lanes into a
    front, ``put`` commits a front's first lanes back, ``retire`` marks
    lanes done (the front's padding lanes)."""

    step: int

    def _tensor_fields(self):
        return [f.name for f in dataclasses.fields(self) if isinstance(getattr(self, f.name), Tensor)]

    def take(self, idx: Tensor):
        return dataclasses.replace(self, **{n: getattr(self, n)[idx] for n in self._tensor_fields()})

    def put(self, idx: Tensor, front, n: int):
        out = {}
        for name in self._tensor_fields():
            a = getattr(self, name).clone()
            a[idx] = getattr(front, name)[:n]
            out[name] = a
        return dataclasses.replace(self, step=front.step, **out)

    def retire(self, start: int):
        done = self.done.clone()
        done[start:] = True
        return dataclasses.replace(self, done=done)


class ChunkedSolver(NamedTuple):
    """Chunked twins of a lane solver (``select_chunked_solver``), over a
    ``LaneGLMObjective`` and a (k, d) start. ``init(objective, w0, config,
    **extra)`` builds the ``LaneState`` at ``w0`` (the initial objective
    pass); ``run(objective, state, config, it_bound, **extra)`` steps the
    lanes until each is done or ``state.step`` reaches the absolute bound
    ``it_bound`` (callers pass c, 2c, 3c, …); ``finalize(state)`` gives the
    ``OptimizationResult``. The state's ``it`` and ``done`` are per lane,
    so a caller can read them between chunks and gather the active lanes
    into a smaller front. Run to exhaustion on the same lanes, the chunks
    give bitwise the one-shot solve: the one-shot lane branches are these
    three pieces."""

    init: Callable
    run: Callable
    finalize: Callable


def select_chunked_solver(config: OptimizerConfig, l1_weight: float = 0.0) -> tuple[ChunkedSolver | None, dict]:
    """The chunked twins of ``select_minimize_fn``'s lane solvers, by the
    same rule: ``(solver, extra_kwargs)``, or ``(None, {})`` for
    NEWTON_CHOLESKY, whose loop has no chunked twin (its callers keep the
    single-launch schedule)."""
    if config.optimizer_type is OptimizerType.NEWTON_CHOLESKY:
        return None, {}
    if config.optimizer_type is OptimizerType.TRON:
        if l1_weight > 0.0:
            raise ValueError("TRON does not support L1 regularization (reference parity)")
        from photon_ml_tpu_torch.optim.tron import tron_chunk_finalize, tron_chunk_init, tron_chunk_run

        return ChunkedSolver(tron_chunk_init, tron_chunk_run, tron_chunk_finalize), {}
    from photon_ml_tpu_torch.optim import lbfgs

    if l1_weight > 0.0:
        return (ChunkedSolver(lbfgs.owlqn_chunk_init, lbfgs.owlqn_chunk_run, lbfgs.owlqn_chunk_finalize),
                {"l1_weight": l1_weight})
    return ChunkedSolver(lbfgs.lbfgs_chunk_init, lbfgs.lbfgs_chunk_run, lbfgs.lbfgs_chunk_finalize), {}
