"""Shared optimizer machinery (port of ``photon_ml_tpu/optim/common.py``):
convergence reasons, the result record, the relative gradient test and the
optimizer-selection rule, which also picks the host-driven twins of the
streamed objectives. The chunked entry points wait for the
lane-compaction knob."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable

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
