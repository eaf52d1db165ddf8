"""Shared optimizer machinery (port of ``photon_ml_tpu/optim/common.py``):
convergence reasons, the result record, the relative gradient test and the
optimizer-selection rule. The chunked and host-streamed entry points wait
for the GAME and out-of-core slices."""

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


def grad_converged(g_norm: Tensor, g0_norm: Tensor, tolerance: float) -> bool:
    """Relative gradient-norm test: ||g|| <= tol·max(1, ||g0||)."""
    return bool(g_norm <= tolerance * torch.clamp_min(g0_norm, 1.0))


def select_minimize_fn(config: OptimizerConfig, l1_weight: float = 0.0) -> tuple[Callable, dict]:
    """The optimizer-selection rule: TRON if configured (rejecting L1, as
    the reference does), else OWL-QN when L1 is active, else L-BFGS.
    Returns (fn, extra_kwargs); ``fn(objective, w0, config, **extra)``
    runs the solve."""
    from photon_ml_tpu_torch.optim.lbfgs import lbfgs_minimize, owlqn_minimize
    from photon_ml_tpu_torch.optim.tron import tron_minimize

    if config.optimizer_type is OptimizerType.TRON:
        if l1_weight > 0.0:
            raise ValueError("TRON does not support L1 regularization (reference parity)")
        return tron_minimize, {}
    if l1_weight > 0.0:
        return owlqn_minimize, {"l1_weight": l1_weight}
    return lbfgs_minimize, {}
