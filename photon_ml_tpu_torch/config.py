"""Optimizer and regularization configuration (own copy of
``RegularizationContext`` and ``OptimizerConfig`` from
``photon_ml_tpu/config.py``; the GAME configuration classes wait for the
GAME slice)."""

from __future__ import annotations

from dataclasses import dataclass

from photon_ml_tpu_torch.types import OptimizerType, RegularizationType


@dataclass(frozen=True)
class RegularizationContext:
    """L1/L2/elastic-net bookkeeping. For ELASTIC_NET, ``alpha`` is the L1
    fraction: l1 = alpha * weight, l2 = (1 - alpha) * weight."""

    regularization_type: RegularizationType = RegularizationType.NONE
    alpha: float = 0.5

    def l1_weight(self, regularization_weight: float) -> float:
        if self.regularization_type is RegularizationType.L1:
            return regularization_weight
        if self.regularization_type is RegularizationType.ELASTIC_NET:
            return self.alpha * regularization_weight
        return 0.0

    def l2_weight(self, regularization_weight: float) -> float:
        if self.regularization_type is RegularizationType.L2:
            return regularization_weight
        if self.regularization_type is RegularizationType.ELASTIC_NET:
            return (1.0 - self.alpha) * regularization_weight
        return 0.0


@dataclass(frozen=True)
class OptimizerConfig:
    """``tolerance`` is the relative gradient-norm tolerance (converged when
    ||g|| <= tolerance * max(1, ||g0||)); ``max_iterations`` bounds the
    outer loop."""

    optimizer_type: OptimizerType = OptimizerType.LBFGS
    max_iterations: int = 100
    tolerance: float = 1e-7
    history_length: int = 10  # L-BFGS history size
    max_line_search_steps: int = 10
    max_cg_iterations: int = 20  # TRON inner conjugate-gradient bound
