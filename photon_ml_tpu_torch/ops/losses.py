"""Pointwise GLM losses ``l(margin, label)`` with first and second
derivatives with respect to the margin (port of ``photon_ml_tpu/ops/losses.py``).

Conventions (matching the reference):
- margin = w·x + offset
- logistic labels are 0/1; loss = softplus(-sign * margin), sign = 2y - 1,
  in the stable form max(x, 0) + log1p(exp(-|x|)) (equal to
  ``logaddexp(x, 0)``, which is ``jax.nn.softplus``).
- Poisson uses the log link: loss = exp(margin) - y * margin.
- squared loss = 0.5 * (margin - y)^2.
- smoothed hinge (Rennie & Srebro) on z = sign * margin.

Each loss carries a small integer ``kernel_id``: the CUDA kernels in
``csrc/fused_glm.cu`` take the loss as a template parameter switched on
that id (the Pallas kernel received the loss as a traced Python callable,
which CUDA cannot take). The ids here and the ``LossId`` enum in the CUDA
source must agree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclass(frozen=True)
class PointwiseLoss:
    """``value``/``d1``/``d2`` map (margin, label) elementwise; ``mean`` is
    the inverse link (prediction from margin)."""

    name: str
    kernel_id: int
    value: Callable[[Tensor, Tensor], Tensor]
    d1: Callable[[Tensor, Tensor], Tensor]
    d2: Callable[[Tensor, Tensor], Tensor]
    mean: Callable[[Tensor], Tensor]


def softplus(x: Tensor) -> Tensor:
    """Stable softplus: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


# --- logistic -----------------------------------------------------------------
def _logistic_value(m: Tensor, y: Tensor) -> Tensor:
    return softplus(-(2.0 * y - 1.0) * m)


def _logistic_d1(m: Tensor, y: Tensor) -> Tensor:
    # d/dm softplus(-s m) = sigmoid(m) - y   (y in {0, 1})
    return torch.sigmoid(m) - y


def _logistic_d2(m: Tensor, y: Tensor) -> Tensor:
    p = torch.sigmoid(m)
    return p * (1.0 - p)


logistic_loss = PointwiseLoss(
    "logistic", 0, _logistic_value, _logistic_d1, _logistic_d2, torch.sigmoid
)

# --- squared ------------------------------------------------------------------
squared_loss = PointwiseLoss(
    "squared",
    1,
    value=lambda m, y: 0.5 * (m - y) ** 2,
    d1=lambda m, y: m - y,
    d2=lambda m, y: torch.ones_like(m),
    mean=lambda m: m,
)

# --- poisson ------------------------------------------------------------------
poisson_loss = PointwiseLoss(
    "poisson",
    2,
    value=lambda m, y: torch.exp(m) - y * m,
    d1=lambda m, y: torch.exp(m) - y,
    d2=lambda m, y: torch.exp(m),
    mean=torch.exp,
)


# --- smoothed hinge -----------------------------------------------------------
def _hinge_z(m: Tensor, y: Tensor) -> tuple[Tensor, Tensor]:
    sign = 2.0 * y - 1.0
    return sign, sign * m


def _smoothed_hinge_value(m: Tensor, y: Tensor) -> Tensor:
    # z <= 0: 0.5 - z;  0 < z < 1: 0.5 (1 - z)^2;  z >= 1: 0
    _, z = _hinge_z(m, y)
    zero = torch.zeros_like(z)
    return torch.where(
        z <= 0.0, 0.5 - z, torch.where(z < 1.0, 0.5 * (1.0 - z) ** 2, zero)
    )


def _smoothed_hinge_d1(m: Tensor, y: Tensor) -> Tensor:
    sign, z = _hinge_z(m, y)
    dz = torch.where(
        z <= 0.0, -torch.ones_like(z), torch.where(z < 1.0, z - 1.0, torch.zeros_like(z))
    )
    return sign * dz


def _smoothed_hinge_d2(m: Tensor, y: Tensor) -> Tensor:
    _, z = _hinge_z(m, y)
    return ((z > 0.0) & (z < 1.0)).to(z.dtype)


smoothed_hinge_loss = PointwiseLoss(
    "smoothed_hinge",
    3,
    _smoothed_hinge_value,
    _smoothed_hinge_d1,
    _smoothed_hinge_d2,
    mean=lambda m: m,  # SVM decision value
)

LOSSES: dict[str, PointwiseLoss] = {
    loss.name: loss
    for loss in (logistic_loss, squared_loss, poisson_loss, smoothed_hinge_loss)
}


def loss_for_task(task: TaskType) -> PointwiseLoss:
    return {
        TaskType.LOGISTIC_REGRESSION: logistic_loss,
        TaskType.LINEAR_REGRESSION: squared_loss,
        TaskType.POISSON_REGRESSION: poisson_loss,
        TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: smoothed_hinge_loss,
    }[task]
