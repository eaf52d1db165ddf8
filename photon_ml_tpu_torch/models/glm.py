"""Generalized linear model classes (port of ``photon_ml_tpu/models/glm.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from photon_ml_tpu_torch.ops.batch import Batch
from photon_ml_tpu_torch.ops.losses import PointwiseLoss, loss_for_task
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclass(frozen=True)
class Coefficients:
    """Model coefficients: means + optional per-coordinate variances
    (produced by VarianceComputationType SIMPLE/FULL)."""

    means: Tensor
    variances: Tensor | None = None

    @property
    def dim(self) -> int:
        return self.means.shape[-1]


@dataclass(frozen=True)
class GeneralizedLinearModel:
    """A GLM: coefficients + task type (which fixes loss and link)."""

    coefficients: Coefficients
    task_type: TaskType = TaskType.LOGISTIC_REGRESSION

    @property
    def loss(self) -> PointwiseLoss:
        return loss_for_task(self.task_type)

    def score(self, batch: Batch) -> Tensor:
        """Raw margins w·x + offset."""
        return batch.matvec(self.coefficients.means) + batch.offsets

    def predict(self, batch: Batch) -> Tensor:
        """Mean response: inverse link applied to margins."""
        return self.loss.mean(self.score(batch))


class LogisticRegressionModel(GeneralizedLinearModel):
    def __init__(self, coefficients: Coefficients):
        super().__init__(coefficients, TaskType.LOGISTIC_REGRESSION)


class LinearRegressionModel(GeneralizedLinearModel):
    def __init__(self, coefficients: Coefficients):
        super().__init__(coefficients, TaskType.LINEAR_REGRESSION)


class PoissonRegressionModel(GeneralizedLinearModel):
    def __init__(self, coefficients: Coefficients):
        super().__init__(coefficients, TaskType.POISSON_REGRESSION)


class SmoothedHingeLossLinearSVMModel(GeneralizedLinearModel):
    def __init__(self, coefficients: Coefficients):
        super().__init__(coefficients, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)


def model_for_task(task: TaskType, coefficients: Coefficients) -> GeneralizedLinearModel:
    return GeneralizedLinearModel(coefficients, task)
