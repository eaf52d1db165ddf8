"""Single-GLM training: regularization sweep with warm start, validation,
model selection and coefficient variances (port of ``train_glm`` in
``photon_ml_tpu/supervised/training.py``; the streamed sweep waits for the
out-of-core slice)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import torch

from photon_ml_tpu_torch._device import check_device
from photon_ml_tpu_torch.config import OptimizerConfig, RegularizationContext
from photon_ml_tpu_torch.evaluation import (
    DEFAULT_EVALUATOR_BY_TASK,
    EvaluationResults,
    evaluate_all,
    make_evaluator,
)
from photon_ml_tpu_torch.models import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.normalization import NormalizationContext, require_intercept_for_shifts
from photon_ml_tpu_torch.ops.batch import Batch
from photon_ml_tpu_torch.ops.glm import GaussianPrior, compute_variances, make_objective
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optim.common import OptimizationResult, select_minimize_fn
from photon_ml_tpu_torch.types import RegularizationType, TaskType, VarianceComputationType


@dataclass(frozen=True)
class GLMTrainingResult:
    """Per-λ models + diagnostics, and the selected best model."""

    models: Mapping[float, GeneralizedLinearModel]
    trackers: Mapping[float, OptimizationResult]
    validation: Mapping[float, EvaluationResults]
    best_weight: float | None

    @property
    def best_model(self) -> GeneralizedLinearModel:
        if self.best_weight is None:
            # no validation data: the sweep's last (most regularized) model
            return self.models[list(self.models)[-1]]
        return self.models[self.best_weight]


def train_glm(
    batch: Batch,
    task: TaskType,
    optimizer_config: OptimizerConfig | None = None,
    regularization: RegularizationContext | None = None,
    regularization_weights: Sequence[float] = (0.0,),
    normalization: NormalizationContext | None = None,
    intercept_index: int | None = None,
    validation_batch: Batch | None = None,
    evaluators: Sequence[str] = (),
    variance_computation: VarianceComputationType = VarianceComputationType.NONE,
    initial_model: GeneralizedLinearModel | None = None,
    incremental: bool = False,
    device=None,
) -> GLMTrainingResult:
    """Train one GLM per regularization weight (ascending, warm-started),
    validate each, and select the best by the first evaluator.

    ``incremental=True`` turns ``initial_model`` from a plain warm start
    into an informative Gaussian prior (MAP update) pulling toward its
    means with strength 1/variance per coordinate.

    Runs on ``device`` (CUDA unless the caller passes another), which must
    hold ``batch`` and ``validation_batch``."""
    dev = check_device(batch.device, device)
    if validation_batch is not None:
        check_device(validation_batch.device, dev)
    optimizer_config = optimizer_config or OptimizerConfig()
    if regularization is None:
        # nonzero weights imply plain L2 (λ>0 with type NONE would silently
        # train unregularized)
        has_weights = any(w > 0 for w in regularization_weights)
        regularization = RegularizationContext(
            RegularizationType.L2 if has_weights else RegularizationType.NONE
        )
    elif regularization.regularization_type is RegularizationType.NONE and any(
        w > 0 for w in regularization_weights
    ):
        raise ValueError(
            "regularization_weights > 0 with RegularizationType.NONE would be "
            "silently ignored; pass an L1/L2/ELASTIC_NET context or drop the weights"
        )
    loss = loss_for_task(task)
    d = batch.num_features
    require_intercept_for_shifts(normalization)
    if normalization is not None:
        normalization = normalization.to(dev)

    # The optimizer works in NORMALIZED coefficient space; models are kept
    # in ORIGINAL space.
    prior = None
    if initial_model is not None:
        means = torch.as_tensor(initial_model.coefficients.means, dtype=torch.float32, device=dev)
        w = means
        if normalization is not None:
            w = normalization.model_from_original_space(w)
        if incremental:
            if not any(regularization.l2_weight(lam) > 0 for lam in regularization_weights):
                raise ValueError(
                    "incremental=True needs at least one sweep weight with a "
                    "positive L2 component: the prior's pull is "
                    "l2_weight * (1/prior_variance)"
                )
            variances = initial_model.coefficients.variances
            prior = GaussianPrior.from_coefficients(
                means,
                None if variances is None
                else torch.as_tensor(variances, dtype=torch.float32, device=dev),
                normalization,
            )
    else:
        if incremental:
            raise ValueError("incremental=True requires initial_model (the prior)")
        w = torch.zeros((d,), dtype=torch.float32, device=dev)

    specs = list(evaluators)
    if validation_batch is not None and not specs:
        specs = [DEFAULT_EVALUATOR_BY_TASK[task]]
    primary = make_evaluator(specs[0]) if specs else None

    models: dict[float, GeneralizedLinearModel] = {}
    trackers: dict[float, OptimizationResult] = {}
    validation: dict[float, EvaluationResults] = {}
    best_weight: float | None = None
    best_value = float("nan")

    for lam in sorted(regularization_weights):  # ascending, warm-started
        obj = make_objective(
            batch,
            loss,
            l2_weight=regularization.l2_weight(lam),
            norm=normalization,
            intercept_index=intercept_index,
            prior=prior,
            device=dev,
        )
        minimize_fn, extra = select_minimize_fn(optimizer_config, regularization.l1_weight(lam))
        result = minimize_fn(obj, w, optimizer_config, **extra)
        w = result.w  # warm start for the next λ (normalized space)

        variances = compute_variances(obj, result.w, variance_computation)
        w_model = result.w
        if normalization is not None:
            w_model, _ = normalization.model_to_original_space(result.w)
            if variances is not None:
                # linear map u = f⊙w ⇒ var scales by f² (diagonal approx.)
                variances = normalization.factors**2 * variances
        model = GeneralizedLinearModel(Coefficients(w_model, variances), task)
        models[lam] = model
        trackers[lam] = result

        if validation_batch is not None and specs:
            # evaluators consume RAW scores (margins + offsets)
            res = evaluate_all(
                specs, model.score(validation_batch), validation_batch.labels,
                validation_batch.weights,
            )
            validation[lam] = res
            if primary is not None and (
                best_weight is None or primary.better(res.primary, best_value)
            ):
                best_weight, best_value = lam, res.primary

    return GLMTrainingResult(
        models=models, trackers=trackers, validation=validation, best_weight=best_weight
    )
