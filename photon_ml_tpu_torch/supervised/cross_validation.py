"""K-fold cross-validation of the GLM sweep (port of
``photon_ml_tpu/supervised/cross_validation.py``).

Each fold trains the full warm-started λ sweep (``train_glm``) on its k-1
training folds and scores every λ's model on the held-out fold; the λ with
the best mean metric wins and is refit on all rows. The folds are gathered
from the batch on its device (one row gather per fold), through
``ops/prefetch.py`` at depth at most 1: the next fold's gather and layout
run on a worker thread while this fold trains, and training and scoring
stay on the calling thread in fold order, so the result is bitwise the
synchronous one.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch._device import check_device
from photon_ml_tpu_torch.config import OptimizerConfig, RegularizationContext
from photon_ml_tpu_torch.evaluation import DEFAULT_EVALUATOR_BY_TASK, make_evaluator
from photon_ml_tpu_torch.obs import span
from photon_ml_tpu_torch.ops import prefetch
from photon_ml_tpu_torch.ops.batch import Batch, DenseBatch, SparseBatch, optimize_batch_layout
from photon_ml_tpu_torch.supervised.training import GLMTrainingResult, train_glm
from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

__all__ = ["CrossValidationResult", "cross_validate_glm"]


@dataclass(frozen=True)
class CrossValidationResult:
    """Per-λ per-fold metrics, the selected weight and its refit."""

    metric_values: Mapping[float, list[float]]  # [λ][fold]: the primary metric on the held-out rows
    metric_name: str
    best_weight: float
    final: GLMTrainingResult  # the best λ refit on all rows

    def mean(self, lam: float) -> float:
        return float(np.mean(self.metric_values[lam]))

    def std(self, lam: float) -> float:
        return float(np.std(self.metric_values[lam]))

    def summary(self) -> dict:
        return {
            "metric": self.metric_name,
            "best_weight": self.best_weight,
            "per_weight": {
                str(lam): {"mean": self.mean(lam), "std": self.std(lam),
                           "folds": [float(v) for v in vals]}
                for lam, vals in self.metric_values.items()
            },
        }


def _row_select(batch: Batch, rows: np.ndarray) -> Batch:
    """The batch's rows ``rows``, gathered on its device."""
    if not isinstance(batch, (DenseBatch, SparseBatch)):
        raise TypeError(f"cross-validation takes a DenseBatch or SparseBatch, not {type(batch).__name__}")
    idx = torch.as_tensor(rows, dtype=torch.int64, device=batch.device)
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[idx]
        for f in dataclasses.fields(batch) if isinstance(getattr(batch, f.name), torch.Tensor)
    })


def _ingest_training_batch(batch: Batch) -> Batch:
    """The fold and refit layout rule: ``optimize_batch_layout`` for a
    sparse batch (dense when it fits, K3's layouts for high-dimensional
    data); a dense batch passes unchanged."""
    return optimize_batch_layout(batch) if isinstance(batch, SparseBatch) else batch


def cross_validate_glm(
    batch: Batch,
    task: TaskType,
    k: int = 5,
    regularization_weights: Sequence[float] = (0.0,),
    evaluator: str | None = None,
    seed: int = 0,
    optimizer_config: OptimizerConfig | None = None,
    regularization: RegularizationContext | None = None,
    normalization=None,
    intercept_index: int | None = None,
    variance_computation: VarianceComputationType = VarianceComputationType.NONE,
    device=None,
) -> CrossValidationResult:
    """Select λ by k-fold CV, then refit the winner on all rows, on
    ``device`` (CUDA unless the caller passes another), which must hold
    ``batch``. ``evaluator`` defaults per task (AUC for classification,
    RMSE for linear, POISSON_LOSS for counts); the folds are numpy's
    permutation of the rows under ``seed``, as in the reference."""
    dev = check_device(batch.device, device)
    if k < 2:
        raise ValueError(f"k-fold CV needs k >= 2, got {k}")
    n = batch.num_rows
    if n < k:
        raise ValueError(f"cannot split {n} rows into {k} folds")
    ev = make_evaluator(evaluator or DEFAULT_EVALUATOR_BY_TASK[task])

    perm = np.random.default_rng(seed).permutation(n)
    folds = np.array_split(perm, k)
    metric_values: dict[float, list[float]] = {float(lam): [] for lam in regularization_weights}

    def ingest_fold(i):
        # the span roots on the worker thread that gathers the fold
        with span("ingest/cv-fold", fold=i):
            train_rows = np.setdiff1d(perm, folds[i], assume_unique=True)
            return _ingest_training_batch(_row_select(batch, train_rows))

    # one fold ahead at most: each item is a near-full training batch
    prefetch.require_stream_executor_off("cv")
    for i, train_batch in enumerate(
        prefetch.prefetch_iter(len(folds), ingest_fold, depth=min(prefetch.prefetch_depth(), 1))
    ):
        with span("cv/fold", fold=i, k=k):
            result = train_glm(
                train_batch, task, optimizer_config=optimizer_config, regularization=regularization,
                regularization_weights=regularization_weights, normalization=normalization,
                intercept_index=intercept_index, device=dev,
            )
            val = _row_select(batch, folds[i])
            for lam, model in result.models.items():
                metric_values[float(lam)].append(float(ev(model.score(val), val.labels, val.weights)))

    best_weight = None
    best_mean = float("nan")
    for lam, vals in metric_values.items():
        m = float(np.mean(vals))
        if best_weight is None or ev.better(m, best_mean):
            best_weight, best_mean = lam, m

    with span("cv/refit", weight=float(best_weight), k=k):
        final = train_glm(
            _ingest_training_batch(batch), task, optimizer_config=optimizer_config,
            regularization=regularization, regularization_weights=[best_weight],
            normalization=normalization, intercept_index=intercept_index,
            variance_computation=variance_computation, device=dev,
        )
    return CrossValidationResult(
        metric_values=metric_values, metric_name=ev.name, best_weight=best_weight, final=final,
    )
