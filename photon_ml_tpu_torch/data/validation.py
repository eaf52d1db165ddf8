"""Pre-training data validation (port of ``photon_ml_tpu/data/validation.py``):
finite features, labels, offsets and weights, the task's label domain
(binary for logistic and hinge, non-negative for Poisson) and non-negative
weights, over every row or a seeded sample of rows. The checks run on the
batch's device; only their verdicts come back."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from photon_ml_tpu_torch.types import DataValidationType, TaskType

_SAMPLE_FRACTION = 0.1
_MIN_SAMPLE = 1024


class DataValidationError(ValueError):
    """Raised when input data fails validation."""


def _sample_rows(n: int, mode: DataValidationType, seed: int) -> np.ndarray | slice:
    if mode is DataValidationType.VALIDATE_FULL:
        return slice(None)
    k = max(_MIN_SAMPLE, int(n * _SAMPLE_FRACTION))
    if k >= n:
        return slice(None)
    return np.random.default_rng(seed).choice(n, size=k, replace=False)


def _check_finite(name: str, a: torch.Tensor) -> None:
    bad = int((~torch.isfinite(a)).sum())
    if bad:
        raise DataValidationError(f"{name}: {bad} non-finite value(s)")


def validate_labels(labels: torch.Tensor, task: TaskType) -> None:
    _check_finite("labels", labels)
    if task.is_classification:
        if not bool(((labels == 0.0) | (labels == 1.0)).all()):
            raise DataValidationError(
                f"{task.value} requires binary labels in {{0, 1}}; found values outside that set"
            )
    elif task is TaskType.POISSON_REGRESSION and bool((labels < 0).any()):
        raise DataValidationError("POISSON_REGRESSION requires non-negative labels")


def validate_arrays(
    task: TaskType,
    labels,
    features,
    offsets=None,
    weights=None,
    mode: DataValidationType = DataValidationType.VALIDATE_FULL,
    seed: int = 0,
) -> None:
    """Validate the columns of a batch (tensors on one device, or arrays);
    raises ``DataValidationError``. ``features`` is one array or a mapping
    shard → array (dense rows, or a sparse shard's values)."""
    if mode is DataValidationType.VALIDATE_DISABLED:
        return
    labels = torch.as_tensor(labels)
    dev = labels.device
    rows = _sample_rows(labels.shape[0], mode, seed)
    if not isinstance(rows, slice):
        rows = torch.as_tensor(rows, device=dev)
    validate_labels(labels[rows], task)
    feats = features if isinstance(features, Mapping) else {"features": features}
    for sid, f in feats.items():
        _check_finite(f"features[{sid}]", torch.as_tensor(f, device=dev)[rows])
    if offsets is not None:
        _check_finite("offsets", torch.as_tensor(offsets, device=dev)[rows])
    if weights is not None:
        w = torch.as_tensor(weights, device=dev)[rows]
        _check_finite("weights", w)
        if bool((w < 0).any()):
            raise DataValidationError("weights must be non-negative")


def validate_game_batch(batch, task: TaskType, mode: DataValidationType, seed: int = 0) -> None:
    """Validate a built ``GameBatch``; raises ``DataValidationError``.
    Sparse shards check their values (indices are ingest-made)."""
    validate_arrays(
        task, batch.labels,
        {sid: f.X if hasattr(f, "X") else f.values for sid, f in batch.features.items()},
        offsets=batch.offsets, weights=batch.weights, mode=mode, seed=seed,
    )
