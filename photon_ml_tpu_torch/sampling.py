"""Per-coordinate down-sampling (own copy of ``photon_ml_tpu/sampling.py``):
a seeded host-side choice of training rows; scoring always sees every row.

- Binary classification keeps every positive, keeps each negative with
  probability ``rate`` and weights the kept negatives by ``1/rate``.
- Other tasks keep each row with probability ``rate``, unweighted.
"""

from __future__ import annotations

import numpy as np

from photon_ml_tpu_torch.types import TaskType


def default_down_sample(
    num_rows: int, rate: float, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray | None]:
    """Uniform Bernoulli sample of rows: (rows, None)."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"down-sampling rate must be in (0, 1), got {rate}")
    keep = rng.uniform(size=num_rows) < rate
    return np.flatnonzero(keep), None


def binary_classification_down_sample(
    labels: np.ndarray, rate: float, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Negative down-sampling: (rows, per-row weight multipliers)."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"down-sampling rate must be in (0, 1), got {rate}")
    labels = np.asarray(labels)
    positive = labels > 0
    keep = positive | (rng.uniform(size=labels.shape[0]) < rate)
    rows = np.flatnonzero(keep)
    scale = np.where(positive[rows], 1.0, 1.0 / rate).astype(np.float32)
    return rows, scale


def down_sample(
    task: TaskType, labels: np.ndarray, rate: float, seed: int = 0
) -> tuple[np.ndarray, np.ndarray | None]:
    """The task's sampler: (row indices, weight scale or None)."""
    rng = np.random.default_rng(seed)
    if task.is_classification:
        return binary_classification_down_sample(labels, rate, rng)
    return default_down_sample(len(labels), rate, rng)
