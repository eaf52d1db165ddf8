"""Synthetic GLM problems (port of ``photon_ml_tpu/data/synthetic.py``)."""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.ops.batch import DenseBatch, dense_batch_from_arrays
from photon_ml_tpu_torch.types import TaskType

_CLASSIFICATION = (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)


def synthetic_glm_data(
    rng: np.random.Generator | int,
    n: int,
    d: int,
    task: TaskType = TaskType.LOGISTIC_REGRESSION,
    noise: float = 0.1,
    add_intercept: bool = True,
    dtype=torch.float32,
    device=None,
) -> tuple[DenseBatch, int | None, torch.Tensor]:
    """Dense GLM problem with known ground-truth weights: X ~ N(0, 1) (plus
    a ones column at index d when ``add_intercept``), w_true ~ N(0, 0.25),
    labels drawn from the task's model at X @ w_true.

    ``rng`` is a numpy ``Generator``, which draws on the host exactly as the
    reference's generator does (the tests feed both packages that way), or an
    int seed, which draws on ``device`` with a ``torch.Generator`` (the
    chip-size problems, whose host draw would take longer than the solve).
    X is stored in ``dtype``; labels, offsets (0) and weights (1) are
    float32. ``device`` defaults to CUDA. Returns (batch, intercept_index,
    w_true)."""
    dev = resolve_device(device)
    intercept_index = d if add_intercept else None
    if isinstance(rng, np.random.Generator):
        X = rng.normal(size=(n, d)).astype(np.float32)
        if add_intercept:
            X = np.concatenate([X, np.ones((n, 1), np.float32)], axis=1)
        w_true = (rng.normal(size=X.shape[1]) * 0.5).astype(np.float32)
        margin = X @ w_true
        if task in _CLASSIFICATION:
            y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
        elif task is TaskType.LINEAR_REGRESSION:
            y = (margin + rng.normal(scale=noise, size=n)).astype(np.float32)
        elif task is TaskType.POISSON_REGRESSION:
            y = rng.poisson(np.exp(np.clip(margin, -10, 3))).astype(np.float32)
        else:  # pragma: no cover
            raise ValueError(task)
        batch = dense_batch_from_arrays(X, y, dtype=dtype, device=dev)
        return batch, intercept_index, torch.as_tensor(w_true, device=dev)

    gen = torch.Generator(device=dev).manual_seed(int(rng))
    f32 = dict(dtype=torch.float32, device=dev)
    width = d + (1 if add_intercept else 0)
    X = torch.randn((n, width), generator=gen, **f32)
    if add_intercept:
        X[:, d] = 1.0
    w_true = torch.randn((width,), generator=gen, **f32) * 0.5
    margin = X @ w_true
    if task in _CLASSIFICATION:
        y = (torch.rand((n,), generator=gen, **f32) < torch.sigmoid(margin)).float()
    elif task is TaskType.LINEAR_REGRESSION:
        y = margin + noise * torch.randn((n,), generator=gen, **f32)
    elif task is TaskType.POISSON_REGRESSION:
        y = torch.poisson(torch.exp(torch.clamp(margin, -10, 3)), generator=gen)
    else:  # pragma: no cover
        raise ValueError(task)
    batch = DenseBatch(
        X=X.to(dtype),
        labels=y,
        offsets=torch.zeros((n,), **f32),
        weights=torch.ones((n,), **f32),
    )
    return batch, intercept_index, w_true
