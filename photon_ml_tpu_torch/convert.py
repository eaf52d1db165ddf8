"""State carried across from the JAX package as plain numpy arrays.

Each function takes parameters the way the JAX package holds them (pass
its arrays through ``numpy.asarray``) and returns the port's objects, so
both packages can compute on the same model, normalization and data.
Nothing here imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.models import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.batch import DenseBatch, dense_batch_from_arrays
from photon_ml_tpu_torch.types import TaskType


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=dev)


def glm_from_numpy(
    means: np.ndarray, variances: np.ndarray | None, task: TaskType | str, device=None
) -> GeneralizedLinearModel:
    """A GLM from its coefficient means, optional variances and task (an
    enum of either package or its string value)."""
    dev = resolve_device(device)
    task = TaskType(getattr(task, "value", task))
    return GeneralizedLinearModel(
        Coefficients(_f32(means, dev), None if variances is None else _f32(variances, dev)),
        task,
    )


def normalization_from_numpy(
    factors: np.ndarray, shifts: np.ndarray, intercept_index: int | None, device=None
) -> NormalizationContext:
    dev = resolve_device(device)
    return NormalizationContext(_f32(factors, dev), _f32(shifts, dev), intercept_index)


def dense_batch_from_numpy(
    X: np.ndarray,
    labels: np.ndarray,
    offsets: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    dtype=torch.float32,
    device=None,
) -> DenseBatch:
    """X stored in ``dtype`` (float32 or bfloat16); a bfloat16 JAX array is
    passed as ``np.asarray(X.astype(jnp.float32))``, which is exact."""
    return dense_batch_from_arrays(X, labels, offsets, weights, dtype, resolve_device(device))
