"""Synthetic GLM and GAME problems (port of ``photon_ml_tpu/data/synthetic.py``)."""

from __future__ import annotations

from dataclasses import dataclass

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


@dataclass(frozen=True)
class GameSyntheticData:
    """A GLMix dataset: the fixed shard ``X`` (n, d_fixed + 1) with the
    intercept column last, labels ``y``, and per effect the entity id of
    every row (``entity_ids[name]``, (n,)), that effect's feature shard
    (``entity_X[name]``, (n, d_re)) and its generating coefficients
    (``w_entity[name]``, (num_entities, d_re)). Numpy arrays when drawn
    from a numpy ``Generator``, tensors on the device when drawn from a
    seed."""

    X: np.ndarray | torch.Tensor
    y: np.ndarray | torch.Tensor
    entity_ids: dict
    entity_X: dict
    w_fixed: np.ndarray | torch.Tensor
    w_entity: dict
    intercept_index: int


def synthetic_game_data(
    rng: np.random.Generator | int,
    n: int,
    d_fixed: int,
    effects: dict[str, tuple[int, int]],
    task: TaskType = TaskType.LOGISTIC_REGRESSION,
    entity_scale: float = 1.0,
    skew: float = 1.5,
    dtype=np.float32,
    device=None,
) -> GameSyntheticData:
    """GLMix data: margin = X·w_fixed + Σ_e w_e[entity_e(i)]·x_e(i).

    ``effects`` maps effect name → (num_entities, d_re). Entity j of an
    effect is drawn with probability ∝ (j + 1)^-skew, so entity sizes follow
    a power law. X and the entity shards are N(0, 1), w_fixed N(0, 0.25),
    each effect's coefficients N(0, entity_scale²); labels come from the
    task's model at the margin.

    A numpy ``Generator`` draws on the host exactly as the reference does
    (the same arrays, bit for bit, from the same generator state; ``device``
    is ignored). An int seed draws the same distributions on ``device``
    (CUDA unless the caller asks for another) with a ``torch.Generator``:
    a host draw at MovieLens-20M depth would first build a 10 GB float64
    matrix."""
    if isinstance(rng, np.random.Generator):
        return _game_data_numpy(rng, n, d_fixed, effects, task, entity_scale, skew, dtype)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(rng))
    f32 = dict(dtype=torch.float32, device=dev)
    X = torch.randn((n, d_fixed + 1), generator=gen, **f32)
    X[:, d_fixed] = 1.0
    w_fixed = torch.randn((d_fixed + 1,), generator=gen, **f32) * 0.5
    margin = X @ w_fixed
    entity_ids, entity_X, w_entity = {}, {}, {}
    for name, (num_entities, d_re) in effects.items():
        p = 1.0 / torch.arange(1, num_entities + 1, dtype=torch.float64, device=dev) ** skew
        cdf = torch.cumsum(p / p.sum(), 0)
        u = torch.rand((n,), generator=gen, dtype=torch.float64, device=dev)
        ids = torch.searchsorted(cdf, u, right=True).clamp_max_(num_entities - 1)
        Xe = torch.randn((n, d_re), generator=gen, **f32)
        We = torch.randn((num_entities, d_re), generator=gen, **f32) * entity_scale
        margin += torch.einsum("nd,nd->n", Xe, We[ids])
        entity_ids[name], entity_X[name], w_entity[name] = ids, Xe, We
    if task is TaskType.LOGISTIC_REGRESSION:
        y = (torch.rand((n,), generator=gen, **f32) < torch.sigmoid(margin)).float()
    elif task is TaskType.LINEAR_REGRESSION:
        y = margin + 0.1 * torch.randn((n,), generator=gen, **f32)
    elif task is TaskType.POISSON_REGRESSION:
        y = torch.poisson(torch.exp(torch.clamp(margin, -10, 3)), generator=gen)
    else:  # pragma: no cover
        raise ValueError(task)
    return GameSyntheticData(X, y, entity_ids, entity_X, w_fixed, w_entity, d_fixed)


def _game_data_numpy(rng, n, d_fixed, effects, task, entity_scale, skew, dtype):
    X = rng.normal(size=(n, d_fixed)).astype(dtype)
    X = np.concatenate([X, np.ones((n, 1), dtype)], axis=1)
    w_fixed = (rng.normal(size=d_fixed + 1) * 0.5).astype(dtype)
    margin = X @ w_fixed
    entity_ids, entity_X, w_entity = {}, {}, {}
    for name, (num_entities, d_re) in effects.items():
        probs = 1.0 / np.arange(1, num_entities + 1) ** skew
        probs /= probs.sum()
        ids = rng.choice(num_entities, size=n, p=probs).astype(np.int32)
        Xe = rng.normal(size=(n, d_re)).astype(dtype)
        We = (rng.normal(size=(num_entities, d_re)) * entity_scale).astype(dtype)
        margin = margin + np.sum(We[ids] * Xe, axis=1)
        entity_ids[name], entity_X[name], w_entity[name] = ids, Xe, We
    if task is TaskType.LOGISTIC_REGRESSION:
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(dtype)
    elif task is TaskType.LINEAR_REGRESSION:
        y = (margin + rng.normal(scale=0.1, size=n)).astype(dtype)
    elif task is TaskType.POISSON_REGRESSION:
        y = rng.poisson(np.exp(np.clip(margin, -10, 3))).astype(dtype)
    else:  # pragma: no cover
        raise ValueError(task)
    return GameSyntheticData(X, y, entity_ids, entity_X, w_fixed, w_entity, d_fixed)
