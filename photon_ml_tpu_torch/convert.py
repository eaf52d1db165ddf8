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
from photon_ml_tpu_torch.ops.batch import DenseBatch, SparseBatch, dense_batch_from_arrays
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


def sparse_batch_from_numpy(
    indices: np.ndarray,
    values: np.ndarray,
    labels: np.ndarray,
    offsets: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    *,
    num_features: int,
    device=None,
) -> SparseBatch:
    """A padded-sparse batch from (n, k) feature indices and values (the
    JAX ``SparseBatch``'s arrays); absent offsets are 0 and absent weights
    1. Indices are checked against ``num_features`` here, on the host."""
    dev = resolve_device(device)
    idx = np.asarray(indices, np.int64)
    val = np.asarray(values, np.float32)
    if idx.ndim != 2 or idx.shape != val.shape:
        raise ValueError(f"indices {idx.shape} and values {val.shape} must be one (n, k) shape")
    if idx.size and (idx.min() < 0 or idx.max() >= num_features):
        raise ValueError(f"feature index out of range [0, {num_features})")
    n = idx.shape[0]
    return SparseBatch(
        indices=torch.as_tensor(idx, device=dev),
        values=_f32(val, dev),
        labels=_f32(labels, dev),
        offsets=torch.zeros(n, device=dev) if offsets is None else _f32(offsets, dev),
        weights=torch.ones(n, device=dev) if weights is None else _f32(weights, dev),
        num_features=int(num_features),
    )


def game_batch_from_numpy(
    labels: np.ndarray,
    features: dict,
    id_tags: dict | None = None,
    offsets: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    device=None,
):
    """A ``GameBatch`` from the JAX ``GameBatch``'s columns: each shard a
    2-D dense array, or a padded-sparse shard as a dict with ``indices``,
    ``values`` and ``num_features``; entity-id columns as integer arrays."""
    from photon_ml_tpu_torch.game.data import SparseFeatures, make_game_batch

    dev = resolve_device(device)
    feats = {}
    for sid, f in features.items():
        if isinstance(f, dict):
            feats[sid] = SparseFeatures(
                torch.as_tensor(np.asarray(f["indices"], np.int64), device=dev),
                _f32(f["values"], dev), int(f["num_features"]),
            )
        else:
            feats[sid] = np.asarray(f, np.float32)
    return make_game_batch(labels, feats, id_tags, offsets, weights, device=dev)


def game_model_from_numpy(models: dict, task: TaskType | str, device=None):
    """A ``GameModel`` from per-coordinate coefficient arrays. Each entry
    of ``models`` (coordinate id → dict) is a fixed effect, with
    ``feature_shard_id``, ``means`` (d,) and ``variances``, or a random
    effect, with ``feature_shard_id``, ``random_effect_type``,
    ``coefficients`` (E, d) and ``variances``; absent variances are None."""
    from photon_ml_tpu_torch.game.models import FixedEffectModel, GameModel, RandomEffectModel

    dev = resolve_device(device)
    task = TaskType(getattr(task, "value", task))
    out = {}
    for cid, m in models.items():
        var = m.get("variances")
        var = None if var is None else _f32(var, dev)
        if "random_effect_type" in m:
            out[cid] = RandomEffectModel(
                coefficients=_f32(m["coefficients"], dev), variances=var,
                random_effect_type=m["random_effect_type"],
                feature_shard_id=m["feature_shard_id"], task_type=task,
            )
        else:
            out[cid] = FixedEffectModel(
                model=GeneralizedLinearModel(Coefficients(_f32(m["means"], dev), var), task),
                feature_shard_id=m["feature_shard_id"],
            )
    return GameModel(models=out, task_type=task)


def streamed_game_data_from_numpy(data):
    """The port's host-resident ``StreamedGameData`` from the JAX
    package's (anything with its ``labels``, ``features``, ``id_tags``,
    ``offsets`` and ``weights``): the same numpy arrays, each feature shard
    a 2-D dense array, a container with ``X``, or one with ``indices``,
    ``values`` and ``num_features``. Nothing is copied to a device. A
    streamed checkpoint needs no conversion: both packages write and read
    the same ``ckpt.npz``."""
    from photon_ml_tpu_torch.game.data import DenseFeatures, SparseFeatures
    from photon_ml_tpu_torch.game.streaming import StreamedGameData

    feats = {}
    for sid, f in data.features.items():
        if hasattr(f, "indices"):
            feats[sid] = SparseFeatures(indices=np.asarray(f.indices), values=np.asarray(f.values),
                                        num_features=int(f.num_features))
        else:
            feats[sid] = DenseFeatures(X=np.asarray(getattr(f, "X", f)))

    def col(a):
        return None if a is None else np.asarray(a)

    return StreamedGameData(
        labels=np.asarray(data.labels), features=feats,
        id_tags={t: np.asarray(v) for t, v in (data.id_tags or {}).items()},
        offsets=col(data.offsets), weights=col(data.weights),
    )
