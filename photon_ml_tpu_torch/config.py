"""Typed configuration (own copy of ``photon_ml_tpu/config.py``): the
optimizer and regularization settings, the GAME coordinate configurations
and ``GameTrainingConfig``, each a frozen dataclass that round-trips
through JSON (``to_dict`` / ``parse_config``) with the reference's field
names, values and defaults. The reference's ``MeshConfig``, which nothing
reads, has no copy here: the port builds its meshes with ``parallel.mesh``."""

from __future__ import annotations

import collections.abc
import dataclasses
import enum
import types
import typing
from dataclasses import dataclass, field
from typing import Any, Mapping

from photon_ml_tpu_torch.types import (
    DataValidationType,
    ModelOutputMode,
    NormalizationType,
    OptimizerType,
    RegularizationType,
    TaskType,
    VarianceComputationType,
)


def _to_jsonable(value: Any) -> Any:
    if isinstance(value, enum.Enum):
        return value.value
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _to_jsonable(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, Mapping):
        return {k: _to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_jsonable(v) for v in value]
    return value


class _JsonMixin:
    def to_dict(self) -> dict:
        return _to_jsonable(self)

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


@dataclass(frozen=True)
class RegularizationContext(_JsonMixin):
    """L1/L2/elastic-net bookkeeping. For ELASTIC_NET, ``alpha`` is the L1
    fraction: l1 = alpha * weight, l2 = (1 - alpha) * weight."""

    regularization_type: RegularizationType = RegularizationType.NONE
    alpha: float = 0.5

    def l1_weight(self, regularization_weight: float) -> float:
        if self.regularization_type is RegularizationType.L1:
            return regularization_weight
        if self.regularization_type is RegularizationType.ELASTIC_NET:
            return self.alpha * regularization_weight
        return 0.0

    def l2_weight(self, regularization_weight: float) -> float:
        if self.regularization_type is RegularizationType.L2:
            return regularization_weight
        if self.regularization_type is RegularizationType.ELASTIC_NET:
            return (1.0 - self.alpha) * regularization_weight
        return 0.0


@dataclass(frozen=True)
class OptimizerConfig(_JsonMixin):
    """``tolerance`` is the relative gradient-norm tolerance (converged when
    ||g|| <= tolerance * max(1, ||g0||)); ``max_iterations`` bounds the
    outer loop."""

    optimizer_type: OptimizerType = OptimizerType.LBFGS
    max_iterations: int = 100
    tolerance: float = 1e-7
    history_length: int = 10  # L-BFGS history size
    max_line_search_steps: int = 10  # also Newton's Armijo ladder length
    max_cg_iterations: int = 20  # TRON inner conjugate-gradient bound


@dataclass(frozen=True)
class OptimizationConfig(_JsonMixin):
    """One coordinate's optimizer, regularization and down-sampling rate."""

    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    regularization: RegularizationContext = field(default_factory=RegularizationContext)
    regularization_weight: float = 0.0
    down_sampling_rate: float = 1.0


@dataclass(frozen=True)
class FeatureShardConfig(_JsonMixin):
    """Which feature bags make up a shard, and whether it has an intercept."""

    feature_bags: tuple[str, ...] = ()
    has_intercept: bool = True


@dataclass(frozen=True)
class FixedEffectCoordinateConfig(_JsonMixin):
    feature_shard_id: str = "global"
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)


@dataclass(frozen=True)
class RandomEffectCoordinateConfig(_JsonMixin):
    """``random_effect_type`` names the entity-id column (e.g. "userId").
    ``active_data_upper_bound`` reservoir-samples each entity's training
    rows. ``sample_bucket_sizes`` fixes the bucket capacities; otherwise the
    capacity ladder is merged toward ``bucket_target_count`` classes while
    the padding merging adds stays under ``bucket_max_padded_ratio`` × the
    active rows (``game/data.py``). ``features_to_samples_ratio_upper_bound``
    solves each entity in the subspace of its ceil(ratio · capacity) most
    frequent columns; ``random_projection_dim`` solves over a shared random
    projection of the shard to that width (``game/projector.py``)."""

    random_effect_type: str = "entityId"
    feature_shard_id: str = "per_entity"
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    active_data_upper_bound: int | None = None
    features_to_samples_ratio_upper_bound: float | None = None
    random_projection_dim: int | None = None
    sample_bucket_sizes: tuple[int, ...] | None = None
    bucket_target_count: int = 4
    bucket_max_padded_ratio: float = 4.0


@dataclass(frozen=True)
class NormalizationConfig(_JsonMixin):
    normalization_type: NormalizationType = NormalizationType.NONE


@dataclass(frozen=True)
class GameTrainingConfig(_JsonMixin):
    """A full GAME training run: coordinate configurations, update sequence,
    descent iterations, task, normalization, evaluators, output mode, warm
    start, variances and the per-coordinate regularization-weight grid
    (the training grid is the cross-product of those lists)."""

    task_type: TaskType = TaskType.LOGISTIC_REGRESSION
    coordinate_update_sequence: tuple[str, ...] = ("fixed",)
    coordinate_descent_iterations: int = 1
    fixed_effect_coordinates: Mapping[str, FixedEffectCoordinateConfig] = field(
        default_factory=dict
    )
    random_effect_coordinates: Mapping[str, RandomEffectCoordinateConfig] = field(
        default_factory=dict
    )
    feature_shards: Mapping[str, FeatureShardConfig] = field(default_factory=dict)
    normalization: NormalizationType = NormalizationType.NONE
    evaluators: tuple[str, ...] = ()
    output_mode: ModelOutputMode = ModelOutputMode.BEST
    variance_computation: VarianceComputationType = VarianceComputationType.NONE
    data_validation: DataValidationType = DataValidationType.VALIDATE_DISABLED
    model_input_dir: str | None = None
    incremental: bool = False
    hyperparameter_tuning_iters: int = 0
    regularization_weight_grid: Mapping[str, tuple[float, ...]] = field(default_factory=dict)

    def coordinate_config(self, cid: str):
        if cid in self.fixed_effect_coordinates:
            return self.fixed_effect_coordinates[cid]
        if cid in self.random_effect_coordinates:
            return self.random_effect_coordinates[cid]
        raise KeyError(f"Unknown coordinate id: {cid!r}")


def _from_dict(cls, d: Mapping[str, Any]):
    """Dataclass from a JSON dict: only the keys present are passed, so the
    defaults live in the dataclass alone; nested dataclasses, enums and
    tuples are rebuilt from the field's annotation."""
    hints = typing.get_type_hints(cls)
    kwargs = {f.name: _convert(hints[f.name], d[f.name]) for f in dataclasses.fields(cls) if f.name in d}
    return cls(**kwargs)


def _convert(tp, v):
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is typing.Union or origin is types.UnionType:
        if v is None:
            return None
        return _convert([a for a in args if a is not type(None)][0], v)
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return tp(v)
    if dataclasses.is_dataclass(tp):
        return _from_dict(tp, v)
    if origin in (tuple, collections.abc.Sequence) or tp is tuple:
        inner = args[0] if args else str
        return tuple(_convert(inner, x) for x in v)
    if origin in (dict, collections.abc.Mapping):
        val_tp = args[1] if len(args) == 2 else str
        return {k: _convert(val_tp, x) for k, x in v.items()}
    if tp in (float, int, bool):
        return tp(v)
    return v


def parse_config(d: Mapping[str, Any]) -> GameTrainingConfig:
    """A ``GameTrainingConfig`` from a JSON-style dict (the inverse of
    ``to_dict``); absent keys keep the dataclass defaults."""
    return _from_dict(GameTrainingConfig, d)
