"""GAME models: fixed effect, random effect and their container (port of
``photon_ml_tpu/game/models.py``). A random-effect model is one (E, d)
matrix on the device, so scoring a batch is a gather and a row-wise dot."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Mapping

import torch

from photon_ml_tpu_torch.game.data import GameBatch
from photon_ml_tpu_torch.game.random_effect import random_effect_scores
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclass(frozen=True)
class FixedEffectModel:
    """One global GLM over a feature shard."""

    model: GeneralizedLinearModel
    feature_shard_id: str

    @property
    def coefficient_means(self) -> Tensor:
        return self.model.coefficients.means

    def score(self, batch: GameBatch) -> Tensor:
        """Raw contribution w·x per row (no offsets: the caller sums them)."""
        return batch.features[self.feature_shard_id].score(self.model.coefficients.means)

    def to(self, device) -> "FixedEffectModel":
        c = self.model.coefficients
        return dataclasses.replace(self, model=dataclasses.replace(self.model, coefficients=Coefficients(
            c.means.to(device), None if c.variances is None else c.variances.to(device))))


@dataclass(frozen=True)
class RandomEffectModel:
    """Per-entity GLMs as one (E, d) coefficient matrix."""

    coefficients: Tensor  # (E, d)
    variances: Tensor | None
    random_effect_type: str  # the entity-id tag this effect keys on
    feature_shard_id: str
    task_type: TaskType = TaskType.LOGISTIC_REGRESSION

    @property
    def num_entities(self) -> int:
        return self.coefficients.shape[0]

    @property
    def coefficient_means(self) -> Tensor:
        return self.coefficients

    def score(self, batch: GameBatch) -> Tensor:
        """w_{e(i)}·x_i per row; rows whose entity id is out of range
        (unseen in training: id < 0 or >= E) score 0."""
        return self.score_rows(batch.features[self.feature_shard_id], batch.id_tags[self.random_effect_type])

    def score_rows(self, features, ids: Tensor) -> Tensor:
        """``score`` of rows given as their feature container and entity
        ids (on the coefficients' device or another: the rows' decides)."""
        in_range = (ids >= 0) & (ids < self.num_entities)
        safe_ids = torch.where(in_range, ids, torch.zeros_like(ids))
        raw = random_effect_scores(features, safe_ids, self.coefficients.to(ids.device))
        return torch.where(in_range, raw, torch.zeros_like(raw))

    def to(self, device) -> "RandomEffectModel":
        return dataclasses.replace(self, coefficients=self.coefficients.to(device),
                                   variances=None if self.variances is None else self.variances.to(device))

    def model_for_entity(self, entity: int) -> GeneralizedLinearModel:
        var = None if self.variances is None else self.variances[entity]
        return GeneralizedLinearModel(Coefficients(self.coefficients[entity], var), self.task_type)


GameSubModel = FixedEffectModel | RandomEffectModel


@dataclass(frozen=True)
class GameModel:
    """Per-coordinate models. ``score`` sums the coordinates' contributions
    and the data offsets; ``predict`` applies the task's inverse link."""

    models: Mapping[str, GameSubModel] = field(default_factory=dict)
    task_type: TaskType = TaskType.LOGISTIC_REGRESSION

    def __getitem__(self, coordinate_id: str) -> GameSubModel:
        return self.models[coordinate_id]

    def __contains__(self, coordinate_id: str) -> bool:
        return coordinate_id in self.models

    def coordinate_scores(self, batch: GameBatch) -> dict[str, Tensor]:
        return {cid: m.score(batch) for cid, m in self.models.items()}

    def score(self, batch: GameBatch) -> Tensor:
        total = batch.offsets
        for m in self.models.values():
            total = total + m.score(batch)
        return total

    def predict(self, batch: GameBatch) -> Tensor:
        return loss_for_task(self.task_type).mean(self.score(batch))

    def updated(self, coordinate_id: str, model: GameSubModel) -> "GameModel":
        models = dict(self.models)
        models[coordinate_id] = model
        return GameModel(models=models, task_type=self.task_type)
