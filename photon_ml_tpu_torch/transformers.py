"""GAME transformer: score a dataset with a trained model (port of
``photon_ml_tpu/transformers.py``). The fixed effect is a dot product per
row; each random effect is an (E, d) matrix, so its score is a gather and a
row-wise dot; the contributions and the data offsets are summed."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from photon_ml_tpu_torch._device import check_device
from photon_ml_tpu_torch.evaluation import EvaluationResults, evaluate_all
from photon_ml_tpu_torch.game.data import GameBatch
from photon_ml_tpu_torch.game.models import GameModel

Tensor = torch.Tensor


class GameTransformer:
    """Scores ``GameBatch``es with a ``GameModel``. ``device`` is where the
    batches must lie (CUDA unless the caller asks for another; raises
    without it)."""

    def __init__(self, model: GameModel, logger: Callable[[str], None] | None = None, device=None):
        self.model = model
        self._log = logger or (lambda msg: None)
        self.device = device

    def transform(self, batch: GameBatch) -> Tensor:
        """Raw scores: Σ coordinate contributions + data offsets."""
        check_device(batch.device, self.device)
        return self.model.score(batch)

    def predict(self, batch: GameBatch) -> Tensor:
        """Mean response (the task's inverse link at the raw score)."""
        check_device(batch.device, self.device)
        return self.model.predict(batch)

    def transform_with_evaluation(
        self, batch: GameBatch, evaluators: Sequence[str]
    ) -> tuple[Tensor, EvaluationResults]:
        """Score and evaluate in one pass; evaluators read raw scores."""
        scores = self.transform(batch)
        results = evaluate_all(
            list(evaluators), scores, batch.labels, batch.weights, group_ids=batch.id_tags
        )
        self._log(f"scoring evaluation: {results}")
        return scores, results
