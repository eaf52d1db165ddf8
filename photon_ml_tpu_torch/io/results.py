"""Scoring-result and feature-summary Avro writers (port of
``photon_ml_tpu/io/results.py``): the scoring driver's ``ScoringResultAvro``
output and the ``FeatureSummarizationResultAvro`` output."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.data.summary import FeatureSummary
from photon_ml_tpu_torch.io.avro import write_avro_file
from photon_ml_tpu_torch.io.model_io import _index_to_key
from photon_ml_tpu_torch.io.schemas import (
    FEATURE_SUMMARIZATION_RESULT_SCHEMA,
    SCORING_RESULT_SCHEMA,
)


def write_scoring_results(
    path: str,
    scores: np.ndarray | torch.Tensor,
    uids: Sequence | None = None,
    labels: np.ndarray | None = None,
    metadata: Sequence[Mapping[str, str]] | None = None,
) -> None:
    """One ``ScoringResultAvro`` record per row; a device tensor of scores
    is read back once."""
    if isinstance(scores, torch.Tensor):
        scores = scores.detach().cpu().numpy()
    scores = np.asarray(scores, np.float64).tolist()
    labels = None if labels is None else np.asarray(labels, np.float64).tolist()

    def records():
        for i, score in enumerate(scores):
            uid = None if uids is None else uids[i]
            if uid is not None and not isinstance(uid, (str, int)):
                uid = str(uid)
            yield {
                "uid": uid,
                "predictionScore": score,
                "label": None if labels is None else labels[i],
                "metadataMap": dict(metadata[i]) if metadata is not None else None,
            }

    write_avro_file(path, SCORING_RESULT_SCHEMA, records())


def write_feature_summary(
    path: str, summary: FeatureSummary, index_map: IndexMap | None = None
) -> None:
    d = len(summary.mean)
    keys = _index_to_key(index_map, d)

    def records():
        for i in range(d):
            yield {
                "featureName": keys[i][0],
                "featureTerm": keys[i][1],
                "metrics": {
                    "mean": float(summary.mean[i]),
                    "variance": float(summary.variance[i]),
                    "min": float(summary.min[i]),
                    "max": float(summary.max[i]),
                    "maxMagnitude": float(summary.max_magnitude[i]),
                    "numNonzeros": float(summary.num_nonzeros[i]),
                },
            }

    write_avro_file(path, FEATURE_SUMMARIZATION_RESULT_SCHEMA, records())
