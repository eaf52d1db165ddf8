"""Feature summarization feeding normalization (port of ``summarize`` in
``photon_ml_tpu/data/summary.py``; the streamed ``summarize_chunks`` waits
for the out-of-core slice)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from photon_ml_tpu_torch.normalization import NormalizationContext, build_normalization
from photon_ml_tpu_torch.ops.batch import Batch, DenseBatch, densify
from photon_ml_tpu_torch.types import NormalizationType


@dataclass(frozen=True)
class FeatureSummary:
    """Weighted per-feature statistics over a dataset (host arrays)."""

    mean: np.ndarray
    variance: np.ndarray
    min: np.ndarray
    max: np.ndarray
    max_magnitude: np.ndarray
    num_nonzeros: np.ndarray
    count: int

    def normalization(
        self, norm_type: NormalizationType, intercept_index: int | None = None, device="cpu"
    ) -> NormalizationContext:
        return build_normalization(
            norm_type, self.mean, self.variance, self.max_magnitude, intercept_index,
            device=device,
        )


def summarize(batch: Batch) -> FeatureSummary:
    """Weighted feature statistics in float64 on the batch's device. A
    sparse batch is densified first, so its implicit zeros take part in the
    moments and duplicate (row, col) entries accumulate, as in the
    reference."""
    dense = batch if isinstance(batch, DenseBatch) else densify(batch, torch.float64)
    X = dense.X.double()
    w = batch.weights.double()
    total = float(w.sum())
    if total <= 0:
        raise ValueError("summarize: total sample weight is zero")
    mean = (w[:, None] * X).sum(0) / total
    var = (w[:, None] * (X - mean) ** 2).sum(0) / total
    Xa = X[w > 0]
    d = X.shape[1]
    zeros = torch.zeros(d, dtype=torch.float64, device=X.device)
    has_rows = Xa.shape[0] > 0

    def host(t):
        return t.cpu().numpy()

    return FeatureSummary(
        mean=host(mean),
        variance=host(var),
        min=host(Xa.min(0).values if has_rows else zeros),
        max=host(Xa.max(0).values if has_rows else zeros),
        max_magnitude=host(Xa.abs().max(0).values if has_rows else zeros),
        num_nonzeros=host((Xa != 0).sum(0)).astype(np.int64),
        count=int(Xa.shape[0]),
    )
