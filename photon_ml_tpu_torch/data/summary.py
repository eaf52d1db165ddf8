"""Feature summarization feeding normalization (port of ``summarize``,
``shard_normalization_context`` and ``summarize_chunks`` in
``photon_ml_tpu/data/summary.py``)."""

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
        self, norm_type: NormalizationType, intercept_index: int | None = None, device=None
    ) -> NormalizationContext:
        """The context of these statistics on ``device`` (CUDA unless asked;
        raises without it)."""
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


def shard_normalization_context(
    summary: FeatureSummary,
    norm_type: NormalizationType,
    shard_id: str,
    intercept_index: int | None,
    log=None,
    device=None,
) -> NormalizationContext:
    """The GAME trainers' per-shard context policy: a shard without an
    intercept cannot absorb the shift on the output model, so
    STANDARDIZATION degrades to scale-only there (and says so through
    ``log``). The context lies on ``device`` (CUDA unless asked)."""
    if intercept_index is None and norm_type is NormalizationType.STANDARDIZATION:
        norm_type = NormalizationType.SCALE_WITH_STANDARD_DEVIATION
        if log is not None:
            log(
                f"shard {shard_id!r} has no intercept: STANDARDIZATION degraded to "
                "SCALE_WITH_STANDARD_DEVIATION (shifts need an intercept to absorb "
                "on the output model)"
            )
    return summary.normalization(norm_type, intercept_index, device=device)


def summarize_chunks(chunks, num_features: int, cross_process: bool = False) -> FeatureSummary:
    """Streamed twin of ``summarize`` over uniform host chunk dicts
    (``ops/streaming.py`` builders or ``AvroDataReader.iter_batch_chunks``):
    weighted statistics in float64 numpy with O(d) accumulators, one chunk
    at a time. The same semantics: implicit zeros take part in the moments
    and in min / max, zero-weight padding rows are inert, and duplicate
    (row, column) entries add up before squaring. ``cross_process`` (a
    summary over every process's chunks) is ROADMAP queue 1 item 12."""
    if cross_process:
        raise NotImplementedError(
            "summarizing chunks across processes waits for ROADMAP queue 1 item 12 (multi-GPU)"
        )
    d = num_features
    w_total = 0.0
    n_active = 0
    s1 = np.zeros(d, np.float64)  # Σ w x
    s2 = np.zeros(d, np.float64)  # Σ w x²
    nnz = np.zeros(d, np.int64)
    vmin = np.full(d, np.inf)
    vmax = np.full(d, -np.inf)
    n_present = np.zeros(d, np.int64)  # active rows where the feature is explicit

    for chunk in chunks:
        w = np.asarray(chunk["weights"], np.float64)
        active = w > 0
        w_total += w.sum()
        n_active += int(active.sum())
        if "X" in chunk:
            X = np.asarray(chunk["X"], np.float64)
            s1 += (w[:, None] * X).sum(0)
            s2 += (w[:, None] * X * X).sum(0)
            Xa = X[active]
            if Xa.size:
                vmin = np.minimum(vmin, Xa.min(0))
                vmax = np.maximum(vmax, Xa.max(0))
                nnz += (Xa != 0).sum(0)
            n_present += int(active.sum())
        else:
            idx = np.asarray(chunk["indices"], np.int64)
            val = np.asarray(chunk["values"], np.float64)
            n, k = idx.shape
            rows = np.repeat(np.arange(n, dtype=np.int64), k)
            flat_v = val.ravel()
            # duplicates per (row, column) add up before squaring; padding
            # slots (value 0) drop out of nnz, min and max
            key = rows * d + idx.ravel()
            uniq, inv = np.unique(key, return_inverse=True)
            summed = np.zeros(len(uniq), np.float64)
            np.add.at(summed, inv, flat_v)
            explicit = np.zeros(len(uniq), np.bool_)
            np.bitwise_or.at(explicit, inv, flat_v != 0.0)
            urows = (uniq // d).astype(np.int64)
            ucols = (uniq % d).astype(np.int64)
            summed, urows, ucols = summed[explicit], urows[explicit], ucols[explicit]
            uw = w[urows]
            np.add.at(s1, ucols, uw * summed)
            np.add.at(s2, ucols, uw * summed * summed)
            a = active[urows]
            if a.any():
                np.minimum.at(vmin, ucols[a], summed[a])
                np.maximum.at(vmax, ucols[a], summed[a])
                np.add.at(nnz, ucols[a], (summed[a] != 0).astype(np.int64))
                np.add.at(n_present, ucols[a], 1)

    if w_total <= 0:
        raise ValueError("summarize: total sample weight is zero")
    # a feature absent from some active row has 0 among its min/max candidates
    has_implicit = n_present < n_active
    vmin = np.where(n_present == 0, 0.0, np.where(has_implicit, np.minimum(vmin, 0.0), vmin))
    vmax = np.where(n_present == 0, 0.0, np.where(has_implicit, np.maximum(vmax, 0.0), vmax))
    mean = s1 / w_total
    # E[w x²]/W − mean², float64 sums
    var = np.maximum(s2 / w_total - mean * mean, 0.0)
    return FeatureSummary(
        mean=mean,
        variance=var,
        min=vmin,
        max=vmax,
        max_magnitude=np.maximum(np.abs(vmin), np.abs(vmax)),
        num_nonzeros=nnz,
        count=n_active,
    )
