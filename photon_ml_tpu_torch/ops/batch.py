"""Sample batches for GLM training (port of ``photon_ml_tpu/ops/batch.py``).

- ``DenseBatch``: features as one ``(n, d)`` matrix, stored float32 or
  bfloat16. With bfloat16 storage the vector operand is rounded to
  bfloat16 and products accumulate in float32, as in the reference.
- ``SparseBatch``: padded per-row ``(n, k)`` (index, value) pairs; padding
  uses index 0 with value 0, which contributes exactly 0.
- ``TiledSparseBatch`` (``ops/sparse_tiled.py``): high-dimensional sparse
  data in the sparse kernel's per-direction layouts.

Padded rows carry weight 0; the objective forces zero-weight rows to
contribute exactly 0 (a select, not a multiply), so padding may hold any
values.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.ops.sparse_tiled import (
    TiledSparseBatch,
    supports_tiling,
    tile_sparse_batch,
)

Tensor = torch.Tensor


def _mm(A: Tensor, v: Tensor) -> Tensor:
    """Matrix-vector product honouring bfloat16 storage: both operands are
    rounded to bfloat16 and the sum is float32 (products of two bfloat16
    values are exact in float32). Float32 storage runs in full float32."""
    if A.dtype == torch.bfloat16:
        return A.float() @ v.to(torch.bfloat16).float()
    return A @ v


@dataclass(frozen=True)
class DenseBatch:
    """X: (n, d) float32 or bfloat16; labels/offsets/weights: (n,) float32.

    With a leading lane axis (X (L, C, d) float32, the rest (L, C): a
    random-effect bucket of L entities) the products are batched over the
    lanes (``torch.bmm``): ``matvec`` takes (L, d) and gives (L, C),
    ``rmatvec`` / ``rmatvec_sq`` take (L, C) and give (L, d)."""

    X: Tensor
    labels: Tensor
    offsets: Tensor
    weights: Tensor

    @property
    def num_features(self) -> int:
        return self.X.shape[-1]

    @property
    def num_rows(self) -> int:
        return self.X.shape[0]

    @property
    def device(self) -> torch.device:
        return self.X.device

    def matvec(self, w: Tensor) -> Tensor:
        """Margins X @ w."""
        if self.X.dim() == 3:
            return torch.bmm(self.X, w.unsqueeze(-1)).squeeze(-1)
        return _mm(self.X, w)

    def rmatvec(self, r: Tensor) -> Tensor:
        """Gradient contraction Xᵀ @ r."""
        if self.X.dim() == 3:
            return torch.bmm(self.X.transpose(1, 2), r.unsqueeze(-1)).squeeze(-1)
        return _mm(self.X.T, r)

    def rmatvec_sq(self, r: Tensor) -> Tensor:
        """(X ⊙ X)ᵀ @ r — Hessian diagonal: Σ_i r_i x_ij²."""
        sq = self.X * self.X
        if sq.dim() == 3:
            return torch.bmm(sq.transpose(1, 2), r.unsqueeze(-1)).squeeze(-1)
        return _mm(sq.T, r)


@dataclass(frozen=True)
class SparseBatch:
    """indices: (n, k) int64 feature ids padded with 0; values: (n, k)
    float padded with 0.0; ``num_features`` is the feature dimension d.

    With a leading lane axis (indices and values (L, C, k), labels /
    offsets / weights (L, C): a random-effect bucket of L entities) the
    products run per lane: ``matvec`` takes (L, d) coefficients and gives
    (L, C) margins, ``rmatvec`` / ``rmatvec_sq`` take (L, C) and give
    (L, d). A padded slot carries value 0 and weight 0."""

    indices: Tensor
    values: Tensor
    labels: Tensor
    offsets: Tensor
    weights: Tensor
    num_features: int

    @property
    def num_rows(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.values.device

    def matvec(self, w: Tensor) -> Tensor:
        if self.indices.dim() == 3:
            lanes = self.indices.shape[0]
            picked = torch.gather(w, 1, self.indices.reshape(lanes, -1)).view_as(self.values)
            return torch.sum(self.values * picked, dim=-1)
        return torch.sum(self.values * w[self.indices], dim=-1)

    def _scatter(self, contrib: Tensor) -> Tensor:
        if self.indices.dim() == 3:
            lanes = self.indices.shape[0]
            out = torch.zeros((lanes, self.num_features), dtype=contrib.dtype,
                              device=contrib.device)
            return out.scatter_add_(1, self.indices.reshape(lanes, -1), contrib.reshape(lanes, -1))
        out = torch.zeros(self.num_features, dtype=contrib.dtype, device=contrib.device)
        return out.index_add_(0, self.indices.reshape(-1), contrib.reshape(-1))

    def rmatvec(self, r: Tensor) -> Tensor:
        return self._scatter(self.values * r.unsqueeze(-1))

    def rmatvec_sq(self, r: Tensor) -> Tensor:
        return self._scatter(self.values * self.values * r.unsqueeze(-1))


Batch = DenseBatch | SparseBatch | TiledSparseBatch


def densify(batch: SparseBatch, dtype=torch.float32) -> DenseBatch:
    """One-time scatter of a ``SparseBatch`` into a dense ``(n, d)``
    matrix; duplicate (row, col) entries accumulate."""
    n, k = batch.indices.shape
    rows = torch.arange(n, device=batch.device).repeat_interleave(k)
    X = torch.zeros((n, batch.num_features), dtype=dtype, device=batch.device)
    X.index_put_(
        (rows, batch.indices.reshape(-1)),
        batch.values.reshape(-1).to(dtype),
        accumulate=True,
    )
    return DenseBatch(
        X=X, labels=batch.labels, offsets=batch.offsets, weights=batch.weights
    )


def maybe_densify(
    batch: Batch, hbm_budget_bytes: float = 6e9, dtype=torch.float32
) -> Batch:
    """Densify a sparse batch when the dense matrix fits
    ``hbm_budget_bytes``; leave dense and over-budget batches unchanged."""
    if not isinstance(batch, SparseBatch):
        return batch
    itemsize = torch.empty((), dtype=dtype).element_size()
    if batch.num_rows * batch.num_features * itemsize > hbm_budget_bytes:
        return batch
    return densify(batch, dtype)


def hbm_budget_bytes(dev: torch.device) -> float:
    """Bytes a dense training matrix may take on ``dev``: the residency
    rule of ``ops/streaming.py`` ``device_hbm_budget_bytes``."""
    from photon_ml_tpu_torch.ops.streaming import device_hbm_budget_bytes

    return device_hbm_budget_bytes(device=dev)


def optimize_batch_layout(
    batch: Batch, hbm_budget_bytes: float = 6e9, dtype=torch.float32
) -> Batch:
    """The ingest layout decision for a single-device GLM solve: densify
    when the dense matrix fits ``hbm_budget_bytes``; otherwise build the
    sparse kernel's layouts (``TiledSparseBatch``, K3) for genuinely
    high-dimensional sparse data (``supports_tiling``); leave everything
    else unchanged."""
    out = maybe_densify(batch, hbm_budget_bytes, dtype)
    if supports_tiling(out):
        return tile_sparse_batch(out)
    return out


def dense_batch_from_arrays(
    X: np.ndarray,
    labels: np.ndarray,
    offsets: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    dtype=torch.float32,
    device=None,
) -> DenseBatch:
    """``DenseBatch`` from host arrays on ``device`` (CUDA unless the caller
    asks for another; raises without it): X in ``dtype``, the per-row
    vectors float32; absent offsets are 0 and absent weights 1."""
    device = resolve_device(device)
    n = X.shape[0]
    f32 = dict(dtype=torch.float32, device=device)

    def col(a, fill):
        if a is None:
            return torch.full((n,), fill, **f32)
        return torch.as_tensor(np.array(a, np.float32), **f32)

    return DenseBatch(
        X=torch.as_tensor(np.array(X, np.float32)).to(device=device, dtype=dtype),
        labels=col(labels, 0.0),
        offsets=col(offsets, 0.0),
        weights=col(weights, 1.0),
    )
