"""Sample batches for GLM training (port of ``photon_ml_tpu/ops/batch.py``).

- ``DenseBatch``: features as one ``(n, d)`` matrix, stored float32 or
  bfloat16. With bfloat16 storage the vector operand is rounded to
  bfloat16 and products accumulate in float32, as in the reference.
- ``SparseBatch``: padded per-row ``(n, k)`` (index, value) pairs; padding
  uses index 0 with value 0, which contributes exactly 0.

Padded rows carry weight 0; the objective forces zero-weight rows to
contribute exactly 0 (a select, not a multiply), so padding may hold any
values.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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
    """X: (n, d) float32 or bfloat16; labels/offsets/weights: (n,) float32."""

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
        return _mm(self.X, w)

    def rmatvec(self, r: Tensor) -> Tensor:
        """Gradient contraction Xᵀ @ r."""
        return _mm(self.X.T, r)

    def rmatvec_sq(self, r: Tensor) -> Tensor:
        """(X ⊙ X)ᵀ @ r — Hessian diagonal: Σ_i r_i x_ij²."""
        return _mm((self.X * self.X).T, r)


@dataclass(frozen=True)
class SparseBatch:
    """indices: (n, k) int64 feature ids padded with 0; values: (n, k)
    float padded with 0.0; ``num_features`` is the feature dimension d."""

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
        return torch.sum(self.values * w[self.indices], dim=-1)

    def _scatter(self, contrib: Tensor) -> Tensor:
        out = torch.zeros(self.num_features, dtype=contrib.dtype, device=contrib.device)
        return out.index_add_(0, self.indices.reshape(-1), contrib.reshape(-1))

    def rmatvec(self, r: Tensor) -> Tensor:
        return self._scatter(self.values * r[:, None])

    def rmatvec_sq(self, r: Tensor) -> Tensor:
        return self._scatter(self.values * self.values * r[:, None])


Batch = DenseBatch | SparseBatch


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


# The reference's tile-COO gate (``sparse_tiled.supports_tiling``): a
# genuinely sparse, high-dimensional problem within the chunk economy.
_TILE_MIN_FEATURES = 4096
_TILE_MAX_FEATURES = 1 << 23
_TILE_MIN_ROWS = 1024
_TILE_MAX_ROWS = 1 << 25


def supports_tiling(batch: Batch) -> bool:
    return (
        isinstance(batch, SparseBatch)
        and _TILE_MIN_FEATURES <= batch.num_features <= _TILE_MAX_FEATURES
        and _TILE_MIN_ROWS <= batch.num_rows <= _TILE_MAX_ROWS
        and bool(torch.any(batch.values != 0))
    )


def optimize_batch_layout(
    batch: Batch, hbm_budget_bytes: float = 6e9, dtype=torch.float32
) -> Batch:
    """Densify when the dense matrix fits the budget. Where the reference
    re-blocks high-dimensional sparse data into its tile-COO kernels, the
    port raises: that kernel (K3, ``ops/sparse_tiled.py``
    ``_tile_kernel_seg``) is not ported yet, and running the plain
    gather/scatter path in its place would hide that."""
    out = maybe_densify(batch, hbm_budget_bytes, dtype)
    if supports_tiling(out):
        raise NotImplementedError(
            "high-dimensional sparse data routes to the tile-COO sparse kernel "
            "(K3, photon_ml_tpu/ops/sparse_tiled.py _tile_kernel_seg), which "
            "the port does not have yet"
        )
    return out


def dense_batch_from_arrays(
    X: np.ndarray,
    labels: np.ndarray,
    offsets: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    dtype=torch.float32,
    device: torch.device | str = "cpu",
) -> DenseBatch:
    """``DenseBatch`` from host arrays: X in ``dtype``, the per-row vectors
    float32; absent offsets are 0 and absent weights 1."""
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
