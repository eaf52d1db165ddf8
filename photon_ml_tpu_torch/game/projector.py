"""Feature projectors for random-effect coordinates (port of the
projectors of ``photon_ml_tpu/game/projector.py``; the reference's
``IndexMapProjection`` and ``RandomProjection``).

- **Per-entity subspace** (``numFeaturesToSamplesRatioUpperBound``): each
  bucket gets a (k, p) column map holding every entity's p most frequent
  feature columns, p = min(d, ceil(ratio · C)) for capacity C. The bucket's
  features are gathered to (k, C, p) once, the lanes solve at width p, and
  the solutions are scattered back into the (E, d) matrix.
- **Random projection**: one (d, p) Gaussian matrix per coordinate, drawn
  with ``numpy.random.default_rng(seed)`` (so the matrix is the
  reference's bit for bit) and applied to the shard once; coefficients
  map back by w = P w_p, which keeps scores exact: (XP)·w_p = X·(P w_p).

The reference's capacity-class projection ladder (``PHOTON_RE_PROJECT``:
``projection_ladder``, ``class_activity``, ``ClassProjection``) is a fleet
knob of ROADMAP queue 1 item 12d and is not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device

Tensor = torch.Tensor


def subspace_columns(X: Tensor, ratio: float, intercept_index: int | None) -> Tensor | None:
    """One bucket's per-entity column maps (k, p) over its (k, C, d)
    features (padded slots zero), p = min(d, ceil(ratio · C)); None when
    that keeps the full width. Columns are ascending, so an intercept (which
    must be the last column) lands at slot p - 1."""
    d, capacity = X.shape[-1], X.shape[1]
    p = min(d, max(1, math.ceil(ratio * capacity)))
    if p >= d:
        return None
    if intercept_index is not None and intercept_index != d - 1:
        raise ValueError(
            "subspace projection requires the intercept at the last column (framework convention)"
        )
    return entity_top_columns(X, p, always_include=intercept_index)


def entity_top_columns(X: Tensor, p: int, always_include: int | None = None) -> Tensor:
    """Each entity's ``p`` most frequent columns of its (k, C, d) rows (by
    nonzero count, ties to the lower index), ascending; ``always_include``
    (the intercept) is in every entity's set. On the features' device."""
    counts = (X != 0).sum(dim=1, dtype=torch.int64)  # (k, d)
    if always_include is not None:
        counts[:, always_include] = torch.iinfo(torch.int64).max
    order = torch.sort(-counts, dim=1, stable=True).indices[:, :p]
    return torch.sort(order, dim=1).values


@dataclass(frozen=True)
class RandomProjector:
    """One coordinate's shared Gaussian projection (the reference's
    ``ProjectionMatrix``), a (d, p) matrix with entries ~ N(0, 1/p), on
    ``device`` (CUDA unless the caller asks for another)."""

    matrix: Tensor  # (d, p) float32

    @classmethod
    def build(cls, num_features: int, projected_dim: int, seed: int = 0, device=None) -> "RandomProjector":
        rng = np.random.default_rng(seed)
        P = rng.normal(scale=1.0 / np.sqrt(projected_dim),
                       size=(num_features, projected_dim)).astype(np.float32)
        return cls(matrix=torch.from_numpy(P).to(resolve_device(device)))

    @property
    def projected_dim(self) -> int:
        return self.matrix.shape[1]

    def project_features(self, X: Tensor) -> Tensor:
        """(…, d) → (…, p)."""
        return X.float() @ self.matrix

    def coefficients_to_original(self, w_projected: Tensor) -> Tensor:
        """(…, p) → (…, d), score-exact: (XP)·w_p = X·(P w_p)."""
        return w_projected @ self.matrix.T
