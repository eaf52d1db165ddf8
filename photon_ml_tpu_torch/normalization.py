"""Feature normalization applied inside the objective (port of
``photon_ml_tpu/normalization.py``).

Training data is never rewritten: for a linear margin the per-feature
affine transform folds into the weight vector,

    margin_i = Σ_j (x_ij - s_j) f_j w_j + o_i = (X @ u)_i - s·u + o_i,  u = f ⊙ w,

so normalized evaluation costs one elementwise multiply and one scalar dot
on top of the unnormalized pass, with no extra traffic over X.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.types import NormalizationType

Tensor = torch.Tensor


@dataclass(frozen=True)
class NormalizationContext:
    """Per-feature affine transform x' = (x - shift) * factor; the
    intercept column (``intercept_index``) has factor 1 and shift 0."""

    factors: Tensor  # (d,)
    shifts: Tensor  # (d,)
    intercept_index: int | None = None

    @property
    def num_features(self) -> int:
        return self.factors.shape[0]

    def to(self, device) -> "NormalizationContext":
        return NormalizationContext(
            self.factors.to(device), self.shifts.to(device), self.intercept_index
        )

    def to_effective(self, w: Tensor) -> tuple[Tensor, Tensor]:
        """Model-space weights → (u, c): margin = X@u - c + offset."""
        u = self.factors * w
        return u, torch.dot(self.shifts, u)

    def grad_to_model_space(self, g_raw: Tensor, r_sum: Tensor) -> Tensor:
        """(Xᵀr, Σr) → model-space gradient: ∂m_i/∂w_j = f_j (x_ij - s_j)."""
        return self.factors * (g_raw - self.shifts * r_sum)

    def model_to_original_space(self, w: Tensor) -> tuple[Tensor, Tensor]:
        """Trained (normalized-space) coefficients → original-feature
        coefficients f ⊙ w and the intercept correction -s·(f ⊙ w), folded
        into the intercept when there is one. Returns (coefficients,
        intercept_delta). ``w`` may be (d,) or a stack of rows (E, d)."""
        u = self.factors * w
        delta = -torch.sum(self.shifts * u, dim=-1)
        if self.intercept_index is not None:
            u = u.clone()
            u[..., self.intercept_index] += delta
            delta = torch.zeros_like(delta)
        return u, delta

    def model_from_original_space(self, w_orig: Tensor) -> Tensor:
        """Inverse of ``model_to_original_space`` (delta folded into the
        intercept): used to warm-start from a saved model. ``w_orig`` may be
        (d,) or (E, d)."""
        w = w_orig / self.factors
        if self.intercept_index is not None:
            correction = torch.sum(self.shifts * (self.factors * w), dim=-1)
            w = w.clone()
            w[..., self.intercept_index] = w_orig[..., self.intercept_index] + correction
        return w


def require_intercept_for_shifts(norm: NormalizationContext | None) -> None:
    """A shifted transform (STANDARDIZATION) without an intercept column
    cannot be un-applied on the output model."""
    if (
        norm is not None
        and norm.intercept_index is None
        and bool(torch.any(norm.shifts != 0.0))
    ):
        raise ValueError(
            "normalization with shifts (STANDARDIZATION) requires an "
            "intercept column to absorb the shift on the output model"
        )


def no_normalization(
    num_features: int, intercept_index: int | None = None, device=None
) -> NormalizationContext:
    """The identity context on ``device`` (CUDA unless asked; raises
    without it)."""
    device = resolve_device(device)
    return NormalizationContext(
        factors=torch.ones(num_features, dtype=torch.float32, device=device),
        shifts=torch.zeros(num_features, dtype=torch.float32, device=device),
        intercept_index=intercept_index,
    )


def build_normalization(
    norm_type: NormalizationType,
    means: np.ndarray,
    variances: np.ndarray,
    max_magnitudes: np.ndarray,
    intercept_index: int | None = None,
    device=None,
) -> NormalizationContext:
    """Context from feature statistics (the reference's four modes):
    NONE identity; SCALE_WITH_STANDARD_DEVIATION factor 1/std;
    SCALE_WITH_MAX_MAGNITUDE factor 1/max|x|; STANDARDIZATION factor 1/std
    and shift mean. Zero std / zero max give factor 1. The context lies on
    ``device`` (CUDA unless asked; raises without it)."""
    device = resolve_device(device)
    d = means.shape[0]
    ones = np.ones(d, np.float32)
    zeros = np.zeros(d, np.float32)
    std = np.sqrt(np.maximum(variances, 0.0)).astype(np.float32)
    inv_std = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 1.0).astype(np.float32)
    maxmag = np.abs(max_magnitudes).astype(np.float32)
    inv_max = np.where(maxmag > 0, 1.0 / np.where(maxmag > 0, maxmag, 1.0), 1.0).astype(
        np.float32
    )
    if norm_type is NormalizationType.NONE:
        factors, shifts = ones, zeros
    elif norm_type is NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        factors, shifts = inv_std, zeros
    elif norm_type is NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        factors, shifts = inv_max, zeros
    elif norm_type is NormalizationType.STANDARDIZATION:
        factors, shifts = inv_std, means.astype(np.float32).copy()
    else:  # pragma: no cover
        raise ValueError(f"unknown normalization type {norm_type}")
    if intercept_index is not None:
        factors = factors.copy()
        shifts = shifts.copy()
        factors[intercept_index] = 1.0
        shifts[intercept_index] = 0.0
    return NormalizationContext(
        factors=torch.as_tensor(factors, device=device),
        shifts=torch.as_tensor(shifts, device=device),
        intercept_index=intercept_index,
    )
