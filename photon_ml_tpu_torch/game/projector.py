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

- **Capacity-class projection** (``PHOTON_RE_PROJECT``): ``support``
  solves every bucket of a capacity class over the columns any entity of
  the class activates (``class_activity`` → ``projection_ladder``: one
  ``ClassProjection`` per class, the same on every process), exact under
  L2 at zero; ``hash`` also folds a support wider than
  ``PHOTON_RE_PROJECT_DIM`` onto that many signed slots (``_hash_fold``,
  the last slot kept for the intercept), a model change.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device

Tensor = torch.Tensor

# PHOTON_RE_PROJECT: "0" (the default) keeps the full-width solves bit for
# bit; "support" solves each capacity class over its active columns;
# "hash" also folds a support wider than PHOTON_RE_PROJECT_DIM (a power of
# two >= 2, the last slot the intercept's) by signed feature hashing. Read
# at call time, the environment over these module values; a fleet knob,
# set alike on every process.
RE_PROJECT = "0"
RE_PROJECT_DIM = 32
_RE_PROJECT_MODES = ("0", "support", "hash")


def re_project_mode() -> str:
    """``PHOTON_RE_PROJECT`` (environment over ``RE_PROJECT``), one of
    "0", "support", "hash"; anything else raises."""
    env = os.environ.get("PHOTON_RE_PROJECT")
    mode = str(env if env is not None and env != "" else RE_PROJECT)
    if mode not in _RE_PROJECT_MODES:
        raise ValueError(f"PHOTON_RE_PROJECT must be one of {_RE_PROJECT_MODES}, got {mode!r}")
    return mode


def re_project_dim() -> int:
    """``PHOTON_RE_PROJECT_DIM`` (environment over ``RE_PROJECT_DIM``), a
    power of two >= 2 (the fold keeps the last slot for the intercept)."""
    env = os.environ.get("PHOTON_RE_PROJECT_DIM")
    m = int(env if env is not None and env != "" else RE_PROJECT_DIM)
    if m < 2 or (m & (m - 1)) != 0:
        raise ValueError(f"PHOTON_RE_PROJECT_DIM must be a power of two >= 2, got {m}")
    return m


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


# Knuth multiplicative mixing of the original column index: every process
# computes the same (slot, sign) from the index alone
_HASH_MULT = np.uint64(2654435761)
_SIGN_MULT = np.uint64(0x9E3779B1)


@dataclass(frozen=True)
class ClassProjection:
    """One capacity class's projection (host metadata). ``columns`` is the
    class's support, the ascending columns any entity of the class
    activates; the class solves at ``len(columns)`` wide, or, folded
    (``hash_dim`` set), at ``hash_dim`` slots through ``hash_slots`` /
    ``hash_signs``. Every bucket of the class shares it, so same-capacity
    buckets still share a launch geometry."""

    capacity: int
    full_dim: int
    columns: np.ndarray  # (d_e,) int64, ascending
    hash_slots: np.ndarray | None = None  # (d_e,) int64 in [0, hash_dim)
    hash_signs: np.ndarray | None = None  # (d_e,) float32, ±1
    hash_dim: int | None = None

    @property
    def support_dim(self) -> int:
        return int(len(self.columns))

    @property
    def dim(self) -> int:
        """The width the class solves at."""
        return int(self.hash_dim) if self.hash_dim is not None else self.support_dim

    def hash_matrix(self) -> np.ndarray:
        """The signed fold as a dense (d_e, m) float32 matrix S,
        S[j, hash_slots[j]] = hash_signs[j]: features and warm starts fold
        by S, coefficients expand by Sᵀ, scores unchanged ((X S) w_h = X (S w_h))."""
        if self.hash_dim is None:
            raise ValueError("hash_matrix: spec has no hash fold")
        S = np.zeros((self.support_dim, int(self.hash_dim)), np.float32)
        S[np.arange(self.support_dim), self.hash_slots] = self.hash_signs
        return S


def _hash_fold(columns: np.ndarray, hash_dim: int, intercept_index: int | None) -> tuple[np.ndarray, np.ndarray]:
    """The (slot, sign) of each support column: the original index mixed
    into [0, m - 1) (slot m - 1 is the intercept's alone) and a sign from
    an independent mix."""
    cols = np.asarray(columns, np.uint64)
    m = int(hash_dim)
    mixed = (cols * _HASH_MULT) % np.uint64(2**32)
    slots = (mixed % np.uint64(m - 1)).astype(np.int64)
    signs = np.where(((cols * _SIGN_MULT) >> np.uint64(16)) & np.uint64(1), np.float32(1.0),
                     np.float32(-1.0)).astype(np.float32)
    if intercept_index is not None:
        at = np.flatnonzero(np.asarray(columns) == intercept_index)
        slots[at] = m - 1
        signs[at] = 1.0
    return slots, signs


def projection_ladder(capacities, activity: np.ndarray, full_dim: int, mode: str, hash_dim: int,
                      intercept_index: int | None) -> dict[int, ClassProjection | None]:
    """The per-class projections, keyed by capacity, from ``activity[i, j]``
    (rows with a nonzero in column j over every entity of class i, summed
    over every process): the same arithmetic on the same counts gives every
    process the same ladder. A class active in every column maps to None
    (the full-width path); an empty support keeps one column (the
    intercept if there is one, else column 0); ``hash`` folds a support
    wider than ``hash_dim``."""
    if mode not in ("support", "hash"):
        raise ValueError(f"projection_ladder: unexpected mode {mode!r}")
    if intercept_index is not None and intercept_index != full_dim - 1:
        raise ValueError("feature projection requires the intercept at the last column (framework convention)")
    activity = np.asarray(activity)
    if activity.shape != (len(capacities), full_dim):
        raise ValueError(f"projection_ladder: activity shape {activity.shape} != ({len(capacities)}, {full_dim})")
    ladder: dict[int, ClassProjection | None] = {}
    for i, cap in enumerate(capacities):
        cols = np.flatnonzero(activity[i] > 0).astype(np.int64)
        if intercept_index is not None and intercept_index not in cols:
            cols = np.sort(np.append(cols, np.int64(intercept_index)))
        if len(cols) == 0:
            cols = np.asarray([intercept_index if intercept_index is not None else 0], np.int64)
        if len(cols) >= full_dim:
            ladder[int(cap)] = None
            continue
        spec = ClassProjection(capacity=int(cap), full_dim=int(full_dim), columns=cols)
        if mode == "hash" and len(cols) > hash_dim:
            slots, signs = _hash_fold(cols, hash_dim, intercept_index)
            spec = ClassProjection(capacity=int(cap), full_dim=int(full_dim), columns=cols, hash_slots=slots,
                                   hash_signs=signs, hash_dim=int(hash_dim))
        ladder[int(cap)] = spec
    return ladder


def class_activity(X, capacities, row_indices) -> tuple[tuple[int, ...], np.ndarray]:
    """Per-capacity-class column activity of bucketed rows: ``(classes,
    activity)``, ``classes`` the ascending distinct capacities and
    ``activity[i, j]`` this process's rows with a nonzero in column j over
    every bucket of capacity ``classes[i]``. ``X`` is the (n, d) feature
    matrix, a tensor (counted where it lies) or a numpy array."""
    X = torch.as_tensor(X)
    classes = tuple(sorted(set(int(c) for c in capacities)))
    pos = {c: i for i, c in enumerate(classes)}
    act = torch.zeros((len(classes), X.shape[-1]), dtype=torch.int64, device=X.device)
    for cap, rows in zip(capacities, row_indices):
        r = np.asarray(rows)
        r = r[r >= 0]
        if len(r):
            act[pos[int(cap)]] += (X[torch.as_tensor(r, device=X.device)] != 0).sum(0)
    return classes, act.cpu().numpy()
