"""Hyperparameter search strategies (own copy of
``photon_ml_tpu/hyperparameter/search.py``).

Reference parity: ``photon-lib::ml.hyperparameter.{GaussianProcessSearch,
RandomSearch}`` and the driver's tuning loop (SURVEY.md §3.4): seed with the
grid observations, then repeatedly (fit GP → argmax EI over a Sobol
candidate pool → full retrain → observe).

API: ``observe(x, y)`` feeds results; ``suggest()`` proposes the next point
in the original (possibly log-scaled) coordinate space. Internally
everything lives in the unit cube and is MINIMIZED (larger-is-better
metrics are negated by the caller — see ``tune`` in drivers).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from photon_ml_tpu_torch.hyperparameter.criteria import expected_improvement
from photon_ml_tpu_torch.hyperparameter.gp import GaussianProcessEstimator
from photon_ml_tpu_torch.hyperparameter.sobol import sobol_sequence


@dataclass(frozen=True)
class SearchRange:
    """One dimension's range. ``log_scale`` searches in log space (the right
    space for regularization weights — the reference tunes log-λ too)."""

    lo: float
    hi: float
    log_scale: bool = False

    def to_unit(self, v: np.ndarray) -> np.ndarray:
        if self.log_scale:
            return (np.log(v) - np.log(self.lo)) / (np.log(self.hi) - np.log(self.lo))
        return (v - self.lo) / (self.hi - self.lo)

    def from_unit(self, u: np.ndarray) -> np.ndarray:
        if self.log_scale:
            return np.exp(np.log(self.lo) + u * (np.log(self.hi) - np.log(self.lo)))
        return self.lo + u * (self.hi - self.lo)


class _SearchBase:
    def __init__(self, ranges: Sequence[SearchRange], seed: int = 0):
        if not ranges:
            raise ValueError("search needs at least one dimension")
        self.ranges = list(ranges)
        self.seed = seed
        self._X: list[np.ndarray] = []  # unit-cube points
        self._y: list[float] = []  # minimized objective

    @property
    def num_dims(self) -> int:
        return len(self.ranges)

    def _to_unit(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        return np.array([r.to_unit(x[i]) for i, r in enumerate(self.ranges)])

    def _from_unit(self, u: np.ndarray) -> np.ndarray:
        return np.array([r.from_unit(u[i]) for i, r in enumerate(self.ranges)])

    def observe(self, x: np.ndarray, y: float) -> None:
        """Record an evaluated point (original space) and its objective
        (lower is better)."""
        self._X.append(np.clip(self._to_unit(x), 0.0, 1.0))
        self._y.append(float(y))

    @property
    def best(self) -> tuple[np.ndarray, float]:
        i = int(np.argmin(self._y))
        return self._from_unit(self._X[i]), self._y[i]


class RandomSearch(_SearchBase):
    """Quasi-random (Sobol) search — the reference's baseline strategy."""

    def __init__(self, ranges: Sequence[SearchRange], seed: int = 0):
        super().__init__(ranges, seed)
        self._draw = 0

    def suggest(self) -> np.ndarray:
        u = sobol_sequence(self._draw + 1, self.num_dims, seed=self.seed)[-1]
        self._draw += 1
        return self._from_unit(u)


class GaussianProcessSearch(_SearchBase):
    """GP + EI search (the reference's Bayesian strategy).

    The first ``num_init`` suggestions are Sobol seeds; afterwards each
    suggestion fits the GP to all observations and maximizes expected
    improvement over a fresh Sobol candidate pool.
    """

    def __init__(
        self,
        ranges: Sequence[SearchRange],
        seed: int = 0,
        num_init: int = 4,
        candidate_pool_size: int = 512,
        estimator: GaussianProcessEstimator | None = None,
    ):
        super().__init__(ranges, seed)
        self.num_init = num_init
        self.candidate_pool_size = candidate_pool_size
        self.estimator = estimator or GaussianProcessEstimator(seed=seed)
        self._draw = 0

    def suggest(self) -> np.ndarray:
        self._draw += 1
        if len(self._y) < self.num_init:
            u = sobol_sequence(self._draw, self.num_dims, seed=self.seed)[-1]
            return self._from_unit(u)
        model = self.estimator.fit(np.stack(self._X), np.asarray(self._y))
        pool = sobol_sequence(
            self.candidate_pool_size, self.num_dims, seed=self.seed + self._draw
        )
        mean, std = model.predict(pool)
        ei = expected_improvement(mean, std, best=float(np.min(self._y)))
        return self._from_unit(pool[int(np.argmax(ei))])
