"""Stationary GP covariance kernels (own copy of
``photon_ml_tpu/hyperparameter/kernels.py``).

Reference parity: ``photon-lib::ml.hyperparameter.estimators.kernels``
(Matern-5/2 — the reference's default for hyperparameter surfaces, after
Snoek et al.'s "Practical Bayesian Optimization" — and RBF), with amplitude,
per-dimension length scales (ARD), and observation noise.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

_SQRT5 = np.sqrt(5.0)


@dataclass(frozen=True)
class StationaryKernel:
    """amplitude² · k(r/lengthscale) + noise²·I (on the diagonal).

    ``lengthscales`` broadcasts: scalar or (d,) ARD.
    """

    amplitude: float = 1.0
    lengthscales: np.ndarray | float = 1.0
    noise: float = 1e-4

    def _scaled_sqdist(self, X: np.ndarray, Z: np.ndarray) -> np.ndarray:
        ls = np.asarray(self.lengthscales, np.float64)
        Xs, Zs = X / ls, Z / ls
        d2 = (
            np.sum(Xs * Xs, 1)[:, None]
            + np.sum(Zs * Zs, 1)[None, :]
            - 2.0 * Xs @ Zs.T
        )
        return np.maximum(d2, 0.0)

    def _base(self, r2: np.ndarray) -> np.ndarray:  # pragma: no cover (abstract)
        raise NotImplementedError

    def __call__(self, X: np.ndarray, Z: np.ndarray | None = None) -> np.ndarray:
        """Covariance matrix; noise is added only on the X==Z diagonal."""
        X = np.atleast_2d(np.asarray(X, np.float64))
        same = Z is None
        Z = X if same else np.atleast_2d(np.asarray(Z, np.float64))
        K = self.amplitude**2 * self._base(self._scaled_sqdist(X, Z))
        if same:
            K = K + (self.noise**2 + 1e-10) * np.eye(len(X))
        return K

    def with_params(self, log_params: np.ndarray) -> "StationaryKernel":
        """Rebuild from log-space parameter vector
        [log amplitude, log noise, log lengthscale...] — the slice sampler's
        coordinate space."""
        p = np.exp(np.asarray(log_params, np.float64))
        ls = p[2] if len(p) == 3 else p[2:]
        return replace(self, amplitude=p[0], noise=p[1], lengthscales=ls)

    def log_params(self, num_dims: int, ard: bool = True) -> np.ndarray:
        ls = np.broadcast_to(
            np.asarray(self.lengthscales, np.float64), (num_dims if ard else 1,)
        )
        return np.log(np.concatenate([[self.amplitude, self.noise], ls]))


@dataclass(frozen=True)
class RBF(StationaryKernel):
    """Squared-exponential: k(r²) = exp(-r²/2)."""

    def _base(self, r2: np.ndarray) -> np.ndarray:
        return np.exp(-0.5 * r2)


@dataclass(frozen=True)
class Matern52(StationaryKernel):
    """Matérn-5/2: (1 + √5 r + 5r²/3)·exp(-√5 r)."""

    def _base(self, r2: np.ndarray) -> np.ndarray:
        r = np.sqrt(r2)
        return (1.0 + _SQRT5 * r + (5.0 / 3.0) * r2) * np.exp(-_SQRT5 * r)
