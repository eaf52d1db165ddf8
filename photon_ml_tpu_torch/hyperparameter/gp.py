"""Gaussian-process regression for hyperparameter surfaces (own copy of
``photon_ml_tpu/hyperparameter/gp.py``).

Reference parity: ``photon-lib::ml.hyperparameter.estimators.
{GaussianProcessEstimator, GaussianProcessModel}`` — GP regression whose
kernel hyperparameters are *slice-sampled* from the marginal likelihood
(not point-optimized), with predictions averaged over the sampled kernels
(Snoek et al. 2012, the design the reference follows).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.linalg import cho_factor, cho_solve

from photon_ml_tpu_torch.hyperparameter.kernels import Matern52, StationaryKernel
from photon_ml_tpu_torch.hyperparameter.sampler import slice_sample


@dataclass(frozen=True)
class GaussianProcessModel:
    """GP posterior over observed (X, y), marginalized over kernel samples.

    ``predict`` returns (mean, std) averaged over the kernel posterior:
    mean = E[mean_k], var = E[var_k + mean_k²] − mean² (law of total
    variance — matching the reference's prediction averaging).
    """

    X: np.ndarray  # (n, d)
    y: np.ndarray  # (n,) — centered internally
    kernels: tuple[StationaryKernel, ...]
    y_mean: float

    def predict(self, Z: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        Z = np.atleast_2d(np.asarray(Z, np.float64))
        means, variances = [], []
        yc = self.y - self.y_mean
        for k in self.kernels:
            K = k(self.X)
            factor = cho_factor(K, lower=True)
            alpha = cho_solve(factor, yc)
            Kzx = k(Z, self.X)
            mu = Kzx @ alpha
            v = cho_solve(factor, Kzx.T)
            var = np.maximum(
                np.diag(k(Z, Z)) + k.noise**2 - np.sum(Kzx * v.T, axis=1), 1e-12
            )
            means.append(mu + self.y_mean)
            variances.append(var)
        M = np.stack(means)
        V = np.stack(variances)
        mean = M.mean(0)
        var = (V + M * M).mean(0) - mean * mean
        return mean, np.sqrt(np.maximum(var, 1e-12))


def _log_marginal_likelihood(
    X: np.ndarray, yc: np.ndarray, kernel: StationaryKernel
) -> float:
    try:
        K = kernel(X)
        factor = cho_factor(K, lower=True)
    except np.linalg.LinAlgError:
        return -np.inf
    alpha = cho_solve(factor, yc)
    logdet = 2.0 * np.sum(np.log(np.diag(factor[0])))
    return float(-0.5 * yc @ alpha - 0.5 * logdet - 0.5 * len(yc) * np.log(2 * np.pi))


@dataclass(frozen=True)
class GaussianProcessEstimator:
    """Fits a ``GaussianProcessModel`` by slice-sampling kernel
    hyperparameters (amplitude, noise, per-dim lengthscales) from the
    marginal likelihood with a weak log-normal prior."""

    kernel: StationaryKernel = Matern52()
    num_kernel_samples: int = 8
    burn_in: int = 16
    seed: int = 0

    def fit(self, X: np.ndarray, y: np.ndarray) -> GaussianProcessModel:
        X = np.atleast_2d(np.asarray(X, np.float64))
        y = np.asarray(y, np.float64)
        y_mean = float(y.mean())
        yc = y - y_mean
        rng = np.random.default_rng(self.seed)

        def log_density(log_params: np.ndarray) -> float:
            # weak log-normal prior keeps amplitude/noise/lengthscales sane
            prior = -0.5 * np.sum((log_params / 3.0) ** 2)
            return _log_marginal_likelihood(X, yc, self.kernel.with_params(log_params)) + prior

        x0 = self.kernel.log_params(X.shape[1])
        samples = slice_sample(
            x0, log_density, self.num_kernel_samples, rng, width=1.0, burn_in=self.burn_in
        )
        kernels = tuple(self.kernel.with_params(s) for s in samples)
        return GaussianProcessModel(X=X, y=y, kernels=kernels, y_mean=y_mean)
