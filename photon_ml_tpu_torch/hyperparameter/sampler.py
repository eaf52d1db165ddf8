"""Univariate slice sampling with stepping-out, applied coordinate-wise (own
copy of ``photon_ml_tpu/hyperparameter/sampler.py``).

Reference parity: ``photon-lib::ml.hyperparameter.sampler.SliceSampler`` —
used to sample GP kernel hyperparameters from their (log) marginal-likelihood
posterior instead of point-optimizing them (Neal 2003; Snoek et al. 2012).
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def _slice_sample_1d(
    x0: np.ndarray,
    dim: int,
    log_density: Callable[[np.ndarray], float],
    rng: np.random.Generator,
    width: float,
    max_steps_out: int = 8,
) -> np.ndarray:
    """One slice-sampling update of coordinate ``dim``."""
    x0 = np.asarray(x0, np.float64)
    f0 = log_density(x0)
    log_y = f0 + np.log(rng.uniform(1e-12, 1.0))

    # step out
    u = rng.uniform()
    lo = x0[dim] - width * u
    hi = lo + width
    def density_at(v: float) -> float:
        x = x0.copy()
        x[dim] = v
        return log_density(x)
    for _ in range(max_steps_out):
        if density_at(lo) <= log_y:
            break
        lo -= width
    for _ in range(max_steps_out):
        if density_at(hi) <= log_y:
            break
        hi += width

    # shrink
    for _ in range(64):
        v = rng.uniform(lo, hi)
        if density_at(v) > log_y:
            x1 = x0.copy()
            x1[dim] = v
            return x1
        if v < x0[dim]:
            lo = v
        else:
            hi = v
    return x0  # shrunk to nothing — keep the current point


def slice_sample(
    x0: np.ndarray,
    log_density: Callable[[np.ndarray], float],
    num_samples: int,
    rng: np.random.Generator,
    width: float = 1.0,
    burn_in: int = 0,
    thin: int = 1,
) -> np.ndarray:
    """Draw ``num_samples`` points from ``exp(log_density)`` by cycling
    coordinate-wise slice updates. Returns (num_samples, d)."""
    x = np.asarray(x0, np.float64).copy()
    out = []
    total = burn_in + num_samples * thin
    for i in range(total):
        for dim in range(len(x)):
            x = _slice_sample_1d(x, dim, log_density, rng, width)
        if i >= burn_in and (i - burn_in) % thin == 0:
            out.append(x.copy())
    return np.stack(out[:num_samples])
