"""Acquisition criteria (own copy of
``photon_ml_tpu/hyperparameter/criteria.py``).

Reference parity: ``photon-lib::ml.hyperparameter.criteria.
ExpectedImprovement`` — EI for MINIMIZATION (metrics are converted so lower
is better before the search sees them).
"""

from __future__ import annotations

import numpy as np
from scipy.stats import norm


def expected_improvement(
    mean: np.ndarray, std: np.ndarray, best: float, xi: float = 0.0
) -> np.ndarray:
    """EI(z) = (best − μ − ξ)·Φ(u) + σ·φ(u), u = (best − μ − ξ)/σ.

    Larger is better (more expected reduction below the incumbent).
    """
    std = np.maximum(std, 1e-12)
    imp = best - mean - xi
    u = imp / std
    return imp * norm.cdf(u) + std * norm.pdf(u)
