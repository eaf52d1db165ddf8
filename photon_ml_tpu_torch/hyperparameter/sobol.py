"""Sobol quasi-random sequences (own copy of
``photon_ml_tpu/hyperparameter/sobol.py``).

Reference parity: ``photon-lib::ml.hyperparameter.SobolSequence`` — used to
seed the search and to draw the candidate pool the acquisition function is
maximized over. Delegates to scipy's direction-number implementation
(scrambled Owen variant), which replaces the reference's hand-rolled tables.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import qmc


def sobol_sequence(num_points: int, num_dims: int, seed: int = 0) -> np.ndarray:
    """``num_points`` scrambled-Sobol points in [0, 1)^num_dims.

    Sobol balance properties hold for power-of-2 sample counts, so the draw
    is padded up to the next power of two and truncated — the kept prefix
    is still a valid (scrambled) Sobol sequence, and scipy's balance
    warning never fires."""
    if num_points <= 0:
        return np.zeros((0, num_dims))
    sampler = qmc.Sobol(d=num_dims, scramble=True, seed=seed)
    pow2 = 1 << (num_points - 1).bit_length()
    return sampler.random(pow2)[:num_points]
