"""Bayesian hyperparameter tuning (own copy of ``photon_ml_tpu/hyperparameter``;
the reference's ``photon-lib::ml.hyperparameter``): ``GaussianProcessSearch``
(a GP surrogate with slice-sampled kernels and expected improvement over a
Sobol candidate pool), ``RandomSearch``, the Matern-5/2 and RBF kernels,
and the driver's tuning loop (``tuning.py``).

Host-side numpy and scipy: the search runs between full refits, whose cost
dwarfs it, and with the same seeds it suggests the same points as the
reference, bit for bit.
"""

from photon_ml_tpu_torch.hyperparameter.kernels import Matern52, RBF, StationaryKernel  # noqa: F401
from photon_ml_tpu_torch.hyperparameter.gp import (  # noqa: F401
    GaussianProcessEstimator,
    GaussianProcessModel,
)
from photon_ml_tpu_torch.hyperparameter.criteria import expected_improvement  # noqa: F401
from photon_ml_tpu_torch.hyperparameter.sobol import sobol_sequence  # noqa: F401
from photon_ml_tpu_torch.hyperparameter.sampler import slice_sample  # noqa: F401
from photon_ml_tpu_torch.hyperparameter.search import (  # noqa: F401
    GaussianProcessSearch,
    RandomSearch,
    SearchRange,
)
