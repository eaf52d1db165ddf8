"""Core enums (own copy of ``photon_ml_tpu.types``; the port imports
nothing of the JAX package). Values are the same strings, so configs and
reports are interchangeable between the two packages."""

from __future__ import annotations

import enum


class TaskType(enum.Enum):
    """Parity: ``photon-api::ml.TaskType``."""

    LOGISTIC_REGRESSION = "LOGISTIC_REGRESSION"
    LINEAR_REGRESSION = "LINEAR_REGRESSION"
    POISSON_REGRESSION = "POISSON_REGRESSION"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "SMOOTHED_HINGE_LOSS_LINEAR_SVM"

    @property
    def is_classification(self) -> bool:
        return self in (
            TaskType.LOGISTIC_REGRESSION,
            TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
        )


class OptimizerType(enum.Enum):
    """LBFGS or TRON; OWL-QN is selected implicitly when L1 is active.
    NEWTON_CHOLESKY is exact damped Newton for small-d dense problems
    (``optim/newton.py``), the per-entity random-effect solver."""

    LBFGS = "LBFGS"
    TRON = "TRON"
    NEWTON_CHOLESKY = "NEWTON_CHOLESKY"


class RegularizationType(enum.Enum):
    NONE = "NONE"
    L1 = "L1"
    L2 = "L2"
    ELASTIC_NET = "ELASTIC_NET"


class NormalizationType(enum.Enum):
    NONE = "NONE"
    SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
    SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
    STANDARDIZATION = "STANDARDIZATION"


class VarianceComputationType(enum.Enum):
    NONE = "NONE"
    SIMPLE = "SIMPLE"  # inverse of Hessian diagonal
    FULL = "FULL"  # diagonal of inverse full Hessian


class DataValidationType(enum.Enum):
    """Pre-training data checks: every row, a sample of rows, or none."""

    VALIDATE_FULL = "VALIDATE_FULL"
    VALIDATE_SAMPLE = "VALIDATE_SAMPLE"
    VALIDATE_DISABLED = "VALIDATE_DISABLED"


class ModelOutputMode(enum.Enum):
    NONE = "NONE"
    BEST = "BEST"
    ALL = "ALL"
