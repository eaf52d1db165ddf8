from photon_ml_tpu_torch.supervised.cross_validation import (  # noqa: F401
    CrossValidationResult,
    cross_validate_glm,
)
from photon_ml_tpu_torch.supervised.training import GLMTrainingResult, train_glm  # noqa: F401
