from photon_ml_tpu_torch.models.glm import (  # noqa: F401
    Coefficients,
    GeneralizedLinearModel,
    LinearRegressionModel,
    LogisticRegressionModel,
    PoissonRegressionModel,
    SmoothedHingeLossLinearSVMModel,
    model_for_task,
)
