from photon_ml_tpu_torch.optim.common import (  # noqa: F401
    ConvergenceReason,
    OptimizationResult,
    select_minimize_fn,
)
from photon_ml_tpu_torch.optim.lbfgs import lbfgs_minimize, owlqn_minimize  # noqa: F401
from photon_ml_tpu_torch.optim.tron import tron_minimize  # noqa: F401
