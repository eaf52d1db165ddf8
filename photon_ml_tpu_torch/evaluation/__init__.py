from photon_ml_tpu_torch.evaluation.evaluators import (  # noqa: F401
    DEFAULT_EVALUATOR_BY_TASK,
    EvaluationResults,
    Evaluator,
    auc_roc,
    evaluate_all,
    grouped_auc,
    grouped_auc_parts,
    grouped_precision_at_k,
    grouped_precision_at_k_parts,
    make_evaluator,
    rmse,
)
from photon_ml_tpu_torch.evaluation.host_sharded import evaluate_host_sharded  # noqa: F401
from photon_ml_tpu_torch.evaluation.scalable import (  # noqa: F401
    bucketed_auc,
    bucketed_auc_sharded,
    bucketed_auc_sharded_padded,
    grouped_auc_device,
    grouped_precision_at_k_device,
)
