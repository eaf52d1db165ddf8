from photon_ml_tpu_torch.evaluation.evaluators import (  # noqa: F401
    DEFAULT_EVALUATOR_BY_TASK,
    EvaluationResults,
    Evaluator,
    auc_roc,
    evaluate_all,
    make_evaluator,
    rmse,
)
