"""Evaluation metrics (port of ``photon_ml_tpu/evaluation/evaluators.py``).

Scalar metrics on tensors of any device: the exact rank-sum AUC with
average ranks for ties, RMSE, and the per-loss mean losses. The grouped
(per-entity) evaluators, ``MULTI_AUC(tag)`` and ``PRECISION_AT_K(k,tag)``,
and the histogram ``BUCKETED_AUC`` are not ported yet (ROADMAP queue 1);
``make_evaluator`` rejects them by name.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np
import torch

from photon_ml_tpu_torch.ops import losses as losses_mod
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


def _weights_or_ones(weights: Tensor | None, scores: Tensor) -> Tensor:
    return torch.ones_like(scores) if weights is None else weights


def auc_roc(scores: Tensor, labels: Tensor, weights: Tensor | None = None) -> Tensor:
    """Exact rank-sum (Mann-Whitney) AUC with average ranks for ties.

    Weights select samples (weight 0 excludes); the rank statistic itself
    is unweighted. Ranks and sums are float64: rank sums of a million rows
    exceed float32's exact integers."""
    w = _weights_or_ones(weights, scores)
    included = w > 0
    # excluded entries go to +inf so they take the top ranks; the mask then
    # drops them from the sums
    s = torch.where(included, scores, torch.full_like(scores, float("inf")))
    order = torch.argsort(s, stable=True)
    s_sorted = s[order].contiguous()
    lab_sorted = torch.where(included, labels, torch.zeros_like(labels))[order].double()
    inc_sorted = included[order]
    n_inc = torch.sum(inc_sorted).double()
    # average rank of each tie group (1-based)
    first = torch.searchsorted(s_sorted, s_sorted, side="left")
    last = torch.searchsorted(s_sorted, s_sorted, side="right") - 1
    avg_rank = 0.5 * (first + last).double() + 1.0
    zero = torch.zeros_like(lab_sorted)
    pos = torch.sum(torch.where(inc_sorted, lab_sorted, zero))
    neg = n_inc - pos
    rank_sum = torch.sum(torch.where(inc_sorted & (lab_sorted > 0), avg_rank, zero))
    u = rank_sum - pos * (pos + 1.0) / 2.0
    auc = torch.where((pos > 0) & (neg > 0), u / (pos * neg), torch.full_like(u, float("nan")))
    return auc.to(scores.dtype)


def rmse(scores: Tensor, labels: Tensor, weights: Tensor | None = None) -> Tensor:
    w = _weights_or_ones(weights, scores)
    return torch.sqrt(torch.sum(w * (scores - labels) ** 2) / torch.sum(w))


def _mean_loss(loss) -> Callable[[Tensor, Tensor, Tensor | None], Tensor]:
    def metric(scores: Tensor, labels: Tensor, weights: Tensor | None = None) -> Tensor:
        w = _weights_or_ones(weights, scores)
        lv = loss.value(scores, labels)
        return torch.sum(torch.where(w != 0, w * lv, torch.zeros_like(lv))) / torch.sum(w)

    return metric


logistic_loss_metric = _mean_loss(losses_mod.logistic_loss)
poisson_loss_metric = _mean_loss(losses_mod.poisson_loss)
squared_loss_metric = _mean_loss(losses_mod.squared_loss)
smoothed_hinge_loss_metric = _mean_loss(losses_mod.smoothed_hinge_loss)


@dataclass(frozen=True)
class Evaluator:
    """Named scalar metric; ``larger_is_better`` drives model selection."""

    name: str
    larger_is_better: bool
    _fn: Callable

    def __call__(self, scores, labels, weights=None) -> float:
        return float(self._fn(scores, labels, weights))

    def better(self, a: float, b: float) -> bool:
        """Is metric a better than b?"""
        if np.isnan(b):
            return True
        if np.isnan(a):
            return False
        return a > b if self.larger_is_better else a < b


_SCALAR_EVALUATORS = {
    "AUC": (auc_roc, True),
    "RMSE": (rmse, False),
    "LOGISTIC_LOSS": (logistic_loss_metric, False),
    "POISSON_LOSS": (poisson_loss_metric, False),
    "SQUARED_LOSS": (squared_loss_metric, False),
    "SMOOTHED_HINGE_LOSS": (smoothed_hinge_loss_metric, False),
}

# The per-task default model-selection metric.
DEFAULT_EVALUATOR_BY_TASK = {
    TaskType.LOGISTIC_REGRESSION: "AUC",
    TaskType.LINEAR_REGRESSION: "RMSE",
    TaskType.POISSON_REGRESSION: "POISSON_LOSS",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: "AUC",
}

_LATER_EVALUATORS = re.compile(
    r"(MULTI_AUC\(\w+\)|PRECISION_AT_K\(\d+\s*,\s*\w+\)|BUCKETED_AUC(\(\d+\))?)",
    re.IGNORECASE,
)


def make_evaluator(spec: str) -> Evaluator:
    """Parse an EvaluatorType string: "AUC" | "RMSE" | "LOGISTIC_LOSS" |
    "POISSON_LOSS" | "SQUARED_LOSS" | "SMOOTHED_HINGE_LOSS"."""
    spec = spec.strip()
    if spec.upper() in _SCALAR_EVALUATORS:
        fn, larger = _SCALAR_EVALUATORS[spec.upper()]
        return Evaluator(name=spec.upper(), larger_is_better=larger, _fn=fn)
    if _LATER_EVALUATORS.fullmatch(spec):
        raise NotImplementedError(
            f"evaluator {spec!r} (grouped or bucketed) is not ported yet "
            "(ROADMAP queue 1)"
        )
    raise ValueError(f"unknown evaluator spec: {spec!r}")


@dataclass(frozen=True)
class EvaluationResults:
    """Named metric values; ``primary`` is the model-selection metric."""

    metrics: Mapping[str, float] = field(default_factory=dict)
    primary_name: str | None = None

    @property
    def primary(self) -> float:
        if not self.metrics:
            return float("nan")
        name = self.primary_name or next(iter(self.metrics))
        return self.metrics[name]


def evaluate_all(specs, scores, labels, weights=None, group_ids=None) -> EvaluationResults:
    """Every evaluator of ``specs`` on raw scores. ``group_ids`` (tag →
    (n,) entity ids) is what the grouped evaluators will read; the scalar
    ones ignore it, and ``make_evaluator`` still refuses the grouped ones."""
    evs = [make_evaluator(s) if isinstance(s, str) else s for s in specs]
    metrics = {e.name: e(scores, labels, weights) for e in evs}
    return EvaluationResults(metrics=metrics, primary_name=evs[0].name if evs else None)
