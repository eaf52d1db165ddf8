"""Evaluation metrics (port of ``photon_ml_tpu/evaluation/evaluators.py``).

Scalar metrics on tensors of any device: the exact rank-sum AUC with
average ranks for ties, RMSE, and the per-loss mean losses. The GAME
model-selection metrics: ``MULTI_AUC(tag)`` and ``PRECISION_AT_K(k,tag)``
group the scores by a validation batch's id tag and average the
per-group metric, on the scores' device (``evaluation/scalable.py``);
``BUCKETED_AUC[(n)]`` is the sort-free histogram AUC, in its sharded form
when ``evaluate_all`` is given a data mesh. The host numpy versions of
the grouped metrics (``grouped_auc``, ``grouped_precision_at_k``) are the
oracle the device versions are held to; their summable halves
(``grouped_auc_parts``, ``grouped_precision_at_k_parts``: partials of
disjoint complete groups add across processes) serve the multi-process
scoring driver.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np
import torch

from photon_ml_tpu_torch.evaluation.scalable import (
    bucketed_auc,
    bucketed_auc_sharded_padded,
    grouped_auc_device,
    grouped_precision_at_k_device,
)
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


# ---------------------------------------------------------------------------
# host (numpy) per-group metrics: the oracle for the device versions
# ---------------------------------------------------------------------------
def grouped_auc(scores: np.ndarray, labels: np.ndarray, group_ids: np.ndarray) -> float:
    """Mean per-group AUC over groups containing both classes."""
    s, n = _grouped_auc_impl(scores, labels, group_ids)
    return s / n if n else float("nan")


def grouped_auc_parts(scores: np.ndarray, labels: np.ndarray, group_ids: np.ndarray) -> tuple[float, int]:
    """(Σ per-group AUC over the valid groups, their count): the summable
    halves of ``grouped_auc``; partials of disjoint complete groups add
    across processes."""
    return _grouped_auc_impl(scores, labels, group_ids)


def _grouped_auc_impl(scores, labels, group_ids) -> tuple[float, int]:
    if len(np.asarray(scores)) == 0:
        return 0.0, 0
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.float64)
    group_ids = np.asarray(group_ids)
    # sort by (group, score) once; average ranks within each group
    order = np.lexsort((scores, group_ids))
    g, s, y = group_ids[order], scores[order], labels[order]
    n = len(s)
    starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
    seg_of = np.cumsum(np.r_[True, g[1:] != g[:-1]]) - 1
    seg_start = starts[seg_of]
    # tie runs within groups: first / last index of equal (g, s) runs
    new_run = np.r_[True, (g[1:] != g[:-1]) | (s[1:] != s[:-1])]
    run_id = np.cumsum(new_run) - 1
    run_first = np.flatnonzero(new_run)
    run_last = np.r_[run_first[1:], n] - 1
    avg_rank = 0.5 * (run_first[run_id] + run_last[run_id]) - seg_start + 1.0
    pos_per_seg = np.add.reduceat(y, starts)
    cnt_per_seg = np.add.reduceat(np.ones_like(y), starts)
    rank_pos = np.add.reduceat(avg_rank * y, starts)
    neg_per_seg = cnt_per_seg - pos_per_seg
    valid = (pos_per_seg > 0) & (neg_per_seg > 0)
    u = rank_pos - pos_per_seg * (pos_per_seg + 1.0) / 2.0
    auc = np.where(valid, u / np.maximum(pos_per_seg * neg_per_seg, 1.0), np.nan)
    if not valid.any():
        return 0.0, 0
    return float(np.nansum(np.where(valid, auc, 0.0))), int(valid.sum())


def grouped_precision_at_k(
    scores: np.ndarray, labels: np.ndarray, group_ids: np.ndarray, k: int
) -> float:
    """Mean per-group precision@k: the fraction of positives among each
    group's top-k scores, averaged over groups with at least one sample."""
    s, n = grouped_precision_at_k_parts(scores, labels, group_ids, k)
    return s / n if n else float("nan")


def grouped_precision_at_k_parts(
    scores: np.ndarray, labels: np.ndarray, group_ids: np.ndarray, k: int
) -> tuple[float, int]:
    """(Σ per-group precision@k, group count): summable across processes
    holding disjoint complete groups (see ``grouped_auc_parts``)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.float64)
    group_ids = np.asarray(group_ids)
    if len(scores) == 0:
        return 0.0, 0
    order = np.lexsort((-scores, group_ids))
    g, y = group_ids[order], labels[order]
    starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
    seg_of = np.cumsum(np.r_[True, g[1:] != g[:-1]]) - 1
    within_rank = np.arange(len(g)) - starts[seg_of]
    hits = np.add.reduceat(np.where(within_rank < k, y, 0.0), starts)
    denom = np.minimum(np.add.reduceat(np.ones_like(y), starts), k)
    return float(np.sum(hits / denom)), int(len(starts))


# ---------------------------------------------------------------------------
# evaluator objects and the registry
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Evaluator:
    """Named metric; ``larger_is_better`` drives model selection. With
    ``group_by`` set it is a per-group metric over the id tag of that name,
    and ``_fn`` receives ``(scores, labels, dense_group_ids, num_groups)``;
    a scalar evaluator's ``_fn`` receives ``(scores, labels, weights)``.
    ``k`` is PRECISION_AT_K's cut-off. ``_sharded_fn(scores, labels,
    weights, mesh)``, where set, is the metric over a data mesh's shards."""

    name: str
    larger_is_better: bool
    _fn: Callable
    group_by: str | None = None
    k: int | None = None
    _sharded_fn: Callable | None = None

    def __call__(self, scores, labels, weights=None, group_ids=None, mesh=None) -> float:
        if mesh is not None and self._sharded_fn is not None:
            return float(self._sharded_fn(scores, labels, weights, mesh))
        if self.group_by is None:
            return float(self._fn(scores, labels, weights))
        if group_ids is None or self.group_by not in group_ids:
            raise KeyError(f"evaluator {self.name} needs id tag {self.group_by!r}")
        # Rows of an unseen entity (id -1) belong to no group and are left
        # out, as in the reference; the rest are densified to [0, G) on the
        # scores' device (one read of G sizes the per-group sums). Weights
        # do not enter a per-group metric.
        gids = torch.as_tensor(group_ids[self.group_by], device=scores.device)
        keep = gids >= 0
        if not bool(keep.all()):
            gids, scores, labels = gids[keep], scores[keep], labels[keep]
        if gids.numel() == 0:
            return float("nan")
        uniq, dense = torch.unique(gids, return_inverse=True)
        return float(self._fn(scores, labels, dense, len(uniq)))

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

def make_evaluator(spec: str) -> Evaluator:
    """Parse an EvaluatorType string: "AUC" | "RMSE" | "LOGISTIC_LOSS" |
    "POISSON_LOSS" | "SQUARED_LOSS" | "SMOOTHED_HINGE_LOSS" |
    "MULTI_AUC(idTag)" | "PRECISION_AT_K(k,idTag)" | "BUCKETED_AUC" |
    "BUCKETED_AUC(numBuckets)" (2¹⁶ buckets by default)."""
    spec = spec.strip()
    if spec.upper() in _SCALAR_EVALUATORS:
        fn, larger = _SCALAR_EVALUATORS[spec.upper()]
        return Evaluator(name=spec.upper(), larger_is_better=larger, _fn=fn)
    m = re.fullmatch(r"BUCKETED_AUC(?:\((\d+)\))?", spec, re.IGNORECASE)
    if m:
        buckets = int(m.group(1)) if m.group(1) else 1 << 16
        if buckets < 1:
            raise ValueError(f"{spec!r}: bucket count must be >= 1")
        return Evaluator(
            name=spec.upper(), larger_is_better=True,
            _fn=lambda s, y, w=None: bucketed_auc(s, y, w, num_buckets=buckets),
            _sharded_fn=lambda s, y, w, mesh: bucketed_auc_sharded_padded(s, y, w, buckets, mesh=mesh),
        )
    m = re.fullmatch(r"MULTI_AUC\((\w+)\)", spec, re.IGNORECASE)
    if m:
        return Evaluator(name=spec, larger_is_better=True, _fn=grouped_auc_device,
                         group_by=m.group(1))
    m = re.fullmatch(r"PRECISION_AT_K\((\d+)\s*,\s*(\w+)\)", spec, re.IGNORECASE)
    if m:
        k = int(m.group(1))
        return Evaluator(
            name=spec, larger_is_better=True,
            _fn=lambda s, y, g, num_groups: grouped_precision_at_k_device(s, y, g, k, num_groups),
            group_by=m.group(2), k=k,
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


def evaluate_all(specs, scores, labels, weights=None, group_ids=None, mesh=None) -> EvaluationResults:
    """Every evaluator of ``specs`` on raw scores. ``group_ids`` (tag →
    (n,) entity ids) is what the grouped evaluators read; the scalar ones
    ignore it. With a data ``mesh`` an evaluator with a sharded form
    (BUCKETED_AUC) computes over the mesh's shards; across processes it is
    a collective (every process calls it with its same copy of the rows)."""
    evs = [make_evaluator(s) if isinstance(s, str) else s for s in specs]
    metrics = {e.name: e(scores, labels, weights, group_ids, mesh) for e in evs}
    return EvaluationResults(metrics=metrics, primary_name=evs[0].name if evs else None)
