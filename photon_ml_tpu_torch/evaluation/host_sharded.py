"""Validation metrics over row-partitioned host columns (port of
``photon_ml_tpu/evaluation/host_sharded.py``), for the multi-process
out-of-core GAME trainer.

Every process holds its own validation rows; no process ever holds the
global score column. Each metric is a per-process partial combined by one
small host allreduce (``parallel/multihost.py``):

- loss metrics (RMSE and the LOGISTIC / POISSON / SQUARED /
  SMOOTHED_HINGE losses): (Σ w·loss, Σ w);
- AUC (and BUCKETED_AUC): the histogram recipe of ``scalable.py`` on the
  host: the global score range from one max-allreduce, each process's
  positive and negative bin masses (2^16 bins unless the spec names a
  count), one allreduce of the masses, Mann-Whitney over the bins. Its
  error against the exact AUC comes from labels mixed within a bin
  (below about 1e-4 at 2^16 bins);
- grouped metrics (MULTI_AUC, PRECISION_AT_K): (Σ group metric, group
  count) over complete groups, which the trainer has routed so that each
  group lies on one process.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from photon_ml_tpu_torch.evaluation.evaluators import (
    EvaluationResults,
    grouped_auc_parts,
    grouped_precision_at_k_parts,
    make_evaluator,
)
from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.parallel.multihost import allreduce_max_host, allreduce_sum_host

_LOSSES = {
    "LOGISTIC_LOSS": losses.logistic_loss,
    "POISSON_LOSS": losses.poisson_loss,
    "SQUARED_LOSS": losses.squared_loss,
    "SMOOTHED_HINGE_LOSS": losses.smoothed_hinge_loss,
}


def _loss_values(name: str, scores: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Per-row values of a loss metric, through the losses the in-memory
    metrics use (float32 on the host), as float64."""
    if name == "RMSE":
        return (scores - labels) ** 2
    value = _LOSSES[name].value(torch.as_tensor(scores, dtype=torch.float32),
                                torch.as_tensor(labels, dtype=torch.float32))
    return value.numpy().astype(np.float64)


def _hist_auc_partial(scores: np.ndarray, labels: np.ndarray, weights: np.ndarray, lo: float, hi: float,
                      num_buckets: int) -> tuple[np.ndarray, np.ndarray]:
    """This process's positive and negative masses over the bins of
    [lo, hi]; rows of weight 0 do not count."""
    inc = weights > 0
    span = max(hi - lo, 1e-30)
    s = np.where(inc, scores, lo)
    bins = np.clip(((s - lo) / span * num_buckets).astype(np.int64), 0, num_buckets - 1)
    y = labels > 0
    pos = np.bincount(bins[inc & y], minlength=num_buckets).astype(np.float64)
    neg = np.bincount(bins[inc & ~y], minlength=num_buckets).astype(np.float64)
    return pos, neg


def _auc_from_hist(pos: np.ndarray, neg: np.ndarray) -> float:
    p, n = pos.sum(), neg.sum()
    if p <= 0 or n <= 0:
        return float("nan")
    neg_below = np.cumsum(neg) - neg
    return float(np.sum(pos * (neg_below + 0.5 * neg)) / (p * n))


def _ratio(part) -> float:
    return float(part[0] / part[1]) if part[1] > 0 else float("nan")


def evaluate_host_sharded(specs, scores: np.ndarray, labels: np.ndarray, weights: np.ndarray,
                          owner_grouped: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]],
                          auc_buckets: int = 1 << 16) -> EvaluationResults:
    """The metrics of ``specs`` over this process's validation rows
    (``scores``, ``labels``, ``weights``: host arrays), combined across
    processes. A grouped spec reads ``owner_grouped[tag] = (scores, labels,
    group ids)``, which must hold complete groups. A collective: every
    process calls it with the same specs in the same order."""
    metrics: dict[str, float] = {}
    for spec in specs:
        ev = make_evaluator(spec)
        name = ev.name if ev.group_by is None else spec
        up = spec.strip().upper()
        if up == "RMSE" or up in _LOSSES:
            inc = weights > 0
            loss = _loss_values(up, np.asarray(scores, np.float64), np.asarray(labels, np.float64))
            part = np.asarray([float(np.sum(weights[inc] * loss[inc])), float(np.sum(weights[inc]))], np.float64)
            mean = _ratio(allreduce_sum_host(part))
            metrics[name] = float(np.sqrt(mean)) if up == "RMSE" else mean
        elif up == "AUC" or re.fullmatch(r"BUCKETED_AUC(?:\(\d+\))?", up):
            m = re.fullmatch(r"BUCKETED_AUC\((\d+)\)", up)
            buckets = int(m.group(1)) if m else auc_buckets
            s_inc = scores[weights > 0]
            local_hi = float(s_inc.max()) if len(s_inc) else -np.inf
            local_lo = float(s_inc.min()) if len(s_inc) else np.inf
            hi, neg_lo = allreduce_max_host(np.asarray([local_hi]), np.asarray([-local_lo]))
            pos, neg = _hist_auc_partial(np.asarray(scores, np.float64), np.asarray(labels, np.float64),
                                         np.asarray(weights, np.float64), float(-neg_lo[0]), float(hi[0]),
                                         buckets)
            metrics[name] = _auc_from_hist(*allreduce_sum_host(pos, neg))
        elif ev.group_by is not None:
            if ev.group_by not in owner_grouped:
                raise KeyError(f"evaluator {spec}: no owner-routed validation rows for id tag {ev.group_by!r}")
            s_o, y_o, g_o = owner_grouped[ev.group_by]
            part = (grouped_precision_at_k_parts(s_o, y_o, g_o, ev.k) if ev.k is not None
                    else grouped_auc_parts(s_o, y_o, g_o))
            metrics[name] = _ratio(allreduce_sum_host(np.asarray(part, np.float64)))
        else:
            raise ValueError(f"unsupported sharded evaluator spec {spec!r}")
    return EvaluationResults(metrics=metrics)
