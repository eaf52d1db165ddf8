"""The driver's hyperparameter tuning loop (port of
``photon_ml_tpu/hyperparameter/tuning.py``): after the grid fit, a
``GaussianProcessSearch`` is seeded with the (regularization weights,
validation metric) observations of the grid entries and iterates: fit the
GP, maximize expected improvement over a Sobol pool, refit with the
suggested weights, observe. The tuned vector is each coordinate's
regularization weight, searched on a log scale.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from photon_ml_tpu_torch.estimators import GameEstimator, GameResult
from photon_ml_tpu_torch.evaluation import make_evaluator
from photon_ml_tpu_torch.game.data import GameBatch
from photon_ml_tpu_torch.hyperparameter.search import GaussianProcessSearch, SearchRange

# the log-λ search box
_DEFAULT_RANGE = SearchRange(lo=1e-4, hi=1e4, log_scale=True)


def gp_tune_weights(
    cids: Sequence[str],
    prior: Sequence[tuple[dict, float]],
    num_iterations: int,
    evaluate,
    larger_is_better: bool,
    seed: int = 0,
) -> None:
    """The GP → EI → refit loop over per-coordinate regularization weights:
    ``prior`` holds (weights by coordinate, primary metric) observations;
    ``evaluate(weights_by_cid, iteration) -> primary`` runs one refit."""
    sign = -1.0 if larger_is_better else 1.0  # the search minimizes
    search = GaussianProcessSearch(ranges=[_DEFAULT_RANGE] * len(cids), seed=seed, num_init=0)
    for weights, y in prior:
        x = np.array([np.clip(weights[cid], _DEFAULT_RANGE.lo, _DEFAULT_RANGE.hi) for cid in cids])
        search.observe(x, sign * y)
    for it in range(num_iterations):
        x = search.suggest()
        y = evaluate({cid: float(x[i]) for i, cid in enumerate(cids)}, it)
        search.observe(x, sign * y)


def tune_game_hyperparameters(
    estimator: GameEstimator,
    batch: GameBatch,
    validation_batch: GameBatch,
    prior_results: Sequence[GameResult],
    num_iterations: int,
    seed: int = 0,
) -> list[GameResult]:
    """``num_iterations`` tuning refits through ``estimator``; returns their
    results (the caller appends them to the grid's before selecting)."""
    cfg = estimator.config
    cids = list(cfg.coordinate_update_sequence)
    primary = make_evaluator(estimator._evaluator_specs()[0])
    prior = [
        ({cid: r.configuration[cid].regularization_weight for cid in cids}, r.evaluation.primary)
        for r in prior_results
        if r.evaluation is not None
    ]
    results: list[GameResult] = []

    def evaluate(weights: dict, _it: int) -> float:
        configuration = {
            cid: dataclasses.replace(cfg.coordinate_config(cid).optimization,
                                     regularization_weight=weights[cid])
            for cid in cids
        }
        fit = estimator.fit(batch, validation_batch, configurations=[configuration])[0]
        results.append(fit)
        return fit.evaluation.primary

    gp_tune_weights(cids, prior, num_iterations, evaluate, primary.larger_is_better, seed=seed)
    return results
