"""The port's diagnostics reports (``photon_ml_tpu_torch/diagnostics.py``)
against the JAX package's on the same numbers: a JAX solve's trackers,
models and validation metrics are carried into the port's types, and the
report dicts of ``optimizer_summary``, ``coefficient_summary``,
``glm_sweep_diagnostics`` and ``game_diagnostics`` must equal the
reference's (floats within rtol 1e-5, everything else exactly); the HTML
and JSON files are written."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

import photon_ml_tpu.config as jcfg
import photon_ml_tpu.diagnostics as jdiag
import photon_ml_tpu.types as jtypes
from photon_ml_tpu.data.index_map import IndexMap as JIndexMap
from photon_ml_tpu.data.synthetic import synthetic_game_data as jax_game_data
from photon_ml_tpu.estimators import GameEstimator as JEstimator
from photon_ml_tpu.game.data import make_game_batch as j_make_game_batch
from photon_ml_tpu.ops.batch import DenseBatch as JDense
from photon_ml_tpu.supervised.training import train_glm as j_train_glm
import photon_ml_tpu_torch.diagnostics as tdiag
from photon_ml_tpu_torch.config import parse_config
from photon_ml_tpu_torch.convert import game_model_from_numpy
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.estimators import GameResult
from photon_ml_tpu_torch.evaluation import EvaluationResults
from photon_ml_tpu_torch.game.descent import CoordinateDescentResult
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.optim.common import OptimizationResult
from photon_ml_tpu_torch.supervised.training import GLMTrainingResult
from photon_ml_tpu_torch.types import TaskType


def _same(got, want, path="report"):
    """Equal JSON-able trees; floats within rtol 1e-5."""
    if isinstance(want, float) and isinstance(got, float):
        assert math.isclose(got, want, rel_tol=1e-5, abs_tol=0.0) or got == want, (path, got, want)
        return
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def _tensor(x):
    return None if x is None else torch.as_tensor(np.array(x))


def _tracker(t) -> OptimizationResult:
    """A JAX ``OptimizationResult`` in the port's type."""
    return OptimizationResult(
        w=_tensor(t.w), value=_tensor(t.value), grad_norm=_tensor(t.grad_norm),
        iterations=int(t.iterations), reason=int(t.reason), loss_history=_tensor(t.loss_history),
        grad_norm_history=_tensor(t.grad_norm_history),
        objective_passes=None if t.objective_passes is None else int(t.objective_passes),
    )


def _evaluation(ev):
    return None if ev is None else EvaluationResults(metrics=dict(ev.metrics), primary_name=ev.primary_name)


def _glm_problem():
    rng = np.random.default_rng(5)
    n, d = 300, 6
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, -1] = 1.0
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-X @ rng.normal(size=d)))).astype(np.float32)
    return JDense(X=X, labels=y, offsets=np.zeros(n, np.float32), weights=np.ones(n, np.float32))


KEYS = ["a", "b\x01x", "c\x01y", "d", "e\x01z"]


def test_optimizer_and_coefficient_summaries_match():
    batch = _glm_problem()
    res = j_train_glm(batch, jtypes.TaskType.LOGISTIC_REGRESSION, regularization_weights=[1.0],
                      intercept_index=5, variance_computation=jtypes.VarianceComputationType.SIMPLE)
    t = res.trackers[1.0]
    _same(tdiag.optimizer_summary(_tracker(t)), jdiag.optimizer_summary(t))
    means, var = res.models[1.0].coefficients.means, res.models[1.0].coefficients.variances
    jmap, tmap = JIndexMap.build(KEYS, add_intercept=True), IndexMap.build(KEYS, add_intercept=True)
    for top_k in (3, 25):
        _same(tdiag.coefficient_summary(_tensor(means), _tensor(var), tmap, top_k=top_k),
              jdiag.coefficient_summary(means, var, jmap, top_k=top_k))
    # zeros, NaN and Inf, and no index map
    w = np.array([0.0, np.nan, 2.0, -np.inf, 0.0, -1.0], np.float32)
    _same(tdiag.coefficient_summary(torch.from_numpy(w)), jdiag.coefficient_summary(w))


def test_glm_sweep_report_matches_and_is_written(tmp_path):
    batch = _glm_problem()
    res = j_train_glm(batch, jtypes.TaskType.LOGISTIC_REGRESSION, regularization_weights=[0.1, 1.0, 10.0],
                      intercept_index=5, validation_batch=batch)
    port = GLMTrainingResult(
        models={lam: GeneralizedLinearModel(Coefficients(_tensor(m.coefficients.means), None),
                                            TaskType.LOGISTIC_REGRESSION) for lam, m in res.models.items()},
        trackers={lam: _tracker(t) for lam, t in res.trackers.items()},
        validation={lam: _evaluation(ev) for lam, ev in res.validation.items()},
        best_weight=res.best_weight,
    )
    jmap, tmap = JIndexMap.build(KEYS, add_intercept=True), IndexMap.build(KEYS, add_intercept=True)
    want = jdiag.glm_sweep_diagnostics(res, index_map=jmap, task=jtypes.TaskType.LOGISTIC_REGRESSION)
    got = tdiag.glm_sweep_diagnostics(port, index_map=tmap, task=TaskType.LOGISTIC_REGRESSION)
    _same(got, want)
    tdiag.write_report(got, str(tmp_path))
    assert json.loads((tmp_path / "diagnostics.json").read_text()) == json.loads(json.dumps(got))
    page = (tmp_path / "diagnostics.html").read_text()
    assert page.startswith("<!doctype html>") and "λ = 0.1" in page and "<svg" in page
    jdiag.write_html(want, str(tmp_path / "ref.html"))
    assert (tmp_path / "ref.html").read_text() == page


def test_game_report_matches_and_is_written(tmp_path):
    data = jax_game_data(np.random.default_rng(2), 300, 4, {"userId": (8, 3)})
    feats = {"global": data.X, "shard_userId": data.entity_X["userId"]}
    jb = j_make_game_batch(data.y, feats, id_tags={"userId": data.entity_ids["userId"]})
    l2 = jcfg.RegularizationContext(jtypes.RegularizationType.L2)
    cfg = jcfg.GameTrainingConfig(
        task_type=jtypes.TaskType.LOGISTIC_REGRESSION,
        coordinate_update_sequence=("fixed", "per_userId"),
        coordinate_descent_iterations=2,
        fixed_effect_coordinates={"fixed": jcfg.FixedEffectCoordinateConfig(
            "global", jcfg.OptimizationConfig(regularization=l2, regularization_weight=1.0))},
        random_effect_coordinates={"per_userId": jcfg.RandomEffectCoordinateConfig(
            "userId", "shard_userId", jcfg.OptimizationConfig(regularization=l2, regularization_weight=1.0))},
        evaluators=("AUC", "MULTI_AUC(userId)"),
        regularization_weight_grid={"fixed": (0.1, 1.0)},
    )
    jres = JEstimator(cfg, intercept_indices={"global": data.intercept_index}).fit(jb, validation_batch=jb)
    tcfg = parse_config(cfg.to_dict())
    port = []
    for r in jres:
        models = {}
        for cid, sub in r.model.models.items():
            if cid == "fixed":
                models[cid] = dict(feature_shard_id="global", means=np.asarray(sub.model.coefficients.means))
            else:
                models[cid] = dict(feature_shard_id="shard_userId", random_effect_type="userId",
                                   coefficients=np.asarray(sub.coefficients))
        trackers = {cid: [_tracker(t) if cid == "fixed" else object() for t in ts]
                    for cid, ts in r.descent.trackers.items()}
        port.append(GameResult(
            model=game_model_from_numpy(models, "LOGISTIC_REGRESSION", device="cpu"),
            evaluation=_evaluation(r.evaluation),
            configuration={cid: tcfg.coordinate_config(cid).optimization.replace(
                regularization_weight=o.regularization_weight) for cid, o in r.configuration.items()},
            descent=CoordinateDescentResult(
                model=None, trackers=trackers, training_scores={},
                validation_history=[{cid: _evaluation(ev) for cid, ev in step.items()}
                                    for step in r.descent.validation_history]),
        ))
    jmaps = {"global": JIndexMap.build([f"g{j}" for j in range(4)], add_intercept=True)}
    tmaps = {"global": IndexMap.build([f"g{j}" for j in range(4)], add_intercept=True)}
    want = jdiag.game_diagnostics(jres, config=cfg, index_maps=jmaps)
    got = tdiag.game_diagnostics(port, config=tcfg, index_maps=tmaps)
    _same(got, want)
    assert [len(g["coordinates"]["fixed"]["per_iteration"]) for g in got["grid"]] == [2, 2]
    tdiag.write_report(got, str(tmp_path))
    jdiag.write_html(want, str(tmp_path / "ref.html"))
    assert (tmp_path / "diagnostics.html").read_text() == (tmp_path / "ref.html").read_text()
    assert json.loads((tmp_path / "diagnostics.json").read_text())["kind"] == "game"


@pytest.mark.parametrize("kind", ["unknown", "glm_sweep_empty"])
def test_html_of_other_reports(tmp_path, kind):
    report = {"kind": "other", "x": [1, 2]} if kind == "unknown" else {
        "kind": "glm_sweep", "task": None, "best_regularization_weight": None, "entries": []}
    tdiag.write_html(report, str(tmp_path / "p.html"))
    jdiag.write_html(report, str(tmp_path / "r.html"))
    assert (tmp_path / "p.html").read_text() == (tmp_path / "r.html").read_text()
