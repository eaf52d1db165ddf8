"""The fused outer iteration of GAME's coordinate descent
(``game/descent.py`` ``_FusedOuter``, the coordinates'
``_fused_visit_parts``), on the CPU.

Held to: the reference's descent, which takes its own fused path on these
fixtures, within the tolerances ``tests/test_torch_game.py`` states
(GLMM_TOLERANCES, coefficients and scores atol 1e-3); the port's eager
visit loop bit for bit (coefficients, variances, training scores, every
tracker's iterations, reasons and objective passes, the last visit's
per-entity diagnostics, and the checkpoints written after every outer
iteration), for Newton, L-BFGS, OWL-QN and TRON lanes, a fixed effect
on TRON, a random projector, a locked coordinate, a warm start and 1, 3
and 5 outer iterations (chunks of 1; 2 + 1; 4 + 1); the reference's
selection rule, case by case (TRON takes the fused path, as the
reference's does); and the reference's span and record names. The card's twins (a captured
replay against the eager loop, no host read inside a chunk, a second run
that captures nothing, a failed capture that raises) are in
``tests/test_torch_cuda.py``."""

from __future__ import annotations

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import photon_ml_tpu.config as jcfg
import photon_ml_tpu_torch.config as tcfg
import photon_ml_tpu_torch.estimators as estimators
import photon_ml_tpu_torch.types as ttypes
from photon_ml_tpu.estimators import GameEstimator as JEstimator
from photon_ml_tpu_torch.checkpoint import load_checkpoint
from photon_ml_tpu_torch.estimators import GameEstimator
from photon_ml_tpu_torch.game import descent as descent_mod
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.data import bucket_entities, group_by_entity
from photon_ml_tpu_torch.game.descent import CoordinateDescent, _pow2_floor
from photon_ml_tpu_torch.optim.common import OptimizationResult

from test_torch_game import GLMM_TOLERANCES, _assert_models_agree, _config, _data


def _fit(cfg, tb, data, fused: bool, **fit_kw):
    """``GameEstimator.fit`` (the first grid entry) with the descent's fused
    path on or forced off."""
    with mock.patch.object(estimators, "CoordinateDescent", functools.partial(CoordinateDescent, _fused=fused)):
        return GameEstimator(cfg, intercept_indices={"global": data.intercept_index}, device="cpu").fit(
            tb, **fit_kw)[0]


def _re_config(cfg, **changes):
    """``cfg`` with every random effect's coordinate config changed."""
    return cfg.replace(random_effect_coordinates={
        cid: rc.replace(**changes) for cid, rc in cfg.random_effect_coordinates.items()})


def _fixed_tron(cfg):
    """``cfg`` with the fixed effect on TRON (its CG steps are Hv passes)."""
    fe = cfg.fixed_effect_coordinates["fixed"]
    opt = fe.optimization
    return cfg.replace(fixed_effect_coordinates={"fixed": fe.replace(optimization=opt.replace(
        optimizer=opt.optimizer.replace(optimizer_type=ttypes.OptimizerType.TRON)))})


def _elastic_net(cfg):
    return cfg.replace(random_effect_coordinates={
        cid: rc.replace(optimization=rc.optimization.replace(
            regularization=tcfg.RegularizationContext(ttypes.RegularizationType.ELASTIC_NET, alpha=0.5)))
        for cid, rc in cfg.random_effect_coordinates.items()})


def _equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _assert_bitwise(fused, eager) -> None:
    """Two descents' results bit for bit: models, scores and trackers."""
    assert fused.model.models.keys() == eager.model.models.keys()
    for cid, sub in fused.model.models.items():
        other = eager.model.models[cid]
        assert _equal(sub.coefficient_means, other.coefficient_means), cid
        if hasattr(sub, "variances"):
            assert _equal(sub.variances, other.variances), cid
    assert fused.training_scores.keys() == eager.training_scores.keys()
    for cid, s in fused.training_scores.items():
        assert _equal(s, eager.training_scores[cid]), cid
    assert fused.validation_history == eager.validation_history
    for cid, ts in fused.trackers.items():
        es = eager.trackers[cid]
        assert len(ts) == len(es)
        for t, e in zip(ts, es):
            assert type(t) is type(e)
            if isinstance(t, OptimizationResult):
                for f in ("iterations", "reason", "objective_passes"):
                    assert type(getattr(t, f)) is int and getattr(t, f) == getattr(e, f), (cid, f)
                for f in ("w", "value", "grad_norm", "loss_history", "grad_norm_history"):
                    assert torch.equal(getattr(t, f).nan_to_num(7.0), getattr(e, f).nan_to_num(7.0)), (cid, f)
        if not isinstance(ts[-1], OptimizationResult):
            last, other = ts[-1], es[-1]
            for f in ("iterations", "converged", "objective_passes"):
                np.testing.assert_array_equal(getattr(last, f), getattr(other, f))
            np.testing.assert_array_equal(last.loss_values, other.loss_values)
            assert _equal(last.coefficients, other.coefficients)


CASES = {
    "newton_1": dict(iterations=1),
    "newton_3": dict(iterations=3),
    "newton_5": dict(iterations=5),
    "lbfgs_lanes": dict(iterations=2, re_solver="LBFGS", re_tolerance=1e-3),
    "owlqn_lanes": dict(iterations=2, re_solver="LBFGS", re_tolerance=1e-3, elastic_net=True),
    "projector": dict(iterations=2, re_solver="LBFGS", re_tolerance=1e-3, projection=2),
    "tron_lanes_1": dict(iterations=1, re_solver="TRON", re_tolerance=1e-3),
    "tron_lanes_3": dict(iterations=3, re_solver="TRON", re_tolerance=1e-3),
    "tron_fixed_and_lanes_1": dict(iterations=1, re_solver="TRON", re_tolerance=1e-3, fixed_tron=True),
    "tron_fixed_and_lanes_3": dict(iterations=3, re_solver="TRON", re_tolerance=1e-3, fixed_tron=True),
}


@pytest.fixture(scope="module")
def glmm():
    return _data(seed=0)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_descent_is_bitwise_the_eager_loop(glmm, case):
    """Every case through the estimator, fused and eager, on the GLMM
    fixture (config E's shape)."""
    data, _, tb = glmm
    kw = {**GLMM_TOLERANCES, **CASES[case]}
    elastic, projection = kw.pop("elastic_net", False), kw.pop("projection", None)
    fixed_tron = kw.pop("fixed_tron", False)
    cfg = _config(tcfg, **kw)
    if elastic:
        cfg = _elastic_net(cfg)
    if fixed_tron:
        cfg = _fixed_tron(cfg)
    if projection is not None:
        cfg = _re_config(cfg, random_projection_dim=projection)
    fused, eager = _fit(cfg, tb, data, True), _fit(cfg, tb, data, False)
    _assert_bitwise(fused.descent, eager.descent)
    assert len(fused.descent.trackers["fixed"]) == kw["iterations"]


def test_chunks_are_powers_of_two_largest_first(glmm, monkeypatch, tmp_path):
    """5 iterations run as chunks of 4 and 1, 3 as 2 and 1, with one
    ``descent/fused-outer`` span a chunk; a checkpoint directory pins 1."""
    assert [_pow2_floor(x) for x in (1, 2, 3, 5, 16, 17)] == [1, 2, 2, 4, 16, 16]
    data, _, tb = glmm
    chunks = []
    real = descent_mod._FusedOuter.__call__

    def spy(self, model, total, scores, r):
        chunks.append(r)
        return real(self, model, total, scores, r)

    monkeypatch.setattr(descent_mod._FusedOuter, "__call__", spy)
    for iterations, want, fit_kw in ((5, [4, 1], {}), (3, [2, 1], {}),
                                     (3, [1, 1, 1], {"checkpoint_dir": str(tmp_path / "ckpt")})):
        chunks.clear()
        _fit(_config(tcfg, **GLMM_TOLERANCES, iterations=iterations), tb, data, True, **fit_kw)
        assert chunks == want


def test_fused_checkpoints_are_the_eager_loops(glmm, tmp_path):
    """With a checkpoint directory each chunk is one iteration, and every
    checkpoint holds the eager loop's model, scores and total bit for
    bit; a second fit resumes from the last and trains nothing more."""
    data, _, tb = glmm
    cfg = _config(tcfg, **GLMM_TOLERANCES, iterations=3)
    fused = _fit(cfg, tb, data, True, checkpoint_dir=str(tmp_path / "fused"))
    eager = _fit(cfg, tb, data, False, checkpoint_dir=str(tmp_path / "eager"))
    _assert_bitwise(fused.descent, eager.descent)
    a = load_checkpoint(str(tmp_path / "fused" / "config-0000"), device="cpu")
    b = load_checkpoint(str(tmp_path / "eager" / "config-0000"), device="cpu")
    assert a.next_iteration == b.next_iteration == 3
    for cid in a.model.models:
        assert _equal(a.model[cid].coefficient_means, b.model[cid].coefficient_means)
    assert a.scores.keys() == b.scores.keys()
    assert all(np.array_equal(a.scores[c], b.scores[c]) for c in a.scores)
    assert np.array_equal(a.total, b.total)
    resumed = _fit(cfg, tb, data, True, checkpoint_dir=str(tmp_path / "fused"))
    assert all(not t for t in resumed.descent.trackers.values())


def _locked_fixture():
    data, _, tb = _data(seed=5, n=300, effects={"userId": (8, 2)}, task="LINEAR_REGRESSION")
    task = ttypes.TaskType.LINEAR_REGRESSION
    opt = tcfg.OptimizationConfig(
        optimizer=tcfg.OptimizerConfig(optimizer_type=ttypes.OptimizerType.NEWTON_CHOLESKY,
                                       max_iterations=30, tolerance=1e-5),
        regularization=tcfg.RegularizationContext(ttypes.RegularizationType.L2),
        regularization_weight=1.0,
    )
    fixed = FixedEffectCoordinate("fixed", tb, "global", opt.replace(
        optimizer=tcfg.OptimizerConfig(max_iterations=50, tolerance=1e-7)), task,
        intercept_index=data.intercept_index)
    g = group_by_entity(data.entity_ids["userId"], num_entities=8)
    re = RandomEffectCoordinate("per_user", tb, "shard_userId", "userId", opt, g, bucket_entities(g), task, 8)
    return tb, task, fixed, re


def test_locked_coordinate_and_warm_start():
    """A warm start (a model from one fixed-effect iteration) and a locked
    coordinate (in the model, not in the sequence): bitwise the eager loop."""
    tb, task, fixed, re = _locked_fixture()
    runs = {}
    for fused in (True, False):
        m1 = CoordinateDescent({"fixed": fixed}, tb, task, _fused=fused).run(["fixed"], 1)
        locked = CoordinateDescent({"fixed": fixed, "per_user": re}, tb, task, _fused=fused).run(
            ["per_user"], 3, initial_model=m1.model)
        warm = CoordinateDescent({"fixed": fixed, "per_user": re}, tb, task, _fused=fused).run(
            ["fixed", "per_user"], 2, initial_model=locked.model)
        runs[fused] = (m1, locked, warm)
    for a, b in zip(runs[True], runs[False]):
        _assert_bitwise(a, b)
    assert runs[True][1].model["fixed"] is runs[True][0].model["fixed"]


def test_fused_descent_matches_the_reference(glmm):
    """The GLMM fixture without validation, where the reference takes its
    fused path: coefficients and scores within atol 1e-3."""
    data, jb, tb = glmm
    jres = JEstimator(_config(jcfg, **GLMM_TOLERANCES),
                      intercept_indices={"global": data.intercept_index}).fit(jb)[0]
    tres = _fit(_config(tcfg, **GLMM_TOLERANCES), tb, data, True)
    _assert_models_agree(jres.model, tres.model, jb, tb)


def test_fused_lbfgs_lanes_match_the_reference():
    """L-BFGS lanes (one outer iteration, tolerance 1e-3), fused in both
    packages: coefficients and scores within atol 1e-3, as
    ``test_glmm_with_default_lane_solvers_matches_reference`` holds them."""
    data, jb, tb = _data(seed=1, n=500)
    kw = dict(buckets=(1, 1e6), re_solver="LBFGS", re_tolerance=1e-3, iterations=1)
    jres = JEstimator(_config(jcfg, **kw), intercept_indices={"global": data.intercept_index}).fit(jb)[0]
    tres = _fit(_config(tcfg, **kw), tb, data, True)
    _assert_models_agree(jres.model, tres.model, jb, tb)


def test_fused_tron_lanes_match_the_reference():
    """TRON lanes (one outer iteration, tolerance 1e-3), fused in both
    packages: coefficients and scores within atol 1e-3."""
    data, jb, tb = _data(seed=1, n=500)
    kw = dict(buckets=(1, 1e6), re_solver="TRON", re_tolerance=1e-3, iterations=1)
    jres = JEstimator(_config(jcfg, **kw), intercept_indices={"global": data.intercept_index}).fit(jb)[0]
    tres = _fit(_config(tcfg, **kw), tb, data, True)
    _assert_models_agree(jres.model, tres.model, jb, tb)


def _takes_fused(monkeypatch, run) -> bool:
    called = []
    real = CoordinateDescent._run_fused

    def spy(self, *a, **k):
        called.append(True)
        return real(self, *a, **k)

    monkeypatch.setattr(CoordinateDescent, "_run_fused", spy)
    run()
    return bool(called)


@pytest.mark.parametrize("case", ["default", "validation", "mesh", "train_rows", "compact_every", "tron"])
def test_selection_rule(glmm, monkeypatch, case):
    """The reference's rule: the fused path unless validation runs with
    evaluators, or a coordinate needs host staging per visit (a mesh,
    down-sampling, lane compaction). TRON lanes take the fused path, as
    the reference's do."""
    data, _, tb = glmm
    cfg = _config(tcfg, **GLMM_TOLERANCES, iterations=1)
    fit_kw = {}
    if case == "validation":
        cfg, fit_kw = cfg.replace(evaluators=("AUC",)), dict(validation_batch=tb)
    elif case == "train_rows":
        fe = cfg.fixed_effect_coordinates["fixed"]
        cfg = cfg.replace(fixed_effect_coordinates={"fixed": fe.replace(
            optimization=fe.optimization.replace(down_sampling_rate=0.5))})
    elif case == "compact_every":
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "2")
    elif case == "tron":
        cfg = _re_config(cfg, optimization=cfg.random_effect_coordinates["per_userId"].optimization.replace(
            optimizer=tcfg.OptimizerConfig(optimizer_type=ttypes.OptimizerType.TRON, max_iterations=30,
                                           tolerance=1e-3)))
    if case == "mesh":
        from photon_ml_tpu_torch.parallel.mesh import data_mesh

        mesh = data_mesh(2, devices=[torch.device("cpu")] * 2)
        coords = {"fixed": FixedEffectCoordinate(
            "fixed", tb, "global", cfg.fixed_effect_coordinates["fixed"].optimization,
            ttypes.TaskType.LOGISTIC_REGRESSION, intercept_index=data.intercept_index, mesh=mesh)}
        assert coords["fixed"]._fused_visit_parts() is None
        taken = _takes_fused(monkeypatch, lambda: CoordinateDescent(
            coords, tb, ttypes.TaskType.LOGISTIC_REGRESSION, mesh=mesh).run(["fixed"], 1))
    else:
        taken = _takes_fused(monkeypatch, lambda: _fit(cfg, tb, data, True, **fit_kw))
    assert taken is (case in ("default", "tron"))


def test_spans_and_records_are_the_references(glmm, tmp_path):
    """A fused fit under a sink in each package: the same span names (one
    ``descent/fused-outer`` a chunk, with the reference's attributes) and
    the same ``descent_iteration`` records."""
    from photon_ml_tpu import obs as jobs
    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.obs.report import load_run

    data, jb, tb = glmm
    jpath = jobs.configure(str(tmp_path / "ref"), run_id="ref")
    try:
        JEstimator(_config(jcfg, **GLMM_TOLERANCES, iterations=3),
                   intercept_indices={"global": data.intercept_index}).fit(jb)
    finally:
        jobs.shutdown()
    path = obs.configure(str(tmp_path / "port"), run_id="port")
    try:
        _fit(_config(tcfg, **GLMM_TOLERANCES, iterations=3), tb, data, True)
    finally:
        obs.shutdown()
    ref, port = load_run(jpath), load_run(path)

    def spans(records, prefix="descent/"):
        return [(r["name"], r["attrs"]) for r in records if r["event"] == "span" and r["name"].startswith(prefix)]

    assert spans(port) == spans(ref) == [("descent/fused-outer", {"first_iteration": 0, "iterations": 2}),
                                         ("descent/fused-outer", {"first_iteration": 2, "iterations": 1})]

    def iterations(records):
        return [r["iteration"] for r in records if r["event"] == "descent_iteration"]

    assert iterations(port) == iterations(ref) == [0, 1, 2]


def test_visit_is_train_then_score(glmm):
    """``visit`` (one visit through the fused parts) gives the eager visit's
    sub-model, score and total bit for bit, for a cold and a warm start,
    on both coordinate classes."""
    data, _, tb = glmm
    est = GameEstimator(_config(tcfg, **GLMM_TOLERANCES), intercept_indices={"global": data.intercept_index},
                        device="cpu")
    cfg = est.config
    coords = est._build_coordinates(tb, estimators.build_configuration_grid(cfg)[0],
                                    est._normalization_contexts(tb), est._entity_layouts(tb))
    total, initial, scores = tb.offsets, {}, {}
    for _ in range(2):  # cold starts, then warm ones
        for cid in cfg.coordinate_update_sequence:
            coord, own = coords[cid], scores.get(cid)
            sub, _, score, new_total = coord.visit(total, own, initial.get(cid))
            offsets = total if own is None else total - own
            ref, _ = coord.train(offsets, initial.get(cid))
            assert _equal(sub.coefficient_means, ref.coefficient_means), cid
            assert _equal(score, coord.score(ref)) and _equal(new_total, offsets + coord.score(ref)), cid
            initial[cid], scores[cid], total = sub, score, new_total
