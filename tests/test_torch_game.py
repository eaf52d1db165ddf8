"""GAME end to end: the port's coordinate descent, ``GameEstimator`` and
``GameTransformer`` against the JAX package's on the same numpy fixture
(``synthetic_game_data`` from one seed, bit for bit on both sides).

Held to: the fixed-effect-only descent equals ``train_glm`` within atol
1e-4; a GLMM shaped like config E (fixed effect plus two random effects, 2
outer iterations) matches the reference's coefficients and scores within
atol 1e-3 and its validation AUC within 1e-4; a λ grid selects the same
entry; a JAX-trained model scores the same within rtol 1e-5 once carried
across; a high-dimensional sparse fixed effect trains on the sparse
kernel's layout; the configuration round-trips through JSON."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.config as jcfg
import photon_ml_tpu.types as jtypes
from photon_ml_tpu.data.synthetic import synthetic_game_data as jax_game_data
from photon_ml_tpu.estimators import GameEstimator as JEstimator
from photon_ml_tpu.estimators import build_configuration_grid as j_grid
from photon_ml_tpu.game.data import make_game_batch as j_make_game_batch
import photon_ml_tpu_torch.config as tcfg
import photon_ml_tpu_torch.types as ttypes
from photon_ml_tpu_torch.convert import game_batch_from_numpy, game_model_from_numpy
from photon_ml_tpu_torch.evaluation import auc_roc
from photon_ml_tpu_torch.estimators import GameEstimator, build_configuration_grid
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.data import bucket_entities, group_by_entity
from photon_ml_tpu_torch.game.descent import CoordinateDescent
from photon_ml_tpu_torch.game.models import GameModel
from photon_ml_tpu_torch.supervised.training import train_glm
from photon_ml_tpu_torch.transformers import GameTransformer

EFFECTS = {"userId": (20, 3), "itemId": (10, 3)}
TASK = "LOGISTIC_REGRESSION"
ONE_BUCKET = (1, 1e6)


def _data(seed=0, n=600, d_fixed=5, effects=EFFECTS, task=TASK):
    data = jax_game_data(np.random.default_rng(seed), n, d_fixed, effects,
                         task=jtypes.TaskType(task))
    feats = {"global": data.X, **{f"shard_{k}": data.entity_X[k] for k in effects}}
    tags = {k: data.entity_ids[k] for k in effects}
    jb = j_make_game_batch(data.y, feats, id_tags=tags)
    tb = game_batch_from_numpy(data.y, feats, id_tags=tags, device="cpu")
    return data, jb, tb


def _config(m, effects=EFFECTS, iterations=2, task=TASK, fixed_lambda=0.0, re_lambda=1.0,
            buckets=(8, 0.5), re_solver="NEWTON_CHOLESKY", re_tolerance=1e-7, fixed_tolerance=1e-7,
            **kw):
    """The same GameTrainingConfig in either package (``m`` is the config
    module, ``T`` below its types): bench.py's config E solvers; ``buckets``
    is (bucket_target_count, bucket_max_padded_ratio), config E's by
    default and ONE_BUCKET (one geometry per effect: fewer reference
    compiles) where the ladder is not what a test is about. ``re_solver``
    / ``re_tolerance`` set the random effects' optimizer and
    ``fixed_tolerance`` the fixed effect's."""
    T = jtypes if m is jcfg else ttypes

    def opt(solver, lam, tol):
        return m.OptimizationConfig(
            optimizer=m.OptimizerConfig(optimizer_type=T.OptimizerType(solver), max_iterations=30,
                                        tolerance=tol),
            regularization=m.RegularizationContext(T.RegularizationType.L2),
            regularization_weight=lam,
        )

    return m.GameTrainingConfig(
        task_type=T.TaskType(task),
        coordinate_update_sequence=("fixed", *(f"per_{k}" for k in effects)),
        coordinate_descent_iterations=iterations,
        fixed_effect_coordinates={"fixed": m.FixedEffectCoordinateConfig(
            "global", opt("LBFGS", fixed_lambda, fixed_tolerance))},
        random_effect_coordinates={
            f"per_{k}": m.RandomEffectCoordinateConfig(
                k, f"shard_{k}", opt(re_solver, re_lambda, re_tolerance),
                bucket_target_count=buckets[0], bucket_max_padded_ratio=buckets[1],
            )
            for k in effects
        },
        **kw,
    )


def _assert_models_agree(jm, tm, jb, tb, atol=1e-3):
    for cid, sub in tm.models.items():
        np.testing.assert_allclose(sub.coefficient_means.numpy(),
                                   np.asarray(jm[cid].coefficient_means), atol=atol)
    np.testing.assert_allclose(tm.score(tb).numpy(), np.asarray(jm.score(jb)), atol=atol)


def test_config_round_trip_and_defaults():
    cfg = _config(tcfg, regularization_weight_grid={"per_userId": (0.5, 2.0)},
                  evaluators=("AUC", "LOGISTIC_LOSS"))
    doc = json.loads(json.dumps(cfg.to_dict()))
    assert tcfg.parse_config(doc) == cfg
    # the reference's document parses to the same configuration, and back
    jdoc = json.loads(json.dumps(_config(jcfg, regularization_weight_grid={"per_userId": (0.5, 2.0)},
                                         evaluators=("AUC", "LOGISTIC_LOSS")).to_dict()))
    assert jdoc == doc and tcfg.parse_config(jdoc) == cfg
    assert tcfg.parse_config({}).to_dict() == jcfg.parse_config({}).to_dict()
    re_default = tcfg.RandomEffectCoordinateConfig()
    assert (re_default.bucket_target_count, re_default.bucket_max_padded_ratio) == (4, 4.0)
    assert tcfg.RandomEffectCoordinateConfig().to_dict() == jcfg.RandomEffectCoordinateConfig().to_dict()
    grid = build_configuration_grid(cfg)
    jgrid = j_grid(_config(jcfg, regularization_weight_grid={"per_userId": (0.5, 2.0)}))
    assert [{c: o.to_dict() for c, o in e.items()} for e in grid] == [
        {c: o.to_dict() for c, o in e.items()} for e in jgrid
    ]
    with pytest.raises(ValueError, match="unknown coordinate"):
        build_configuration_grid(_config(tcfg, regularization_weight_grid={"nope": (1.0,)}))


def test_fixed_only_descent_equals_train_glm():
    """Config D's shape: one fixed coordinate, one outer iteration."""
    data, jb, tb = _data(seed=1, effects={"userId": (10, 2)})
    opt = tcfg.OptimizationConfig(
        optimizer=tcfg.OptimizerConfig(max_iterations=50, tolerance=1e-9),
        regularization=tcfg.RegularizationContext(ttypes.RegularizationType.L2),
        regularization_weight=1.0,
    )
    coord = FixedEffectCoordinate("fixed", tb, "global", opt, ttypes.TaskType.LOGISTIC_REGRESSION,
                                  intercept_index=data.intercept_index)
    res = CoordinateDescent({"fixed": coord}, tb, ttypes.TaskType.LOGISTIC_REGRESSION).run(["fixed"], 1)
    ref = train_glm(tb.batch_for("global"), ttypes.TaskType.LOGISTIC_REGRESSION,
                    optimizer_config=opt.optimizer, regularization_weights=[1.0],
                    intercept_index=data.intercept_index, device="cpu")
    w = res.model["fixed"].model.coefficients.means
    np.testing.assert_allclose(w.numpy(), ref.models[1.0].coefficients.means.numpy(), atol=1e-4)
    # and against the reference package's descent
    jcfg_d = _config(jcfg, effects={}, iterations=1, fixed_lambda=1.0)
    jres = JEstimator(jcfg_d, intercept_indices={"global": data.intercept_index}).fit(jb)[0]
    np.testing.assert_allclose(w.numpy(), np.asarray(jres.model["fixed"].coefficient_means), atol=1e-4)


@pytest.fixture(scope="module")
def reference_glmm():
    """The reference's fit of config E's shape without validation (shared
    by the GLMM and transformer tests: the reference compiles per fit)."""
    data, jb, tb = _data(seed=0)
    jres = JEstimator(_config(jcfg), intercept_indices={"global": data.intercept_index}).fit(jb)[0]
    return data, jb, tb, jres


@pytest.mark.parametrize("validate", [False, True], ids=["no_validation", "validation"])
def test_glmm_matches_reference(reference_glmm, validate):
    """Config E's shape: fixed, per-user and per-item effects, 2 outer
    iterations, with and without per-visit validation."""
    data, jb, tb, jres = reference_glmm
    intercepts = {"global": data.intercept_index}
    if validate:
        jres = JEstimator(_config(jcfg), intercept_indices=intercepts).fit(jb, validation_batch=jb)[0]
    tres = GameEstimator(_config(tcfg), intercept_indices=intercepts, device="cpu").fit(
        tb, validation_batch=tb if validate else None)[0]
    _assert_models_agree(jres.model, tres.model, jb, tb)
    if validate:
        assert abs(tres.evaluation.metrics["AUC"] - jres.evaluation.metrics["AUC"]) <= 1e-4
        for it in range(2):
            for cid in ("fixed", "per_userId", "per_itemId"):
                assert abs(tres.descent.validation_history[it][cid].primary
                           - jres.descent.validation_history[it][cid].primary) <= 1e-4
    else:
        assert tres.evaluation is None and tres.descent.validation_history == [{}, {}]
    # the last visit's per-entity diagnostics are readable; earlier ones released
    last = tres.descent.trackers["per_userId"]
    assert len(last) == 2 and not np.isnan(last[-1].loss_values[last[-1].iterations > 0]).any()
    with pytest.raises(RuntimeError, match="released"):
        last[0].loss_values
    for cid, s in tres.descent.training_scores.items():
        np.testing.assert_allclose(s.numpy(), tres.model[cid].score(tb).numpy(), atol=1e-5)


def test_grid_selects_the_same_entry():
    data, jb, tb = _data(seed=2, n=500)
    _, jvb, tvb = _data(seed=3, n=300)
    kw = dict(regularization_weight_grid={"per_userId": (0.1, 30.0)}, evaluators=("AUC",))
    intercepts = {"global": data.intercept_index}
    jest = JEstimator(_config(jcfg, iterations=1, buckets=ONE_BUCKET, **kw), intercept_indices=intercepts)
    test = GameEstimator(_config(tcfg, iterations=1, buckets=ONE_BUCKET, **kw),
                         intercept_indices=intercepts, device="cpu")
    jr, tr = jest.fit(jb, validation_batch=jvb), test.fit(tb, validation_batch=tvb)
    assert len(tr) == len(jr) == 2
    for a, b in zip(jr, tr):
        assert abs(a.evaluation.primary - b.evaluation.primary) <= 1e-4
        assert b.configuration["per_userId"].regularization_weight == \
            a.configuration["per_userId"].regularization_weight
    jbest, tbest = jest.select_best(jr), test.select_best(tr)
    assert tbest.configuration["per_userId"].regularization_weight == \
        jbest.configuration["per_userId"].regularization_weight
    assert test.select_best([r.__class__(r.model, None, r.configuration, r.descent) for r in tr]) \
        .configuration == tr[0].configuration


def test_normalization_down_sampling_and_incremental_prior():
    """STANDARDIZATION on every shard (degraded to scale-only on the
    intercept-free random-effect shard), a down-sampled fixed effect, and
    the generating model as warm start and Gaussian prior."""
    effects = {"userId": (12, 3)}
    data, jb, tb = _data(seed=4, n=500, effects=effects)
    intercepts = {"global": data.intercept_index, "shard_userId": None}

    def config(m, T):
        cfg = _config(m, effects=effects, iterations=1, fixed_lambda=1.0, buckets=ONE_BUCKET,
                      normalization=T.NormalizationType.STANDARDIZATION, incremental=True)
        fixed = cfg.fixed_effect_coordinates["fixed"]
        return cfg.replace(fixed_effect_coordinates={"fixed": fixed.replace(
            optimization=fixed.optimization.replace(down_sampling_rate=0.6))})

    var_fixed = np.full(data.w_fixed.shape, 0.5, np.float32)
    var_user = np.full(data.w_entity["userId"].shape, 2.0, np.float32)
    twarm = game_model_from_numpy({
        "fixed": dict(feature_shard_id="global", means=data.w_fixed, variances=var_fixed),
        "per_userId": dict(feature_shard_id="shard_userId", random_effect_type="userId",
                           coefficients=data.w_entity["userId"], variances=var_user),
    }, TASK, device="cpu")
    from photon_ml_tpu.game.models import FixedEffectModel as JFE
    from photon_ml_tpu.game.models import GameModel as JGame
    from photon_ml_tpu.game.models import RandomEffectModel as JRE
    from photon_ml_tpu.models.glm import Coefficients as JCoef
    from photon_ml_tpu.models.glm import GeneralizedLinearModel as JGLM

    task = jtypes.TaskType(TASK)
    jwarm = JGame(models={
        "fixed": JFE(JGLM(JCoef(jnp.asarray(data.w_fixed), jnp.asarray(var_fixed)), task), "global"),
        "per_userId": JRE(jnp.asarray(data.w_entity["userId"]), jnp.asarray(var_user), "userId",
                          "shard_userId", task),
    }, task_type=task)
    jres = JEstimator(config(jcfg, jtypes), intercept_indices=intercepts).fit(jb, initial_model=jwarm)[0]
    tres = GameEstimator(config(tcfg, ttypes), intercept_indices=intercepts, device="cpu").fit(
        tb, initial_model=twarm)[0]
    _assert_models_agree(jres.model, tres.model, jb, tb)


def test_locked_coordinate_keeps_scoring():
    """A coordinate in the initial model but not in the update sequence
    stays as it is and still enters every residual."""
    data, jb, tb = _data(seed=5, n=300, effects={"userId": (8, 2)}, task="LINEAR_REGRESSION")
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
    m1 = CoordinateDescent({"fixed": fixed}, tb, task).run(["fixed"], 1).model
    g = group_by_entity(data.entity_ids["userId"], num_entities=8)
    re = RandomEffectCoordinate("per_user", tb, "shard_userId", "userId", opt, g, bucket_entities(g),
                                task, 8)
    res = CoordinateDescent({"fixed": fixed, "per_user": re}, tb, task).run(["per_user"], 1,
                                                                          initial_model=m1)
    assert res.model["fixed"] is m1["fixed"]
    err = lambda m: float(torch.mean((m.score(tb) - tb.labels) ** 2))  # noqa: E731
    assert err(res.model) < err(m1)
    np.testing.assert_allclose(res.training_scores["fixed"].numpy(), m1["fixed"].score(tb).numpy())


def test_transformer_scores_a_carried_model(reference_glmm):
    data, jb, tb, jres = reference_glmm
    jm = jres.model
    models = {}
    for cid, sub in jm.models.items():
        if cid == "fixed":
            models[cid] = dict(feature_shard_id=sub.feature_shard_id,
                               means=np.asarray(sub.model.coefficients.means), variances=None)
        else:
            models[cid] = dict(feature_shard_id=sub.feature_shard_id,
                               random_effect_type=sub.random_effect_type,
                               coefficients=np.asarray(sub.coefficients),
                               variances=np.ones_like(np.asarray(sub.coefficients)))
    tm = game_model_from_numpy(models, jm.task_type, device="cpu")
    assert isinstance(tm, GameModel) and tm["per_userId"].variances is not None
    tr = GameTransformer(tm, device="cpu")
    np.testing.assert_allclose(tr.transform(tb).numpy(), np.asarray(jm.score(jb)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr.predict(tb).numpy(), np.asarray(jm.predict(jb)), rtol=1e-5, atol=1e-6)
    scores, ev = tr.transform_with_evaluation(tb, ["AUC", "LOGISTIC_LOSS"])
    assert abs(ev.metrics["AUC"] - float(auc_roc(scores, tb.labels))) == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GameTransformer(tm).transform(tb)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GameEstimator(_config(tcfg)).fit(tb)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            game_model_from_numpy(models, TASK)


def test_estimator_refuses_what_is_not_ported():
    """What was refused before now fits: the projector knobs (the
    reference's numFeaturesToSamplesRatioUpperBound and random projection,
    held to the reference in tests/test_torch_projector.py), a random
    effect left at the default optimizer (L-BFGS), and MULTI_AUC model
    selection, which selects as the reference does."""
    data, jb, tb = _data(seed=7, n=200, effects={"userId": (5, 2)})
    cfg = _config(tcfg, effects={"userId": (5, 2)})
    re = cfg.random_effect_coordinates["per_userId"]
    for field, value in (("random_projection_dim", 2), ("features_to_samples_ratio_upper_bound", 1.0)):
        projected = cfg.replace(random_effect_coordinates={"per_userId": re.replace(**{field: value})})
        fit = GameEstimator(projected, device="cpu").fit(tb)
        assert fit[0].model["per_userId"].coefficients.shape == (5, 2)
        assert torch.isfinite(fit[0].model["per_userId"].coefficients).all()
    lbfgs = re.replace(optimization=re.optimization.replace(optimizer=tcfg.OptimizerConfig()))
    fit = GameEstimator(cfg.replace(random_effect_coordinates={"per_userId": lbfgs}), device="cpu").fit(tb)
    assert torch.isfinite(fit[0].model["per_userId"].coefficients).all()
    assert fit[0].descent.trackers["per_userId"][-1].iterations.max() > 0
    jcfg_multi = _config(jcfg, effects={"userId": (5, 2)}, evaluators=("MULTI_AUC(userId)",))
    jres = JEstimator(jcfg_multi).fit(jb, validation_batch=jb)[0]
    tres = GameEstimator(cfg.replace(evaluators=("MULTI_AUC(userId)",)), device="cpu").fit(
        tb, validation_batch=tb)[0]
    assert tres.evaluation.primary_name == "MULTI_AUC(userId)"
    assert abs(tres.evaluation.primary - jres.evaluation.primary) <= 1e-4


@pytest.mark.parametrize("iterations", [1, 2])
def test_glmm_with_default_lane_solvers_matches_reference(iterations):
    """Config E's shape with both random effects left at the default
    optimizer (L-BFGS, tolerance 1e-3). One outer iteration: coefficients
    and scores within atol 1e-3 (they agree to float32 rounding) and the
    validation metrics within 1e-4. Two: coefficients within atol 1e-3;
    the warm-started fixed effect of the second iteration stops on the
    float32 floor (LINE_SEARCH_FAILED in both packages) after 1 iteration
    in one and 2 in the other, the random effects follow, and a score
    moves by up to 1.6e-3 (ROADMAP queue 3): scores within atol 2e-3 and
    the metrics within 1e-3."""
    data, jb, tb = _data(seed=1, n=500)
    kw = dict(buckets=ONE_BUCKET, re_solver="LBFGS", re_tolerance=1e-3, iterations=iterations,
              evaluators=("MULTI_AUC(userId)", "PRECISION_AT_K(3,itemId)", "AUC"))
    intercepts = {"global": data.intercept_index}
    jres = JEstimator(_config(jcfg, **kw), intercept_indices=intercepts).fit(jb, validation_batch=jb)[0]
    tres = GameEstimator(_config(tcfg, **kw), intercept_indices=intercepts, device="cpu").fit(
        tb, validation_batch=tb)[0]
    for cid, sub in tres.model.models.items():
        np.testing.assert_allclose(sub.coefficient_means.numpy(),
                                   np.asarray(jres.model[cid].coefficient_means), atol=1e-3)
    np.testing.assert_allclose(tres.model.score(tb).numpy(), np.asarray(jres.model.score(jb)),
                               atol=1e-3 if iterations == 1 else 2e-3)
    for name, value in jres.evaluation.metrics.items():
        assert abs(tres.evaluation.metrics[name] - value) <= (1e-4 if iterations == 1 else 1e-3), name


def test_high_dimensional_sparse_fixed_effect_takes_the_tiled_layout(monkeypatch):
    """A sparse fixed-effect shard wider than the dense budget allows runs
    on the sparse kernel's layout (its plain version on the CPU), built
    once and re-bound to each visit's offsets; it trains the same model as
    the densified shard and as the reference."""
    from photon_ml_tpu.game.data import SparseFeatures as JSparse
    from photon_ml_tpu_torch.game import coordinate as coord_mod
    from photon_ml_tpu_torch.ops.sparse_tiled import TiledSparseBatch

    rng = np.random.default_rng(8)
    n, d, k = 1100, 4096, 6
    idx = rng.integers(0, d, size=(n, k))
    val = rng.normal(size=(n, k)).astype(np.float32)
    ids = rng.integers(0, 10, size=n).astype(np.int32)
    Xu = rng.normal(size=(n, 2)).astype(np.float32)
    w_true = (0.5 * rng.normal(size=d)).astype(np.float32)
    m = np.sum(val * w_true[idx], axis=1) + Xu[:, 0] * (ids % 3 - 1)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    effects = {"userId": (10, 2)}
    tb = game_batch_from_numpy(y, {"global": {"indices": idx, "values": val, "num_features": d},
                                   "shard_userId": Xu}, id_tags={"userId": ids}, device="cpu")
    jb = j_make_game_batch(y, {"global": JSparse(jnp.asarray(idx), jnp.asarray(val), d),
                               "shard_userId": Xu}, id_tags={"userId": ids})
    kw = dict(effects=effects, iterations=2, fixed_lambda=1.0, buckets=ONE_BUCKET)
    dense = GameEstimator(_config(tcfg, **kw), device="cpu").fit(tb)[0]
    layouts = []
    orig = coord_mod.optimize_batch_layout

    def spy(batch, **kwargs):
        out = orig(batch, **kwargs)
        layouts.append(out)
        return out

    monkeypatch.setattr(coord_mod, "hbm_budget_bytes", lambda dev: 1.0)
    monkeypatch.setattr(coord_mod, "optimize_batch_layout", spy)
    tiled = GameEstimator(_config(tcfg, **kw), device="cpu").fit(tb)[0]
    assert len(layouts) == 1 and isinstance(layouts[0], TiledSparseBatch)
    jres = JEstimator(_config(jcfg, **kw)).fit(jb)[0]
    np.testing.assert_allclose(tiled.model["fixed"].coefficient_means.numpy(),
                               dense.model["fixed"].coefficient_means.numpy(), atol=1e-4)
    np.testing.assert_allclose(tiled.model["per_userId"].coefficient_means.numpy(),
                               dense.model["per_userId"].coefficient_means.numpy(), atol=1e-3)
    _assert_models_agree(jres.model, tiled.model, jb, tb)
