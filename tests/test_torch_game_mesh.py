"""GAME over a data mesh in one process: the port on 4 row / lane shards of
the CPU (``data_mesh(4, ["cpu"] * 4)``) against the JAX package on its
8-device virtual CPU mesh (conftest) and against the port without a mesh,
on the same numpy fixtures.

Held to:
- ``train_random_effects(mesh=)`` against the reference's
  ``train_random_effects(mesh=data_mesh(8))`` on the fixture of
  ``tests/test_game.py``'s entity-sharding test: atol 3e-4 (the reference's
  own tolerance there) on every lane that stops at the same iteration in
  both packages, the lane tolerance on all (two lanes stop one float32
  stopping test apart, without a mesh too); against the port without a
  mesh at 3e-4; a repeat bitwise equal;
- ``GameEstimator(mesh=)`` against the JAX ``GameEstimator(mesh=data_mesh(8))``
  on config E's shape: |dAUC| <= 0.005, fixed effect rtol 1e-3 (atol
  1e-4 on coefficients near 0), random effects within the lane tolerance
  (atol 2e-3 / rtol 1e-2); a repeat bitwise equal; against the port
  without a mesh (also with normalization, down-sampling, subspace
  projection and a sparse shard) the fixed effect within rtol 1e-2 / atol
  1e-3 (another summation order moves L-BFGS's float32 stop) and the
  random effects within the lane tolerance;
- the sharded BUCKETED_AUC equal to the unsharded one bit for bit;
- ``grouped_auc_parts`` / ``grouped_precision_at_k_parts`` equal to the
  reference's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import photon_ml_tpu.config as jcfg
import photon_ml_tpu.types as jtypes
from photon_ml_tpu.data.synthetic import synthetic_game_data as jax_game_data
from photon_ml_tpu.estimators import GameEstimator as JEstimator
from photon_ml_tpu.evaluation import evaluators as j_evaluators
from photon_ml_tpu.game import data as jdata
from photon_ml_tpu.game.data import make_game_batch as j_make_game_batch
from photon_ml_tpu.game.random_effect import train_random_effects as j_train
from photon_ml_tpu.ops.losses import logistic_loss as j_logistic
from photon_ml_tpu.parallel import data_mesh as j_data_mesh
import photon_ml_tpu_torch.config as tcfg
import photon_ml_tpu_torch.types as ttypes
from photon_ml_tpu_torch.convert import game_batch_from_numpy
from photon_ml_tpu_torch.estimators import GameEstimator
from photon_ml_tpu_torch.evaluation import (
    bucketed_auc,
    bucketed_auc_sharded,
    bucketed_auc_sharded_padded,
    evaluate_all,
    grouped_auc,
    grouped_auc_parts,
    grouped_precision_at_k,
    grouped_precision_at_k_parts,
)
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.game.data import SparseFeatures
from photon_ml_tpu_torch.game.random_effect import train_random_effects
from photon_ml_tpu_torch.ops.losses import logistic_loss
from photon_ml_tpu_torch.parallel import data_mesh
from photon_ml_tpu_torch.parallel.mesh import ProcessMesh, as_process_mesh, shard_extent

CPU4 = data_mesh(4, devices=["cpu"] * 4)
EFFECTS = {"userId": (20, 3), "itemId": (10, 3)}
LANE_TOL = dict(atol=2e-3, rtol=1e-2)
# the sharded fixed effect against the unsharded one: another summation
# order moves L-BFGS's float32 stop (PERF.md's multi-process tolerance)
SUM_ORDER_TOL = dict(rtol=1e-2, atol=1e-3)


# ---------------------------------------------------------------------------
# random effects
# ---------------------------------------------------------------------------
def _re_fixture(n=200, d=3, E=10):
    """tests/test_game.py's entity-sharding fixture (the rng fixture's seed)."""
    rng = np.random.default_rng(42)
    ids = rng.integers(0, E, size=n).astype(np.int32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return ids, X, y, E


def test_train_random_effects_over_a_mesh_matches_the_reference_and_no_mesh():
    ids, X, y, E = _re_fixture()
    n, zeros, ones = len(y), np.zeros(len(y), np.float32), np.ones(len(y), np.float32)
    jb = jdata.bucket_entities(jdata.group_by_entity(ids, num_entities=E))
    ref = j_train(jdata.DenseFeatures(X=jnp.asarray(X)), y, zeros, ones, jb, E, j_logistic,
                  jcfg.OptimizerConfig(max_iterations=50, tolerance=1e-9), l2_weight=0.5,
                  mesh=j_data_mesh(8))
    tb = tdata.bucket_entities(tdata.group_by_entity(ids.astype(np.int64), num_entities=E))
    args = (tdata.DenseFeatures(X=torch.from_numpy(X)), y, zeros, ones, tb, E, logistic_loss,
            tcfg.OptimizerConfig(max_iterations=50, tolerance=1e-9))
    sharded = train_random_effects(*args, l2_weight=0.5, device="cpu", mesh=CPU4)
    again = train_random_effects(*args, l2_weight=0.5, device="cpu", mesh=CPU4)
    plain = train_random_effects(*args, l2_weight=0.5, device="cpu")
    # lanes that stop at the same iteration in both packages agree at the
    # reference's 3e-4; on this fixture two lanes stop one float32 stopping
    # test apart (8 against 7 and 5 against 6 iterations, unsharded too:
    # the float32 floor of ROADMAP queue 3), and every lane is within the
    # lane tolerance
    same = sharded.iterations == np.asarray(ref.iterations)
    assert same.sum() >= E - 2
    np.testing.assert_allclose(sharded.coefficients.numpy()[same], np.asarray(ref.coefficients)[same], atol=3e-4)
    np.testing.assert_allclose(sharded.coefficients.numpy(), np.asarray(ref.coefficients), **LANE_TOL)
    np.testing.assert_allclose(sharded.coefficients.numpy(), plain.coefficients.numpy(), atol=3e-4)
    assert torch.equal(sharded.coefficients, again.coefficients)
    # every entity's diagnostics come back from its shard
    assert n and np.all(sharded.iterations[np.bincount(ids, minlength=E) > 0] > 0)
    np.testing.assert_allclose(sharded.loss_values, plain.loss_values, rtol=1e-4)


def test_mesh_lane_split_depends_on_the_lane_and_shard_counts_only():
    """P processes × L shards hold the global shards of one process × P·L:
    global shard s = rank × L + i on the i-th local device."""
    one = as_process_mesh(CPU4)
    two = [ProcessMesh(local=data_mesh(2, devices=["cpu"]), process_index=r, process_count=2) for r in range(2)]
    assert list(one.global_shards()) == [s for m in two for s in m.global_shards()] == [0, 1, 2, 3]
    assert one.num_shards == two[0].num_shards == 4 and not one.spans_processes and two[1].spans_processes
    assert [shard_extent(k, 4) for k in (1, 4, 5, 9)] == [1, 1, 2, 3]


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------
def _data(seed=0, n=600, d_fixed=5, effects=EFFECTS):
    data = jax_game_data(np.random.default_rng(seed), n, d_fixed, effects,
                         task=jtypes.TaskType.LOGISTIC_REGRESSION)
    feats = {"global": data.X, **{f"shard_{k}": data.entity_X[k] for k in effects}}
    tags = {k: data.entity_ids[k] for k in effects}
    return data, j_make_game_batch(data.y, feats, id_tags=tags), game_batch_from_numpy(
        data.y, feats, id_tags=tags, device="cpu")


# The solver tolerances in the comparison with the reference's mesh fit:
# at 1e-7 the random effects' Newton lanes stop on the float32 floor, and
# at 1e-7 (or 1e-3) the fixed effect's warm-started second visit does,
# on torch's AVX-512 kernels (this is the GLMM fixture: ROADMAP queue 3,
# test_torch_game.py::test_newton_lane_floor_is_float32_rounding and
# ::test_glmm_warm_started_fixed_effect_floor_is_float32_rounding).
ABOVE_FLOOR = 1e-3
ABOVE_FLOOR_FIXED = 1e-2


def _config(m, effects=EFFECTS, re_solver="NEWTON_CHOLESKY", iterations=2, re_tolerance=1e-7,
            fixed_tolerance=1e-7, **kw):
    T = jtypes if m is jcfg else ttypes

    def opt(solver, lam, tolerance=1e-7):
        return m.OptimizationConfig(
            optimizer=m.OptimizerConfig(optimizer_type=T.OptimizerType(solver), max_iterations=30,
                                        tolerance=tolerance),
            regularization=m.RegularizationContext(T.RegularizationType.L2), regularization_weight=lam)

    re_kw = kw.pop("re_kw", {})
    return m.GameTrainingConfig(
        task_type=T.TaskType.LOGISTIC_REGRESSION,
        coordinate_update_sequence=("fixed", *(f"per_{k}" for k in effects)),
        coordinate_descent_iterations=iterations,
        fixed_effect_coordinates={"fixed": m.FixedEffectCoordinateConfig(
            "global", kw.pop("fixed_opt", opt("LBFGS", 0.0, fixed_tolerance)))},
        random_effect_coordinates={
            f"per_{k}": m.RandomEffectCoordinateConfig(k, f"shard_{k}", opt(re_solver, 1.0, re_tolerance),
                                                       bucket_target_count=8, bucket_max_padded_ratio=0.5,
                                                       **re_kw)
            for k in effects
        },
        evaluators=("AUC", "BUCKETED_AUC", "MULTI_AUC(userId)"),
        **kw,
    )


def _assert_fits_agree(a, b, fixed_tol=dict(rtol=1e-3, atol=1e-4)):
    for cid, sub in a.models.items():
        tol = fixed_tol if cid == "fixed" else LANE_TOL
        np.testing.assert_allclose(np.asarray(sub.coefficient_means), np.asarray(b[cid].coefficient_means),
                                   err_msg=cid, **tol)


@pytest.fixture(scope="module")
def reference_mesh_fit():
    data, jb, tb = _data()
    intercepts = {"global": data.intercept_index}
    jres = JEstimator(_config(jcfg, re_tolerance=ABOVE_FLOOR, fixed_tolerance=ABOVE_FLOOR_FIXED),
                      mesh=j_data_mesh(8), intercept_indices=intercepts).fit(
        jb, validation_batch=jb)[0]
    return data, tb, jres


def test_estimator_over_a_mesh_matches_the_reference_mesh_fit(reference_mesh_fit):
    data, tb, jres = reference_mesh_fit
    tres = GameEstimator(_config(tcfg, re_tolerance=ABOVE_FLOOR, fixed_tolerance=ABOVE_FLOOR_FIXED),
                         intercept_indices={"global": data.intercept_index},
                         device="cpu",
                         mesh=CPU4).fit(tb, validation_batch=tb)[0]
    _assert_fits_agree(tres.model, jres.model)
    for name in ("AUC", "BUCKETED_AUC", "MULTI_AUC(userId)"):
        assert abs(tres.evaluation.metrics[name] - jres.evaluation.metrics[name]) <= 0.005, name
    # validation ran after every visit, over the mesh
    assert [sorted(h) for h in tres.descent.validation_history] == [["fixed", "per_itemId", "per_userId"]] * 2


def test_estimator_over_a_mesh_repeats_bitwise_and_matches_no_mesh(reference_mesh_fit):
    data, tb, _ = reference_mesh_fit
    intercepts = {"global": data.intercept_index}
    fits = [GameEstimator(_config(tcfg), intercept_indices=intercepts, device="cpu", mesh=mesh).fit(tb)[0]
            for mesh in (CPU4, CPU4, None)]
    for cid, sub in fits[0].model.models.items():
        assert torch.equal(sub.coefficient_means, fits[1].model[cid].coefficient_means), cid
    _assert_fits_agree(fits[0].model, fits[2].model, fixed_tol=SUM_ORDER_TOL)
    for cid, s in fits[0].descent.training_scores.items():
        np.testing.assert_allclose(s.numpy(), fits[0].model[cid].score(tb).numpy(), atol=1e-5)


@pytest.mark.parametrize("case", ["normalization_down_sampling", "subspace_projection", "sparse_shard_lbfgs"])
def test_estimator_options_over_a_mesh_match_no_mesh(case):
    """The options a coordinate carries under a mesh: normalization and
    down-sampling of the fixed effect (its training rows are a subset, its
    scores every row), per-entity subspaces, and a sparse random-effect
    shard on L-BFGS lanes."""
    data, _, tb = _data(seed=3, n=500)
    intercepts = {"global": data.intercept_index}
    kw: dict = {}
    if case == "normalization_down_sampling":
        kw = dict(normalization=ttypes.NormalizationType.STANDARDIZATION, fixed_opt=tcfg.OptimizationConfig(
            optimizer=tcfg.OptimizerConfig(max_iterations=30, tolerance=1e-7), down_sampling_rate=0.6))
    elif case == "subspace_projection":
        kw = dict(re_kw=dict(features_to_samples_ratio_upper_bound=0.5))
    else:
        X = tb.features["shard_userId"].X
        tb = tdata.GameBatch(labels=tb.labels, offsets=tb.offsets, weights=tb.weights, id_tags=tb.id_tags,
                             features={**tb.features, "shard_userId": SparseFeatures(
                                 torch.arange(3).repeat(tb.num_rows, 1), X.clone(), 3)})
        kw = dict(re_solver="LBFGS")
    fits = [GameEstimator(_config(tcfg, **kw), intercept_indices=intercepts, device="cpu", mesh=mesh).fit(tb)[0]
            for mesh in (CPU4, None)]
    _assert_fits_agree(fits[0].model, fits[1].model, fixed_tol=SUM_ORDER_TOL)


def test_estimator_over_a_mesh_takes_a_host_batch_and_refuses_newton_fixed():
    data, _, tb = _data(seed=4, n=300, effects={"userId": (10, 2)})
    intercepts = {"global": data.intercept_index}
    cfg = _config(tcfg, effects={"userId": (10, 2)}, iterations=1)
    res = GameEstimator(cfg, intercept_indices=intercepts, device="cpu", mesh=CPU4).fit(tb)[0]
    assert res.model["fixed"].coefficient_means.device == torch.device("cpu")
    newton = tcfg.OptimizationConfig(optimizer=tcfg.OptimizerConfig(
        optimizer_type=ttypes.OptimizerType.NEWTON_CHOLESKY, max_iterations=5))
    with pytest.raises(NotImplementedError, match="NEWTON_CHOLESKY"):
        GameEstimator(_config(tcfg, effects={"userId": (10, 2)}, iterations=1, fixed_opt=newton),
                      intercept_indices=intercepts, device="cpu", mesh=CPU4).fit(tb)


# ---------------------------------------------------------------------------
# evaluators
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [4000, 4001])
def test_sharded_bucketed_auc_equals_the_unsharded_one(n):
    rng = np.random.default_rng(n)
    s = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    y = torch.from_numpy((rng.uniform(size=n) < 0.3).astype(np.float32))
    w = torch.from_numpy(np.where(rng.uniform(size=n) < 0.1, 0.0, 1.0).astype(np.float32))
    for weights in (None, w):
        want = bucketed_auc(s, y, weights, num_buckets=256)
        got = bucketed_auc_sharded_padded(s, y, weights, 256, mesh=CPU4)
        assert float(got) == float(want)
    if n % 4 == 0:
        assert float(bucketed_auc_sharded(s, y, w, 256, mesh=CPU4)) == float(bucketed_auc(s, y, w, 256))
    else:
        with pytest.raises(ValueError, match="do not divide"):
            bucketed_auc_sharded(s, y, w, 256, mesh=CPU4)
    metrics = evaluate_all(["BUCKETED_AUC(256)", "AUC"], s, y, w, mesh=CPU4).metrics
    assert metrics["BUCKETED_AUC(256)"] == float(bucketed_auc(s, y, w, 256))


def _grouped_fixture(seed=7, n=900, groups=40):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=n).astype(np.float32)
    scores[::7] = scores[1::7][: len(scores[::7])]  # ties
    labels = (rng.uniform(size=n) < 0.4).astype(np.float32)
    gids = rng.integers(0, groups, size=n).astype(np.int64)
    return scores, labels, gids


@pytest.mark.parametrize("metric", ["auc", "precision_at_3"])
def test_grouped_parts_equal_the_reference(metric):
    scores, labels, gids = _grouped_fixture()
    if metric == "auc":
        got, want = grouped_auc_parts(scores, labels, gids), j_evaluators.grouped_auc_parts(scores, labels, gids)
        whole = grouped_auc(scores, labels, gids)
    else:
        got = grouped_precision_at_k_parts(scores, labels, gids, 3)
        want = j_evaluators.grouped_precision_at_k_parts(scores, labels, gids, 3)
        whole = grouped_precision_at_k(scores, labels, gids, 3)
    assert got == want and isinstance(got[1], int)
    # parts of disjoint complete groups add up to the whole
    owner = gids % 3
    parts = [grouped_auc_parts(scores[owner == o], labels[owner == o], gids[owner == o]) if metric == "auc"
             else grouped_precision_at_k_parts(scores[owner == o], labels[owner == o], gids[owner == o], 3)
             for o in range(3)]
    total = np.sum(np.asarray(parts, np.float64), axis=0)
    np.testing.assert_allclose(total[0] / total[1], whole, rtol=1e-12)
    empty = np.zeros(0, np.float32)
    assert grouped_auc_parts(empty, empty, np.zeros(0, np.int64)) == (0.0, 0)
    assert grouped_precision_at_k_parts(empty, empty, np.zeros(0, np.int64), 3) == (0.0, 0)
