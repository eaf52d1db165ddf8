"""The port's random-effect projectors (``game/projector.py``) against the JAX
package's: the per-entity subspace columns (``entity_top_columns``,
``subspace_columns``) and the random projection matrix equal the
reference's bit for bit on the same numpy input; the prepared buckets' column
maps equal the reference's ``prepare_buckets``; a GAME fit with a per-entity
subspace or a random projection matches the reference's estimator (L-BFGS
lanes at atol 2e-3 / rtol 1e-2, Newton at tolerance 1e-3 within 1e-4); the
original-space model scores as (XP)·w_p within rtol 1e-5; and a projected
solve of entities that use few columns scores as the full-width solve."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.config as jcfg
import photon_ml_tpu.types as jtypes
from photon_ml_tpu.data.synthetic import synthetic_game_data as jax_game_data
from photon_ml_tpu.estimators import GameEstimator as JEstimator
from photon_ml_tpu.game import data as jdata
from photon_ml_tpu.game.data import make_game_batch as j_make_game_batch
from photon_ml_tpu.game.projector import RandomProjector as JProjector
from photon_ml_tpu.game.projector import entity_top_columns as j_top
from photon_ml_tpu.game.projector import subspace_columns as j_subspace
from photon_ml_tpu.game.random_effect import prepare_buckets as j_prepare
import photon_ml_tpu_torch.config as tcfg
import photon_ml_tpu_torch.types as ttypes
from photon_ml_tpu_torch.convert import game_batch_from_numpy
from photon_ml_tpu_torch.estimators import GameEstimator
from photon_ml_tpu_torch.game import data as tdata
from photon_ml_tpu_torch.game.coordinate import RandomEffectCoordinate
from photon_ml_tpu_torch.game.data import DenseFeatures
from photon_ml_tpu_torch.game.projector import RandomProjector, entity_top_columns, subspace_columns
from photon_ml_tpu_torch.game.random_effect import prepare_buckets, train_prepared, train_random_effects
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.types import TaskType

# random-effect solver → (its tolerance, the coefficients' tolerance against the reference)
SOLVERS = {
    "LBFGS": (1e-7, dict(atol=2e-3, rtol=1e-2)),
    "NEWTON_CHOLESKY": (1e-3, dict(atol=1e-4, rtol=0.0)),
}


def _bucket_features(seed: int, k=6, C=9, d=11, density=0.35):
    """(k, C, d) bucket features with zeroed padded slots and many ties in
    the per-column counts; the last column (an intercept) never set."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(k, C, d)).astype(np.float32) * (rng.uniform(size=(k, C, d)) < density)
    X[:, C - 2:, :] = 0.0
    X[..., -1] = 0.0
    return X


@pytest.mark.parametrize("p", [1, 3, 7, 11])
@pytest.mark.parametrize("always", [None, 10])
def test_entity_top_columns_match_the_reference(p, always):
    X = _bucket_features(p)
    got = entity_top_columns(torch.from_numpy(X), p, always_include=always)
    want = j_top(X, p, always_include=always)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ratio", [0.1, 0.4, 0.75, 1.0, 2.0])
@pytest.mark.parametrize("intercept", [None, 10])
def test_subspace_columns_match_the_reference(ratio, intercept):
    X = _bucket_features(4)
    got = subspace_columns(torch.from_numpy(X), ratio, intercept)
    want = j_subspace(X, ratio, intercept)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got.numpy(), want)
        if intercept is not None:
            assert (got[:, -1] == intercept).all()
    if ratio < 1.0:
        with pytest.raises(ValueError, match="intercept at the last column"):
            subspace_columns(torch.from_numpy(X), ratio, 3)


@pytest.mark.parametrize("d,p,seed", [(20, 6, 1), (8, 4, 0), (65, 4, 7)])
def test_random_projector_matrix_is_the_references(d, p, seed):
    got = RandomProjector.build(d, p, seed=seed, device="cpu")
    want = JProjector.build(d, p, seed=seed)
    assert got.projected_dim == p and got.matrix.dtype == torch.float32
    np.testing.assert_array_equal(got.matrix.numpy(), np.asarray(want.matrix))


def test_projection_is_score_exact():
    """(XP)·w_p equals X·(P w_p) within rtol 1e-5."""
    rng = np.random.default_rng(3)
    proj = RandomProjector.build(20, 6, seed=1, device="cpu")
    X = torch.from_numpy(rng.normal(size=(15, 20)).astype(np.float32))
    w_p = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32))
    s1 = proj.project_features(X) @ w_p.T
    s2 = X @ proj.coefficients_to_original(w_p).T
    torch.testing.assert_close(s1, s2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ratio", [0.3, 1.0])
@pytest.mark.parametrize("intercept", [False, True])
def test_prepared_column_maps_match_the_reference(ratio, intercept):
    """Each bucket's column map and gathered (k, C, p) features equal the
    reference's ``prepare_buckets``; a sparse shard ignores the ratio."""
    rng = np.random.default_rng(11)
    n, d = 300, 9
    p_ent = 1.0 / np.arange(1, 25) ** 1.3
    ids = rng.choice(24, size=n, p=p_ent / p_ent.sum()).astype(np.int32)
    X = (rng.normal(size=(n, d)) * (rng.uniform(size=(n, d)) < 0.4)).astype(np.float32)
    icept = None
    if intercept:
        X[:, -1] = 1.0
        icept = d - 1
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    jb = jdata.bucket_entities(jdata.group_by_entity(ids), target_buckets=4, max_padded_ratio=0.5)
    tb = tdata.bucket_entities(tdata.group_by_entity(ids), target_buckets=4, max_padded_ratio=0.5)
    want = j_prepare(jdata.DenseFeatures(X=jnp.asarray(X)), y, w, jb, features_to_samples_ratio=ratio,
                     intercept_index=icept)
    got = prepare_buckets(DenseFeatures(X=torch.from_numpy(X)), torch.from_numpy(y), torch.from_numpy(w), tb,
                          features_to_samples_ratio=ratio, intercept_index=icept)
    assert len(got) == len(want) > 1
    projected = 0
    for g, r in zip(got, want):
        assert (g.columns is None) == (r.columns is None)
        if r.columns is not None:
            projected += 1
            np.testing.assert_array_equal(g.columns.numpy(), np.asarray(r.columns))
        np.testing.assert_array_equal(g.static.X.numpy(), np.asarray(r.static.X))
    assert projected > 0 if ratio < 1.0 else True
    sparse = tdata.SparseFeatures(
        indices=torch.arange(d).repeat(n, 1), values=torch.from_numpy(X), num_features=d)
    assert all(pb.columns is None for pb in prepare_buckets(
        sparse, torch.from_numpy(y), torch.from_numpy(w), tb, features_to_samples_ratio=ratio))


def _estimator_fixture():
    """The reference's test_estimator_with_projection_and_random_projection
    fixture: 500 rows, 4 global features and an intercept, 12 users with 6
    features each."""
    data = jax_game_data(np.random.default_rng(42), 500, d_fixed=4, effects={"userId": (12, 6)})
    feats = {"global": data.X, "per_user": data.entity_X["userId"]}
    tags = {"userId": data.entity_ids["userId"]}
    return (j_make_game_batch(data.y, feats, id_tags=tags),
            game_batch_from_numpy(data.y, feats, id_tags=tags, device="cpu"))


def _config(m, solver: str, projection: dict):
    T = jtypes if m is jcfg else ttypes
    fixed = m.OptimizationConfig(optimizer=m.OptimizerConfig(max_iterations=60, tolerance=1e-7))
    per_user = m.OptimizationConfig(
        optimizer=m.OptimizerConfig(optimizer_type=T.OptimizerType(solver), max_iterations=60,
                                    tolerance=SOLVERS[solver][0]),
        regularization=m.RegularizationContext(T.RegularizationType.L2), regularization_weight=1.0)
    return m.GameTrainingConfig(
        task_type=T.TaskType.LOGISTIC_REGRESSION,
        coordinate_update_sequence=("fixed", "per_user"),
        coordinate_descent_iterations=2,
        fixed_effect_coordinates={"fixed": m.FixedEffectCoordinateConfig("global", fixed)},
        random_effect_coordinates={"per_user": m.RandomEffectCoordinateConfig(
            random_effect_type="userId", feature_shard_id="per_user", optimization=per_user,
            bucket_target_count=2, bucket_max_padded_ratio=1.0, **projection)},
        evaluators=("AUC",),
    )


@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("projection", [
    {"features_to_samples_ratio_upper_bound": 0.4},
    {"random_projection_dim": 4},
], ids=["subspace", "random"])
def test_game_fit_with_projectors_matches_the_reference(solver, projection):
    jb, tb = _estimator_fixture()
    intercepts = {"global": 4}
    jres = JEstimator(_config(jcfg, solver, projection), intercept_indices=intercepts).fit(jb, jb)[0]
    tres = GameEstimator(_config(tcfg, solver, projection), intercept_indices=intercepts,
                         device="cpu").fit(tb, validation_batch=tb)[0]
    W = tres.model["per_user"].coefficients
    assert W.shape == (12, 6)
    assert tres.model["per_user"].variances is None
    for cid in ("fixed", "per_user"):
        np.testing.assert_allclose(tres.model[cid].coefficient_means.numpy(),
                                   np.asarray(jres.model[cid].coefficient_means), **SOLVERS[solver][1])
    assert abs(tres.evaluation.primary - jres.evaluation.primary) <= 1e-3
    assert tres.evaluation.primary > 0.6


def test_random_projection_scores_are_the_projected_solves():
    """The stored original-space model scores each row as (XP)·w_p within
    rtol 1e-5, where w_p is the lane solution in the projected space."""
    _, tb = _estimator_fixture()
    cfg = _config(tcfg, "LBFGS", {"random_projection_dim": 4})
    est = GameEstimator(cfg, intercept_indices={"global": 4}, device="cpu")
    seen = {}
    train = train_prepared

    def recorded(*args, **kwargs):
        out = train(*args, **kwargs)
        seen["w_p"] = out.coefficients
        return out

    import photon_ml_tpu_torch.game.coordinate as coordinate

    coordinate.train_prepared = recorded
    try:
        res = est.fit(tb)[0]
    finally:
        coordinate.train_prepared = train
    P = RandomProjector.build(6, 4, seed=0, device="cpu").matrix
    X = tb.features["per_user"].X
    ids = tb.id_tags["userId"]
    projected = torch.einsum("np,np->n", X @ P, seen["w_p"][ids])
    torch.testing.assert_close(res.model["per_user"].score(tb), projected, rtol=1e-5, atol=1e-6)


def test_projectors_refuse_normalization():
    _, tb = _estimator_fixture()
    base = dict(coordinate_id="per_user", batch=tb, feature_shard_id="per_user", random_effect_type="userId",
                config=tcfg.OptimizationConfig(), grouping=None, buckets=None,
                task_type=TaskType.LOGISTIC_REGRESSION, num_entities=12,
                normalization=NormalizationContext(factors=torch.ones(6), shifts=torch.zeros(6)))
    with pytest.raises(NotImplementedError, match="random projection"):
        RandomEffectCoordinate(projector=RandomProjector.build(6, 4, device="cpu"), **base)
    with pytest.raises(NotImplementedError, match="subspace projection"):
        RandomEffectCoordinate(features_to_samples_ratio=0.5, **base)


def test_projected_solution_matches_full_width():
    """The reference's test_projected_solution_matches_full_width: each
    entity's rows use 3 of 12 columns, so its top 4 columns hold all of its
    signal and the projected solve scores as the full one (at the
    reference's ratio 0.5 no bucket of this fixture is narrowed, so the
    ratio here keeps 4 columns)."""
    rng = np.random.default_rng(42)
    n, E, d = 400, 5, 12
    ids = rng.integers(0, E, size=n).astype(np.int32)
    entity_cols = [rng.choice(d, size=3, replace=False) for _ in range(E)]
    X = np.zeros((n, d), np.float32)
    W_true = np.zeros((E, d), np.float32)
    for e in range(E):
        W_true[e, entity_cols[e]] = rng.normal(size=3)
    for i in range(n):
        X[i, entity_cols[ids[i]]] = rng.normal(size=3)
    y = (np.sum(W_true[ids] * X, axis=1) + rng.normal(scale=0.05, size=n)).astype(np.float32)
    grouping = tdata.group_by_entity(ids)
    buckets = tdata.bucket_entities(grouping)
    loss = loss_for_task(TaskType.LINEAR_REGRESSION)
    opt = tcfg.OptimizerConfig(max_iterations=60, tolerance=1e-9)
    feats = DenseFeatures(X=torch.from_numpy(X))
    zeros, ones = torch.zeros(n), torch.ones(n)
    full = train_random_effects(feats, y, zeros, ones, buckets, grouping.num_entities, loss, opt,
                                l2_weight=0.1, device="cpu")
    # a ratio that keeps 4 of the 12 columns for the largest bucket
    ratio = 4.0 / max(rows.shape[1] for rows in buckets.row_indices)
    prepared = prepare_buckets(feats, torch.from_numpy(y), ones, buckets, features_to_samples_ratio=ratio)
    assert all(pb.columns is not None and 3 <= pb.columns.shape[1] < d for pb in prepared)
    proj = train_prepared(prepared, zeros, d, grouping.num_entities, loss, opt, l2_weight=0.1)
    scores_full = (full.coefficients[torch.from_numpy(ids).long()] * feats.X).sum(1)
    scores_proj = (proj.coefficients[torch.from_numpy(ids).long()] * feats.X).sum(1)
    torch.testing.assert_close(scores_proj, scores_full, rtol=1e-3, atol=1e-3)
    outside = torch.ones(E, d, dtype=torch.bool)
    for pb in prepared:
        outside[pb.ids[:, None], pb.columns] = False
    assert (proj.coefficients[outside] == 0).all()
