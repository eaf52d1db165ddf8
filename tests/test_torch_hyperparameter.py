"""The port's hyperparameter tuning (``photon_ml_tpu_torch/hyperparameter``)
against the JAX package's: each numpy/scipy module gives the reference's
numbers bit for bit on identical observations (kernels, GP posterior,
expected improvement, Sobol points, slice samples, the Gaussian-process and
random searches' suggestion sequences); ``tune_game_hyperparameters`` on a
small GLMM (Newton random effects at tolerance 1e-3) suggests the same λs
and each refit's primary metric agrees within 1e-4."""

from __future__ import annotations

import numpy as np
import pytest

import photon_ml_tpu.config as jcfg
import photon_ml_tpu.hyperparameter as jh
import photon_ml_tpu.types as jtypes
from photon_ml_tpu.data.synthetic import synthetic_game_data as jax_game_data
from photon_ml_tpu.estimators import GameEstimator as JEstimator
from photon_ml_tpu.game.data import make_game_batch as j_make_game_batch
from photon_ml_tpu.hyperparameter.tuning import gp_tune_weights as j_gp_tune
from photon_ml_tpu.hyperparameter.tuning import tune_game_hyperparameters as j_tune
import photon_ml_tpu_torch.config as tcfg
import photon_ml_tpu_torch.hyperparameter as th
import photon_ml_tpu_torch.types as ttypes
from photon_ml_tpu_torch.convert import game_batch_from_numpy
from photon_ml_tpu_torch.estimators import GameEstimator
from photon_ml_tpu_torch.hyperparameter.tuning import gp_tune_weights, tune_game_hyperparameters


def _observations(seed: int, n: int = 7, d: int = 2):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    y = np.sin(3 * X[:, 0]) + X[:, -1] ** 2 + 0.01 * rng.normal(size=n)
    return X, y


@pytest.mark.parametrize("kernel", ["Matern52", "RBF"])
def test_kernels_match(kernel):
    X, _ = _observations(0)
    Z = np.random.default_rng(1).uniform(size=(4, 2))
    got = getattr(th, kernel)(amplitude=1.3, lengthscales=np.array([0.4, 2.0]), noise=0.1)
    want = getattr(jh, kernel)(amplitude=1.3, lengthscales=np.array([0.4, 2.0]), noise=0.1)
    np.testing.assert_array_equal(got(X), want(X))
    np.testing.assert_array_equal(got(X, Z), want(X, Z))
    params = np.log([0.5, 0.01, 0.3, 0.7])
    np.testing.assert_array_equal(got.with_params(params)(X), want.with_params(params)(X))
    np.testing.assert_array_equal(got.log_params(2), want.log_params(2))


def test_gp_posterior_matches():
    X, y = _observations(2)
    Z = np.random.default_rng(3).uniform(size=(16, 2))
    got = th.GaussianProcessEstimator(num_kernel_samples=4, burn_in=4, seed=5).fit(X, y).predict(Z)
    want = jh.GaussianProcessEstimator(num_kernel_samples=4, burn_in=4, seed=5).fit(X, y).predict(Z)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_expected_improvement_matches():
    rng = np.random.default_rng(4)
    mean, std = rng.normal(size=32), rng.uniform(0.0, 2.0, size=32)
    std[:3] = 0.0
    for xi in (0.0, 0.05):
        np.testing.assert_array_equal(th.expected_improvement(mean, std, 0.1, xi),
                                      jh.expected_improvement(mean, std, 0.1, xi))


@pytest.mark.parametrize("n,d,seed", [(1, 1, 0), (5, 2, 3), (16, 3, 7), (0, 2, 0)])
def test_sobol_matches(n, d, seed):
    np.testing.assert_array_equal(th.sobol_sequence(n, d, seed=seed), jh.sobol_sequence(n, d, seed=seed))


def test_slice_sampler_matches():
    def log_density(x):
        return float(-0.5 * np.sum((x - 1.0) ** 2 / np.array([1.0, 0.25])))

    got = th.slice_sample(np.zeros(2), log_density, 6, np.random.default_rng(9), burn_in=3, thin=2)
    want = jh.slice_sample(np.zeros(2), log_density, 6, np.random.default_rng(9), burn_in=3, thin=2)
    np.testing.assert_array_equal(got, want)


def _objective(x):
    return float((np.log10(x[0]) - 0.7) ** 2 + 0.3 * np.cos(np.log10(x[-1])))


@pytest.mark.parametrize("search", ["GaussianProcessSearch", "RandomSearch"])
def test_search_suggestions_match(search):
    """Both searches, fed the same objective, suggest the same points; the
    GP search seeds with Sobol points, then maximizes EI."""
    ranges = [(1e-3, 1e3, True), (0.0, 1.0, False)]
    kw = dict(num_init=2, candidate_pool_size=64) if search == "GaussianProcessSearch" else {}
    got = getattr(th, search)([th.SearchRange(*r) for r in ranges], seed=3, **kw)
    want = getattr(jh, search)([jh.SearchRange(*r) for r in ranges], seed=3, **kw)
    for _ in range(5):
        x, xr = got.suggest(), want.suggest()
        np.testing.assert_array_equal(x, xr)
        got.observe(x, _objective(x))
        want.observe(xr, _objective(xr))
    np.testing.assert_array_equal(got.best[0], want.best[0])
    assert got.best[1] == want.best[1]


def test_gp_tune_weights_matches():
    """The tuning loop on identical observations: the same λ sequence."""
    prior = [({"a": 0.1, "b": 1.0}, 0.71), ({"a": 1.0, "b": 1.0}, 0.74), ({"a": 10.0, "b": 0.01}, 0.69)]
    seen: dict[str, list] = {"port": [], "ref": []}

    def evaluate(key):
        def run(weights, it):
            seen[key].append((it, weights))
            return 0.75 - 0.01 * (np.log10(weights["a"]) - 0.5) ** 2 - 0.002 * abs(np.log10(weights["b"]))
        return run

    gp_tune_weights(["a", "b"], prior, 3, evaluate("port"), larger_is_better=True, seed=2)
    j_gp_tune(["a", "b"], prior, 3, evaluate("ref"), larger_is_better=True, seed=2)
    assert seen["port"] == seen["ref"] and len(seen["port"]) == 3


def _glmm():
    data = jax_game_data(np.random.default_rng(3), 400, 4, {"userId": (12, 3)})
    feats = {"global": data.X, "shard_userId": data.entity_X["userId"]}
    tags = {"userId": data.entity_ids["userId"]}
    return (data, j_make_game_batch(data.y, feats, id_tags=tags),
            game_batch_from_numpy(data.y, feats, id_tags=tags, device="cpu"))


def _config(m, iterations: int):
    T = jtypes if m is jcfg else ttypes

    def opt(solver, lam):
        return m.OptimizationConfig(
            optimizer=m.OptimizerConfig(optimizer_type=T.OptimizerType(solver), max_iterations=30,
                                        tolerance=1e-3),
            regularization=m.RegularizationContext(T.RegularizationType.L2), regularization_weight=lam)

    return m.GameTrainingConfig(
        task_type=T.TaskType.LOGISTIC_REGRESSION,
        coordinate_update_sequence=("fixed", "per_userId"),
        coordinate_descent_iterations=1,
        fixed_effect_coordinates={"fixed": m.FixedEffectCoordinateConfig("global", opt("LBFGS", 1.0))},
        random_effect_coordinates={"per_userId": m.RandomEffectCoordinateConfig(
            "userId", "shard_userId", opt("NEWTON_CHOLESKY", 1.0),
            bucket_target_count=1, bucket_max_padded_ratio=1e6)},
        evaluators=("AUC",),
        regularization_weight_grid={"fixed": (0.1, 10.0)},
        hyperparameter_tuning_iters=iterations,
    )


def test_tune_game_hyperparameters_matches_the_reference():
    data, jb, tb = _glmm()
    intercepts = {"global": data.intercept_index}
    jest = JEstimator(_config(jcfg, 2), intercept_indices=intercepts)
    test = GameEstimator(_config(tcfg, 2), intercept_indices=intercepts, device="cpu")
    jgrid, tgrid = jest.fit(jb, jb), test.fit(tb, validation_batch=tb)
    for g, w in zip(tgrid, jgrid):
        assert abs(g.evaluation.primary - w.evaluation.primary) <= 1e-4
    want = j_tune(jest, jb, jb, jgrid, 2)
    got = tune_game_hyperparameters(test, tb, tb, tgrid, 2)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for cid in ("fixed", "per_userId"):
            assert g.configuration[cid].regularization_weight == w.configuration[cid].regularization_weight
        assert abs(g.evaluation.primary - w.evaluation.primary) <= 1e-4
    # the suggestions are new points of the search box, not the grid's
    assert {r.configuration["fixed"].regularization_weight for r in got}.isdisjoint({0.1, 10.0})
