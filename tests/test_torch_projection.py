"""Capacity-class projection (``PHOTON_RE_PROJECT``, ``PHOTON_RE_PROJECT_DIM``)
in the port, on the CPU: the classes of the reference's
``tests/test_projection.py`` on its fixtures (knob parsing, the ladder,
the hash algebra, knob-off bitwise, support exactness, the hash rung, the
scatter-back edges), the reference's refusals, the lane-sharded and owned
mesh schedules, and every arm against the JAX package's same arm under the
same environment (lane tolerance, atol 2e-3 / rtol 1e-2; the ladders and
folds equal)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.config import OptimizerConfig as JOpt
from photon_ml_tpu.game import bucket_entities as jbucket
from photon_ml_tpu.game import group_by_entity as jgroup
from photon_ml_tpu.game import projector as jproj
from photon_ml_tpu.game import train_random_effects as jtrain
from photon_ml_tpu.game.data import DenseFeatures as JDense
from photon_ml_tpu.ops.losses import loss_for_task as jloss
from photon_ml_tpu.optim import common as jcommon
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.evaluation.evaluators import auc_roc
from photon_ml_tpu_torch.game import bucket_entities, group_by_entity, train_random_effects
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.game.data import DenseFeatures, SparseFeatures
from photon_ml_tpu_torch.game.projector import (
    ClassProjection,
    _hash_fold,
    class_activity,
    projection_ladder,
    re_project_dim,
    re_project_mode,
)
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optim.common import (
    hash_expand_coefficients,
    hash_expand_variances,
    hash_fold_prior,
    hash_fold_warm_start,
)
from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

CFG = OptimizerConfig(max_iterations=25, tolerance=1e-9)
LOSS = loss_for_task(TaskType.LOGISTIC_REGRESSION)
LANE_TOL = dict(rtol=1e-2, atol=2e-3)
SIMPLE = dict(variance_computation=VarianceComputationType.SIMPLE)


def _prefix_problem(rng, E=9, d=10, rows=12, widths=None):
    """The reference's fixture: entity e activates only its first
    ``widths[e]`` columns, so support width follows the entity and the
    capacity classes have distinct supports."""
    widths = np.asarray(widths, np.int64) if widths is not None else np.minimum(d, 2 + np.arange(E))
    ids = np.repeat(np.arange(E), rows).astype(np.int32)
    n = len(ids)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X = np.where(np.arange(d)[None, :] < widths[ids][:, None], X, 0.0).astype(np.float32)
    W_true = rng.normal(size=(E, d)).astype(np.float32)
    margin = np.sum(W_true[ids] * X, axis=1)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    return ids, X, y


CLASSED_ROWS = np.repeat([6, 14, 30], 3)
CLASSED_WIDTHS = np.asarray([3, 2, 4, 7, 5, 6, 10, 9, 8])


def _classed_problem(rng):
    """Three capacity classes whose supports are 4, 7 and 10 columns."""
    return _prefix_problem(rng, rows=CLASSED_ROWS, widths=CLASSED_WIDTHS)


def _t(a):
    return None if a is None else torch.as_tensor(np.asarray(a))


def _train(ids, X, y, E, **kw):
    buckets = bucket_entities(group_by_entity(ids, num_entities=E))
    n = len(ids)
    for k in ("initial_coefficients", "prior_coefficients", "prior_variances"):
        if k in kw:
            kw[k] = _t(kw[k])
    res = train_random_effects(DenseFeatures(X=torch.from_numpy(X)), y, np.zeros(n, np.float32),
                               np.ones(n, np.float32), buckets, E, LOSS, CFG, l2_weight=1.0, device="cpu", **kw)
    return (res.coefficients.numpy(), None if res.variances is None else res.variances.numpy(),
            res.iterations.copy())


def _jtrain(ids, X, y, E, **kw):
    buckets = jbucket(jgroup(ids, num_entities=E))
    n = len(ids)
    if "variance_computation" in kw:
        kw["variance_computation"] = JVar[kw["variance_computation"].name]
    for k in ("initial_coefficients", "prior_coefficients", "prior_variances"):
        if k in kw:
            kw[k] = jnp.asarray(kw[k])
    res = jtrain(JDense(X=jnp.asarray(X)), y, np.zeros(n, np.float32), np.ones(n, np.float32), buckets, E,
                 jloss(JTask.LOGISTIC_REGRESSION), JOpt(max_iterations=25, tolerance=1e-9), l2_weight=1.0, **kw)
    return np.asarray(res.coefficients), None if res.variances is None else np.asarray(res.variances)


class TestKnobParsing:
    def test_mode_strict_membership(self, monkeypatch):
        for ok in ("0", "support", "hash"):
            monkeypatch.setenv("PHOTON_RE_PROJECT", ok)
            assert re_project_mode() == ok == jproj.re_project_mode()
        monkeypatch.setenv("PHOTON_RE_PROJECT", "subspace")
        with pytest.raises(ValueError, match="PHOTON_RE_PROJECT"):
            re_project_mode()

    def test_dim_requires_pow2(self, monkeypatch):
        monkeypatch.setenv("PHOTON_RE_PROJECT_DIM", "16")
        assert re_project_dim() == 16
        for bad in ("0", "1", "12"):
            monkeypatch.setenv("PHOTON_RE_PROJECT_DIM", bad)
            with pytest.raises(ValueError, match="power of two"):
                re_project_dim()

    def test_unset_defaults(self, monkeypatch):
        monkeypatch.delenv("PHOTON_RE_PROJECT", raising=False)
        monkeypatch.delenv("PHOTON_RE_PROJECT_DIM", raising=False)
        assert (re_project_mode(), re_project_dim()) == ("0", 32) == (jproj.re_project_mode(),
                                                                      jproj.re_project_dim())


class TestLadder:
    def _activity(self, rng, n_classes=3, d=12):
        act = (rng.uniform(size=(n_classes, d)) < 0.5).astype(np.int64)
        act *= rng.integers(1, 50, size=(n_classes, d))
        act[-1] = 1  # one dense class
        return act

    @pytest.mark.parametrize("mode", ["support", "hash"])
    def test_deterministic_and_the_references(self, rng, mode):
        act = self._activity(rng)
        caps = (2, 8, 32)
        a = projection_ladder(caps, act, 12, mode, 4, None)
        b = projection_ladder(caps, act, 12, mode, 4, None)
        ref = jproj.projection_ladder(caps, act, 12, mode, 4, None)
        assert set(a) == set(b) == set(ref)
        for cap in a:
            if a[cap] is None:
                assert b[cap] is None and ref[cap] is None
                continue
            for other in (b[cap], ref[cap]):
                np.testing.assert_array_equal(a[cap].columns, other.columns)
                assert a[cap].hash_dim == other.hash_dim
                if a[cap].hash_dim is not None:
                    np.testing.assert_array_equal(a[cap].hash_slots, other.hash_slots)
                    np.testing.assert_array_equal(a[cap].hash_signs, other.hash_signs)
                    np.testing.assert_array_equal(a[cap].hash_matrix(), other.hash_matrix())

    @pytest.mark.parametrize("nproc", [1, 2, 4])
    def test_process_count_independent(self, rng, nproc):
        """The streamed global ladder comes from the sum of per-process
        counts: any row partition gives the one-process ladder."""
        ids, X, y = _prefix_problem(rng, E=8, d=10, rows=8)
        caps = (2, 4, 8, 16)
        cls_of_entity = np.minimum(np.searchsorted(np.asarray(caps), np.bincount(ids, minlength=8)), len(caps) - 1)
        full = np.zeros((len(caps), 10), np.int64)
        np.add.at(full, cls_of_entity[ids], (X != 0).astype(np.int64))
        part = np.zeros_like(full)
        for p in range(nproc):
            rows = np.arange(len(ids)) % nproc == p
            np.add.at(part, cls_of_entity[ids[rows]], (X[rows] != 0).astype(np.int64))
        np.testing.assert_array_equal(part, full)
        la = projection_ladder(caps, full, 10, "support", 4, None)
        lb = projection_ladder(caps, part, 10, "support", 4, None)
        for cap in la:
            if la[cap] is None:
                assert lb[cap] is None
            else:
                np.testing.assert_array_equal(la[cap].columns, lb[cap].columns)

    def test_dense_class_skips_projection(self):
        assert projection_ladder((4,), np.ones((1, 6), np.int64), 6, "support", 4, None) == {4: None}

    def test_empty_support_keeps_one_column(self):
        act = np.zeros((1, 6), np.int64)
        spec = projection_ladder((4,), act, 6, "support", 4, None)[4]
        assert spec is not None and spec.support_dim == 1
        np.testing.assert_array_equal(projection_ladder((4,), act, 6, "support", 4, 5)[4].columns, [5])

    def test_hash_only_over_wide_supports(self):
        act = np.zeros((2, 16), np.int64)
        act[0, :3] = 1
        act[1, :9] = 1
        ladder = projection_ladder((2, 8), act, 16, "hash", 4, None)
        assert ladder[2].hash_dim is None and ladder[2].dim == 3
        assert ladder[8].hash_dim == 4 and ladder[8].dim == 4
        assert ladder[8].hash_slots.max() < 3  # the last slot is the intercept's

    def test_intercept_keeps_the_last_slot(self):
        act = np.zeros((1, 16), np.int64)
        act[0, :12] = 1
        spec = projection_ladder((8,), act, 16, "hash", 4, 15)[8]
        assert spec.columns[-1] == 15 and spec.hash_slots[-1] == 3 and spec.hash_signs[-1] == 1.0
        assert (spec.hash_slots[:-1] < 3).all()
        with pytest.raises(ValueError, match="last column"):
            projection_ladder((8,), act, 16, "hash", 4, 3)

    def test_class_activity_matches_bincount_and_the_references(self, rng):
        ids, X, y = _prefix_problem(rng, E=6, d=8, rows=5)
        buckets = bucket_entities(group_by_entity(ids, num_entities=6))
        classes, act = class_activity(X, buckets.capacities, buckets.row_indices)
        classes_t, act_t = class_activity(torch.from_numpy(X), buckets.capacities, buckets.row_indices)
        ref_classes, ref_act = jproj.class_activity(X, buckets.capacities, buckets.row_indices)
        assert classes == classes_t == ref_classes and act.shape == (len(classes), 8)
        np.testing.assert_array_equal(act, act_t)
        np.testing.assert_array_equal(act, ref_act)
        np.testing.assert_array_equal(act.sum(axis=0), (X != 0).sum(axis=0).astype(np.int64))


class TestHashAlgebra:
    def _spec(self, cols=None, d_e=6, m=8):
        cols = np.asarray(cols, np.int64) if cols is not None else np.arange(d_e, dtype=np.int64)
        slots, signs = _hash_fold(cols, m, None)
        ref_slots, ref_signs = jproj._hash_fold(cols, m, None)
        np.testing.assert_array_equal(slots, ref_slots)
        np.testing.assert_array_equal(signs, ref_signs)
        return ClassProjection(capacity=4, full_dim=16, columns=cols, hash_slots=slots, hash_signs=signs,
                               hash_dim=m)

    def test_fold_expand_round_trip_collision_free(self):
        spec = self._spec(cols=[0, 1, 3, 6], m=16)
        S = torch.from_numpy(spec.hash_matrix())
        assert S.abs().sum(0).max() == 1.0  # one column per slot
        w = torch.tensor([1.5, -2.0, 0.25, 3.0])
        assert torch.equal(hash_expand_coefficients(hash_fold_warm_start(w, S), S), w)

    def test_fold_warm_start_averages_collisions(self):
        S = torch.zeros(2, 4)
        S[0, 1], S[1, 1] = 1.0, -1.0
        np.testing.assert_allclose(hash_fold_warm_start(torch.tensor([3.0, 1.0]), S).numpy(), [0.0, 1.0, 0.0, 0.0])

    def test_fold_prior_precision_weighted(self):
        S = torch.zeros(2, 4)
        S[0, 2], S[1, 2] = 1.0, 1.0
        mu_h, var_h = hash_fold_prior(torch.tensor([2.0, -1.0]), torch.tensor([0.5, 1.0]), S)
        np.testing.assert_allclose(var_h[2], 1.0 / 3.0, rtol=1e-6)  # precisions 2 and 1 collapse to 3
        np.testing.assert_allclose(mu_h[2], 1.0, rtol=1e-6)  # (2*2 + 1*(-1)) / 3
        np.testing.assert_allclose(var_h[[0, 1, 3]], 1.0)  # empty slots: the inert (0, 1) prior
        np.testing.assert_allclose(mu_h[[0, 1, 3]], 0.0)

    def test_expand_variances_sign_free(self):
        spec = self._spec(d_e=5, m=4)
        v_h = torch.tensor([0.1, 0.2, 0.3, 0.4])
        v = hash_expand_variances(v_h, torch.from_numpy(spec.hash_matrix()))
        assert (v > 0).all()
        np.testing.assert_allclose(v.numpy(), v_h.numpy()[spec.hash_slots])

    def test_folds_match_the_references(self, rng):
        spec = self._spec(d_e=9, m=4)
        S = spec.hash_matrix()
        w = rng.normal(size=(3, 9)).astype(np.float32)
        var = (0.5 + rng.uniform(size=(3, 9))).astype(np.float32)
        St, wt, vt = torch.from_numpy(S), torch.from_numpy(w), torch.from_numpy(var)
        np.testing.assert_allclose(hash_fold_warm_start(wt, St).numpy(), jcommon.hash_fold_warm_start(w, S, xp=np),
                                   rtol=1e-6)
        for a, b in zip(hash_fold_prior(wt, vt, St), jcommon.hash_fold_prior(w, var, S, xp=np)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6)
        w_h = rng.normal(size=(3, 4)).astype(np.float32)
        np.testing.assert_allclose(hash_expand_coefficients(torch.from_numpy(w_h), St).numpy(),
                                   jcommon.hash_expand_coefficients(w_h, S, xp=np), rtol=1e-6)
        np.testing.assert_allclose(hash_expand_variances(torch.from_numpy(np.abs(w_h)), St).numpy(),
                                   jcommon.hash_expand_variances(np.abs(w_h), S, xp=np), rtol=1e-6)


class TestKnobOffBitwise:
    def test_in_memory_unset_vs_zero(self, rng, monkeypatch):
        ids, X, y = _prefix_problem(rng)
        monkeypatch.delenv("PHOTON_RE_PROJECT", raising=False)
        REGISTRY.reset("re_")
        W, V, it = ref = _train(ids, X, y, 9, **SIMPLE)
        refp = _train(ids, X, y, 9, initial_coefficients=W, prior_coefficients=W, prior_variances=V, **SIMPLE)
        launches = REGISTRY.snapshot("re_solve.")["counters"]["re_solve.launches"]["value"]
        assert not REGISTRY.snapshot("re_project.")["gauges"]  # no gauge with the knob off
        monkeypatch.setenv("PHOTON_RE_PROJECT", "0")
        REGISTRY.reset("re_")
        out = _train(ids, X, y, 9, **SIMPLE)
        outp = _train(ids, X, y, 9, initial_coefficients=W, prior_coefficients=W, prior_variances=V, **SIMPLE)
        assert REGISTRY.snapshot("re_solve.")["counters"]["re_solve.launches"]["value"] == launches
        assert not REGISTRY.snapshot("re_project.")["gauges"]
        for a, b in zip(ref + refp, out + outp):
            np.testing.assert_array_equal(a, b)

    def test_streamed_unset_vs_zero(self, rng, monkeypatch):
        from test_game_streaming import _data

        from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer

        X, Xr, ids, y, _ = _data(rng, n=240, E=6)
        data = StreamedGameData(labels=y, features={"g": X, "r": Xr}, id_tags={"uid": ids})
        monkeypatch.delenv("PHOTON_RE_PROJECT", raising=False)
        m_ref, _ = StreamedGameTrainer(_port_streamed_config(), chunk_rows=96, device="cpu").fit(data)
        monkeypatch.setenv("PHOTON_RE_PROJECT", "0")
        m_z, _ = StreamedGameTrainer(_port_streamed_config(), chunk_rows=96, device="cpu").fit(data)
        assert torch.equal(m_ref.models["user"].coefficients, m_z.models["user"].coefficients)
        assert torch.equal(m_ref.models["fixed"].model.coefficients.means,
                           m_z.models["fixed"].model.coefficients.means)


def _port_streamed_config(iters=1):
    from test_game_streaming import _config

    from photon_ml_tpu_torch.config import parse_config

    return parse_config(_config(iters=iters).to_dict())


class TestSupportExactness:
    def test_matches_dense_and_zeros_inactive(self, rng, monkeypatch):
        ids, X, y = _prefix_problem(rng)
        monkeypatch.delenv("PHOTON_RE_PROJECT", raising=False)
        W0, V0, _ = _train(ids, X, y, 9, **SIMPLE)
        monkeypatch.setenv("PHOTON_RE_PROJECT", "support")
        W1, V1, _ = _train(ids, X, y, 9, **SIMPLE)
        np.testing.assert_allclose(W1, W0, rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(V1, V0, rtol=1e-2, atol=1e-3)
        buckets = bucket_entities(group_by_entity(ids, num_entities=9))
        classes, act = class_activity(X, buckets.capacities, buckets.row_indices)
        ladder = projection_ladder(classes, act, 10, "support", 32, None)
        ent_class = np.minimum(np.searchsorted(np.asarray(classes), np.bincount(ids, minlength=9)), len(classes) - 1)
        for e in range(9):
            spec = ladder[int(classes[ent_class[e]])]
            if spec is None:
                continue
            inactive = np.setdiff1d(np.arange(10), spec.columns)
            np.testing.assert_array_equal(W1[e, inactive], 0.0)

    def test_narrowed_classes_match_dense(self, rng, monkeypatch):
        """The same on classes that do narrow (row counts follow the
        support width, as in the reference's bench recipe): two of three
        classes solve below full width, their inactive columns exactly 0."""
        ids, X, y = _classed_problem(rng)
        monkeypatch.delenv("PHOTON_RE_PROJECT", raising=False)
        W0, V0, _ = _train(ids, X, y, 9, **SIMPLE)
        monkeypatch.setenv("PHOTON_RE_PROJECT", "support")
        REGISTRY.reset("re_project.")
        W1, V1, _ = _train(ids, X, y, 9, **SIMPLE)
        gauges = REGISTRY.snapshot("re_project.")["gauges"]
        assert gauges["re_project.mean_ratio"] < 1.0 and gauges["re_project.dims_saved_bytes"] > 0
        np.testing.assert_allclose(W1, W0, rtol=1e-3, atol=2e-3)
        for e in range(9):
            width = CLASSED_WIDTHS[3 * (e // 3):3 * (e // 3) + 3].max()  # the class's support
            np.testing.assert_allclose(V1[e, :width], V0[e, :width], rtol=1e-2, atol=1e-3)
            # off the support both stay as the solve never touched them: 0
            np.testing.assert_array_equal(W1[e, width:], 0.0)
            np.testing.assert_array_equal(V1[e, width:], 0.0)

    def test_streamed_support_matches_dense(self, rng, monkeypatch):
        from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer

        data = _streamed_prefix_data(rng)
        monkeypatch.delenv("PHOTON_RE_PROJECT", raising=False)
        m0, _ = StreamedGameTrainer(_port_streamed_config(), chunk_rows=96, device="cpu").fit(
            StreamedGameData(**data))
        monkeypatch.setenv("PHOTON_RE_PROJECT", "support")
        REGISTRY.reset("re_project.")
        m1, _ = StreamedGameTrainer(_port_streamed_config(), chunk_rows=96, device="cpu").fit(
            StreamedGameData(**data))
        assert REGISTRY.snapshot("re_project.")["gauges"]["re_project.mean_ratio"] < 1.0
        np.testing.assert_allclose(m1.models["user"].coefficients.numpy(), m0.models["user"].coefficients.numpy(),
                                   rtol=1e-3, atol=2e-3)


def _streamed_prefix_data(rng) -> dict:
    """The reference's streamed support fixture: random-effect features
    with per-entity prefix support."""
    E, dr, n = 6, 8, 240
    ids = rng.integers(0, E, size=n).astype(np.int32)
    widths = np.minimum(dr, 2 + np.arange(E))
    Xr = rng.normal(size=(n, dr)).astype(np.float32)
    Xr = np.where(np.arange(dr)[None, :] < widths[ids][:, None], Xr, 0.0).astype(np.float32)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    W_re = (rng.normal(size=(E, dr)) * 0.6).astype(np.float32)
    margin = X @ np.ones(4, np.float32) * 0.3 + np.sum(W_re[ids] * Xr, axis=1)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    return dict(labels=y, features={"g": X, "r": Xr}, id_tags={"uid": ids})


def _hash_problem(rng):
    """The reference's hash-rung fixture: support 9 folded to 4 slots,
    signal on one column per distinct slot, the colliding columns rare
    weak noise; a held-out twin draw for the AUC."""
    E, d, rows = 6, 10, 40
    slots, signs = _hash_fold(np.arange(9, dtype=np.int64), 4, None)
    signal_cols = [int(np.flatnonzero(slots == s)[0]) for s in range(3)]
    noise_cols = [c for c in range(9) if c not in signal_cols]
    ids = np.repeat(np.arange(E), rows).astype(np.int32)
    n = len(ids)
    W_true = np.zeros((E, d), np.float32)
    W_true[:, signal_cols] = rng.normal(size=(E, 3)).astype(np.float32)

    def draw():
        X = rng.normal(size=(n, d)).astype(np.float32)
        X[:, noise_cols] *= 0.3 * (rng.uniform(size=(n, len(noise_cols))) < 0.1).astype(np.float32)
        X[:, 9:] = 0.0
        margin = 2.0 * np.sum(W_true[ids] * X, axis=1)
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
        return X, y

    X, y = draw()
    Xe, ye = draw()
    return E, ids, X, y, Xe, ye, slots, signs


class TestHashRung:
    def test_structural_fold_and_quality_parity(self, rng, monkeypatch):
        E, ids, X, y, Xe, ye, slots, signs = _hash_problem(rng)
        monkeypatch.delenv("PHOTON_RE_PROJECT", raising=False)
        W0, _, _ = _train(ids, X, y, E)
        monkeypatch.setenv("PHOTON_RE_PROJECT", "hash")
        monkeypatch.setenv("PHOTON_RE_PROJECT_DIM", "4")
        W1, _, _ = _train(ids, X, y, E)
        for s in range(3):  # colliding columns carry one hashed weight, up to sign
            cols = np.flatnonzero(slots == s)
            folded = W1[:, cols] * signs[cols][None, :]
            np.testing.assert_allclose(folded, folded[:, :1] * np.ones((1, len(cols))), atol=1e-6)
        np.testing.assert_array_equal(W1[:, 9:], 0.0)
        auc0 = float(auc_roc(torch.from_numpy(np.sum(W0[ids] * Xe, axis=1)), torch.from_numpy(ye)))
        auc1 = float(auc_roc(torch.from_numpy(np.sum(W1[ids] * Xe, axis=1)), torch.from_numpy(ye)))
        assert abs(auc1 - auc0) <= 0.005, (auc0, auc1)

    def test_warm_start_and_prior_pass_through_fold(self, rng, monkeypatch):
        ids, X, y = _prefix_problem(rng, E=4, d=10, rows=30, widths=[9, 9, 9, 9])
        monkeypatch.setenv("PHOTON_RE_PROJECT", "hash")
        monkeypatch.setenv("PHOTON_RE_PROJECT_DIM", "4")
        W, V, _ = _train(ids, X, y, 4, **SIMPLE)
        W2, V2, _ = _train(ids, X, y, 4, initial_coefficients=W, prior_coefficients=W, prior_variances=V, **SIMPLE)
        assert np.isfinite(W2).all() and np.isfinite(V2).all()
        np.testing.assert_allclose(W2, W, rtol=0.3, atol=0.1)
        # means alone fold like a warm start
        W3, _, _ = _train(ids, X, y, 4, initial_coefficients=W, prior_coefficients=W)
        assert np.isfinite(W3).all()


class TestScatterBackEdges:
    def test_empty_support_entity_stays_zero(self, rng, monkeypatch):
        E, d, rows = 4, 6, 10
        ids = np.repeat(np.arange(E), rows).astype(np.int32)
        X = rng.normal(size=(len(ids), d)).astype(np.float32)
        X[ids == 3] = 0.0
        y = (rng.uniform(size=len(ids)) < 0.5).astype(np.float32)
        monkeypatch.setenv("PHOTON_RE_PROJECT", "support")
        W, _, _ = _train(ids, X, y, E)
        monkeypatch.delenv("PHOTON_RE_PROJECT", raising=False)
        W0, _, _ = _train(ids, X, y, E)
        np.testing.assert_allclose(W, W0, rtol=1e-3, atol=2e-3)

    def test_singleton_support_matches_dense(self, rng, monkeypatch):
        E, d, rows = 5, 7, 12
        ids = np.repeat(np.arange(E), rows).astype(np.int32)
        X = np.zeros((len(ids), d), np.float32)
        X[np.arange(len(ids)), 2] = rng.normal(size=len(ids)).astype(np.float32)
        W_true = rng.normal(size=E).astype(np.float32)
        y = (rng.uniform(size=len(ids)) < 1 / (1 + np.exp(-W_true[ids] * X[:, 2]))).astype(np.float32)
        monkeypatch.delenv("PHOTON_RE_PROJECT", raising=False)
        W0, _, _ = _train(ids, X, y, E)
        monkeypatch.setenv("PHOTON_RE_PROJECT", "support")
        W1, _, _ = _train(ids, X, y, E)
        np.testing.assert_allclose(W1, W0, rtol=1e-3, atol=2e-3)
        np.testing.assert_array_equal(W1[:, np.setdiff1d(np.arange(d), [2])], 0.0)


# ---------------------------------------------------------------------------
# the reference's refusals, the mesh schedules, the JAX package's arms
# ---------------------------------------------------------------------------
class TestRefusals:
    def test_in_memory_refusals(self, rng, monkeypatch):
        from photon_ml_tpu_torch.normalization import NormalizationContext

        ids, X, y = _classed_problem(rng)
        buckets = bucket_entities(group_by_entity(ids, num_entities=9))
        n = len(ids)
        monkeypatch.setenv("PHOTON_RE_PROJECT", "support")
        with pytest.raises(ValueError, match="mutually exclusive"):
            tre.prepare_buckets(DenseFeatures(X=torch.from_numpy(X)), torch.from_numpy(y), torch.ones(n), buckets,
                                features_to_samples_ratio=0.5)
        sparse = SparseFeatures(indices=torch.zeros((n, 2), dtype=torch.int64), values=torch.ones(n, 2),
                                num_features=10)
        with pytest.raises(ValueError, match="dense features"):
            tre.prepare_buckets(sparse, torch.from_numpy(y), torch.ones(n), buckets)
        prepared = tre.prepare_buckets(DenseFeatures(X=torch.from_numpy(X)), torch.from_numpy(y), torch.ones(n),
                                       buckets)
        norm = NormalizationContext(factors=torch.ones(10), shifts=torch.zeros(10))
        with pytest.raises(NotImplementedError, match="normalization"):
            tre.train_prepared(prepared, torch.zeros(n), 10, 9, LOSS, CFG, norm=norm)
        monkeypatch.setenv("PHOTON_RE_PROJECT", "bogus")
        with pytest.raises(ValueError, match="PHOTON_RE_PROJECT"):
            _train(ids, X, y, 9)

    def test_streamed_refusals(self, rng, monkeypatch):
        import dataclasses

        from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer

        data = _streamed_prefix_data(rng)
        cfg = _port_streamed_config()
        monkeypatch.setenv("PHOTON_RE_PROJECT", "support")
        ratio = dataclasses.replace(cfg, random_effect_coordinates={"user": dataclasses.replace(
            cfg.random_effect_coordinates["user"], features_to_samples_ratio_upper_bound=0.5)})
        with pytest.raises(ValueError, match="mutually exclusive"):
            StreamedGameTrainer(ratio, chunk_rows=96, device="cpu").fit(StreamedGameData(**data))
        sparse = dict(data, features={"g": data["features"]["g"], "r": SparseFeatures(
            indices=np.zeros((240, 2), np.int64), values=np.ones((240, 2), np.float32), num_features=8)})
        with pytest.raises(ValueError, match="dense features"):
            StreamedGameTrainer(cfg, chunk_rows=96, device="cpu").fit(StreamedGameData(**sparse))


@pytest.mark.parametrize("env", [{"PHOTON_RE_PROJECT": "support"},
                                 {"PHOTON_RE_PROJECT": "hash", "PHOTON_RE_PROJECT_DIM": "4"}],
                         ids=["support", "hash"])
def test_in_memory_arm_matches_the_jax_arm(env, rng, monkeypatch):
    """Same environment for both packages: cold, then warm with the MAP
    prior, within the lane tolerance; the same gauges."""
    from photon_ml_tpu.obs.metrics import REGISTRY as REF_REGISTRY

    ids, X, y = _classed_problem(rng)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    REGISTRY.reset("re_project.")
    REF_REGISTRY.reset("re_project.")
    W, V, _ = _train(ids, X, y, 9, **SIMPLE)
    jW, jV = _jtrain(ids, X, y, 9, **SIMPLE)
    np.testing.assert_allclose(W, jW, **LANE_TOL)
    np.testing.assert_allclose(V, jV, **LANE_TOL)
    assert REGISTRY.snapshot("re_project.")["gauges"] == pytest.approx(REF_REGISTRY.snapshot("re_project.")["gauges"])
    warm = dict(initial_coefficients=W, prior_coefficients=W, prior_variances=V, **SIMPLE)
    W2, V2, _ = _train(ids, X, y, 9, **warm)
    jW2, jV2 = _jtrain(ids, X, y, 9, **warm)
    np.testing.assert_allclose(W2, jW2, **LANE_TOL)
    np.testing.assert_allclose(V2, jV2, **LANE_TOL)


@pytest.mark.parametrize("env", [{"PHOTON_RE_PROJECT": "support"},
                                 {"PHOTON_RE_PROJECT": "hash", "PHOTON_RE_PROJECT_DIM": "4"}],
                         ids=["support", "hash"])
def test_streamed_arm_matches_the_jax_arm(env, rng, monkeypatch):
    from photon_ml_tpu.game.streaming import StreamedGameData as JData
    from photon_ml_tpu.game.streaming import StreamedGameTrainer as JTrainer
    from test_game_streaming import _config

    from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer

    data = _streamed_prefix_data(rng)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, _ = StreamedGameTrainer(_port_streamed_config(), chunk_rows=96, device="cpu").fit(StreamedGameData(**data))
    ref, _ = JTrainer(_config(iters=1), chunk_rows=96).fit(JData(**data))
    np.testing.assert_allclose(port.models["user"].coefficients.numpy(), np.asarray(ref.models["user"].coefficients),
                               **LANE_TOL)


@pytest.mark.parametrize("mode", ["support", "hash"])
def test_mesh_schedules_match_the_unsharded_projection(mode, rng, monkeypatch):
    """A lane-sharded mesh and owned buckets solve the same projected
    classes: owned buckets bitwise the no-mesh solve, lane shards within
    the lane tolerance (other lane batches, ROADMAP queue 3)."""
    from photon_ml_tpu_torch.parallel.mesh import data_mesh, process_mesh

    ids, X, y = _classed_problem(rng)
    monkeypatch.setenv("PHOTON_RE_PROJECT", mode)
    monkeypatch.setenv("PHOTON_RE_PROJECT_DIM", "4")
    W, V, it = _train(ids, X, y, 9, **SIMPLE)
    Wl, Vl, _ = _train(ids, X, y, 9, mesh=data_mesh(2, ["cpu"] * 2), **SIMPLE)
    np.testing.assert_allclose(Wl, W, **LANE_TOL)
    np.testing.assert_allclose(Vl, V, **LANE_TOL)
    monkeypatch.setenv("PHOTON_RE_SHARD", "1")
    Wo, Vo, ito = _train(ids, X, y, 9, mesh=process_mesh(2, devices=["cpu"]), **SIMPLE)
    np.testing.assert_array_equal(Wo, W)
    np.testing.assert_array_equal(Vo, V)
    np.testing.assert_array_equal(ito, it)


def test_projection_with_compaction_and_fusion(rng, monkeypatch):
    """The schedule knobs on projected (and hashed) classes: the compacted
    prologue folds and the epilogue expands as the single launch does."""
    ids, X, y = _prefix_problem(rng, E=16, rows=np.repeat([6, 14], 8), widths=np.minimum(10, 6 + np.arange(16) % 5))
    monkeypatch.setenv("PHOTON_RE_PROJECT", "hash")
    monkeypatch.setenv("PHOTON_RE_PROJECT_DIM", "4")
    ref = _train(ids, X, y, 16, **SIMPLE)
    monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "2")
    monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "1")
    out = _train(ids, X, y, 16, **SIMPLE)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)
