"""Lane compaction and launch fusion (``PHOTON_RE_COMPACT_EVERY``,
``PHOTON_RE_FUSE_BUCKETS``) in the port, on the CPU: the classes of the
reference's ``tests/test_re_compaction.py`` on its fixtures and sizes.

The knobs change the launch schedule and not the lanes' arithmetic, so
every knob arm is held to the knob-off arm bitwise (coefficients,
variances, final objective, iterations, convergence). On the CPU a
lane's bits can depend on the other lanes of its batch (ROADMAP queue 3:
the vectorized body of ``torch.sigmoid`` against its scalar tail); these
fixtures keep every front a whole number of vectors, and the port gives
the same bits, so no arm needs the lane tolerance here. Each arm is also
held to the JAX package's same arm, under the same environment, at the
lane tolerance (atol 2e-3 / rtol 1e-2).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.config import OptimizerConfig as JOpt
from photon_ml_tpu.game import DenseFeatures as JDense
from photon_ml_tpu.game import bucket_entities as jbucket
from photon_ml_tpu.game import group_by_entity as jgroup
from photon_ml_tpu.game import train_random_effects as jtrain
from photon_ml_tpu.game.data import EntityBuckets as JBuckets
from photon_ml_tpu.ops.losses import loss_for_task as jloss
from photon_ml_tpu.types import OptimizerType as JType
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.game import DenseFeatures, bucket_entities, group_by_entity, train_random_effects
from photon_ml_tpu_torch.game import random_effect as tre
from photon_ml_tpu_torch.game.data import EntityBuckets
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.ops.batch import DenseBatch
from photon_ml_tpu_torch.ops.glm import make_lane_objective
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optim.common import select_chunked_solver, select_minimize_fn
from photon_ml_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

CFG = OptimizerConfig(max_iterations=40, tolerance=1e-8)
TRON = OptimizerConfig(optimizer_type=OptimizerType.TRON, max_iterations=40, tolerance=1e-8)
LOSS = loss_for_task(TaskType.LOGISTIC_REGRESSION)
LANE_TOL = dict(rtol=1e-2, atol=2e-3)
KNOBS = ("PHOTON_RE_COMPACT_EVERY", "PHOTON_RE_FUSE_BUCKETS")


def _skewed_problem(rng, E=10, d=4, rows_per_entity=14, slow=(0,)):
    """The reference's fixture: logistic per-entity data where the
    ``slow`` entities' features are scaled anisotropically, so their
    solves take several times the others' iterations."""
    ids = np.repeat(np.arange(E), rows_per_entity).astype(np.int32)
    n = len(ids)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[np.isin(ids, list(slow))] *= np.geomspace(1.0, 40.0, d).astype(np.float32)
    W_true = rng.normal(size=(E, d)).astype(np.float32)
    margin = np.sum(W_true[ids] * X, axis=1)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    return ids, X, y


def _train(ids, X, y, E, cfg=CFG, buckets=None, **kw):
    if buckets is None:
        buckets = bucket_entities(group_by_entity(ids, num_entities=E))
    n = len(ids)
    res = train_random_effects(DenseFeatures(X=torch.from_numpy(X)), y, np.zeros(n, np.float32),
                               np.ones(n, np.float32), buckets, E, LOSS, cfg, device="cpu", **kw)
    return (res.coefficients.numpy(), None if res.variances is None else res.variances.numpy(),
            res.loss_values.copy(), res.iterations.copy(), res.converged.copy())


def _jtrain(ids, X, y, E, cfg=CFG, buckets=None, **kw):
    """The JAX package's solve of the same fixture (``cfg`` carried
    across by its fields)."""
    jcfg = JOpt(optimizer_type=JType[cfg.optimizer_type.name], max_iterations=cfg.max_iterations,
                tolerance=cfg.tolerance)
    if buckets is None:
        jb = jbucket(jgroup(ids, num_entities=E))
    else:
        jb = JBuckets(capacities=buckets.capacities, entity_ids=buckets.entity_ids, row_indices=buckets.row_indices)
    if "variance_computation" in kw:
        kw["variance_computation"] = JVar[kw["variance_computation"].name]
    n = len(ids)
    res = jtrain(JDense(X=jnp.asarray(X)), y, np.zeros(n, np.float32), np.ones(n, np.float32), jb, E,
                 jloss(JTask.LOGISTIC_REGRESSION), jcfg, **kw)
    return np.asarray(res.coefficients), None if res.variances is None else np.asarray(res.variances)


def _assert_bitwise(ref, out):
    for a, b in zip(ref, out):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


def _launches() -> float:
    return REGISTRY.snapshot("re_solve.")["counters"]["re_solve.launches"]["value"]


# ---------------------------------------------------------------------------
# the chunked entry points against the one-shot lane solve
# ---------------------------------------------------------------------------
class TestChunkedSolverParity:
    def _objective(self, rng, k=6, d=5, n=40):
        """k lanes of the reference's hard problem (columns scaled 1-30)."""
        X = rng.normal(size=(k, n, d)).astype(np.float32) * np.geomspace(1.0, 30.0, d).astype(np.float32)
        w = rng.normal(size=(k, d)).astype(np.float32)
        margin = np.clip(np.einsum("knd,kd->kn", X, w), -30.0, 30.0)
        y = (rng.uniform(size=(k, n)) < 1 / (1 + np.exp(-margin))).astype(np.float32)
        batch = DenseBatch(X=torch.from_numpy(X), labels=torch.from_numpy(y), offsets=torch.zeros(k, n),
                           weights=torch.ones(k, n))
        return make_lane_objective(batch, LOSS, l2_weight=0.3)

    @staticmethod
    def _run_chunked(solver, extra, obj, w0, cfg, step):
        state = solver.init(obj, w0, cfg, **extra)
        bound = 0
        while True:
            bound = min(bound + step, cfg.max_iterations)
            state = solver.run(obj, state, cfg, bound, **extra)
            if bool(state.done.all()) or bound >= cfg.max_iterations:
                break
        return solver.finalize(state)

    @staticmethod
    def _assert_results_bitwise(ref, out):
        for field in ("w", "value", "grad_norm", "iterations", "reason", "loss_history", "grad_norm_history",
                      "objective_passes"):
            a, b = getattr(ref, field), getattr(out, field)
            assert torch.equal(torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0)), field

    @pytest.mark.parametrize("l1", [0.0, 0.05], ids=["lbfgs", "owlqn"])
    def test_lbfgs_owlqn_chunked_matches_minimize(self, rng, l1):
        obj = self._objective(rng)
        w0 = torch.zeros(6, 5)
        minimize_fn, extra = select_minimize_fn(CFG, l1)
        ref = minimize_fn(obj, w0, CFG, **extra)
        solver, cextra = select_chunked_solver(CFG, l1)
        assert cextra == extra
        out = self._run_chunked(solver, cextra, obj, w0, CFG, step=3)
        assert int(ref.iterations.max()) > 3  # several chunks ran
        self._assert_results_bitwise(ref, out)

    def test_tron_chunked_matches_minimize(self, rng):
        cfg = OptimizerConfig(optimizer_type=OptimizerType.TRON, max_iterations=60, tolerance=1e-8)
        obj = self._objective(rng)
        w0 = torch.zeros(6, 5)
        ref = select_minimize_fn(cfg)[0](obj, w0, cfg)
        solver, extra = select_chunked_solver(cfg)
        out = self._run_chunked(solver, extra, obj, w0, cfg, step=2)
        assert int(ref.iterations.max()) > 2
        self._assert_results_bitwise(ref, out)

    def test_newton_has_no_chunked_twin(self):
        cfg = OptimizerConfig(optimizer_type=OptimizerType.NEWTON_CHOLESKY)
        solver, extra = select_chunked_solver(cfg)
        assert solver is None and extra == {}

    def test_lane_state_take_put_retire(self, rng):
        obj = self._objective(rng, k=4)
        st = select_chunked_solver(CFG)[0].init(obj, torch.zeros(4, 5), CFG)
        front = st.take(torch.tensor([2, 0]))
        assert torch.equal(front.w, st.w[[2, 0]]) and front.S.shape == (2,) + st.S.shape[1:]
        front = front.retire(1)
        assert front.done.tolist()[1] is True
        back = st.put(torch.tensor([3]), dataclasses_replace_w(front, 5.0), 1)
        assert torch.equal(back.w[3], torch.full((5,), 5.0)) and torch.equal(back.w[:3], st.w[:3])


def dataclasses_replace_w(state, value):
    import dataclasses

    return dataclasses.replace(state, w=torch.full_like(state.w, value))


# ---------------------------------------------------------------------------
# compaction: bitwise the single launch (in-memory bucket solves)
# ---------------------------------------------------------------------------
class TestCompactionParity:
    def test_skewed_buckets_bitwise(self, rng, monkeypatch):
        ids, X, y = _skewed_problem(rng)
        kw = dict(l2_weight=0.5, variance_computation=VarianceComputationType.SIMPLE)
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "0")
        ref = _train(ids, X, y, 10, **kw)
        assert ref[3].max() >= 2 * np.median(ref[3])  # the slow lane is skewed
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "2")  # many rounds and an uneven last chunk
        _assert_bitwise(ref, _train(ids, X, y, 10, **kw))

    def test_all_lanes_converge_in_first_chunk(self, rng, monkeypatch):
        ids, X, y = _skewed_problem(rng, slow=())
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "0")
        ref = _train(ids, X, y, 10, l2_weight=1.0)
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "500")  # one chunk, no compaction
        REGISTRY.reset("re_solve.")
        _assert_bitwise(ref, _train(ids, X, y, 10, l2_weight=1.0))
        assert _launches() == 3  # init, the one chunk, finalize

    def test_single_entity_bucket_bitwise(self, rng, monkeypatch):
        ids, X, y = _skewed_problem(rng, E=1, rows_per_entity=30)
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "0")
        ref = _train(ids, X, y, 1, l2_weight=0.5)
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "2")
        _assert_bitwise(ref, _train(ids, X, y, 1, l2_weight=0.5))

    def test_owlqn_l1_path_bitwise(self, rng, monkeypatch):
        ids, X, y = _skewed_problem(rng)
        kw = dict(l2_weight=0.2, l1_weight=0.05)
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "0")
        ref = _train(ids, X, y, 10, **kw)
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "3")
        _assert_bitwise(ref, _train(ids, X, y, 10, **kw))

    def test_tron_path_bitwise(self, rng, monkeypatch):
        ids, X, y = _skewed_problem(rng)
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "0")
        ref = _train(ids, X, y, 10, cfg=TRON, l2_weight=0.5)
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "2")
        _assert_bitwise(ref, _train(ids, X, y, 10, cfg=TRON, l2_weight=0.5))

    def test_newton_keeps_the_single_launch(self, rng, monkeypatch):
        ids, X, y = _skewed_problem(rng)
        cfg = OptimizerConfig(optimizer_type=OptimizerType.NEWTON_CHOLESKY, max_iterations=20, tolerance=1e-6)
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "0")
        ref = _train(ids, X, y, 10, cfg=cfg, l2_weight=0.5)
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "2")
        REGISTRY.reset("re_solve.")
        _assert_bitwise(ref, _train(ids, X, y, 10, cfg=cfg, l2_weight=0.5))
        assert _launches() == len(bucket_entities(group_by_entity(ids, num_entities=10)).entity_ids)

    def test_subspace_projection_columns_bitwise(self, rng, monkeypatch):
        """Per-entity subspace columns: the compacted solve routes the (k,
        p) column maps exactly as the single launch."""
        n, d, E = 160, 8, 8
        ids = np.repeat(np.arange(E), 20).astype(np.int32)
        X = rng.normal(size=(n, d)).astype(np.float32)
        X[ids == 2] *= np.geomspace(1.0, 30.0, d).astype(np.float32)
        y = (rng.uniform(size=n) < 0.5).astype(np.float32)
        buckets = bucket_entities(group_by_entity(ids, num_entities=E))
        prepared = tre.prepare_buckets(DenseFeatures(X=torch.from_numpy(X)), torch.from_numpy(y), torch.ones(n),
                                       buckets, features_to_samples_ratio=0.15, intercept_index=None)
        assert any(pb.columns is not None for pb in prepared)

        def run():
            res = tre.train_prepared(prepared, torch.zeros(n), d, E, LOSS, CFG, l2_weight=0.5)
            return res.coefficients.numpy(), res.loss_values.copy(), res.iterations.copy()

        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "0")
        ref = run()
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "3")
        _assert_bitwise(ref, run())

    @pytest.mark.parametrize("value", [None, "0"], ids=["unset", "zero"])
    def test_knob_off_keeps_single_launch_schedule(self, rng, monkeypatch, value):
        """Unset and 0 alike: one launch per bucket, and no iteration read
        without a sink or ``PHOTON_RE_ITER_ACCOUNTING``."""
        ids, X, y = _skewed_problem(rng)
        for knob in KNOBS:
            if value is None:
                monkeypatch.delenv(knob, raising=False)
            else:
                monkeypatch.setenv(knob, value)
        REGISTRY.reset("re_solve.")
        tre.reset_launch_counts()
        _train(ids, X, y, 10, l2_weight=0.5)
        n_buckets = len(bucket_entities(group_by_entity(ids, num_entities=10)).entity_ids)
        snap = REGISTRY.snapshot("re_solve.")
        assert snap["counters"]["re_solve.launches"]["value"] == n_buckets == tre.launch_counts["launches"]
        assert "re_solve.executed_entity_iterations" not in snap["counters"]


# ---------------------------------------------------------------------------
# same-geometry launch fusion
# ---------------------------------------------------------------------------
def _two_bucket_same_geometry(rng, E=8, d=4, cap=8):
    """Two buckets of one (C, d) geometry."""
    ids = np.repeat(np.arange(E), cap).astype(np.int32)
    half = E // 2
    rows = np.arange(E * cap, dtype=np.int64).reshape(E, cap)
    buckets = EntityBuckets(capacities=(cap, cap), entity_ids=[np.arange(half, dtype=np.int64),
                                                                np.arange(half, E, dtype=np.int64)],
                            row_indices=[rows[:half], rows[half:]])
    X = rng.normal(size=(E * cap, d)).astype(np.float32)
    X[ids == 1] *= np.geomspace(1.0, 30.0, d).astype(np.float32)
    W_true = rng.normal(size=(E, d)).astype(np.float32)
    margin = np.sum(W_true[ids] * X, axis=1)
    y = (rng.uniform(size=len(ids)) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    return ids, X, y, buckets


class TestLaunchFusion:
    def test_fusion_bitwise_and_single_launch(self, rng, monkeypatch):
        ids, X, y, buckets = _two_bucket_same_geometry(rng)
        kw = dict(l2_weight=0.5, buckets=buckets, variance_computation=VarianceComputationType.SIMPLE)
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "0")
        monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "0")
        REGISTRY.reset("re_solve.")
        ref = _train(ids, X, y, 8, **kw)
        assert _launches() == 2  # one per bucket
        monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "1")
        REGISTRY.reset("re_solve.")
        _assert_bitwise(ref, _train(ids, X, y, 8, **kw))
        assert _launches() == 1  # one geometry: one launch

    def test_fusion_keeps_distinct_geometries_separate(self, rng, monkeypatch):
        counts = np.concatenate([np.full(6, 5), np.full(4, 20)])
        ids = np.repeat(np.arange(10), counts).astype(np.int32)
        n = len(ids)
        X = rng.normal(size=(n, 4)).astype(np.float32)
        y = (rng.uniform(size=n) < 0.5).astype(np.float32)
        monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "0")
        ref = _train(ids, X, y, 10, l2_weight=1.0)
        monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "1")
        REGISTRY.reset("re_solve.")
        _assert_bitwise(ref, _train(ids, X, y, 10, l2_weight=1.0))
        assert _launches() == len(bucket_entities(group_by_entity(ids, num_entities=10)).entity_ids) == 2

    def test_fusion_leaves_single_lane_buckets_alone(self, rng, monkeypatch):
        E, d, cap = 5, 4, 8
        ids = np.repeat(np.arange(E), cap).astype(np.int32)
        rows = np.arange(E * cap, dtype=np.int64).reshape(E, cap)
        buckets = EntityBuckets(capacities=(cap, cap), entity_ids=[np.arange(4, dtype=np.int64),
                                                                    np.array([4], dtype=np.int64)],
                                row_indices=[rows[:4], rows[4:]])
        X = rng.normal(size=(E * cap, d)).astype(np.float32)
        X[ids == 4] *= np.geomspace(1.0, 30.0, d).astype(np.float32)
        y = (rng.uniform(size=E * cap) < 0.5).astype(np.float32)
        kw = dict(l2_weight=0.5, buckets=buckets, variance_computation=VarianceComputationType.SIMPLE)
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "0")
        monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "0")
        ref = _train(ids, X, y, E, **kw)
        monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "1")
        REGISTRY.reset("re_solve.")
        _assert_bitwise(ref, _train(ids, X, y, E, **kw))
        assert _launches() == 2  # the one-lane bucket stayed its own launch

    def test_fusion_plus_compaction_bitwise(self, rng, monkeypatch):
        ids, X, y, buckets = _two_bucket_same_geometry(rng)
        kw = dict(l2_weight=0.5, buckets=buckets)
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "0")
        monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "0")
        ref = _train(ids, X, y, 8, **kw)
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "3")
        monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "1")
        _assert_bitwise(ref, _train(ids, X, y, 8, **kw))

    def test_coordinate_stages_fused_units_once(self, rng, monkeypatch):
        """The coordinate keeps its fused units across visits (and grid
        entries): the second visit concatenates nothing."""
        from photon_ml_tpu_torch.config import OptimizationConfig, RegularizationContext
        from photon_ml_tpu_torch.game import RandomEffectCoordinate, make_game_batch
        from photon_ml_tpu_torch.types import RegularizationType

        ids, X, y, buckets = _two_bucket_same_geometry(rng)
        batch = make_game_batch(y, {"r": X}, id_tags={"u": ids}, device="cpu")
        opt = OptimizationConfig(optimizer=CFG, regularization=RegularizationContext(RegularizationType.L2),
                                 regularization_weight=0.5)
        coord = RandomEffectCoordinate("u", batch, "r", "u", opt, group_by_entity(ids, num_entities=8), buckets,
                                       TaskType.LOGISTIC_REGRESSION, 8)
        monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "0")
        off = coord.train(torch.zeros(len(y)))[0].coefficients
        monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "1")
        calls = []
        real = tre._fusion_units
        monkeypatch.setattr("photon_ml_tpu_torch.game.coordinate._fusion_units",
                            lambda p: calls.append(1) or real(p))
        first = coord.train(torch.zeros(len(y)))[0].coefficients
        second = coord.with_config(opt).train(torch.zeros(len(y)))[0].coefficients
        assert len(calls) == 1
        assert torch.equal(first, off) and torch.equal(second, off)


@pytest.mark.parametrize("layout", ["lane_sharded", "owned"])
def test_mesh_layouts_take_the_knobs_as_the_reference_does(layout, rng, monkeypatch):
    """Over a lane-sharded mesh both knobs keep the classic schedule (one
    launch per shard's lanes, bitwise the knob-off mesh solve); owned
    buckets (``PHOTON_RE_SHARD=1``) compact and fuse per bucket, bitwise
    the knob-on solve without a mesh."""
    from photon_ml_tpu_torch.parallel.mesh import data_mesh, process_mesh

    ids, X, y, buckets = _two_bucket_same_geometry(rng)
    kw = dict(l2_weight=0.5, buckets=buckets, variance_computation=VarianceComputationType.SIMPLE)
    if layout == "owned":
        monkeypatch.setenv("PHOTON_RE_SHARD", "1")
    mesh = data_mesh(2, ["cpu"] * 2) if layout == "lane_sharded" else process_mesh(2, devices=["cpu"])
    REGISTRY.reset("re_solve.")
    off = _train(ids, X, y, 8, mesh=mesh, **kw)
    off_launches = _launches()
    monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "3")
    monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "1")
    REGISTRY.reset("re_solve.")
    on = _train(ids, X, y, 8, mesh=mesh, **kw)
    if layout == "lane_sharded":
        assert _launches() == off_launches == 4  # 2 buckets x 2 shards, one launch each
        _assert_bitwise(off, on)
    else:
        assert _launches() > off_launches
        _assert_bitwise(_train(ids, X, y, 8, **kw), on)


# ---------------------------------------------------------------------------
# iteration accounting: the waste drops
# ---------------------------------------------------------------------------
class TestIterationAccounting:
    def test_executed_iterations_drop_30pct_useful_unchanged(self, rng, monkeypatch):
        """On an iteration-skewed bucket the compacted schedule executes at
        least 30% fewer entity iterations than the single launch, with
        the same useful ones (each lane's own count)."""
        ids, X, y = _skewed_problem(rng, E=16, rows_per_entity=12, slow=(0,))
        monkeypatch.setenv("PHOTON_RE_ITER_ACCOUNTING", "1")

        def counters():
            snap = REGISTRY.snapshot("re_solve.")["counters"]
            return (snap["re_solve.executed_entity_iterations"]["value"],
                    snap["re_solve.useful_entity_iterations"]["value"])

        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "0")
        REGISTRY.reset("re_solve.")
        ref = _train(ids, X, y, 16, l2_weight=0.5)
        exec_off, useful_off = counters()
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "4")
        REGISTRY.reset("re_solve.")
        out = _train(ids, X, y, 16, l2_weight=0.5)
        exec_on, useful_on = counters()
        _assert_bitwise(ref, out)
        assert useful_on == useful_off
        assert exec_on <= 0.7 * exec_off, (exec_on, exec_off)
        frac = REGISTRY.snapshot("re_solve.")["gauges"]["re_solve.active_lane_fraction"]
        assert 0.0 < frac < 1.0

    def test_compaction_counts_without_a_sink(self, rng, monkeypatch):
        """The compacted schedule reads the iterations between its chunks
        anyway, so it counts them with accounting off."""
        ids, X, y = _skewed_problem(rng)
        monkeypatch.setenv("PHOTON_RE_ITER_ACCOUNTING", "0")
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "4")
        REGISTRY.reset("re_solve.")
        _train(ids, X, y, 10, l2_weight=0.5)
        counters = REGISTRY.snapshot("re_solve.")["counters"]
        assert counters["re_solve.useful_entity_iterations"]["value"] > 0


# ---------------------------------------------------------------------------
# the JAX package's same arm, same environment
# ---------------------------------------------------------------------------
ARMS = {
    "lbfgs_compact": ({"PHOTON_RE_COMPACT_EVERY": "2"}, CFG, dict(l2_weight=0.5,
                                                               variance_computation=VarianceComputationType.SIMPLE)),
    "owlqn_compact": ({"PHOTON_RE_COMPACT_EVERY": "3"}, CFG, dict(l2_weight=0.2, l1_weight=0.05)),
    "tron_compact": ({"PHOTON_RE_COMPACT_EVERY": "2"}, TRON, dict(l2_weight=0.5)),
    "lbfgs_fused_compact": ({"PHOTON_RE_COMPACT_EVERY": "3", "PHOTON_RE_FUSE_BUCKETS": "1"}, CFG,
                            dict(l2_weight=0.5)),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_port_arm_matches_the_jax_arm(arm, rng, monkeypatch):
    env, cfg, kw = ARMS[arm]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if "FUSE" in "".join(env):
        ids, X, y, buckets = _two_bucket_same_geometry(rng)
        E = 8
    else:
        ids, X, y = _skewed_problem(rng)
        buckets, E = None, 10
    W, V, *_ = _train(ids, X, y, E, cfg=cfg, buckets=buckets, **kw)
    jW, jV = _jtrain(ids, X, y, E, cfg=cfg, buckets=buckets, **dict(kw))
    np.testing.assert_allclose(W, jW, **LANE_TOL)
    if V is not None:
        np.testing.assert_allclose(V, jV, **LANE_TOL)


# ---------------------------------------------------------------------------
# the out-of-core consumer (_solve_re_buckets)
# ---------------------------------------------------------------------------
def _streamed_config(pkg: str, solver: str = "LBFGS", l1: bool = False):
    if pkg == "ref":
        from photon_ml_tpu import config as C
        from photon_ml_tpu import types as T
    else:
        from photon_ml_tpu_torch import config as C
        from photon_ml_tpu_torch import types as T
    reg = C.RegularizationContext(T.RegularizationType.ELASTIC_NET if l1 else T.RegularizationType.L2)
    opt = C.OptimizationConfig(
        optimizer=C.OptimizerConfig(optimizer_type=T.OptimizerType[solver], max_iterations=40, tolerance=1e-8),
        regularization=reg, regularization_weight=1.0)
    return C.GameTrainingConfig(
        task_type=T.TaskType.LOGISTIC_REGRESSION, coordinate_update_sequence=("fixed", "user"),
        coordinate_descent_iterations=2,
        fixed_effect_coordinates={"fixed": C.FixedEffectCoordinateConfig(feature_shard_id="g", optimization=opt)},
        random_effect_coordinates={"user": C.RandomEffectCoordinateConfig(
            feature_shard_id="r", random_effect_type="uid", optimization=opt)})


def _streamed_data(seed=3, E=5):
    rng = np.random.default_rng(seed)
    n, d, dr = 320, 5, 3
    X = rng.normal(size=(n, d)).astype(np.float32)
    Xr = rng.normal(size=(n, dr)).astype(np.float32)
    ids = rng.integers(0, E, size=n).astype(np.int32)
    Xr[ids == 0] *= np.geomspace(1.0, 25.0, dr).astype(np.float32)  # lockstep waste for compaction
    w_fixed = (rng.normal(size=d) * 0.6).astype(np.float32)
    W_re = (rng.normal(size=(E, dr)) * 0.6).astype(np.float32)
    margin = X @ w_fixed + np.sum(W_re[ids] * Xr, axis=1)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    return y, X, Xr, ids


def _streamed_fit(pkg: str, E: int = 5, **cfg_kw):
    y, X, Xr, ids = _streamed_data(E=E)
    if pkg == "ref":
        from photon_ml_tpu.game.streaming import StreamedGameData as D
        from photon_ml_tpu.game.streaming import StreamedGameTrainer as Tr

        model, _ = Tr(_streamed_config("ref", **cfg_kw), chunk_rows=128).fit(
            D(labels=y, features={"g": X, "r": Xr}, id_tags={"uid": ids}))
        return {cid: np.asarray(sub.coefficient_means) for cid, sub in model.models.items()}
    from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer

    model, _ = StreamedGameTrainer(_streamed_config("port", **cfg_kw), chunk_rows=128, device="cpu").fit(
        StreamedGameData(labels=y, features={"g": X, "r": Xr}, id_tags={"uid": ids}))
    return {cid: sub.coefficient_means.numpy() for cid, sub in model.models.items()}


class TestStreamedParity:
    @pytest.mark.parametrize("cfg_kw", [{}, {"l1": True}, {"solver": "TRON"}], ids=["lbfgs", "owlqn", "tron"])
    def test_streamed_fit_bitwise_across_knobs(self, monkeypatch, cfg_kw):
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "0")
        monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "0")
        REGISTRY.reset("re_solve.")
        ref = _streamed_fit("port", **cfg_kw)
        off_launches = _launches()
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "3")
        monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "1")
        REGISTRY.reset("re_solve.")
        out = _streamed_fit("port", **cfg_kw)
        assert _launches() > off_launches  # the chunks ran
        assert set(ref) == set(out)
        for cid in ref:
            np.testing.assert_array_equal(ref[cid], out[cid])

    def test_streamed_knob_arm_matches_the_jax_arm(self, monkeypatch):
        monkeypatch.setenv("PHOTON_RE_COMPACT_EVERY", "3")
        monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", "1")
        port, ref = _streamed_fit("port"), _streamed_fit("ref")
        np.testing.assert_allclose(port["user"], ref["user"], **LANE_TOL)
        np.testing.assert_allclose(port["fixed"], ref["fixed"], rtol=1e-3, atol=2e-4)

    def test_streamed_fusion_fuses_same_capacity_buckets(self, monkeypatch):
        """The natural buckets are one per capacity class, so the trainer's
        buckets are split in two halves of one capacity here: fusion puts
        each pair back into one launch, bitwise."""
        from photon_ml_tpu_torch.game import streaming as tst

        real = tst.bucket_entities

        def halves(*a, **k):
            b = real(*a, **k)
            ent, rows, caps = [], [], []
            for e, r, c in zip(b.entity_ids, b.row_indices, b.capacities):
                cut = [0, len(e) // 2, len(e)] if len(e) >= 4 else [0, len(e)]
                for lo, hi in zip(cut, cut[1:]):
                    ent.append(e[lo:hi])
                    rows.append(r[lo:hi])
                    caps.append(c)
            return EntityBuckets(capacities=tuple(caps), entity_ids=ent, row_indices=rows)

        monkeypatch.setattr(tst, "bucket_entities", halves)
        launches = {}
        models = {}
        for fuse in ("0", "1"):
            monkeypatch.setenv("PHOTON_RE_FUSE_BUCKETS", fuse)
            REGISTRY.reset("re_solve.")
            models[fuse] = _streamed_fit("port", E=16)
            launches[fuse] = _launches()
        assert launches["1"] < launches["0"]
        for cid in models["0"]:
            np.testing.assert_array_equal(models["0"][cid], models["1"][cid])
