"""Checkpoint and resume in the port (the cases of the reference's
``tests/test_checkpoint.py``), and across the two packages: the checkpoint
fingerprints are equal strings for the same configuration and batch, a
checkpoint that either package writes loads in the other with identical
arrays, and the port resumes the JAX package's descent."""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_ml_tpu.config as jcfg
import photon_ml_tpu.types as jtypes
from photon_ml_tpu import checkpoint as ref_ckpt
from photon_ml_tpu import estimators as ref_est
from photon_ml_tpu.data.synthetic import synthetic_game_data as jax_game_data
from photon_ml_tpu.game.data import make_game_batch as j_make_game_batch
from photon_ml_tpu.game.models import FixedEffectModel as JFixed
from photon_ml_tpu.game.models import GameModel as JGame
from photon_ml_tpu.game.models import RandomEffectModel as JRandom
from photon_ml_tpu.models.glm import Coefficients as JCoef
from photon_ml_tpu.models.glm import GeneralizedLinearModel as JGLM
import photon_ml_tpu_torch.config as tcfg
import photon_ml_tpu_torch.types as ttypes
from photon_ml_tpu_torch import estimators as port_est
from photon_ml_tpu_torch.checkpoint import (
    batch_digest,
    load_checkpoint,
    peek_fingerprint,
    save_checkpoint,
)
from photon_ml_tpu_torch.convert import game_batch_from_numpy, game_model_from_numpy
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.data import bucket_entities, group_by_entity
from photon_ml_tpu_torch.game.descent import CoordinateDescent

TASK = ttypes.TaskType.LOGISTIC_REGRESSION
# resume equivalence holds at any optimizer depth (the reference's setting)
OPT = tcfg.OptimizerConfig(max_iterations=12, tolerance=1e-9)


def _data(seed=42, n=400, weights=None):
    data = jax_game_data(np.random.default_rng(seed), n, 4, {"userId": (10, 3)})
    feats = {"global": data.X, "per_user": data.entity_X["userId"]}
    tags = {"userId": data.entity_ids["userId"]}
    return (
        game_batch_from_numpy(data.y, feats, id_tags=tags, weights=weights, device="cpu"),
        j_make_game_batch(data.y, feats, id_tags=tags, weights=weights),
    )


def _cd(batch=None):
    batch = batch if batch is not None else _data()[0]
    grouping = group_by_entity(batch.id_tags["userId"].numpy())
    l2 = tcfg.RegularizationContext(ttypes.RegularizationType.L2)
    coords = {
        "fixed": FixedEffectCoordinate("fixed", batch, "global", tcfg.OptimizationConfig(optimizer=OPT),
                                       TASK, intercept_index=4),
        "per_user": RandomEffectCoordinate(
            "per_user", batch, "per_user", "userId",
            tcfg.OptimizationConfig(optimizer=OPT, regularization=l2, regularization_weight=1.0),
            grouping, bucket_entities(grouping), TASK, grouping.num_entities,
        ),
    }
    return CoordinateDescent(coords, batch, TASK)


def _model(rng, variances=True):
    return game_model_from_numpy({
        "f": dict(feature_shard_id="global", means=rng.normal(size=5).astype(np.float32),
                  variances=np.abs(rng.normal(size=5)).astype(np.float32) if variances else None),
        "r": dict(feature_shard_id="per_user", random_effect_type="userId",
                  coefficients=rng.normal(size=(6, 3)).astype(np.float32), variances=None),
    }, TASK, device="cpu")


class TestCheckpointRoundtrip:
    def test_save_load(self, tmp_path, rng):
        model = _model(rng)
        d = str(tmp_path / "ckpt")
        save_checkpoint(d, model, next_iteration=3)
        ckpt = load_checkpoint(d, device="cpu")
        assert ckpt.next_iteration == 3
        # the format's restart coordinate, as the reference reads it
        assert ref_ckpt.load_checkpoint(d).next_coordinate == 0
        for cid in ("f", "r"):
            np.testing.assert_array_equal(ckpt.model[cid].coefficient_means.numpy(),
                                          model[cid].coefficient_means.numpy())
        np.testing.assert_array_equal(ckpt.model["f"].model.coefficients.variances.numpy(),
                                      model["f"].model.coefficients.variances.numpy())
        assert ckpt.model["r"].variances is None and ckpt.model["r"].random_effect_type == "userId"
        assert ckpt.model["f"].coefficient_means.device.type == "cpu"

    def test_missing_returns_none(self, tmp_path):
        assert load_checkpoint(str(tmp_path / "nope"), device="cpu") is None
        assert peek_fingerprint(str(tmp_path / "nope")) is None

    def test_fingerprint_mismatch_ignored(self, tmp_path, rng):
        d = str(tmp_path / "ckpt")
        save_checkpoint(d, _model(rng), next_iteration=1, fingerprint="setup-a")
        assert peek_fingerprint(d) == "setup-a"
        assert load_checkpoint(d, fingerprint="setup-a", device="cpu") is not None
        # written under another configuration or data: ignored, not resumed
        assert load_checkpoint(d, fingerprint="setup-b", device="cpu") is None
        assert load_checkpoint(d, device="cpu") is not None

    def test_digest_mismatch_drops_scores_keeps_model(self, tmp_path, rng):
        d = str(tmp_path / "ckpt")
        save_checkpoint(d, _model(rng), next_iteration=1, scores={"f": np.ones(5, np.float32)},
                        total=np.ones(5, np.float32), data_digest="data-a")
        same = load_checkpoint(d, data_digest="data-a", device="cpu")
        assert same.scores is not None and same.total is not None
        other = load_checkpoint(d, data_digest="data-b", device="cpu")
        assert other is not None and other.next_iteration == 1
        assert other.scores is None and other.total is None

    def test_foreign_npz_is_ignored(self, tmp_path):
        os.makedirs(tmp_path / "ckpt")
        np.savez(str(tmp_path / "ckpt" / "ckpt.npz"), x=np.zeros(2))
        assert load_checkpoint(str(tmp_path / "ckpt"), device="cpu") is None
        assert peek_fingerprint(str(tmp_path / "ckpt")) is None


class TestDescentResume:
    def test_resume_matches_uninterrupted(self, tmp_path):
        seq = ("fixed", "per_user")
        full = _cd().run(seq, 2)
        ckpt_dir = str(tmp_path / "ck")
        _cd().run(seq, 1, checkpoint_dir=ckpt_dir)  # then "crash"
        assert os.path.exists(os.path.join(ckpt_dir, "ckpt.npz"))
        logs = []
        cd = _cd()
        cd._log = logs.append
        resumed = cd.run(seq, 2, checkpoint_dir=ckpt_dir)
        assert logs[0] == "resuming coordinate descent from checkpoint at outer iteration 1"
        assert len(resumed.validation_history) == 1  # one iteration ran
        for cid in seq:
            np.testing.assert_allclose(resumed.model[cid].coefficient_means.numpy(),
                                       full.model[cid].coefficient_means.numpy(), rtol=1e-4, atol=1e-5)

    def test_completed_checkpoint_short_circuits(self, tmp_path):
        ckpt_dir = str(tmp_path / "ck")
        seq = ("fixed", "per_user")
        first = _cd().run(seq, 2, checkpoint_dir=ckpt_dir)
        rerun = _cd().run(seq, 2, checkpoint_dir=ckpt_dir)
        assert rerun.trackers == {"fixed": [], "per_user": []}
        for cid in seq:
            np.testing.assert_array_equal(rerun.model[cid].coefficient_means.numpy(),
                                          first.model[cid].coefficient_means.numpy())

    def test_other_data_resumes_the_model_and_recomputes_scores(self, tmp_path):
        ckpt_dir = str(tmp_path / "ck")
        seq = ("fixed", "per_user")
        first = _cd().run(seq, 1, checkpoint_dir=ckpt_dir)
        other = _data(seed=43)[0]
        assert batch_digest(other.labels, other.weights) != batch_digest(*_labels_weights(_data()[0]))
        resumed = _cd(other).run(seq, 1, checkpoint_dir=ckpt_dir)
        np.testing.assert_array_equal(resumed.model["fixed"].coefficient_means.numpy(),
                                      first.model["fixed"].coefficient_means.numpy())
        np.testing.assert_allclose(resumed.training_scores["fixed"].numpy(),
                                   resumed.model["fixed"].score(other).numpy(), rtol=1e-6)


def _labels_weights(batch):
    return batch.labels, batch.weights


def _configs(**kw):
    """The same GameTrainingConfig in both packages (the port's parsed from
    the reference's JSON document)."""
    l2 = jcfg.RegularizationContext(jtypes.RegularizationType.L2)
    opt = jcfg.OptimizationConfig(optimizer=jcfg.OptimizerConfig(
        optimizer_type=jtypes.OptimizerType.NEWTON_CHOLESKY, max_iterations=12, tolerance=1e-7),
        regularization=l2, regularization_weight=1.0)
    ref_cfg = jcfg.GameTrainingConfig(
        task_type=jtypes.TaskType.LOGISTIC_REGRESSION,
        coordinate_update_sequence=("fixed", "per_user"),
        fixed_effect_coordinates={"fixed": jcfg.FixedEffectCoordinateConfig(
            "global", jcfg.OptimizationConfig(optimizer=jcfg.OptimizerConfig(max_iterations=12),
                                              regularization=l2))},
        random_effect_coordinates={"per_user": jcfg.RandomEffectCoordinateConfig(
            "userId", "per_user", opt, bucket_target_count=1, bucket_max_padded_ratio=1e6)},
        regularization_weight_grid={"fixed": (0.1, 10.0)},
        **kw,
    )
    return ref_cfg, tcfg.parse_config(ref_cfg.to_dict())


@pytest.mark.parametrize("warm", [False, True])
def test_fingerprints_are_the_reference_strings(rng, warm):
    tb, jb = _data()
    ref_cfg, port_cfg = _configs(evaluators=("AUC",))
    assert port_cfg.to_dict() == ref_cfg.to_dict()
    assert batch_digest(tb.labels, tb.weights) == ref_ckpt.batch_digest(jb.labels, jb.weights)
    port_init = ref_init = None
    if warm:
        m = _model(rng)
        port_init = m
        ref_init = JGame(models={
            "f": JFixed(model=JGLM(JCoef(jnp.asarray(m["f"].coefficient_means.numpy()))),
                        feature_shard_id="global"),
            "r": JRandom(coefficients=jnp.asarray(m["r"].coefficients.numpy()), variances=None,
                         random_effect_type="userId", feature_shard_id="per_user"),
        }, task_type=jtypes.TaskType.LOGISTIC_REGRESSION)
    port_base = port_est._fingerprint_base(port_cfg, tb, 0, port_init)
    ref_base = ref_est._fingerprint_base(ref_cfg, jb, 0, ref_init)
    assert port_base == ref_base
    for port_entry, ref_entry in zip(port_est.build_configuration_grid(port_cfg),
                                     ref_est.build_configuration_grid(ref_cfg)):
        got = port_est._fit_fingerprint(port_base, port_entry)
        assert got == ref_est._fit_fingerprint(ref_base, ref_entry)
    assert set(port_est._NON_TRAJECTORY_CONFIG_FIELDS) == set(ref_est._NON_TRAJECTORY_CONFIG_FIELDS)
    # a trajectory-neutral change keeps the fingerprint; a trajectory change does not
    more = port_est._fingerprint_base(_configs(coordinate_descent_iterations=5)[1], tb, 0, port_init)
    assert more == port_base
    assert port_est._fingerprint_base(port_cfg, tb, 1, port_init) != port_base


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_checkpoints_cross_both_ways(tmp_path, rng, writer):
    m = _model(rng)
    scores = {"f": rng.normal(size=7).astype(np.float32), "r": rng.normal(size=7).astype(np.float32)}
    total = rng.normal(size=7).astype(np.float32)
    d = str(tmp_path / "ck")
    kw = dict(next_iteration=2, fingerprint="fp", scores=scores, total=total, data_digest="dg")
    if writer == "port":
        save_checkpoint(d, m, **kw)
        got = ref_ckpt.load_checkpoint(d, fingerprint="fp", data_digest="dg")
        arrays = {cid: np.asarray(sub.coefficient_means) for cid, sub in got.model.models.items()}
        f_var = np.asarray(got.model["f"].model.coefficients.variances)
    else:
        ref_ckpt.save_checkpoint(d, JGame(models={
            "f": JFixed(model=JGLM(JCoef(jnp.asarray(m["f"].coefficient_means.numpy()),
                                         jnp.asarray(m["f"].model.coefficients.variances.numpy()))),
                        feature_shard_id="global"),
            "r": JRandom(coefficients=jnp.asarray(m["r"].coefficients.numpy()), variances=None,
                         random_effect_type="userId", feature_shard_id="per_user"),
        }, task_type=jtypes.TaskType.LOGISTIC_REGRESSION), **kw)
        got = load_checkpoint(d, fingerprint="fp", data_digest="dg", device="cpu")
        arrays = {cid: sub.coefficient_means.numpy() for cid, sub in got.model.models.items()}
        f_var = got.model["f"].model.coefficients.variances.numpy()
    assert (got.next_iteration, got.fingerprint) == (2, "fp")
    for cid in ("f", "r"):
        np.testing.assert_array_equal(arrays[cid], m[cid].coefficient_means.numpy())
    np.testing.assert_array_equal(f_var, m["f"].model.coefficients.variances.numpy())
    assert got.model["r"].random_effect_type == "userId"
    for cid, s in scores.items():
        np.testing.assert_array_equal(got.scores[cid], s)
    np.testing.assert_array_equal(got.total, total)


def test_fit_checkpoints_each_grid_entry_and_resumes(tmp_path):
    tb, _ = _data()
    _, cfg = _configs(coordinate_descent_iterations=1)
    ckpt_dir = str(tmp_path / "ck")
    est = port_est.GameEstimator(cfg, intercept_indices={"global": 4}, device="cpu")
    first = est.fit(tb, checkpoint_dir=ckpt_dir)
    assert sorted(os.listdir(ckpt_dir)) == ["config-0000", "config-0001"]
    fps = [peek_fingerprint(os.path.join(ckpt_dir, c)) for c in sorted(os.listdir(ckpt_dir))]
    assert fps[0] != fps[1]
    logs = []
    again = port_est.GameEstimator(cfg, intercept_indices={"global": 4}, device="cpu",
                                   logger=logs.append).fit(tb, checkpoint_dir=ckpt_dir)
    assert sum("resuming coordinate descent from checkpoint at outer iteration 1" in m for m in logs) == 2
    for a, b in zip(first, again):
        for cid in ("fixed", "per_user"):
            np.testing.assert_array_equal(a.model[cid].coefficient_means.numpy(),
                                          b.model[cid].coefficient_means.numpy())


def test_port_resumes_the_reference_descent(tmp_path):
    """The JAX package trains one outer iteration with checkpoints; the port,
    given the same configuration and data, takes that checkpoint: asked for
    one iteration it returns the reference's model exactly, asked for two it
    runs the second from it."""
    tb, jb = _data()
    ref_cfg, port_cfg = _configs(coordinate_descent_iterations=1)
    ckpt_dir = str(tmp_path / "ck")
    ref_res = ref_est.GameEstimator(ref_cfg, intercept_indices={"global": 4}).fit(jb, checkpoint_dir=ckpt_dir)
    logs = []
    got = port_est.GameEstimator(port_cfg, intercept_indices={"global": 4}, device="cpu",
                                 logger=logs.append).fit(tb, checkpoint_dir=ckpt_dir)
    assert sum("at outer iteration 1" in m for m in logs) == 2
    for r, p in zip(ref_res, got):
        for cid in ("fixed", "per_user"):
            np.testing.assert_array_equal(p.model[cid].coefficient_means.numpy(),
                                          np.asarray(r.model[cid].coefficient_means))
    _, port_cfg2 = _configs(coordinate_descent_iterations=2)
    resumed = port_est.GameEstimator(port_cfg2, intercept_indices={"global": 4},
                                     device="cpu").fit(tb, checkpoint_dir=ckpt_dir)
    fresh = port_est.GameEstimator(port_cfg2, intercept_indices={"global": 4}, device="cpu").fit(tb)
    for r, f in zip(resumed, fresh):
        assert len(r.descent.validation_history) == 1
        for cid in ("fixed", "per_user"):
            np.testing.assert_allclose(r.model[cid].coefficient_means.numpy(),
                                       f.model[cid].coefficient_means.numpy(), atol=1e-3)


@pytest.mark.parametrize("seed", [42, 43])
def test_non_unit_weights_resume_across_packages_or_restart(tmp_path, caplog, seed):
    """With non-unit float weights the two packages' weight sums may round
    apart (the port sums in float64, the reference in float32 in XLA's
    order), and then the data digest and so the fingerprint differ. The
    port then ignores the reference's checkpoint with a warning and trains
    from iteration 0, equal to a fresh fit; where the sums agree it resumes
    the reference's model exactly. Seed 43 gives the first case, 42 the
    second."""
    w = np.random.default_rng(seed + 1).uniform(0.5, 2.0, 400).astype(np.float32)
    tb, jb = _data(seed, weights=w)
    same = batch_digest(tb.labels, tb.weights) == ref_ckpt.batch_digest(jb.labels, jb.weights)
    assert same == (seed == 42)
    ref_cfg, port_cfg = _configs(coordinate_descent_iterations=1)
    ckpt_dir = str(tmp_path / "ck")
    ref_res = ref_est.GameEstimator(ref_cfg, intercept_indices={"global": 4}).fit(jb, checkpoint_dir=ckpt_dir)
    logs = []
    with caplog.at_level("WARNING", logger="photon_ml_tpu_torch.checkpoint"):
        got = port_est.GameEstimator(port_cfg, intercept_indices={"global": 4}, device="cpu",
                                     logger=logs.append).fit(tb, checkpoint_dir=ckpt_dir)
    mismatches = sum("fingerprint mismatch" in r.getMessage() for r in caplog.records)
    resumed = sum("at outer iteration 1" in m for m in logs)
    if same:
        assert (mismatches, resumed) == (0, 2)
        expected = [{cid: np.asarray(r.model[cid].coefficient_means) for cid in ("fixed", "per_user")}
                    for r in ref_res]
    else:
        assert (mismatches, resumed) == (2, 0)
        fresh = port_est.GameEstimator(port_cfg, intercept_indices={"global": 4}, device="cpu").fit(tb)
        expected = [{cid: f.model[cid].coefficient_means.numpy() for cid in ("fixed", "per_user")}
                    for f in fresh]
    for p, e in zip(got, expected):
        for cid in ("fixed", "per_user"):
            np.testing.assert_array_equal(p.model[cid].coefficient_means.numpy(), e[cid])


def test_load_checkpoint_needs_cuda_unless_cpu_is_asked(tmp_path, rng, monkeypatch):
    d = str(tmp_path / "ck")
    save_checkpoint(d, _model(rng), next_iteration=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_checkpoint(d)
    assert load_checkpoint(d, device="cpu") is not None
