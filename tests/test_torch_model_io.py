"""The port's model files against the JAX package's: GLM and GAME models
saved by one package load in the other with exactly equal means and
variances, the same ``metadata.json`` and the same directory listing; the
sparsity threshold, the intercept cases and a grown feature space resolve
as in the reference; fingerprints and scoring-result files agree."""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from photon_ml_tpu.data.index_map import IndexMap as JIndexMap
from photon_ml_tpu.data.summary import FeatureSummary as JSummary
from photon_ml_tpu.game.models import FixedEffectModel as JFixed
from photon_ml_tpu.game.models import GameModel as JGame
from photon_ml_tpu.game.models import RandomEffectModel as JRandom
from photon_ml_tpu.io import model_io as ref
from photon_ml_tpu.io.avro import iter_avro_directory
from photon_ml_tpu.io.avro import read_avro_file as ref_read
from photon_ml_tpu.io.results import write_feature_summary as ref_write_summary
from photon_ml_tpu.io.results import write_scoring_results as ref_write_scores
from photon_ml_tpu.models.glm import Coefficients as JCoef
from photon_ml_tpu.models.glm import GeneralizedLinearModel as JGLM
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.convert import game_model_from_numpy, glm_from_numpy
from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key
from photon_ml_tpu_torch.data.summary import FeatureSummary
from photon_ml_tpu_torch.io import model_io as port
from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
from photon_ml_tpu_torch.io.results import write_feature_summary, write_scoring_results
from photon_ml_tpu_torch.io.schemas import BAYESIAN_LINEAR_MODEL_SCHEMA
from photon_ml_tpu_torch.types import TaskType

TASK = TaskType.LOGISTIC_REGRESSION


def _arrays(seed: int = 0, d_fixed: int = 5, entities: int = 7, d_re: int = 3):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=d_fixed).astype(np.float32)
    means[1] = 0.0  # left out of the file
    W = rng.normal(size=(entities, d_re)).astype(np.float32)
    W[2] = 0.0  # an entity with no coefficient above the threshold
    return dict(
        means=means, variances=rng.uniform(0.1, 1, d_fixed).astype(np.float32),
        W=W, V=rng.uniform(0.1, 1, (entities, d_re)).astype(np.float32),
    )


def _maps(a):
    fixed_keys = [feature_key("g", str(j)) for j in range(len(a["means"]) - 1)]
    re_keys = [feature_key("u", str(j)) for j in range(a["W"].shape[1])]
    return (
        {"global": IndexMap.build(fixed_keys, True), "per_user": IndexMap.build(re_keys, False)},
        {"global": JIndexMap.build(fixed_keys, True), "per_user": JIndexMap.build(re_keys, False)},
    )


def _models(a, variances: bool):
    port_model = game_model_from_numpy({
        "fixed": dict(feature_shard_id="global", means=a["means"],
                      variances=a["variances"] if variances else None),
        "per_user": dict(feature_shard_id="per_user", random_effect_type="userId",
                         coefficients=a["W"], variances=a["V"] if variances else None),
    }, TASK, device="cpu")
    ref_model = JGame(models={
        "fixed": JFixed(model=JGLM(JCoef(jnp.asarray(a["means"]),
                                         jnp.asarray(a["variances"]) if variances else None),
                                   JTask.LOGISTIC_REGRESSION),
                        feature_shard_id="global"),
        "per_user": JRandom(coefficients=jnp.asarray(a["W"]),
                            variances=jnp.asarray(a["V"]) if variances else None,
                            random_effect_type="userId", feature_shard_id="per_user",
                            task_type=JTask.LOGISTIC_REGRESSION),
    }, task_type=JTask.LOGISTIC_REGRESSION)
    return port_model, ref_model


def _listing(root) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _records(root) -> dict:
    """Decoded records of every Avro file under ``root``, by relative path."""
    return {p: ref_read(os.path.join(root, p))[1] for p in _listing(root) if p.endswith(".avro")}


def _port_arrays(model, cid):
    sub = model.models[cid]
    if hasattr(sub, "model"):
        c = sub.model.coefficients
        return c.means.numpy(), None if c.variances is None else c.variances.numpy()
    return sub.coefficients.numpy(), None if sub.variances is None else sub.variances.numpy()


def _ref_arrays(model, cid):
    sub = model.models[cid]
    if hasattr(sub, "model"):
        c = sub.model.coefficients
        return np.asarray(c.means), None if c.variances is None else np.asarray(c.variances)
    return np.asarray(sub.coefficients), None if sub.variances is None else np.asarray(sub.variances)


@pytest.mark.parametrize("variances", [False, True])
@pytest.mark.parametrize("with_maps", [False, True])
def test_game_models_cross_both_ways(tmp_path, variances, with_maps):
    a = _arrays()
    port_maps, ref_maps = _maps(a) if with_maps else ({}, {})
    port_model, ref_model = _models(a, variances)
    names = [f"user_{i}" for i in range(a["W"].shape[0])]
    ids = {"per_user": {n: i for i, n in enumerate(names)}}
    kw = dict(entity_names={"per_user": names}, records_per_part=3)
    port.save_game_model(port_model, str(tmp_path / "port"), index_maps=port_maps, **kw)
    ref.save_game_model(ref_model, str(tmp_path / "ref"), index_maps=ref_maps, **kw)

    assert _listing(tmp_path / "port") == _listing(tmp_path / "ref")
    for side in ("port", "ref"):
        assert len(os.listdir(tmp_path / side / "random-effect" / "per_user" / "coefficients")) == 3
    assert (tmp_path / "port" / "metadata.json").read_text() == (tmp_path / "ref" / "metadata.json").read_text()
    assert _records(tmp_path / "port") == _records(tmp_path / "ref")

    by_ref = ref.load_game_model(str(tmp_path / "port"), index_maps=ref_maps or None, entity_ids=ids)
    by_port = port.load_game_model(str(tmp_path / "ref"), index_maps=port_maps or None, entity_ids=ids,
                                   device="cpu")
    for cid in ("fixed", "per_user"):
        for got, want in zip(_port_arrays(by_port, cid), _ref_arrays(by_ref, cid)):
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)
    m, v = _port_arrays(by_port, "per_user")
    np.testing.assert_array_equal(m, a["W"])
    assert port.model_fingerprint(by_port) == ref.model_fingerprint(by_ref)
    assert port.model_fingerprint(port_model) == ref.model_fingerprint(ref_model)
    assert by_port.models["per_user"].random_effect_type == "userId"


@pytest.mark.parametrize("entities", [0, 6])
def test_part_files_split_as_the_reference(tmp_path, entities):
    a = _arrays()
    a["W"], a["V"] = a["W"][:entities], a["V"][:entities]
    port_model, ref_model = _models(a, False)
    port.save_game_model(port_model, str(tmp_path / "port"), records_per_part=3)
    ref.save_game_model(ref_model, str(tmp_path / "ref"), records_per_part=3)
    assert _listing(tmp_path / "port") == _listing(tmp_path / "ref")
    assert _records(tmp_path / "port") == _records(tmp_path / "ref")


def test_fingerprint_tells_models_apart():
    a = _arrays()
    one, _ = _models(a, True)
    b = dict(a, W=a["W"].copy())
    b["W"][0, 0] += 1.0
    two, _ = _models(b, True)
    assert port.model_fingerprint(one) == port.model_fingerprint(_models(a, True)[0])
    assert port.model_fingerprint(one) != port.model_fingerprint(two)


@pytest.mark.parametrize("saver", ["port", "ref"])
@pytest.mark.parametrize("with_map", [False, True])
def test_glm_crosses_both_ways(tmp_path, saver, with_map):
    a = _arrays()
    port_maps, ref_maps = _maps(a)
    imap = (port_maps if saver == "port" else ref_maps)["global"] if with_map else None
    path = str(tmp_path / "m.avro")
    if saver == "port":
        port.save_glm(glm_from_numpy(a["means"], a["variances"], TaskType.LINEAR_REGRESSION, device="cpu"),
                      path, index_map=imap, model_id="best")
    else:
        ref.save_glm(JGLM(JCoef(jnp.asarray(a["means"]), jnp.asarray(a["variances"])),
                          JTask.LINEAR_REGRESSION), path, index_map=imap, model_id="best")
    d = len(a["means"])
    got = port.load_glm(path, index_map=port_maps["global"] if with_map else None, num_features=d,
                        device="cpu")
    want = ref.load_glm(path, index_map=ref_maps["global"] if with_map else None, num_features=d)
    assert got.task_type is TaskType.LINEAR_REGRESSION
    np.testing.assert_array_equal(got.coefficients.means.numpy(), np.asarray(want.coefficients.means))
    np.testing.assert_array_equal(got.coefficients.variances.numpy(), np.asarray(want.coefficients.variances))
    np.testing.assert_array_equal(got.coefficients.means.numpy(), a["means"])
    assert read_avro_file(path)[1][0]["modelId"] == "best"


def test_sparsity_threshold_matches_the_reference(tmp_path):
    w = np.array([1e-9, 5.0, -1e-7, -3.0], np.float32)
    port.save_glm(glm_from_numpy(w, None, TASK, device="cpu"), str(tmp_path / "p.avro"),
                  sparsity_threshold=1e-6)
    ref.save_glm(JGLM(JCoef(jnp.asarray(w)), JTask.LOGISTIC_REGRESSION), str(tmp_path / "r.avro"),
                 sparsity_threshold=1e-6)
    got, want = read_avro_file(str(tmp_path / "p.avro"))[1], ref_read(str(tmp_path / "r.avro"))[1]
    assert got == want and [r["name"] for r in got[0]["means"]] == ["f1", "f3"]


def _write_model_record(path, means, variances=None):
    rec = {"modelId": "global", "modelClass": "GeneralizedLinearModel",
           "lossFunction": "LOGISTIC_REGRESSION", "means": means, "variances": variances}
    write_avro_file(path, BAYESIAN_LINEAR_MODEL_SCHEMA, [rec])


@pytest.mark.parametrize("num_features", [None, 6])
def test_intercept_without_index_map_matches_the_reference(tmp_path, num_features):
    """An '(INTERCEPT)' record with neither an IndexMap nor a width lands one
    past the largest synthetic index; with a width, at the last slot; its
    variance shares the mean's slot even when the variance list is sparser."""
    path = str(tmp_path / "m.avro")
    _write_model_record(
        path,
        [{"name": "f0", "term": "", "value": 1.0}, {"name": "f2", "term": "", "value": 3.0},
         {"name": "(INTERCEPT)", "term": "", "value": -0.5}],
        [{"name": "f0", "term": "", "value": 0.7}, {"name": "(INTERCEPT)", "term": "", "value": 0.9}],
    )
    got = port.load_glm(path, num_features=num_features, device="cpu")
    want = ref.load_glm(path, num_features=num_features)
    np.testing.assert_array_equal(got.coefficients.means.numpy(), np.asarray(want.coefficients.means))
    np.testing.assert_array_equal(got.coefficients.variances.numpy(), np.asarray(want.coefficients.variances))
    slot = 3 if num_features is None else 5
    assert got.coefficients.means[slot] == -0.5 and got.coefficients.variances[slot] == pytest.approx(0.9)


def test_grown_feature_space_and_unresolvable_names(tmp_path):
    """A warm start onto data with new features: the width comes from the new
    map and shared features resolve by key, whatever their new position."""
    old = IndexMap.build(["a", "b"], add_intercept=True)
    path = str(tmp_path / "m.avro")
    port.save_glm(glm_from_numpy(np.array([1.0, 2.0, 3.0], np.float32), None, TASK, device="cpu"),
                  path, index_map=old)
    keys = ["zzz", "b", "a", "extra"]
    got = port.load_glm(path, index_map=IndexMap.build(keys, True), device="cpu")
    want = ref.load_glm(path, index_map=JIndexMap.build(keys, True))
    np.testing.assert_array_equal(got.coefficients.means.numpy(), np.asarray(want.coefficients.means))
    assert got.coefficients.dim == 5 and got.coefficients.means[4] == 3.0
    with pytest.raises(ValueError, match="needs an IndexMap"):
        port.load_glm(path, device="cpu")


def test_scoring_results_read_the_same_from_either_package(tmp_path):
    rng = np.random.default_rng(1)
    scores = rng.normal(size=9).astype(np.float32)
    labels = (rng.uniform(size=9) < 0.5).astype(np.float32)
    uids = ["a", 1, None, "d", 4, "f", np.int64(7), "h", "i"]
    meta = [{"k": str(i)} for i in range(9)]
    import torch

    write_scoring_results(str(tmp_path / "p.avro"), torch.from_numpy(scores), uids=uids, labels=labels,
                          metadata=meta)
    ref_write_scores(str(tmp_path / "r.avro"), scores, uids=uids, labels=labels, metadata=meta)
    got = read_avro_file(str(tmp_path / "p.avro"))[1]
    assert got == ref_read(str(tmp_path / "r.avro"))[1] == list(iter_avro_directory(str(tmp_path / "p.avro")))
    assert [r["predictionScore"] for r in got] == scores.astype(np.float64).tolist()
    write_scoring_results(str(tmp_path / "p2.avro"), scores)
    ref_write_scores(str(tmp_path / "r2.avro"), scores)
    assert read_avro_file(str(tmp_path / "p2.avro"))[1] == ref_read(str(tmp_path / "r2.avro"))[1]


def test_feature_summary_file_matches_the_reference(tmp_path):
    rng = np.random.default_rng(2)
    stats = {k: rng.normal(size=4) for k in ("mean", "variance", "min", "max", "max_magnitude", "num_nonzeros")}
    keys = ["x", feature_key("y", "t"), "z"]
    write_feature_summary(str(tmp_path / "p.avro"), FeatureSummary(count=10, **stats), IndexMap.build(keys, True))
    ref_write_summary(str(tmp_path / "r.avro"), JSummary(count=10, **stats), JIndexMap.build(keys, True))
    assert read_avro_file(str(tmp_path / "p.avro"))[1] == ref_read(str(tmp_path / "r.avro"))[1]
    json.dumps(read_avro_file(str(tmp_path / "p.avro"))[1])  # plain values


def test_load_game_model_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    import torch

    a = _arrays()
    port.save_game_model(_models(a, False)[0], str(tmp_path / "m"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.load_game_model(str(tmp_path / "m"))
    assert port.load_game_model(str(tmp_path / "m"), device="cpu").models["fixed"].model.coefficients.dim == 5
