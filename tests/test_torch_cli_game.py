"""The port's GAME train and score drivers against the JAX package's on the
same small Avro data (400 rows: 8 users, 3 global and 2 per-user
features; a 2-entry λ grid, output mode ALL): equal ``metrics.json`` keys,
configurations and best index, metrics within 1e-3, the same files, the
best model within the lane tolerance (L-BFGS random effects, atol 2e-3 /
rtol 1e-2) or atol 1e-4 (Newton); each package's scoring driver scores the
other's output to atol 1e-5 in the same uid order; warm start, resume from
``checkpoints/``, hyperparameter tuning with ``--diagnostics`` and the
unported flags."""

from __future__ import annotations

import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import photon_ml_tpu.config as jcfg
import photon_ml_tpu.types as jtypes
from photon_ml_tpu.cli import score as ref_score
from photon_ml_tpu.cli import train as ref_train
from photon_ml_tpu.data.synthetic import synthetic_game_data
from photon_ml_tpu.io.avro import read_avro_file as ref_read
from photon_ml_tpu.io.avro import write_avro_file as ref_write
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu.ops.batch import DenseBatch as JDense
from photon_ml_tpu.ops.glm import make_objective as j_make_objective
from photon_ml_tpu.ops.losses import loss_for_task as j_loss_for_task
from photon_ml_tpu.optim import lbfgs_minimize as j_lbfgs
from photon_ml_tpu.utils import PhotonLogger as JLogger
from photon_ml_tpu_torch.cli import score as port_score
from photon_ml_tpu_torch.cli import train as port_train
from photon_ml_tpu_torch.config import OptimizerConfig, parse_config
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.io.avro import read_avro_file
from photon_ml_tpu_torch.io.data_reader import AvroDataReader
from photon_ml_tpu_torch.io.model_io import load_game_model
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.batch import DenseBatch
from photon_ml_tpu_torch.ops.glm import make_objective
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optim import lbfgs_minimize
from photon_ml_tpu_torch.optim.common import ConvergenceReason
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import PhotonLogger

# random-effect solver → (the coordinates' tolerance, the model tolerance). L-BFGS
# runs at 1e-7, where lanes meet a stopping rule an iteration apart (the lane
# tolerance of ROADMAP queue 3); the Newton case runs above the float32
# floor of the stopping rules (1e-3, queue 3), where the packages agree to 1e-4:
# at 1e-7 the fixed effect stops one float32 ulp of f apart, which
# test_fixed_effect_stop_at_1e7_is_float32_rounding shows
SOLVERS = {
    "LBFGS": (1e-7, dict(atol=2e-3, rtol=1e-2)),
    "NEWTON_CHOLESKY": (1e-3, dict(atol=1e-4, rtol=0.0)),
}
EVALUATORS = ["AUC", "MULTI_AUC(userId)"]


def _quiet(cls):
    return cls(None, stream=io.StringIO())


def _schema():
    schema = json.loads(json.dumps(TRAINING_EXAMPLE_SCHEMA))
    schema["fields"].insert(5, {"name": "userFeatures",
                                "type": {"type": "array", "items": "NameTermValueAvro"}, "default": []})
    return schema


def _write(path, data, lo, hi, users_offset=0):
    """``data``'s rows [lo, hi) as records: a global bag, a per-user bag and
    the user id in ``metadataMap``; values are float32, so they cross the
    file exactly."""
    recs = [
        {
            "uid": f"s{i}",
            "response": float(data.y[i]),
            "offset": None,
            "weight": None,
            "features": [{"name": "g", "term": str(j), "value": float(np.float32(data.X[i, j]))}
                         for j in range(3)],
            "userFeatures": [{"name": "u", "term": str(j),
                              "value": float(np.float32(data.entity_X["userId"][i, j]))} for j in range(2)],
            "metadataMap": {"userId": f"user_{data.entity_ids['userId'][i] + users_offset}"},
        }
        for i in range(lo, hi)
    ]
    ref_write(path, _schema(), recs)


def _config(solver: str, **kw):
    """The reference's configuration; the port's is parsed from its JSON."""
    l2 = jcfg.RegularizationContext(jtypes.RegularizationType.L2)

    def opt(solver_type, lam):
        return jcfg.OptimizationConfig(
            optimizer=jcfg.OptimizerConfig(optimizer_type=jtypes.OptimizerType(solver_type),
                                           max_iterations=30, tolerance=SOLVERS[solver][0]),
            regularization=l2, regularization_weight=lam)

    kw.setdefault("coordinate_descent_iterations", 2)
    return jcfg.GameTrainingConfig(
        task_type=jtypes.TaskType.LOGISTIC_REGRESSION,
        coordinate_update_sequence=("fixed", "per_user"),
        fixed_effect_coordinates={"fixed": jcfg.FixedEffectCoordinateConfig("global", opt("LBFGS", 1.0))},
        random_effect_coordinates={"per_user": jcfg.RandomEffectCoordinateConfig(
            "userId", "per_user", opt(solver, 1.0), bucket_target_count=1, bucket_max_padded_ratio=1e6)},
        feature_shards={
            "global": jcfg.FeatureShardConfig(feature_bags=("features",), has_intercept=True),
            "per_user": jcfg.FeatureShardConfig(feature_bags=("userFeatures",), has_intercept=False),
        },
        evaluators=tuple(EVALUATORS),
        output_mode=jtypes.ModelOutputMode.ALL,
        regularization_weight_grid={"fixed": (0.1, 10.0)},
        **kw,
    )


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("game-avro")
    data = synthetic_game_data(np.random.default_rng(42), 460, d_fixed=3, effects={"userId": (8, 2)})
    os.makedirs(root / "train")
    _write(str(root / "train" / "part-00000.avro"), data, 0, 200)
    _write(str(root / "train" / "part-00001.avro"), data, 200, 300)
    _write(str(root / "val.avro"), data, 300, 400)
    _write(str(root / "new.avro"), data, 400, 460, users_offset=3)  # 3 users no model has
    return root


@pytest.fixture(scope="module", params=list(SOLVERS))
def trained(request, data_dir, tmp_path_factory):
    """Both packages' training runs on the same files, into separate dirs."""
    solver = request.param
    out = tmp_path_factory.mktemp(f"out-{solver}")
    cfg = _config(solver)
    train, val = [str(data_dir / "train")], [str(data_dir / "val.avro")]
    ref_best = ref_train.run(cfg, train, str(out / "ref"), validation_data=val, logger=_quiet(JLogger))
    port_best = port_train.run(parse_config(cfg.to_dict()), train, str(out / "port"), validation_data=val,
                               logger=_quiet(PhotonLogger), device="cpu")
    return dict(solver=solver, out=out, cfg=cfg, ref_best=ref_best, port_best=port_best)


def _metrics(path):
    with open(os.path.join(path, "metrics.json")) as f:
        return json.load(f)


def _listing(root) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _load(out_dir, sub="best"):
    maps = {f[:-4]: IndexMap.load(os.path.join(out_dir, "index-maps", f))
            for f in os.listdir(os.path.join(out_dir, "index-maps"))}
    with open(os.path.join(out_dir, "entity-maps.json")) as f:
        ent = json.load(f)
    return load_game_model(os.path.join(out_dir, sub), index_maps=maps,
                           entity_ids={"per_user": ent["userId"]}, device="cpu")


def test_metrics_and_best_index_match(trained):
    ref, port = _metrics(trained["out"] / "ref"), _metrics(trained["out"] / "port")
    assert port.keys() == ref.keys() == {"results", "best_index"}
    assert port["best_index"] == ref["best_index"]
    assert len(port["results"]) == len(ref["results"]) == 2
    for got, want in zip(port["results"], ref["results"]):
        assert got["configuration"] == want["configuration"]
        assert got["metrics"].keys() == want["metrics"].keys() == set(EVALUATORS)
        for k, v in want["metrics"].items():
            assert abs(got["metrics"][k] - v) <= 1e-3
    assert trained["port_best"].configuration["fixed"].regularization_weight == \
        trained["ref_best"].configuration["fixed"].regularization_weight


def test_outputs_are_the_reference_files(trained):
    ref_dir, port_dir = trained["out"] / "ref", trained["out"] / "port"
    assert _listing(port_dir) == _listing(ref_dir)
    for sub in ("best", "models/0000", "models/0001"):
        assert (port_dir / sub / "metadata.json").read_text() == (ref_dir / sub / "metadata.json").read_text()
    assert json.loads((port_dir / "entity-maps.json").read_text()) == \
        json.loads((ref_dir / "entity-maps.json").read_text())
    for f in os.listdir(ref_dir / "index-maps"):
        assert list(IndexMap.load(str(port_dir / "index-maps" / f)).items()) == \
            list(IndexMap.load(str(ref_dir / "index-maps" / f)).items())


def test_best_and_grid_models_match(trained):
    tol = SOLVERS[trained["solver"]][1]
    for sub in ("best", "models/0000", "models/0001"):
        got, want = _load(trained["out"] / "port", sub), _load(trained["out"] / "ref", sub)
        for cid in ("fixed", "per_user"):
            np.testing.assert_allclose(got[cid].coefficient_means.numpy(),
                                       want[cid].coefficient_means.numpy(), **tol)


@pytest.mark.parametrize("lam", [0.1, 10.0])
def test_fixed_effect_stop_at_1e7_is_float32_rounding(data_dir, lam):
    """Why the Newton case runs at 1e-3: the drivers' first fixed-effect
    solve (the global shard read from the Avro files, zero offsets, L-BFGS
    at tolerance 1e-7) in both packages. In float64 the two trajectories are
    the same to 1e-12 and stop GRADIENT_CONVERGED at the same iteration. In
    float32 both stop LINE_SEARCH_FAILED, where the last trial step leaves f
    unchanged in float32, and the objectives there lie one float32 ulp
    apart, so the iteration at the stop may differ by one."""
    cfg = parse_config(_config("LBFGS").to_dict())
    ds = AvroDataReader(cfg.feature_shards).read([str(data_dir / "train")], id_tags=["userId"],
                                                 device="cpu")
    X, y = ds.batch.features["global"].X.numpy(), ds.batch.labels.numpy()
    ii = ds.intercept_indices["global"]
    (n, d), kw = X.shape, dict(max_iterations=30, tolerance=1e-7)
    got = {}
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        jobj = j_make_objective(
            JDense(jnp.asarray(X, jd), jnp.asarray(y, jd), jnp.zeros(n, jd), jnp.ones(n, jd)),
            j_loss_for_task(jtypes.TaskType.LOGISTIC_REGRESSION), l2_weight=lam, intercept_index=ii)
        tobj = make_objective(
            DenseBatch(torch.tensor(X, dtype=td), torch.tensor(y, dtype=td),
                       torch.zeros(n, dtype=td), torch.ones(n, dtype=td)),
            loss_for_task(TaskType.LOGISTIC_REGRESSION), l2_weight=lam, intercept_index=ii,
            norm=NormalizationContext(torch.ones(d, dtype=td), torch.zeros(d, dtype=td), ii),
            device="cpu")
        got[td] = (j_lbfgs(jobj, jnp.zeros(d, jd), jcfg.OptimizerConfig(**kw)),
                   lbfgs_minimize(tobj, torch.zeros(d, dtype=td), OptimizerConfig(**kw)))
    rj, rt = got[torch.float64]
    assert int(rj.reason) == rt.reason == ConvergenceReason.GRADIENT_CONVERGED
    assert int(rj.iterations) == rt.iterations
    np.testing.assert_allclose(rt.w.numpy(), np.asarray(rj.w), rtol=0, atol=1e-12)
    rj, rt = got[torch.float32]
    assert int(rj.reason) == rt.reason == ConvergenceReason.LINE_SEARCH_FAILED
    assert abs(int(rj.iterations) - rt.iterations) <= 1
    f_ref = np.float32(rj.loss_history[int(rj.iterations)])
    f_port = np.float32(rt.loss_history[rt.iterations].item())
    assert abs(f_ref - f_port) <= np.spacing(f_ref), (f_ref, f_port)


@pytest.fixture(scope="module")
def cross_scored(trained, data_dir):
    """Each package's scoring driver on each package's training output."""
    out, shards = trained["out"], dict(trained["cfg"].feature_shards)
    port_shards = dict(parse_config(trained["cfg"].to_dict()).feature_shards)
    data = [str(data_dir / "val.avro")]
    runs = {}
    for model in ("ref", "port"):
        ref_score.run(str(out / model), data, str(out / f"score-{model}-by-ref"), evaluators=EVALUATORS,
                      feature_shards=shards, logger=_quiet(JLogger))
        port_score.run(str(out / model), data, str(out / f"score-{model}-by-port"), evaluators=EVALUATORS,
                       feature_shards=port_shards, logger=_quiet(PhotonLogger), device="cpu")
        runs[model] = {
            by: read_avro_file(str(out / f"score-{model}-by-{by}" / "scores" / "part-00000.avro"))[1]
            for by in ("ref", "port")
        }
    return runs


@pytest.mark.parametrize("model", ["ref", "port"])
def test_each_scorer_scores_the_others_model(trained, cross_scored, model):
    got, want = cross_scored[model]["port"], cross_scored[model]["ref"]
    assert [r["uid"] for r in got] == [r["uid"] for r in want] == [f"s{i}" for i in range(300, 400)]
    assert [r["label"] for r in got] == [r["label"] for r in want]
    np.testing.assert_allclose([r["predictionScore"] for r in got],
                               [r["predictionScore"] for r in want], rtol=0, atol=1e-5)
    m_port = _metrics(trained["out"] / f"score-{model}-by-port")
    m_ref = _metrics(trained["out"] / f"score-{model}-by-ref")
    assert m_port.keys() == m_ref.keys() == set(EVALUATORS)
    for k in EVALUATORS:
        assert abs(m_port[k] - m_ref[k]) <= 1e-6
    # the scoring run's AUC is the training run's for its best entry
    best = _metrics(trained["out"] / model)
    assert abs(m_port["AUC"] - best["results"][best["best_index"]]["metrics"]["AUC"]) <= 1e-6


def test_rerun_resumes_from_checkpoints(trained, data_dir, tmp_path):
    out = tmp_path / "port"
    shutil.copytree(trained["out"] / "port", out)
    log = io.StringIO()
    port_train.run(parse_config(trained["cfg"].to_dict()), [str(data_dir / "train")], str(out),
                   validation_data=[str(data_dir / "val.avro")], logger=PhotonLogger(None, stream=log),
                   device="cpu")
    assert log.getvalue().count("resuming coordinate descent from checkpoint at outer iteration 2") == 2
    assert "coordinate per_user" not in log.getvalue()  # nothing retrained
    assert _metrics(out) == _metrics(trained["out"] / "port")


def test_warm_start_from_model_input_dir(trained, data_dir, tmp_path):
    """Both packages warm-start from the reference's best model on data with
    new users (their rows start at zero) and train one more iteration."""
    cfg = _config(trained["solver"], coordinate_descent_iterations=1,
                  model_input_dir=str(trained["out"] / "ref" / "best"))
    data = [str(data_dir / "train"), str(data_dir / "new.avro")]
    ref_train.run(cfg, data, str(tmp_path / "ref"), logger=_quiet(JLogger))
    port_train.run(parse_config(cfg.to_dict()), data, str(tmp_path / "port"), logger=_quiet(PhotonLogger),
                   device="cpu")
    ent = json.loads((tmp_path / "port" / "entity-maps.json").read_text())
    assert ent == json.loads((tmp_path / "ref" / "entity-maps.json").read_text())
    assert len(ent["userId"]) == 11  # 8 from the warm-start run, 3 appended
    got, want = _load(tmp_path / "port"), _load(tmp_path / "ref")
    for cid in ("fixed", "per_user"):
        np.testing.assert_allclose(got[cid].coefficient_means.numpy(), want[cid].coefficient_means.numpy(),
                                   **SOLVERS[trained["solver"]][1])


@pytest.fixture
def config_file(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(_config("LBFGS", coordinate_descent_iterations=1).to_dict()))
    return path


@pytest.mark.parametrize("flags,item", [
    (["--streaming-chunk-rows", "1000", "--profile-dir", "p"], "item 13"),
    # --multihost is ported in memory and out of core: outside a process
    # group it raises the initialization error
    # (tests/test_torch_multihost_game_streaming.py runs it)
    pytest.param(["--multihost", "--streaming-chunk-rows", "1000"], "multihost initialization failed",
                 id="flags1-item 12"),
    (["--profile-dir", "p"], "item 13"),
    (["--telemetry-dir", "t"], "item 13"),
])
def test_unported_train_flags_raise(tmp_path, data_dir, config_file, flags, item, monkeypatch):
    """``--multihost`` outside a process group raises; ``--profile-dir``
    and ``--telemetry-dir`` (ROADMAP item 13, ported) run and write a
    profiler trace of the fit, or a valid telemetry run."""
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(tmp_path)  # the flags' directories are relative
    argv = ["--config", str(config_file), "--train-data", str(data_dir / "train"),
            "--validation-data", str(data_dir / "val.avro"),  # the streamed grid selects by it
            "--output-dir", str(tmp_path / "out"), "--device", "cpu", *flags]
    if "--multihost" in flags:
        with pytest.raises(RuntimeError, match=item):
            port_train.main(argv)
        return
    port_train.main(argv)
    assert (tmp_path / "out" / "best").is_dir()
    _assert_item_13_outputs(tmp_path, flags, "streamed-game" if "--streaming-chunk-rows" in flags else "grid-fit",
                            "train/grid-fit" if "--streaming-chunk-rows" not in flags else "train/streamed-descent")


def _assert_item_13_outputs(tmp_path, flags, trace_label, span_name):
    from photon_ml_tpu_torch.obs.report import load_run, validate_run

    if "--profile-dir" in flags:
        assert (tmp_path / "p" / trace_label / "trace.json").stat().st_size > 0
    if "--telemetry-dir" in flags:
        (run,) = [f for f in os.listdir(tmp_path / "t") if f.endswith(".jsonl")]
        records = load_run(str(tmp_path / "t" / run))
        assert validate_run(records) == []
        assert span_name in {r["name"] for r in records if r["event"] == "span"}


def test_tuning_and_auto_streaming_raise(tmp_path, data_dir, config_file, monkeypatch):
    """Tuning without validation data raises the reference's ValueError;
    an input over the device budget selects the out-of-core trainer (chunks
    of 2^20 rows), unless --no-auto-streaming."""
    cfg = parse_config(_config("LBFGS", hyperparameter_tuning_iters=2).to_dict())
    with pytest.raises(ValueError, match="hyperparameter tuning requires validation data"):
        port_train.run(cfg, [str(data_dir / "train")], str(tmp_path / "a"), logger=_quiet(PhotonLogger),
                       device="cpu")
    with pytest.raises(ValueError, match="hyperparameter tuning requires validation data"):
        ref_train.run(_config("LBFGS", hyperparameter_tuning_iters=2), [str(data_dir / "train")],
                      str(tmp_path / "a-ref"), logger=_quiet(JLogger))
    monkeypatch.setattr(port_train, "hbm_budget_bytes", lambda dev: 100.0)
    argv = ["--config", str(config_file), "--train-data", str(data_dir / "train"),
            "--output-dir", str(tmp_path / "b"), "--device", "cpu"]
    port_train.main(argv)  # a grid without validation data cannot select by metric: in memory
    assert set(_metrics(tmp_path / "b")) == {"results", "best_index"}
    streamed = argv[:-4] + ["--output-dir", str(tmp_path / "c"), "--device", "cpu",
                            "--validation-data", str(data_dir / "val.avro")]
    port_train.main(streamed)
    assert _metrics(tmp_path / "c")["streaming_chunk_rows"] == 1 << 20
    port_train.main(argv + ["--no-auto-streaming"])  # in memory when asked
    assert _metrics(tmp_path / "b")["best_index"] in (0, 1)


@pytest.mark.parametrize("flags,item", [
    # --multihost is ported: outside a process group it raises the
    # initialization error (tests/test_torch_multihost_game.py runs it)
    pytest.param(["--multihost"], "multihost initialization failed", id="flags0-item 12"),
    (["--profile-dir", "p"], "item 13"),
    (["--telemetry-dir", "t"], "item 13"),
])
def test_unported_score_flags_raise(tmp_path, trained, data_dir, config_file, flags, item, monkeypatch):
    """``--multihost`` outside a process group raises; ``--profile-dir``
    and ``--telemetry-dir`` (ROADMAP item 13, ported) run and write a
    profiler trace of the scoring pass, or a valid telemetry run."""
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(tmp_path)  # the flags' directories are relative
    argv = ["--model-dir", str(trained["out"] / "port"), "--data", str(data_dir / "val.avro"),
            "--output-dir", str(tmp_path / "s"), "--config", str(config_file), "--device", "cpu", *flags]
    if "--multihost" in flags:
        with pytest.raises(RuntimeError, match=item):
            port_score.main(argv)
        return
    port_score.main(argv)
    assert os.listdir(tmp_path / "s" / "scores")
    _assert_item_13_outputs(tmp_path, flags, "score", "score/pass")


def test_drivers_need_cuda_unless_cpu_is_asked(tmp_path, trained, data_dir, config_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_train.main(["--config", str(config_file), "--train-data", str(data_dir / "train"),
                         "--output-dir", str(tmp_path / "t")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_score.main(["--model-dir", str(trained["out"] / "port"), "--data", str(data_dir / "val.avro"),
                         "--output-dir", str(tmp_path / "s")])
    port_score.main(["--model-dir", str(trained["out"] / "port"), "--data", str(data_dir / "val.avro"),
                     "--output-dir", str(tmp_path / "s"), "--config", str(config_file), "--device", "cpu"])
    scores = read_avro_file(str(tmp_path / "s" / "scores" / "part-00000.avro"))[1]
    assert len(scores) == 100 and not (tmp_path / "s" / "metrics.json").exists()
    assert ref_read(str(tmp_path / "s" / "scores" / "part-00000.avro"))[1] == scores


def test_date_ranges_and_prebuilt_index_maps(trained, data_dir, tmp_path):
    """``main`` with the training parts in daily directories (both layouts)
    and the reference's saved index maps: the same run as from the plain
    directory, bit for bit."""
    base = tmp_path / "base"
    for part, day in (("part-00000.avro", "daily/2024/02/28"), ("part-00001.avro", "2024-02-29")):
        os.makedirs(base / day)
        shutil.copy(data_dir / "train" / part, base / day / part)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(trained["cfg"].to_dict()))
    out = tmp_path / "out"
    port_train.main([
        "--config", str(cfg_path), "--train-data", str(base), "--train-date-range", "2024-02-27",
        "2024-03-01", "--validation-data", str(data_dir / "val.avro"),
        "--index-maps", str(trained["out"] / "ref" / "index-maps"), "--output-dir", str(out),
        "--device", "cpu",
    ])
    assert _metrics(out) == _metrics(trained["out"] / "port")
    got, want = _load(out), _load(trained["out"] / "port")
    for cid in ("fixed", "per_user"):
        np.testing.assert_array_equal(got[cid].coefficient_means.numpy(), want[cid].coefficient_means.numpy())
    assert (out / "photon.log").read_text().count("loaded index maps") == 1


def test_tuning_and_diagnostics_match_the_reference(data_dir, tmp_path):
    """``hyperparameter_tuning_iters`` = 2 and ``--diagnostics`` through both
    drivers on the same files (Newton random effects at tolerance 1e-3):
    the same files, the same four configurations (the grid's two, then the
    same two suggested λs) with metrics within 1e-3, the same best entry,
    its model within 1e-4, and diagnostics reports of the same shape."""
    cfg = _config("NEWTON_CHOLESKY", hyperparameter_tuning_iters=2)
    train, val = [str(data_dir / "train")], [str(data_dir / "val.avro")]
    ref_train.run(cfg, train, str(tmp_path / "ref"), validation_data=val, logger=_quiet(JLogger),
                  diagnostics=True)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    port_train.main(["--config", str(cfg_path), "--train-data", *train, "--validation-data", *val,
                     "--output-dir", str(tmp_path / "port"), "--diagnostics", "--device", "cpu"])
    ref, port = _metrics(tmp_path / "ref"), _metrics(tmp_path / "port")
    assert set(_listing(tmp_path / "port")) - {"photon.log"} == set(_listing(tmp_path / "ref"))
    assert {"diagnostics.json", "diagnostics.html", "models/0003/metadata.json"} <= set(_listing(tmp_path / "port"))
    assert len(port["results"]) == len(ref["results"]) == 4
    assert port["best_index"] == ref["best_index"]
    for got, want in zip(port["results"], ref["results"]):
        assert got["configuration"] == want["configuration"]
        for k, v in want["metrics"].items():
            assert abs(got["metrics"][k] - v) <= 1e-3
    got, want = _load(tmp_path / "port"), _load(tmp_path / "ref")
    for cid in ("fixed", "per_user"):
        np.testing.assert_allclose(got[cid].coefficient_means.numpy(), want[cid].coefficient_means.numpy(),
                                   atol=1e-4)
    got, want = (json.loads((tmp_path / d / "diagnostics.json").read_text()) for d in ("port", "ref"))
    assert got.keys() == want.keys() and got["config"] == want["config"]
    assert len(got["grid"]) == len(want["grid"]) == 4
    for g, w in zip(got["grid"], want["grid"]):
        assert g["configuration"] == w["configuration"]
        assert g["coordinates"].keys() == w["coordinates"].keys()
        for cid in g["coordinates"]:
            assert g["coordinates"][cid].keys() == w["coordinates"][cid].keys()
        assert len(g["validation_history"]) == len(w["validation_history"])
    assert "grid entry 3" in (tmp_path / "port" / "diagnostics.html").read_text()
