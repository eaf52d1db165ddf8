"""Multi-process GAME on the CPU: two processes join one gloo group over
loopback (each spawned with ``subprocess`` on a free port and killed after
120 s, as ``tests/test_torch_multihost.py`` does), each with two CPU
shards of a process-spanning data mesh.

Held to:
- ``exchange_rows``: each row reaches its destination, grouped by source in
  ascending order, an empty sender takes part, ``LAST_EXCHANGE_STATS``
  counts the payload; the identity on one process; ``allgather_rows``
  concatenates in rank order;
- ``GameEstimator`` over 2 processes × 2 shards: both ranks' models and
  training scores bitwise equal, and bitwise equal to one process × 4
  shards, validation metrics too;
- ``cli.train --multihost`` against the one-process driver on the same
  Avro files: the same best index, every model within rtol 1e-2 / atol
  1e-3 (the multi-process tolerance), process 0 alone writing, a rerun
  resuming every grid entry from process 0's checkpoints with the same
  model;
- ``cli.score --multihost``: one scores part per process whose union is
  the one-process score driver's scores of the same model (atol 1e-5),
  one ``metrics.json`` within 1e-6 of the one-process metrics;
- ``--multihost``, in memory or with ``--streaming-chunk-rows``, raising
  the initialization error without a process group, and the out-of-core
  trainer's fleet knobs raising naming ROADMAP item 12d.
"""

from __future__ import annotations

import io
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import photon_ml_tpu_torch.config as tcfg
import photon_ml_tpu_torch.types as ttypes
from photon_ml_tpu_torch.cli import score as port_score
from photon_ml_tpu_torch.cli import train as port_train
from photon_ml_tpu_torch.data.synthetic import synthetic_game_data
from photon_ml_tpu_torch.estimators import GameEstimator
from photon_ml_tpu_torch.game.data import make_game_batch
from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer
from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu_torch.parallel import data_mesh
from photon_ml_tpu_torch.parallel import multihost as mh
from photon_ml_tpu_torch.utils import PhotonLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120
EFFECTS = {"userId": (16, 3), "itemId": (6, 2)}
EVALUATORS = ["AUC", "BUCKETED_AUC", "MULTI_AUC(userId)"]
COEF_TOL = dict(rtol=1e-2, atol=1e-3)

_WORKER = textwrap.dedent(
    """
    import json, os, sys
    root, ports, rank, mode, work = sys.argv[1:6]
    rank, ports = int(rank), [int(p) for p in ports.split(",")]
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from photon_ml_tpu_torch.parallel import multihost as mh

    if mode == "library":
        from test_torch_multihost_game import estimator_fit
        from photon_ml_tpu_torch.parallel.mesh import process_mesh

        mh.initialize_multihost(f"127.0.0.1:{ports[0]}", 2, rank, timeout_s=100)
        out = {}
        rng = np.random.default_rng(rank)
        n = 7 if rank == 0 else 0  # process 1 sends nothing
        rows = {"gid": np.arange(n, dtype=np.int64) + 100 * rank,
                "x": rng.normal(size=(n, 3)).astype(np.float32)}
        got = mh.exchange_rows(rows, np.asarray([1, 0, 1, 1, 0, 1, 0])[:n], tag="test")
        out["ex_gid"], out["ex_x"] = got["gid"], got["x"]
        out["ex_sent"] = np.asarray([mh.LAST_EXCHANGE_STATS[k] for k in ("bytes_sent", "rows_sent", "padded_rows")])
        out["ex_transport"] = np.asarray(mh.LAST_EXCHANGE_STATS["transport"])
        # both send, to both
        got = mh.exchange_rows({"gid": np.asarray([10 * rank + 1, 10 * rank + 2], np.int64)}, np.asarray([1, 0]))
        out["ex2_gid"] = got["gid"]
        out["rows"] = mh.allgather_rows(np.arange(rank + 2, dtype=np.int64))
        mesh = process_mesh(2, devices=["cpu"])
        out.update(estimator_fit(mesh))
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
        mh.shutdown_multihost()
    else:
        from photon_ml_tpu_torch.cli import score, train
        with open(os.path.join(work, "argv.json")) as f:
            argv = json.load(f)
        for port, (cmd, args) in zip(ports, argv):
            os.environ.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
                              JAX_PROCESS_ID=str(rank))
            (train if cmd == "train" else score).main([a.replace("{rank}", str(rank)) for a in args])
    print("WORKER DONE", rank)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(mode: str, work, phases: int = 1) -> None:
    """Two workers of ``mode``, one fresh port per phase; each is killed
    after ``WORKER_TIMEOUT_S`` and a failure or timeout fails the caller."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")}
    env["OMP_NUM_THREADS"] = "1"
    ports = ",".join(str(_free_port()) for _ in range(phases))
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, ROOT, ports, str(rank), mode, str(work)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
        for rank in range(2)
    ]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0 and f"WORKER DONE {rank}" in out, f"worker {rank} failed (rc {rc}):\n{out}\n{err[-4000:]}"


# ---------------------------------------------------------------------------
# the library: exchange_rows and the estimator
# ---------------------------------------------------------------------------
def _config(iterations: int = 2, grid: tuple = ()) -> tcfg.GameTrainingConfig:
    def opt(solver, lam):
        return tcfg.OptimizationConfig(
            optimizer=tcfg.OptimizerConfig(optimizer_type=ttypes.OptimizerType(solver), max_iterations=30,
                                           tolerance=1e-7),
            regularization=tcfg.RegularizationContext(ttypes.RegularizationType.L2), regularization_weight=lam)

    return tcfg.GameTrainingConfig(
        task_type=ttypes.TaskType.LOGISTIC_REGRESSION,
        coordinate_update_sequence=("fixed", "per_user", "per_item"),
        coordinate_descent_iterations=iterations,
        fixed_effect_coordinates={"fixed": tcfg.FixedEffectCoordinateConfig("global", opt("LBFGS", 0.1))},
        random_effect_coordinates={
            "per_user": tcfg.RandomEffectCoordinateConfig("userId", "per_user", opt("NEWTON_CHOLESKY", 1.0),
                                                          bucket_target_count=4, bucket_max_padded_ratio=0.5),
            "per_item": tcfg.RandomEffectCoordinateConfig("itemId", "per_item", opt("LBFGS", 1.0)),
        },
        feature_shards={
            "global": tcfg.FeatureShardConfig(feature_bags=("features",), has_intercept=True),
            "per_user": tcfg.FeatureShardConfig(feature_bags=("userFeatures",), has_intercept=False),
            "per_item": tcfg.FeatureShardConfig(feature_bags=("itemFeatures",), has_intercept=False),
        },
        evaluators=tuple(EVALUATORS),
        output_mode=ttypes.ModelOutputMode.ALL,
        regularization_weight_grid={"fixed": grid} if grid else {},
    )


def _library_data():
    data = synthetic_game_data(5, 701, 4, EFFECTS, device="cpu")
    feats = {"global": data.X, "per_user": data.entity_X["userId"], "per_item": data.entity_X["itemId"]}
    return data, make_game_batch(data.y, feats, id_tags=data.entity_ids, device="cpu")


def estimator_fit(mesh) -> dict:
    """The library fit every process (and the one-process twin) runs: the
    same seeded batch on the host, over ``mesh``."""
    data, batch = _library_data()
    res = GameEstimator(_config(), intercept_indices={"global": data.intercept_index}, device="cpu",
                        mesh=mesh).fit(batch, validation_batch=batch)[0]
    out = {f"w_{cid}": sub.coefficient_means.numpy() for cid, sub in res.model.models.items()}
    out.update({f"score_{cid}": s.numpy() for cid, s in res.descent.training_scores.items()})
    out["metrics"] = np.asarray([res.evaluation.metrics[m] for m in EVALUATORS])
    return out


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    work = tmp_path_factory.mktemp("multihost_game_library")
    _spawn("library", work)
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(2)]


def test_exchange_rows_routes_by_destination_in_source_order(library):
    sent = np.arange(7, dtype=np.int64)
    dest = np.asarray([1, 0, 1, 1, 0, 1, 0])
    x = np.random.default_rng(0).normal(size=(7, 3)).astype(np.float32)
    for rank, r in enumerate(library):
        np.testing.assert_array_equal(r["ex_gid"], sent[dest == rank])
        np.testing.assert_array_equal(r["ex_x"], x[dest == rank])
        assert str(r["ex_transport"]) == "gloo"
    # process 0 sent 7 rows of (8 + 12) bytes, process 1 none: an empty sender takes part
    np.testing.assert_array_equal(library[0]["ex_sent"], [7 * 20, 7, 14])
    np.testing.assert_array_equal(library[1]["ex_sent"], [0, 0, 0])
    # grouped by source, ascending
    np.testing.assert_array_equal(library[0]["ex2_gid"], [2, 12])
    np.testing.assert_array_equal(library[1]["ex2_gid"], [1, 11])
    for r in library:
        np.testing.assert_array_equal(r["rows"], [0, 1, 0, 1, 2])


def test_exchange_rows_and_allgather_rows_on_one_process():
    rows = {"gid": np.arange(4), "x": np.ones((4, 2), np.float32)}
    out = mh.exchange_rows(rows, np.zeros(4, np.int64))
    assert all(out[k] is rows[k] or np.array_equal(out[k], rows[k]) for k in rows)
    assert mh.LAST_EXCHANGE_STATS == dict(bytes_sent=0, rows_sent=4, padded_rows=4, transport="local")
    a = np.arange(3)
    np.testing.assert_array_equal(mh.allgather_rows(a), a)
    b, c = mh.allgather_rows(a, a + 1)
    np.testing.assert_array_equal(c, a + 1)


def test_estimator_across_processes_is_bitwise_one_process_over_four_shards(library):
    one = estimator_fit(data_mesh(4, devices=["cpu"] * 4))
    for key, value in one.items():
        assert library[0][key].tobytes() == library[1][key].tobytes(), key
        assert library[0][key].tobytes() == value.tobytes(), key


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------
def _schema():
    schema = json.loads(json.dumps(TRAINING_EXAMPLE_SCHEMA))
    for i, bag in enumerate(("userFeatures", "itemFeatures")):
        schema["fields"].insert(5 + i, {"name": bag, "type": {"type": "array", "items": "NameTermValueAvro"},
                                        "default": []})
    return schema


def _write(path, data, lo, hi):
    def bag(name, X, i):
        return [{"name": name, "term": str(j), "value": float(X[i, j])} for j in range(X.shape[1])]

    X, Xu, Xi = (t.numpy() for t in (data.X, data.entity_X["userId"], data.entity_X["itemId"]))
    recs = [{"uid": f"s{i}", "response": float(data.y[i]), "offset": None, "weight": None,
             "features": bag("g", X[:, :-1], i), "userFeatures": bag("u", Xu, i), "itemFeatures": bag("i", Xi, i),
             "metadataMap": {"userId": f"user_{int(data.entity_ids['userId'][i])}",
                             "itemId": f"item_{int(data.entity_ids['itemId'][i])}"}}
            for i in range(lo, hi)]
    write_avro_file(path, _schema(), recs)


def _models(out_dir) -> dict:
    """Every saved model's coefficients by (coordinate, name, term, entity)."""
    found = {}
    for root, _, files in os.walk(out_dir):
        for fn in files:
            if fn.endswith(".avro") and ("best" in root or "models" in root):
                rel = os.path.relpath(os.path.join(root, fn), out_dir)
                for rec in read_avro_file(os.path.join(root, fn))[1]:
                    for m in rec["means"]:
                        found[(rel, rec.get("modelId"), m["name"], m["term"])] = m["value"]
    return found


def _scores(score_dir) -> dict:
    out = {}
    for fn in sorted(os.listdir(score_dir / "scores")):
        for rec in read_avro_file(str(score_dir / "scores" / fn))[1]:
            out[rec["uid"]] = rec["predictionScore"]
    return out


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """Two ``--multihost`` processes: the train driver, the same command
    again (a resume), the score driver; then the one-process drivers on the
    same files."""
    work = tmp_path_factory.mktemp("multihost_game_drivers")
    data = synthetic_game_data(6, 560, 4, EFFECTS, device="cpu")
    for d in ("train", "val"):
        (work / d).mkdir()
    _write(str(work / "train" / "part-00000.avro"), data, 0, 230)
    _write(str(work / "train" / "part-00001.avro"), data, 230, 400)
    _write(str(work / "val" / "part-00000.avro"), data, 400, 470)
    _write(str(work / "val" / "part-00001.avro"), data, 470, 560)
    (work / "config.json").write_text(json.dumps(_config(grid=(0.1, 10.0)).to_dict()))
    train = ["--config", str(work / "config.json"), "--train-data", str(work / "train"),
             "--validation-data", str(work / "val"), "--device", "cpu", "--multihost"]
    score = ["--data", str(work / "val"), "--evaluators", *EVALUATORS, "--config", str(work / "config.json"),
             "--device", "cpu", "--multihost"]
    argv = [("train", train + ["--output-dir", str(work / "out{rank}")]),
            ("train", train + ["--output-dir", str(work / "out{rank}")]),
            ("score", score + ["--model-dir", str(work / "out0"), "--output-dir", str(work / "score{rank}")])]
    (work / "argv.json").write_text(json.dumps(argv[:1]))
    _spawn("driver", work)
    first = {"models": _models(work / "out0"), "metrics": json.loads((work / "out0" / "metrics.json").read_text()),
             "out1": sorted(p.name for p in (work / "out1").iterdir()) if (work / "out1").exists() else [],
             "ckpt_mtime": (work / "out0" / "checkpoints" / "config-0000" / "ckpt.npz").stat().st_mtime_ns}
    (work / "argv.json").write_text(json.dumps(argv[1:]))
    _spawn("driver", work, phases=2)
    logger = PhotonLogger(None, stream=io.StringIO())
    port_train.run(_config(grid=(0.1, 10.0)), [str(work / "train")], str(work / "one"),
                   validation_data=[str(work / "val")], logger=logger, device="cpu")
    # the one-process score driver on the model the processes scored
    port_score.run(str(work / "out0"), [str(work / "val")], str(work / "one_score"), evaluators=EVALUATORS,
                   feature_shards=dict(_config().feature_shards), logger=logger, device="cpu")
    return work, first


def test_train_driver_multihost_matches_the_one_process_driver(drivers):
    work, first = drivers
    one = json.loads((work / "one" / "metrics.json").read_text())
    assert first["metrics"]["best_index"] == one["best_index"]
    for got, want in zip(first["metrics"]["results"], one["results"]):
        assert got["configuration"] == want["configuration"]
        for name, value in want["metrics"].items():
            assert abs(got["metrics"][name] - value) <= 1e-3, name
    models = _models(work / "one")
    assert set(first["models"]) == set(models) and any(k[0].startswith("models") for k in models)
    for key, value in models.items():
        np.testing.assert_allclose(first["models"][key], value, err_msg=str(key), **COEF_TOL)


def test_train_driver_multihost_writes_on_process_0_only(drivers):
    work, first = drivers
    assert (work / "out0" / "best").is_dir() and (work / "out0" / "entity-maps.json").exists()
    assert (work / "out0" / "checkpoints" / "config-0001" / "ckpt.npz").exists()
    assert first["out1"] == []  # process 1 logs to stderr and writes nothing
    assert "multihost runtime" in (work / "out0" / "photon.log").read_text()


def test_train_driver_multihost_rerun_resumes_from_process_0_checkpoints(drivers):
    work, first = drivers
    log = (work / "out0" / "photon.log").read_text()
    assert log.count("resuming coordinate descent from checkpoint at outer iteration 2") == 2
    rerun = _models(work / "out0")
    assert set(rerun) == set(first["models"])
    for key, value in first["models"].items():
        assert rerun[key] == value, key


def test_score_driver_multihost_writes_a_part_a_process_and_one_metrics_file(drivers):
    work, _ = drivers
    parts = [sorted(os.listdir(work / f"score{r}" / "scores")) for r in range(2)]
    assert parts == [["part-00000.avro"], ["part-00001.avro"]]
    got = {**_scores(work / "score0"), **_scores(work / "score1")}
    want = _scores(work / "one_score")
    assert sorted(got) == sorted(want) and len(want) == 160
    np.testing.assert_allclose([got[u] for u in sorted(want)], [want[u] for u in sorted(want)], atol=1e-5)
    assert (work / "score0" / "metrics.json").exists() and not (work / "score1" / "metrics.json").exists()
    metrics = json.loads((work / "score0" / "metrics.json").read_text())
    one = json.loads((work / "one_score" / "metrics.json").read_text())
    assert list(metrics) == list(one) == EVALUATORS
    for name, value in one.items():
        assert abs(metrics[name] - value) <= 1e-6, name


def test_multihost_refuses_streaming_and_needs_a_process_group(tmp_path, monkeypatch):
    """Out of core too, ``--multihost`` needs a process group (it runs in
    tests/test_torch_multihost_game_streaming.py); the fleet knobs still
    raise, naming ROADMAP item 12d."""
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    (tmp_path / "config.json").write_text(json.dumps(_config().to_dict()))
    base = ["--config", str(tmp_path / "config.json"), "--train-data", str(tmp_path / "t"), "--device", "cpu",
            "--output-dir", str(tmp_path / "o"), "--multihost"]
    with pytest.raises(RuntimeError, match="multihost initialization failed"):
        port_train.main(base + ["--streaming-chunk-rows", "64"])
    with pytest.raises(RuntimeError, match="multihost initialization failed"):
        port_train.run(_config(), [str(tmp_path / "t")], str(tmp_path / "o"), streaming_chunk_rows=64,
                       multihost=True, device="cpu")
    with pytest.raises(RuntimeError, match="multihost initialization failed"):
        StreamedGameTrainer(_config(), multihost=True, device="cpu")
    data, _ = _library_data()
    streamed = StreamedGameData(labels=data.y, features={"global": data.X, "per_user": data.entity_X["userId"],
                                                         "per_item": data.entity_X["itemId"]},
                                id_tags={k: v.numpy() for k, v in data.entity_ids.items()})
    for knob in ("PHOTON_RE_SHARD", "PHOTON_RE_PROJECT", "PHOTON_RE_DEVICE_SPLIT"):
        monkeypatch.setenv(knob, "1")
        with pytest.raises(NotImplementedError, match="item 12d"):
            StreamedGameTrainer(_config(), chunk_rows=256, device="cpu").fit(streamed)
        monkeypatch.delenv(knob)
    with pytest.raises(RuntimeError, match="multihost initialization failed"):
        port_train.main(base)
    with pytest.raises(RuntimeError, match="multihost initialization failed"):
        port_train.run(_config(), [str(tmp_path / "t")], str(tmp_path / "o"), multihost=True, device="cpu")
    with pytest.raises(RuntimeError, match="multihost initialization failed"):
        port_score.main(["--model-dir", str(tmp_path), "--data", str(tmp_path / "t"), "--output-dir",
                         str(tmp_path / "s"), "--device", "cpu", "--multihost"])
    with pytest.raises(RuntimeError, match="multihost initialization failed"):
        port_score.run(str(tmp_path), [str(tmp_path / "t")], str(tmp_path / "s"), multihost=True, device="cpu")
    assert not torch.distributed.is_initialized()
