"""The multi-process out-of-core GAME trainer on the CPU: two processes join
one gloo group over loopback (each spawned with ``subprocess`` on a free
port and killed after 120 s, as ``tests/test_torch_multihost_game.py``
does), each holding half of the rows.

The fixture is the reference test's (``tests/test_multihost.py``
``test_two_process_streamed_game_matches_single``): a fixed effect, a
per-user random effect and a validation-only ``queryId`` grouping tag,
from ``synthetic_game_data``. Held to:
- ``StreamedGameTrainer(multihost=True)``: both ranks' models and
  validation histories bitwise equal; against the port's one-process
  trainer on all rows and against the JAX package's, at the reference's
  tolerances (fixed coefficients rtol 1e-3 / atol 1e-4, entity rows rtol
  5e-3 / atol 1e-3, validation AUC and grouped metrics within 5e-3);
- the per-visit exchanges moving each process's own rows only
  (``LAST_EXCHANGE_STATS``, as the reference's traffic test reads it);
- sharded checkpoints (the reference's file names): a fit stopped after
  its first outer iteration and resumed is bitwise the uninterrupted fit;
  a score file of another visit, or a torn one, is a miss; gathered
  checkpoints resume bitwise too; the JAX package's trainer accepts the
  port's score file with the same fingerprint and digest;
- a process with no rows taking part, its model the one-process fit's,
  in the library and in the driver (one training file for two
  processes); the reader's ``allow_empty`` on both decoders;
- ``cli.train --multihost --streaming-chunk-rows`` against the
  one-process streamed driver on the same Avro files: the same best
  index, models within rtol 1e-2 / atol 1e-3 (after 2 outer iterations,
  and after a rerun at 3 that resumes every grid entry from the sharded
  checkpoints, bitwise an uninterrupted 3-iteration run), process 0 alone
  writing (process 1 only its score files); auto-streaming by input size
  under ``--multihost``.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import photon_ml_tpu_torch.config as tcfg
import photon_ml_tpu_torch.types as ttypes
from photon_ml_tpu_torch.cli import train as port_train
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.data.synthetic import synthetic_game_data
from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer
from photon_ml_tpu_torch.io.avro import write_avro_file
from photon_ml_tpu_torch.io.data_reader import AvroDataReader
from photon_ml_tpu_torch.io.model_io import load_game_model
from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu_torch.parallel import multihost as mh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120
CHUNK = 64
N_TRAIN, N_VAL = 400, 120
EVALUATORS = ("AUC", "MULTI_AUC(queryId)", "PRECISION_AT_K(2,userId)")
FIXED_TOL = dict(rtol=1e-3, atol=1e-4)
ENTITY_TOL = dict(rtol=5e-3, atol=1e-3)
METRIC_TOL = 5e-3
DRIVER_TOL = dict(rtol=1e-2, atol=1e-3)

_WORKER = textwrap.dedent(
    """
    import json, os, sys
    root, ports, rank, mode, work = sys.argv[1:6]
    rank, ports = int(rank), [int(p) for p in ports.split(",")]
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import torch
    torch.set_num_threads(1)
    import test_torch_multihost_game_streaming as t

    (t.library_worker if mode == "library" else t.driver_worker)(rank, ports, work)
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
# the fixture
# ---------------------------------------------------------------------------
def _config(iterations: int = 2, grid: tuple = ()) -> tcfg.GameTrainingConfig:
    opt = tcfg.OptimizationConfig(
        optimizer=tcfg.OptimizerConfig(max_iterations=40, tolerance=1e-8),
        regularization=tcfg.RegularizationContext(ttypes.RegularizationType.L2), regularization_weight=1.0)
    return tcfg.GameTrainingConfig(
        task_type=ttypes.TaskType.LOGISTIC_REGRESSION,
        coordinate_update_sequence=("fixed", "per_user"),
        coordinate_descent_iterations=iterations,
        fixed_effect_coordinates={"fixed": tcfg.FixedEffectCoordinateConfig("global", opt)},
        random_effect_coordinates={"per_user": tcfg.RandomEffectCoordinateConfig("userId", "per_user", opt)},
        feature_shards={
            "global": tcfg.FeatureShardConfig(feature_bags=("features",), has_intercept=True),
            "per_user": tcfg.FeatureShardConfig(feature_bags=("userFeatures",), has_intercept=False),
        },
        evaluators=EVALUATORS,
        regularization_weight_grid={"fixed": grid} if grid else {},
    )


def _arrays() -> dict:
    """The seeded rows: the first ``N_TRAIN`` train, the rest validate; a
    query groups 6 consecutive validation rows, and every 17th validation
    row's user is unseen (-1)."""
    data = synthetic_game_data(np.random.default_rng(11), N_TRAIN + N_VAL, 3, {"userId": (10, 2)})
    users = np.asarray(data.entity_ids["userId"], np.int64).copy()
    users[N_TRAIN::17] = -1
    return {"X": np.asarray(data.X, np.float32), "Xu": np.asarray(data.entity_X["userId"], np.float32),
            "y": np.asarray(data.y, np.float32), "users": users,
            "queries": np.arange(N_TRAIN + N_VAL, dtype=np.int64) // 6 - N_TRAIN // 6}


def _data(a: dict, lo: int, hi: int, validation: bool = False) -> StreamedGameData:
    tags = {"userId": a["users"][lo:hi]}
    if validation:
        tags["queryId"] = a["queries"][lo:hi]
    return StreamedGameData(labels=a["y"][lo:hi], features={"global": a["X"][lo:hi], "per_user": a["Xu"][lo:hi]},
                            id_tags=tags)


def _split(a: dict, rank: int, empty_rank: int | None = None) -> tuple[StreamedGameData, StreamedGameData]:
    """This rank's training and validation rows: contiguous halves, or all
    of them on rank 0 and none on ``empty_rank``."""
    def part(lo, hi):
        if empty_rank is not None:
            return (hi, hi) if rank == empty_rank else (lo, hi)
        mid = (lo + hi) // 2
        return (lo, mid) if rank == 0 else (mid, hi)

    return _data(a, *part(0, N_TRAIN)), _data(a, *part(N_TRAIN, N_TRAIN + N_VAL), validation=True)


def _trainer(iterations: int, **kw) -> StreamedGameTrainer:
    return StreamedGameTrainer(_config(iterations), chunk_rows=CHUNK, intercept_indices={"global": 3},
                               evaluators=EVALUATORS, device="cpu", **kw)


def _model_arrays(model, prefix: str) -> dict:
    return {f"{prefix}{cid}": sub.coefficient_means.numpy() for cid, sub in model.models.items()}


def _history(trainer) -> list:
    return [{cid: dict(res.metrics) for cid, res in entry.items()} for entry in trainer.validation_history]


def library_worker(rank: int, ports: list, work: str) -> None:
    """One process of the library runs: the main fit with every exchange
    recorded, the checkpoint runs and the run with an empty process."""
    mh.initialize_multihost(f"127.0.0.1:{ports[0]}", 2, rank, timeout_s=100)
    a = dict(np.load(os.path.join(work, "arrays.npz")))
    train, val = _split(a, rank)
    arrays, out = {}, {"rank": rank, "n_train": train.num_rows}

    calls, real = [], mh.exchange_rows

    def recording(rows, dest, tag=""):
        got = real(rows, dest, tag=tag)
        calls.append(dict(mh.LAST_EXCHANGE_STATS, tag=tag, keys=len(rows)))
        return got

    mh.exchange_rows = recording
    t = _trainer(2, multihost=True)
    model, info = t.fit(train, validation=val)
    mh.exchange_rows = real
    arrays.update(_model_arrays(model, "main_"))
    out.update(calls=calls, history=_history(t), info={c: vars(i) for c, i in info.items()},
               visit_stats=t.visit_stats, exchange_totals=t.exchange_totals)

    # sharded checkpoints: stop after the first outer iteration, resume
    ck = os.path.join(work, "ck_sharded")
    _trainer(1, multihost=True, checkpoint_dir=ck).fit(train, validation=val)
    out["files_after_first"] = sorted(os.listdir(ck))
    first_shard = os.path.join(work, f"first-{rank}.npz")
    shutil.copy(os.path.join(ck, f"scores-shard-{rank:05d}.npz"), first_shard)
    resumed = _trainer(2, multihost=True, checkpoint_dir=ck)
    arrays.update(_model_arrays(resumed.fit(train, validation=val)[0], "resumed_"))
    out["resumed_from"] = resumed.resumed_from
    # a score file of another visit: the resume is refused on every process
    mh.sync_processes("test-before-stale")
    if rank == 1:
        shutil.copy(first_shard, os.path.join(ck, f"scores-shard-{rank:05d}.npz"))
    mh.sync_processes("test-stale")
    stale = _trainer(2, multihost=True, checkpoint_dir=ck)
    arrays.update(_model_arrays(stale.fit(train, validation=val)[0], "stale_"))
    out["stale_resumed_from"] = stale.resumed_from
    # a torn one likewise
    mh.sync_processes("test-before-torn")
    if rank == 0:
        with open(os.path.join(ck, "scores-shard-00000.npz"), "wb") as f:
            f.write(b"PK\x03\x04 torn")
    mh.sync_processes("test-torn")
    torn = _trainer(2, multihost=True, checkpoint_dir=ck)
    torn.fit(train, validation=val)
    out["torn_resumed_from"] = torn.resumed_from

    # gathered checkpoints
    ck2 = os.path.join(work, "ck_gathered")
    _trainer(1, multihost=True, checkpoint_dir=ck2, sharded_checkpoints=False).fit(train, validation=val)
    out["gathered_files"] = sorted(os.listdir(ck2)) if os.path.isdir(ck2) else []
    gathered = _trainer(2, multihost=True, checkpoint_dir=ck2, sharded_checkpoints=False)
    arrays.update(_model_arrays(gathered.fit(train, validation=val)[0], "gathered_"))
    out["gathered_resumed_from"] = gathered.resumed_from

    # every row on process 0, none on process 1
    train_e, val_e = _split(a, rank, empty_rank=1)
    empty = _trainer(2, multihost=True)
    arrays.update(_model_arrays(empty.fit(train_e, validation=val_e)[0], "empty_"))
    out["empty_history"] = _history(empty)
    mh.shutdown_multihost()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def fixture_arrays():
    return _arrays()


@pytest.fixture(scope="module")
def library(tmp_path_factory, fixture_arrays):
    work = tmp_path_factory.mktemp("multihost_streamed_library")
    np.savez(work / "arrays.npz", **fixture_arrays)
    _spawn("library", work)
    ranks = []
    for r in range(2):
        with open(work / f"rank{r}.json") as f:
            ranks.append(dict(json.load(f), arrays=dict(np.load(work / f"rank{r}.npz"))))
    return work, ranks


@pytest.fixture(scope="module")
def one_process(fixture_arrays):
    """The port's one-process streamed fit on every row."""
    a = fixture_arrays
    t = _trainer(2)
    model, _ = t.fit(_data(a, 0, N_TRAIN), validation=_data(a, N_TRAIN, N_TRAIN + N_VAL, validation=True))
    return _model_arrays(model, ""), _history(t)


def _assert_close_to(arrays: dict, prefix: str, want: dict) -> None:
    np.testing.assert_allclose(arrays[f"{prefix}fixed"], want["fixed"], **FIXED_TOL)
    np.testing.assert_allclose(arrays[f"{prefix}per_user"], want["per_user"], **ENTITY_TOL)


def _assert_histories_close(got: list, want: list) -> None:
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        (cg, mg), = g.items()
        (cw, mw), = w.items()
        assert cg == cw and list(mg) == list(mw) == list(EVALUATORS)
        for name in EVALUATORS:
            assert abs(mg[name] - mw[name]) <= METRIC_TOL, (cg, name, mg[name], mw[name])


def test_ranks_end_with_the_same_model_and_history(library):
    _, ranks = library
    for key, value in ranks[0]["arrays"].items():
        assert value.tobytes() == ranks[1]["arrays"][key].tobytes(), key
    assert ranks[0]["history"] == ranks[1]["history"]
    assert ranks[0]["info"] == ranks[1]["info"]
    assert [r["n_train"] for r in ranks] == [N_TRAIN // 2] * 2


def test_matches_the_port_one_process_trainer(library, one_process):
    _, ranks = library
    want, history = one_process
    _assert_close_to(ranks[0]["arrays"], "main_", want)
    _assert_histories_close(ranks[0]["history"], history)


def test_matches_the_jax_one_process_trainer(library, fixture_arrays):
    from photon_ml_tpu.config import parse_config as jparse
    from photon_ml_tpu.game.streaming import StreamedGameData as JData
    from photon_ml_tpu.game.streaming import StreamedGameTrainer as JTrainer

    a = fixture_arrays

    def jdata(lo, hi, validation=False):
        d = _data(a, lo, hi, validation)
        return JData(labels=d.labels, features=dict(d.features), id_tags=dict(d.id_tags))

    jt = JTrainer(jparse(_config(2).to_dict()), chunk_rows=CHUNK, intercept_indices={"global": 3},
                  evaluators=EVALUATORS)
    jm, _ = jt.fit(jdata(0, N_TRAIN), validation=jdata(N_TRAIN, N_TRAIN + N_VAL, True))
    want = {cid: np.asarray(sub.coefficient_means) for cid, sub in jm.models.items()}
    _, ranks = library
    _assert_close_to(ranks[0]["arrays"], "main_", want)
    _assert_histories_close(ranks[0]["history"], _history(jt))


def test_per_visit_exchanges_move_only_each_process_s_own_rows(library, fixture_arrays):
    """As the reference's ``test_two_process_exchange_traffic_is_point_to_point``
    reads ``LAST_EXCHANGE_STATS``: ingest in ceil(200 / 64) = 4 rounds,
    then every random-effect visit one offsets and one scores exchange,
    each sending this process's rows (offsets: its own rows; scores: the
    rows of its entities) and nothing padded."""
    _, ranks = library
    users = fixture_arrays["users"][:N_TRAIN]
    owned = [int(np.sum(users % 2 == r)) for r in range(2)]
    assert sum(owned) == N_TRAIN
    for r, rank in enumerate(ranks):
        by_tag: dict = {}
        for c in rank["calls"]:
            by_tag.setdefault(c["tag"], []).append(c)
            assert c["transport"] == "gloo" and c["padded_rows"] == c["rows_sent"] * c["keys"], c
        assert len(by_tag["ingest/per_user"]) == 4
        assert sum(c["rows_sent"] for c in by_tag["ingest/per_user"]) == N_TRAIN // 2
        assert [c["rows_sent"] for c in by_tag["offsets"]] == [N_TRAIN // 2] * 2
        assert [c["rows_sent"] for c in by_tag["scores"]] == [owned[r]] * 2
        visits = [v for v in rank["visit_stats"] if v["coordinate"] == "per_user"]
        assert [v["offsets_exchange_bytes"] for v in visits] == [c["bytes_sent"] for c in by_tag["offsets"]]
        assert [v["scores_exchange_bytes"] for v in visits] == [c["bytes_sent"] for c in by_tag["scores"]]
        assert all(v["offsets_exchange_s"] >= 0 and v["scores_exchange_s"] >= 0 for v in visits)
        assert rank["exchange_totals"]["ingest/per_user"]["calls"] == 4


def test_sharded_checkpoint_resume_is_bitwise_the_uninterrupted_fit(library):
    work, ranks = library
    assert ranks[0]["files_after_first"] == ["ckpt.json", "ckpt.npz", "scores-shard-00000.npz",
                                             "scores-shard-00001.npz"]
    for r in ranks:
        assert r["resumed_from"] == [1, 0]
        for cid in ("fixed", "per_user"):
            assert r["arrays"][f"resumed_{cid}"].tobytes() == r["arrays"][f"main_{cid}"].tobytes(), cid
    from photon_ml_tpu_torch.checkpoint import load_checkpoint

    saved = load_checkpoint(str(work / "ck_sharded"), device="cpu")
    assert saved is not None and saved.scores is None and saved.total is None  # the model's file only


def test_a_stale_or_torn_score_file_is_a_miss(library):
    _, ranks = library
    for r in ranks:
        assert r["stale_resumed_from"] is None and r["torn_resumed_from"] is None
        for cid in ("fixed", "per_user"):  # trained from scratch
            assert r["arrays"][f"stale_{cid}"].tobytes() == r["arrays"][f"main_{cid}"].tobytes(), cid


def test_gathered_checkpoint_resume_is_bitwise_the_uninterrupted_fit(library):
    work, ranks = library
    assert ranks[0]["gathered_files"] == ["ckpt.json", "ckpt.npz"]
    for r in ranks:
        assert r["gathered_resumed_from"] == [1, 0]
        for cid in ("fixed", "per_user"):
            assert r["arrays"][f"gathered_{cid}"].tobytes() == r["arrays"][f"main_{cid}"].tobytes(), cid
    from photon_ml_tpu_torch.checkpoint import load_checkpoint

    saved = load_checkpoint(str(work / "ck_gathered"), device="cpu")
    assert saved.total.shape == (N_TRAIN,) and set(saved.scores) == {"fixed", "per_user"}


def test_the_jax_package_accepts_a_port_score_file(library, fixture_arrays):
    """The JAX trainer's own ``_load_score_shard`` (process 0 in one JAX
    process) reads process 0's score file with the fingerprint and digest
    it computes itself for that process's rows and the two-process
    layout."""
    from photon_ml_tpu.config import parse_config as jparse
    from photon_ml_tpu.game.streaming import StreamedGameData as JData
    from photon_ml_tpu.game.streaming import StreamedGameTrainer as JTrainer
    from photon_ml_tpu.game.streaming import _host_digest

    work, _ = library
    ck = work / "ck_sharded"
    a = fixture_arrays
    mine = _data(a, 0, N_TRAIN // 2)
    jt = JTrainer(jparse(_config(2).to_dict()), chunk_rows=CHUNK, intercept_indices={"global": 3},
                  checkpoint_dir=str(ck))
    fp = jt._fingerprint(JData(labels=mine.labels, features=dict(mine.features), id_tags=dict(mine.id_tags)),
                         N_TRAIN, (N_TRAIN // 2, N_TRAIN // 2))
    digest = _host_digest(mine.labels, np.ones(mine.num_rows, np.float32))
    with np.load(ck / "scores-shard-00000.npz") as z:
        meta = json.loads(bytes(z["meta"]).decode())
        saved = {k: z[k] for k in z.files if k != "meta"}
    assert meta == dict(fingerprint=fp, data_digest=digest, next_iteration=2, next_coordinate=0, row_base=0)
    got = jt._load_score_shard(fp, digest, 2, 0)
    assert got is not None
    scores, total = got
    assert set(scores) == {"fixed", "per_user"}
    for cid, s in scores.items():
        assert s.tobytes() == saved[f"s__{cid}"].tobytes()
    assert total.tobytes() == saved["total"].tobytes() and total.shape == (N_TRAIN // 2,)
    assert jt._load_score_shard(fp, digest, 1, 0) is None  # another visit's


def test_a_process_without_rows_takes_part(library, one_process):
    _, ranks = library
    want, history = one_process
    for r in ranks:
        _assert_close_to(r["arrays"], "empty_", want)
        _assert_histories_close(r["empty_history"], history)
    for cid in ("fixed", "per_user"):
        assert ranks[0]["arrays"][f"empty_{cid}"].tobytes() == ranks[1]["arrays"][f"empty_{cid}"].tobytes()


# ---------------------------------------------------------------------------
# the reader and the driver
# ---------------------------------------------------------------------------
def _schema():
    schema = json.loads(json.dumps(TRAINING_EXAMPLE_SCHEMA))
    schema["fields"].insert(5, {"name": "userFeatures", "type": {"type": "array", "items": "NameTermValueAvro"},
                                "default": []})
    return schema


def _write(path, a: dict, lo: int, hi: int) -> None:
    def bag(name, X, i):
        return [{"name": name, "term": str(j), "value": float(X[i, j])} for j in range(X.shape[1])]

    recs = [{"uid": f"s{i}", "response": float(a["y"][i]), "offset": None, "weight": None,
             "features": bag("g", a["X"][:, :-1], i), "userFeatures": bag("u", a["Xu"], i),
             "metadataMap": {"userId": f"user_{max(int(a['users'][i]), 0)}", "queryId": f"q_{i // 6 % 20}"}}
            for i in range(lo, hi)]
    write_avro_file(path, _schema(), recs)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_read_streamed_game_allow_empty(tmp_path, fixture_arrays, use_native):
    path = str(tmp_path / "part-00000.avro")
    _write(path, fixture_arrays, 0, 30)
    reader = AvroDataReader(dict(_config().feature_shards))
    maps, max_nnz, entities, _ = reader.streaming_game_stats([path], ("userId", "queryId"))
    empty = reader.read_streamed_game([], ("userId", "queryId"), maps, entities, max_nnz=max_nnz,
                                      use_native=use_native, allow_empty=True)
    full = reader.read_streamed_game([path], ("userId", "queryId"), maps, entities, max_nnz=max_nnz,
                                     use_native=use_native)
    assert empty.num_rows == 0 and full.num_rows == 30
    for sid in ("global", "per_user"):
        assert empty.feature_container(sid).X.shape == (0, maps[sid].size)
        assert empty.feature_container(sid).X.dtype == full.feature_container(sid).X.dtype
    assert set(empty.id_tags) == {"userId", "queryId"}
    for col in (empty.labels, empty.offsets, empty.weights, *empty.id_tags.values()):
        assert col.shape == (0,)
    assert empty.id_tags["userId"].dtype == full.id_tags["userId"].dtype
    with pytest.raises(ValueError, match="no records"):
        reader.read_streamed_game([], ("userId", "queryId"), maps, entities, use_native=use_native)


def driver_worker(rank: int, ports: list, work: str) -> None:
    """One process of the driver runs, one command a port (a command without
    ``--streaming-chunk-rows`` sees a device budget of 100 bytes, so the
    driver selects the out-of-core branch by itself); after the first,
    process 0 keeps a copy of its outputs and process 1 lists its files."""
    with open(os.path.join(work, "argv.json")) as f:
        phases = json.load(f)
    for i, (port, argv) in enumerate(zip(ports, phases)):
        os.environ.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
                          JAX_PROCESS_ID=str(rank))
        if "--streaming-chunk-rows" not in argv:
            port_train.hbm_budget_bytes = lambda dev: 100.0
        port_train.main([x.replace("{rank}", str(rank)) for x in argv])
        if i == 0 and rank == 0:
            shutil.copytree(os.path.join(work, "out0"), os.path.join(work, "out0-first"))
        if i == 0 and rank == 1:
            out1 = os.path.join(work, "out1")
            files = sorted(os.path.relpath(os.path.join(d, f), out1) for d, _, fs in os.walk(out1) for f in fs)
            with open(os.path.join(work, "out1-first.json"), "w") as f:
                json.dump(files, f)


def _load(out) -> tuple:
    maps = {fn[:-4]: IndexMap.load(str(out / "index-maps" / fn)) for fn in os.listdir(out / "index-maps")}
    ent = json.loads((out / "entity-maps.json").read_text())
    model = load_game_model(str(out / "best"), index_maps=maps, entity_ids={"per_user": ent["userId"]},
                            device="cpu")
    return model, ent, json.loads((out / "metrics.json").read_text())


@pytest.fixture(scope="module")
def drivers(tmp_path_factory, fixture_arrays):
    """``cli.train --multihost --streaming-chunk-rows`` in two processes (2
    outer iterations over a grid of 2), the same command at 3 outer
    iterations (a resume of each grid entry at outer iteration 2), 3 outer
    iterations uninterrupted in other directories, then auto-streaming
    over one training part file (process 1 fills none); and the
    one-process driver's first two runs and its twin of the last."""
    work = tmp_path_factory.mktemp("multihost_streamed_drivers")
    a = fixture_arrays
    for d in ("train", "val", "train1"):
        (work / d).mkdir()
    _write(str(work / "train1" / "part-00000.avro"), a, 0, N_TRAIN)
    _write(str(work / "train" / "part-00000.avro"), a, 0, 190)
    _write(str(work / "train" / "part-00001.avro"), a, 190, N_TRAIN)
    _write(str(work / "val" / "part-00000.avro"), a, N_TRAIN, 460)
    _write(str(work / "val" / "part-00001.avro"), a, 460, N_TRAIN + N_VAL)
    for it in (2, 3):
        (work / f"config-{it}.json").write_text(json.dumps(_config(it, grid=(0.1, 10.0)).to_dict()))

    def argv(it, out, chunk=CHUNK, train="train"):
        return ["--config", str(work / f"config-{it}.json"), "--train-data", str(work / train),
                "--validation-data", str(work / "val"), "--device", "cpu", "--output-dir", str(out)] + (
            ["--streaming-chunk-rows", str(chunk)] if chunk else [])

    (work / "argv.json").write_text(json.dumps([argv(it, work / out) + ["--multihost"]
                                                for it, out in ((2, "out{rank}"), (3, "out{rank}"),
                                                                (3, "fresh{rank}"))]
                                               + [argv(2, work / "auto{rank}", None, "train1") + ["--multihost"]]))
    _spawn("driver", work, phases=4)
    port_train.main(argv(2, work / "one"))
    shutil.copytree(work / "one", work / "one-first")
    port_train.main(argv(3, work / "one"))
    port_train.main(argv(2, work / "one-auto", 1 << 20, "train1"))
    return work


def test_driver_multihost_streamed_matches_the_one_process_driver(drivers):
    work = drivers
    for mine, one in (("out0-first", "one-first"), ("out0", "one"), ("auto0", "one-auto")):
        model, ent, metrics = _load(work / mine)
        want, want_ent, want_metrics = _load(work / one)
        assert metrics["best_index"] == want_metrics["best_index"]
        assert ent == want_ent  # every process's statistics pass reads every file
        for cid in ("fixed", "per_user"):
            np.testing.assert_allclose(model[cid].coefficient_means.numpy(), want[cid].coefficient_means.numpy(),
                                       err_msg=f"{mine} {cid}", **DRIVER_TOL)
        assert len(metrics["validation_history"]) == len(want_metrics["validation_history"])
        for got, w in zip(metrics["results"], want_metrics["results"]):
            assert got["configuration"] == w["configuration"]
            assert abs(got["primary"] - w["primary"]) <= METRIC_TOL


def test_driver_multihost_streamed_writes_on_process_0_only(drivers):
    work = drivers
    out0 = work / "out0-first"
    assert (out0 / "best").is_dir() and (out0 / "metrics.json").exists() and (out0 / "photon.log").exists()
    for entry in ("grid-0000", "grid-0001"):
        assert sorted(os.listdir(out0 / "checkpoints" / entry)) == ["ckpt.json", "ckpt.npz",
                                                                    "scores-shard-00000.npz"]
    # process 1 writes its own score files and nothing else
    first = json.loads((work / "out1-first.json").read_text())
    assert first == [f"checkpoints/grid-000{i}/scores-shard-00001.npz" for i in range(2)]


def test_driver_multihost_auto_streams_with_a_process_without_a_file(drivers):
    """An input over the device budget selects the out-of-core branch under
    ``--multihost`` too (chunks of 2^20 rows), and with one training part
    file process 1 fills no row (``allow_empty``) and still takes part;
    the model matches the one-process driver (test above)."""
    work = drivers
    metrics = json.loads((work / "auto0" / "metrics.json").read_text())
    assert metrics["streaming_chunk_rows"] == 1 << 20
    log = (work / "auto0" / "photon.log").read_text()
    assert "this process fills 1/1 files" in log and "selecting the out-of-core streamed path" in log
    assert not (work / "auto1" / "best").exists()


def test_driver_multihost_streamed_rerun_resumes_every_grid_entry(drivers):
    work = drivers
    log = (work / "out0" / "photon.log").read_text()
    assert log.count("resuming streamed descent at outer iteration 2, coordinate index 0") == 2
    metrics = json.loads((work / "out0" / "metrics.json").read_text())
    first = json.loads((work / "out0-first" / "metrics.json").read_text())
    # the resumed run's third iteration is merged after the first run's history
    assert metrics["validation_history"][:4] == first["validation_history"] and len(
        metrics["validation_history"]) == 6
    # and it is bitwise the uninterrupted 3-iteration run
    resumed, _, _ = _load(work / "out0")
    fresh, _, fresh_metrics = _load(work / "fresh0")
    assert metrics["best_index"] == fresh_metrics["best_index"]
    for cid in ("fixed", "per_user"):
        assert resumed[cid].coefficient_means.numpy().tobytes() == fresh[cid].coefficient_means.numpy().tobytes()
