"""The GAME driver's out-of-core branch against the JAX package's on the
same Avro files (the in-memory driver tests' data: 300 training rows in 2
parts, 8 users, a 2-entry λ grid): ``streaming_game_stats`` and
``read_streamed_game`` bit for bit on the native decoder and on the Python
codec; ``--streaming-chunk-rows`` writing the reference's files with the
same best index, validation metrics within 1e-3 and the best model within
the lane tolerance (atol 2e-3 / rtol 1e-2); a resume that extends the run
from its visit checkpoints in both packages; and the selection of the
streamed branch by input size (the device budget monkeypatched)."""

from __future__ import annotations

import dataclasses
import io
import json
import os

import numpy as np
import pytest
from test_torch_cli_game import EVALUATORS, _config, _listing, _load, _metrics, _quiet, _write

import photon_ml_tpu.io.native_ingest as ref_native_ingest
from photon_ml_tpu.cli import train as ref_train
from photon_ml_tpu.data.synthetic import synthetic_game_data
from photon_ml_tpu.io.data_reader import AvroDataReader as JReader
from photon_ml_tpu.utils import PhotonLogger as JLogger
from photon_ml_tpu_torch.cli import train as port_train
from photon_ml_tpu_torch.config import parse_config
from photon_ml_tpu_torch.io.data_reader import AvroDataReader
from photon_ml_tpu_torch.utils import PhotonLogger

LANE_TOL = dict(atol=2e-3, rtol=1e-2)
CHUNK = 64


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("game-avro-streamed")
    data = synthetic_game_data(np.random.default_rng(42), 460, d_fixed=3, effects={"userId": (8, 2)})
    os.makedirs(root / "train")
    _write(str(root / "train" / "part-00000.avro"), data, 0, 200)
    _write(str(root / "train" / "part-00001.avro"), data, 200, 300)
    _write(str(root / "val.avro"), data, 300, 400)
    _write(str(root / "new.avro"), data, 400, 460, users_offset=3)  # 3 users training never saw
    return root


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_streamed_reads_match_reference(data_dir, monkeypatch, native):
    cfg = _config("LBFGS")
    shards = parse_config(cfg.to_dict()).feature_shards
    train = [str(data_dir / "train")]
    if not native:  # the reference takes its Python codec when its decoder is unavailable
        monkeypatch.setattr(ref_native_ingest, "native_ingest_available", lambda: False)
    jr, pr = JReader(cfg.feature_shards), AvroDataReader(shards)
    want = jr.streaming_game_stats(train, ("userId",))
    got = pr.streaming_game_stats(train, ("userId",), use_native=native)
    assert {s: list(m.items()) for s, m in got[0].items()} == {s: list(m.items()) for s, m in want[0].items()}
    assert got[1:] == want[1:] and got[3] == 300
    maps, nnz, ents = got[0], got[1], got[2]
    for paths, unseen in ((train, False), ([str(data_dir / "new.avro")], True)):
        w = jr.read_streamed_game(paths, ("userId",), want[0], want[2], max_nnz=want[1], unseen_entity_ok=unseen)
        g = pr.read_streamed_game(paths, ("userId",), maps, ents, max_nnz=nnz, unseen_entity_ok=unseen,
                                  use_native=native)
        assert g.decoder == ("native" if native else "python")
        cols = [(g.labels, w.labels), (g.offsets, w.offsets), (g.weights, w.weights),
                (g.id_tags["userId"], w.id_tags["userId"])]
        cols += [(g.features[s].X, np.asarray(w.features[s].X)) for s in ("global", "per_user")]
        for a, b in cols:
            assert a.dtype == b.dtype and np.array_equal(a, b)
        if unseen:
            assert (g.id_tags["userId"] == -1).sum() > 0
    with pytest.raises(ValueError, match="absent from the statistics pass"):
        pr.read_streamed_game([str(data_dir / "new.avro")], ("userId",), maps, ents, use_native=native)


def _runs(data_dir, out, iters, logs=None):
    """Both drivers' streamed branch into ``out``/ref and ``out``/port."""
    cfg = _config("LBFGS", coordinate_descent_iterations=iters)
    train, val = [str(data_dir / "train")], [str(data_dir / "val.avro")]
    ref_train.run(cfg, train, str(out / "ref"), validation_data=val, streaming_chunk_rows=CHUNK,
                  logger=_quiet(JLogger))
    logger = PhotonLogger(None, stream=logs if logs is not None else io.StringIO())
    return port_train.run(parse_config(cfg.to_dict()), train, str(out / "port"), validation_data=val,
                          streaming_chunk_rows=CHUNK, logger=logger, device="cpu")


@pytest.fixture(scope="module")
def streamed(data_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("streamed-out")
    model = _runs(data_dir, out, 2)
    return out, model


def test_streamed_driver_writes_the_reference_files(streamed):
    out, model = streamed
    assert _listing(out / "port") == _listing(out / "ref")
    assert "checkpoints/grid-0001/ckpt.npz" in _listing(out / "port")
    ref, port = _metrics(out / "ref"), _metrics(out / "port")
    assert port.keys() == ref.keys() == {"streaming_chunk_rows", "coordinates", "validation_history",
                                         "results", "best_index"}
    assert port["best_index"] == ref["best_index"] and port["streaming_chunk_rows"] == CHUNK
    for got, want in zip(port["results"], ref["results"]):
        assert got["configuration"] == want["configuration"]
        assert abs(got["primary"] - want["primary"]) <= 1e-3
    assert [list(e) for e in port["validation_history"]] == [list(e) for e in ref["validation_history"]]
    for g, w in zip(port["validation_history"], ref["validation_history"]):
        (cid, gm), = g.items()
        assert gm.keys() == w[cid].keys() == set(EVALUATORS)
        assert all(abs(gm[k] - w[cid][k]) <= 1e-3 for k in gm)
    assert port["coordinates"].keys() == ref["coordinates"].keys()
    got, want = _load(out / "port"), _load(out / "ref")
    for cid in ("fixed", "per_user"):
        np.testing.assert_allclose(got[cid].coefficient_means.numpy(), want[cid].coefficient_means.numpy(),
                                   **LANE_TOL)
        np.testing.assert_allclose(model[cid].coefficient_means.numpy(), got[cid].coefficient_means.numpy(),
                                   atol=1e-6, rtol=0)


def test_streamed_driver_resumes_from_its_visit_checkpoints(data_dir, tmp_path):
    """Two outer iterations, then three into the same directories: both
    drivers resume at iteration 2 and merge the metrics files."""
    _runs(data_dir, tmp_path, 2)
    logs = io.StringIO()
    _runs(data_dir, tmp_path, 3, logs=logs)
    assert logs.getvalue().count("resuming streamed descent at outer iteration 2, coordinate index 0") == 2
    ref, port = _metrics(tmp_path / "ref"), _metrics(tmp_path / "port")
    # the interrupted run's four visits and the resumed run's two
    assert len(port["validation_history"]) == len(ref["validation_history"]) == 2 * 2 + 2
    assert port["best_index"] == ref["best_index"]
    got, want = _load(tmp_path / "port"), _load(tmp_path / "ref")
    for cid in ("fixed", "per_user"):
        np.testing.assert_allclose(got[cid].coefficient_means.numpy(), want[cid].coefficient_means.numpy(),
                                   **LANE_TOL)


def test_input_over_the_device_budget_selects_the_streamed_branch(data_dir, tmp_path, monkeypatch):
    cfg = dataclasses.replace(_config("LBFGS", coordinate_descent_iterations=1), regularization_weight_grid={})
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg.to_dict()))
    argv = ["--config", str(path), "--train-data", str(data_dir / "train"), "--device", "cpu"]
    monkeypatch.setattr(port_train, "hbm_budget_bytes", lambda dev: 100.0)
    port_train.main(argv + ["--output-dir", str(tmp_path / "auto")])
    metrics = _metrics(tmp_path / "auto")
    assert metrics["streaming_chunk_rows"] == 1 << 20 and metrics["validation_history"] == []
    assert "checkpoints/ckpt.npz" in _listing(tmp_path / "auto")
    with open(tmp_path / "auto" / "photon.log") as f:
        assert "selecting the out-of-core streamed path" in f.read()
    port_train.main(argv + ["--output-dir", str(tmp_path / "mem"), "--no-auto-streaming"])
    assert set(_metrics(tmp_path / "mem")) == {"results", "best_index"}
