"""The port's multi-process runtime on the CPU: two processes join one gloo
group over loopback, as the reference's ``tests/test_multihost.py`` runs
two ``jax.distributed`` processes. Each worker is its own Python process,
spawned with ``subprocess`` on a free port and killed after 120 s, so a
hang fails the test instead of stalling the suite. The cases are grouped
into three worker runs (the library, the driver, the driver's rerun).

Held to:
- the host collectives: ``allreduce_sum_host`` bitwise identical on both
  ranks and equal to numpy's float64 sum in rank order, likewise
  ``allreduce_max_host``, ``broadcast_from_host0``, ``allgather_host``,
  and ``sync_processes`` raising on both ranks at mismatched tags;
- ``summarize_chunks(cross_process=True)`` over two processes' chunks
  against the one-process summary of all chunks (rtol 1e-12);
- ``train_glm_streamed(cross_process=True)`` against the one-process
  streamed solve and the JAX package's, coefficients within rtol 1e-2 /
  atol 1e-3 (the reference's tolerances; float32 stopping rules flip at
  another summation order), objective within rtol 1e-5;
- ``cli.train_glm --multihost`` against the one-process driver at the same
  tolerances, with only process 0 writing and a rerun that resumes from
  its checkpoints within rtol 1e-6.
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

from photon_ml_tpu_torch.cli.train_glm import main as cli_main
from photon_ml_tpu_torch.cli.train_glm import run as port_run
from photon_ml_tpu_torch.config import OptimizerConfig, RegularizationContext
from photon_ml_tpu_torch.data.summary import summarize_chunks
from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu_torch.ops.streaming import dense_chunks, sparse_chunks
from photon_ml_tpu_torch.parallel import multihost as mh
from photon_ml_tpu_torch.supervised.training import train_glm_streamed
from photon_ml_tpu_torch.types import (
    DataValidationType,
    NormalizationType,
    OptimizerType,
    RegularizationType,
    TaskType,
)
from photon_ml_tpu_torch.utils import PhotonLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120
N, D, CHUNK = 1200, 6, 128
WEIGHTS = (0.1, 1.0)
COEF_TOL = dict(rtol=1e-2, atol=1e-3)

_WORKER = textwrap.dedent(
    """
    import json, os, sys
    root, port, rank, mode, work = sys.argv[1:6]
    rank = int(rank)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from photon_ml_tpu_torch.parallel import multihost as mh

    if mode == "library":
        from photon_ml_tpu_torch.config import OptimizerConfig, RegularizationContext
        from photon_ml_tpu_torch.data.summary import summarize_chunks
        from photon_ml_tpu_torch.ops.streaming import dense_chunks, sparse_chunks
        from photon_ml_tpu_torch.supervised.training import train_glm_streamed
        from photon_ml_tpu_torch.types import OptimizerType, RegularizationType, TaskType

        mh.initialize_multihost(f"127.0.0.1:{port}", 2, rank, timeout_s=100)
        z = np.load(os.path.join(work, "input.npz"))
        out = {}
        out["paths"] = np.asarray(mh.host_shard_of_paths(["c.avro", "a.avro", "e.avro", "b.avro", "d.avro"]))
        rng = np.random.default_rng(100 + rank)
        a, b, c = rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=5), np.asarray([rank + 1, 7])
        out["sum_a"], out["sum_b"], out["sum_c"] = mh.allreduce_sum_host(a, b, c)
        out["sum_one"] = mh.allreduce_sum_host(b)
        out["max_a"], out["max_neg_b"] = mh.allreduce_max_host(a, -b)
        got = mh.broadcast_from_host0({"x": a, "y": (b, c)})
        out["bcast_x"], out["bcast_y0"], out["bcast_y1"] = got["x"], got["y"][0], got["y"][1]
        out["gather"] = mh.allgather_host(a)
        mh.sync_processes("first")
        mh.sync_processes("first")
        out["barriers"] = np.asarray(mh._BARRIER_SEQ[0])
        try:
            mh.sync_processes("left" if rank == 0 else "right")
            out["mismatch_raised"] = np.asarray(False)
        except RuntimeError:
            out["mismatch_raised"] = np.asarray(True)
        mh.sync_processes("after-mismatch")

        chunks = dense_chunks(z["X"], z["y"], int(z["chunk"]))
        half = len(chunks) // 2
        mine = chunks[:half] if rank == 0 else chunks[half:]
        sp = sparse_chunks(z["idx"], z["val"], z["y"], int(z["chunk"]))
        sp_mine = sp[: len(sp) // 2] if rank == 0 else sp[len(sp) // 2:]
        for tag, cs, d in (("dense", mine, int(z["d"])), ("sparse", sp_mine, int(z["d_sparse"]))):
            s = summarize_chunks(cs, d, cross_process=True)
            for f in ("mean", "variance", "min", "max", "max_magnitude", "num_nonzeros"):
                out[f"summary_{tag}_{f}"] = getattr(s, f)
            out[f"summary_{tag}_count"] = np.asarray(s.count)

        val = dense_chunks(z["Xv"], z["yv"], int(z["chunk"]))
        task = TaskType.LOGISTIC_REGRESSION
        reg = RegularizationContext(RegularizationType.L2)
        for tag, cs, opt in (("lbfgs", mine, OptimizerType.LBFGS),
                             ("zero_chunks", chunks if rank == 0 else [], OptimizerType.LBFGS),
                             ("tron", mine, OptimizerType.TRON)):
            res = train_glm_streamed(
                cs, task, int(z["d"]), OptimizerConfig(optimizer_type=opt, max_iterations=100, tolerance=1e-8),
                regularization=reg, regularization_weights=list(z["weights"]), intercept_index=0,
                validation_chunks=val, cross_process=True, device="cpu")
            for lam, model in res.models.items():
                out[f"{tag}_w_{lam:g}"] = model.coefficients.means.numpy()
                out[f"{tag}_value_{lam:g}"] = np.asarray(float(res.trackers[lam].value))
            out[f"{tag}_best"] = np.asarray(res.best_weight)
        np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    else:
        os.environ.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
                          JAX_PROCESS_ID=str(rank))
        from photon_ml_tpu_torch.cli import train_glm
        with open(os.path.join(work, "argv.json")) as f:
            argv = json.load(f)
        train_glm.main(argv + ["--output-dir", os.path.join(work, f"out{rank}")])
    mh.shutdown_multihost()
    print("WORKER DONE", rank)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(mode: str, work) -> list[str]:
    """Two workers of ``mode`` on a fresh port; each is killed after
    ``WORKER_TIMEOUT_S`` and a failure or timeout fails the caller."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")}
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, ROOT, str(port), str(rank), mode, str(work)],
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
        assert rc == 0 and f"WORKER DONE {rank}" in out, f"worker {rank} failed (rc {rc}):\n{out}\n{err}"
    return [r[1] for r in results]


def _glm_arrays(n: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    X = (0.7 * rng.normal(size=(n, d)) + 0.3).astype(np.float32)
    X[:, 0] = 1.0
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ rng.normal(size=d))))).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """The library worker run: its inputs and each rank's outputs."""
    work = tmp_path_factory.mktemp("multihost_library")
    X, y = _glm_arrays(N, D, seed=5)
    Xv, yv = _glm_arrays(400, D, seed=6)
    rng = np.random.default_rng(7)
    d_sparse = 50
    idx = rng.integers(0, d_sparse, size=(N, 4)).astype(np.int32)
    idx[5, 1] = idx[5, 0]  # a duplicated (row, column) pair adds up before squaring
    val = rng.normal(size=(N, 4)).astype(np.float32)
    val[:, 3] = np.where(rng.uniform(size=N) < 0.3, 0.0, val[:, 3])
    inputs = dict(X=X, y=y, Xv=Xv, yv=yv, idx=idx, val=val, chunk=CHUNK, d=D, d_sparse=d_sparse,
                  weights=np.asarray(WEIGHTS))
    np.savez(work / "input.npz", **inputs)
    _spawn("library", work)
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(2)]
    return inputs, ranks


def _rank_inputs(rank: int):
    rng = np.random.default_rng(100 + rank)
    return rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=5), np.asarray([rank + 1, 7])


def test_host_shard_of_paths_is_round_robin_over_sorted_paths(library):
    _, ranks = library
    assert list(ranks[0]["paths"]) == ["a.avro", "c.avro", "e.avro"]
    assert list(ranks[1]["paths"]) == ["b.avro", "d.avro"]
    assert mh.host_shard_of_paths(["b", "a"]) == ["a", "b"]  # one process reads every file


def test_allreduce_sum_host_is_bitwise_identical_on_both_ranks(library):
    _, ranks = library
    ins = [_rank_inputs(r) for r in range(2)]
    for i, key in enumerate(("sum_a", "sum_b", "sum_c")):
        assert ranks[0][key].tobytes() == ranks[1][key].tobytes()
        want = np.sum(np.stack([np.asarray(x[i], np.float64) for x in ins]), axis=0)
        assert ranks[0][key].dtype == np.float64
        np.testing.assert_array_equal(ranks[0][key], want)
    np.testing.assert_array_equal(ranks[1]["sum_one"], ins[0][1] + ins[1][1])
    a = np.ones(3, np.float32)
    assert mh.allreduce_sum_host(a) is a  # one process: unchanged


def test_allreduce_max_broadcast_and_allgather(library):
    _, ranks = library
    ins = [_rank_inputs(r) for r in range(2)]
    for r in ranks:
        np.testing.assert_array_equal(r["max_a"], np.maximum(ins[0][0], ins[1][0]))
        np.testing.assert_array_equal(r["max_neg_b"], np.maximum(-ins[0][1], -ins[1][1]))
        np.testing.assert_array_equal(r["bcast_x"], ins[0][0])
        np.testing.assert_array_equal(r["bcast_y0"], ins[0][1])
        np.testing.assert_array_equal(r["bcast_y1"], ins[0][2])
        np.testing.assert_array_equal(r["gather"], np.stack([ins[0][0], ins[1][0]]))
    assert ranks[0]["bcast_x"].dtype == np.float32


def test_sync_processes_counts_tags_and_refuses_a_mismatch(library):
    _, ranks = library
    for r in ranks:
        assert int(r["barriers"]) == 2
        assert bool(r["mismatch_raised"])


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_summarize_chunks_across_processes_is_the_summary_of_all_chunks(library, kind):
    inputs, ranks = library
    if kind == "dense":
        chunks, d = dense_chunks(inputs["X"], inputs["y"], CHUNK), D
    else:
        chunks, d = sparse_chunks(inputs["idx"], inputs["val"], inputs["y"], CHUNK), inputs["d_sparse"]
    want = summarize_chunks(chunks, d)
    for r in ranks:
        for f in ("mean", "variance", "min", "max", "max_magnitude"):
            np.testing.assert_allclose(r[f"summary_{kind}_{f}"], getattr(want, f), rtol=1e-12, atol=1e-15,
                                       err_msg=f)
        np.testing.assert_array_equal(r[f"summary_{kind}_num_nonzeros"], want.num_nonzeros)
        assert int(r[f"summary_{kind}_count"]) == want.count == N
    for f in ("mean", "variance", "min", "max"):
        assert ranks[0][f"summary_{kind}_{f}"].tobytes() == ranks[1][f"summary_{kind}_{f}"].tobytes()


def _one_process(inputs, optimizer=OptimizerType.LBFGS):
    return train_glm_streamed(
        dense_chunks(inputs["X"], inputs["y"], CHUNK), TaskType.LOGISTIC_REGRESSION, D,
        OptimizerConfig(optimizer_type=optimizer, max_iterations=100, tolerance=1e-8),
        regularization=RegularizationContext(RegularizationType.L2), regularization_weights=list(WEIGHTS),
        intercept_index=0, validation_chunks=dense_chunks(inputs["Xv"], inputs["yv"], CHUNK), device="cpu",
    )


@pytest.mark.parametrize("case", ["lbfgs", "zero_chunks", "tron"])
def test_train_glm_streamed_across_processes_matches_one_process(library, case):
    """Each process streams its half of the chunks (``zero_chunks``: all
    on process 0, none on process 1); both hold the same model."""
    inputs, ranks = library
    ref = _one_process(inputs, OptimizerType.TRON if case == "tron" else OptimizerType.LBFGS)
    for lam in WEIGHTS:
        assert ranks[0][f"{case}_w_{lam:g}"].tobytes() == ranks[1][f"{case}_w_{lam:g}"].tobytes()
        np.testing.assert_allclose(ranks[0][f"{case}_w_{lam:g}"], ref.models[lam].coefficients.means.numpy(),
                                   **COEF_TOL)
        np.testing.assert_allclose(float(ranks[0][f"{case}_value_{lam:g}"]), float(ref.trackers[lam].value),
                                   rtol=1e-5)
    assert float(ranks[0][f"{case}_best"]) == float(ranks[1][f"{case}_best"]) == ref.best_weight


def test_train_glm_streamed_across_processes_matches_the_reference(library):
    """The two-process solve against the JAX package's one-process
    ``train_glm_streamed`` on the same chunks."""
    from photon_ml_tpu.config import OptimizerConfig as JConfig
    from photon_ml_tpu.config import RegularizationContext as JReg
    from photon_ml_tpu.ops.streaming import dense_chunks as j_dense_chunks
    from photon_ml_tpu.supervised.training import train_glm_streamed as j_train_glm_streamed
    from photon_ml_tpu.types import RegularizationType as JRegType
    from photon_ml_tpu.types import TaskType as JTask

    inputs, ranks = library
    ref = j_train_glm_streamed(
        j_dense_chunks(inputs["X"], inputs["y"], CHUNK), JTask.LOGISTIC_REGRESSION, D,
        JConfig(max_iterations=100, tolerance=1e-8), regularization=JReg(JRegType.L2),
        regularization_weights=list(WEIGHTS), intercept_index=0,
        validation_chunks=j_dense_chunks(inputs["Xv"], inputs["yv"], CHUNK),
    )
    for lam in WEIGHTS:
        np.testing.assert_allclose(ranks[0][f"lbfgs_w_{lam:g}"], np.asarray(ref.models[lam].coefficients.means),
                                   **COEF_TOL)
    assert float(ranks[0]["lbfgs_best"]) == ref.best_weight


# ---------------------------------------------------------------------------
# the driver's --multihost
# ---------------------------------------------------------------------------
def _write_part(path, X, y):
    recs = [{"uid": f"r{i}", "response": float(label), "offset": None, "weight": None,
             "features": [{"name": "x", "term": str(j), "value": float(row[j])} for j in range(1, len(row))],
             "metadataMap": None}
            for i, (row, label) in enumerate(zip(X, y))]
    write_avro_file(str(path), TRAINING_EXAMPLE_SCHEMA, recs)


def _coefficients(model_dir) -> dict:
    rec = read_avro_file(str(model_dir / "best" / "model.avro"))[1][0]
    return {(r["name"], r["term"]): r["value"] for r in rec["means"]}


DRIVER_FLAGS = ["--task", "LOGISTIC_REGRESSION", "--format", "avro", "--weights", "0.1", "1", "10",
                "--max-iterations", "100", "--tolerance", "1e-8", "--streaming-chunk-rows", "64",
                "--normalization", "STANDARDIZATION", "--validate", "VALIDATE_FULL", "--device", "cpu"]


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    """Two ``--multihost`` driver processes over two part files (one each),
    then the same command again into the same directories."""
    work = tmp_path_factory.mktemp("multihost_driver")
    X, y = _glm_arrays(700, 4, seed=8)
    (work / "train").mkdir()
    _write_part(work / "train" / "part-00000.avro", X[:260], y[:260])
    _write_part(work / "train" / "part-00001.avro", X[260:500], y[260:500])
    _write_part(work / "val.avro", X[500:], y[500:])
    argv = DRIVER_FLAGS + ["--train-data", str(work / "train"), "--validation-data", str(work / "val.avro"),
                           "--multihost"]
    (work / "argv.json").write_text(json.dumps(argv))
    _spawn("driver", work)
    first = {"coefficients": _coefficients(work / "out0"),
             "report": json.loads((work / "out0" / "report.json").read_text()),
             "out1": sorted(p.name for p in (work / "out1").iterdir()),
             "done_mtime": (work / "out0" / "checkpoints" / "sweep-done.npz").stat().st_mtime_ns}
    _spawn("driver", work)
    port_run(TaskType.LOGISTIC_REGRESSION, [str(work / "train")], str(work / "one"), data_format="avro",
             validation_data=[str(work / "val.avro")], weights=[0.1, 1.0, 10.0], max_iterations=100,
             tolerance=1e-8, streaming_chunk_rows=64, device="cpu",
             normalization=NormalizationType.STANDARDIZATION, validate=DataValidationType.VALIDATE_FULL,
             logger=PhotonLogger(None, stream=io.StringIO()))
    return work, first


def test_driver_multihost_matches_the_one_process_driver(driver):
    work, first = driver
    one = _coefficients(work / "one")
    assert set(first["coefficients"]) == set(one)
    for key in one:
        np.testing.assert_allclose(first["coefficients"][key], one[key], **COEF_TOL)
    one_report = json.loads((work / "one" / "report.json").read_text())
    assert first["report"]["best_weight"] == one_report["best_weight"]
    for lam, metrics in one_report["validation"].items():
        np.testing.assert_allclose(first["report"]["validation"][lam]["AUC"], metrics["AUC"], atol=1e-3)


def test_driver_multihost_writes_on_process_0_only(driver):
    work, first = driver
    assert (work / "out0" / "checkpoints" / "sweep-done.npz").exists()
    assert (work / "out0" / "_stage").read_text() == "VALIDATED"
    # process 1 keeps its log and nothing else
    assert first["out1"] == ["photon.log"]
    assert not (work / "out1" / "best").exists() and not (work / "out1" / "checkpoints").exists()


def test_driver_multihost_rerun_resumes_from_process_0_checkpoints(driver):
    work, first = driver
    log = (work / "out0" / "photon.log").read_text()
    assert log.count("this process reads 1/2 files") == 2
    # every λ loaded on both processes: the checkpoint was not rewritten
    assert (work / "out0" / "checkpoints" / "sweep-done.npz").stat().st_mtime_ns == first["done_mtime"]
    rerun = _coefficients(work / "out0")
    for key, value in first["coefficients"].items():
        np.testing.assert_allclose(rerun[key], value, rtol=1e-6)
    report = json.loads((work / "out0" / "report.json").read_text())
    assert report["best_weight"] == first["report"]["best_weight"]


def test_driver_multihost_needs_streaming_and_a_process_group(tmp_path, monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    base = ["--task", "LOGISTIC_REGRESSION", "--format", "avro", "--train-data", str(tmp_path / "t.avro"),
            "--device", "cpu", "--output-dir", str(tmp_path / "o"), "--multihost"]
    with pytest.raises(ValueError, match="--multihost requires --streaming-chunk-rows"):
        cli_main(base)
    with pytest.raises(ValueError, match="--multihost requires --streaming-chunk-rows"):
        port_run(TaskType.LOGISTIC_REGRESSION, [str(tmp_path / "t.avro")], str(tmp_path / "o"),
                 data_format="avro", multihost=True, device="cpu")
    with pytest.raises(RuntimeError, match="multihost initialization failed"):
        cli_main(base + ["--streaming-chunk-rows", "64"])
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "two")
    with pytest.raises(RuntimeError, match="JAX_PROCESS_ID"):
        mh.initialize_multihost()
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    with pytest.raises(RuntimeError, match="outside"):
        mh.initialize_multihost()
    assert mh.runtime_summary()["process_count"] == 1 and mh.is_output_process()
