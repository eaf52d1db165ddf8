"""The out-of-core GLM path end to end against the JAX package on the same
files and arrays: ``streaming_ingest_stats`` and ``iter_batch_chunks``
(native and Python, in both packages) bit for bit; ``summarize_chunks``;
``train_glm_streamed`` over an L2 sweep, L1, TRON, normalization, SIMPLE
and FULL variances and a prior; a mid-λ resume across packages and the
checkpoint's fingerprint string; the GLM driver's ``--streaming-chunk-rows``
branch against the reference's driver and the port's in-memory branch
(rtol 1e-2 / atol 1e-3), with its rejections and streamed ``--validate``;
and ``cross_validate_glm``."""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from photon_ml_tpu.cli.train_glm import run as ref_run
from photon_ml_tpu.config import FeatureShardConfig as JShard
from photon_ml_tpu.config import OptimizerConfig as JConfig
from photon_ml_tpu.config import RegularizationContext as JReg
from photon_ml_tpu.data.summary import summarize_chunks as ref_summarize_chunks
from photon_ml_tpu.io.avro import read_avro_file as ref_read
from photon_ml_tpu.io.avro import write_avro_file as ref_write
from photon_ml_tpu.io.data_reader import AvroDataReader as JReader
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu.models import Coefficients as JCoefficients
from photon_ml_tpu.models import GeneralizedLinearModel as JGLM
from photon_ml_tpu.normalization import build_normalization as ref_build_normalization
from photon_ml_tpu.ops import streaming as jstreaming
from photon_ml_tpu.ops.batch import DenseBatch as JDense
from photon_ml_tpu.supervised import training as ref_training
from photon_ml_tpu.supervised.cross_validation import cross_validate_glm as ref_cv
from photon_ml_tpu.types import NormalizationType as JNormType
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import RegularizationType as JRegType
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch.cli.train_glm import main as cli_main
from photon_ml_tpu_torch.cli.train_glm import run as port_run
from photon_ml_tpu_torch.config import FeatureShardConfig, OptimizerConfig, RegularizationContext
from photon_ml_tpu_torch.convert import dense_batch_from_numpy, glm_from_numpy
from photon_ml_tpu_torch.data.summary import summarize_chunks
from photon_ml_tpu_torch.io.avro import write_avro_file
from photon_ml_tpu_torch.io.data_reader import AvroDataReader
from photon_ml_tpu_torch.ops import streaming
from photon_ml_tpu_torch.supervised import training
from photon_ml_tpu_torch.supervised.cross_validation import cross_validate_glm
from photon_ml_tpu_torch.types import (
    DataValidationType,
    NormalizationType,
    OptimizerType,
    RegularizationType,
    TaskType,
    VarianceComputationType,
)
from photon_ml_tpu_torch.utils import PhotonLogger


def _schema():
    schema = json.loads(json.dumps(TRAINING_EXAMPLE_SCHEMA))
    for bag in ("wideFeatures", "userFeatures"):
        schema["fields"].insert(5, {"name": bag, "type": {"type": "array", "items": "NameTermValueAvro"},
                                    "default": []})
    return schema


def _records(n: int, seed: int) -> list[dict]:
    """float32-exact values: rows with missing features, a repeated key in a
    row, null and set offsets / weights, and a wide bag of nearly distinct
    keys (past the 2048-column densify threshold)."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        vals = rng.normal(size=12).astype(np.float32)
        feats = [{"name": "g", "term": str(j), "value": float(vals[j])} for j in range(5) if rng.uniform() < 0.8]
        if i % 7 == 3:
            feats.append({"name": "g", "term": "0", "value": float(vals[5])})
        wide = [{"name": "w", "term": str(int(t)), "value": float(v)}
                for t, v in zip(rng.integers(0, 100_000, size=1 + i % 4), vals[6:10])]
        recs.append({
            "uid": f"r{i}",
            "response": float(rng.integers(0, 2)),
            "offset": None if i % 3 else float(vals[10]),
            "weight": None if i % 4 else float(abs(vals[11]) + 0.5),
            "features": feats,
            "userFeatures": [{"name": "u", "term": str(i % 3), "value": float(vals[0])}],
            "wideFeatures": wide,
            "metadataMap": {"userId": f"user_{i % 5}"},
        })
    return recs


SHARDS = {
    "global": dict(feature_bags=("features",), has_intercept=True),
    "mixed": dict(feature_bags=("userFeatures", "features"), has_intercept=True),
    "wide": dict(feature_bags=("wideFeatures",), has_intercept=True),
}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream")
    os.makedirs(root / "train")
    write_avro_file(str(root / "train" / "part-00000.avro"), _schema(), _records(700, seed=1))
    ref_write(str(root / "train" / "part-00001.avro"), _schema(), _records(500, seed=2), sync_interval=100)
    return root


def _assert_chunks_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_chunked_reads_are_bitwise_the_reference(data_dir, caplog):
    port = AvroDataReader({s: FeatureShardConfig(**c) for s, c in SHARDS.items()})
    ref = JReader({s: JShard(**c) for s, c in SHARDS.items()})
    path = str(data_dir / "train")
    maps, max_nnz = port.streaming_ingest_stats(path)
    assert maps["wide"].size > 2048 and maps["global"].size <= 2048
    for use_native in (True, False):
        p_maps, p_nnz = port.streaming_ingest_stats(path, use_native=use_native)
        r_maps, r_nnz = ref.streaming_ingest_stats(path, use_native=use_native)
        assert p_nnz == r_nnz == max_nnz
        for sid in SHARDS:
            assert list(p_maps[sid].items()) == list(r_maps[sid].items()) == list(maps[sid].items())
    # the streamed maps are the in-memory reader's
    in_memory = port.read(path, device="cpu").index_maps
    assert all(list(in_memory[s].items()) == list(maps[s].items()) for s in SHARDS)
    assert list(port.build_index_maps_streaming(path)["global"].items()) == list(maps["global"].items())
    r_maps = ref.streaming_ingest_stats(path)[0]
    for sid in SHARDS:
        for rows in (128, 500):
            native = list(port.iter_batch_chunks(path, sid, rows, maps, max_nnz=max_nnz[sid]))
            _assert_chunks_equal(port.iter_batch_chunks(path, sid, rows, maps, use_native=False), native)
            for ref_native in (True, False):
                _assert_chunks_equal(
                    ref.iter_batch_chunks(path, sid, rows, r_maps, max_nnz=max_nnz[sid], use_native=ref_native),
                    native,
                )
            assert sum(int((c["weights"] > 0).sum()) for c in native) <= 1200
            assert all(c["labels"].shape == (rows,) for c in native)
    # frozen maps: a file's unknown keys drop
    val = str(data_dir / "val.avro")
    recs = _records(90, seed=9)
    recs[0]["features"].append({"name": "unseen", "term": "z", "value": 3.0})
    write_avro_file(val, _schema(), recs)
    for sid in ("global", "wide"):
        want = list(ref.iter_batch_chunks(val, sid, 64, r_maps))
        _assert_chunks_equal(port.iter_batch_chunks(val, sid, 64, maps), want)
        _assert_chunks_equal(port.iter_batch_chunks(val, sid, 64, maps, use_native=False), want)
    with pytest.raises(ValueError, match="max_nnz"):
        list(port.iter_batch_chunks(path, "wide", 128, maps, max_nnz=2))
    # the default path was the native decoder throughout (the schema's uid is
    # a null / string / long union, which the decoder parses and drops)
    assert not [r for r in caplog.records if "native decoder's envelope" in r.getMessage()]


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_summarize_chunks_matches_the_reference(data_dir, kind):
    port = AvroDataReader({s: FeatureShardConfig(**c) for s, c in SHARDS.items()})
    path = str(data_dir / "train")
    maps, max_nnz = port.streaming_ingest_stats(path)
    sid = "mixed" if kind == "dense" else "wide"
    chunks = list(port.iter_batch_chunks(path, sid, 256, maps, max_nnz=max_nnz[sid]))
    if kind == "sparse":  # a duplicated (row, column) pair adds up before squaring
        chunks[0]["indices"][3, 1] = chunks[0]["indices"][3, 0]
    got = summarize_chunks(chunks, maps[sid].size)
    want = ref_summarize_chunks(chunks, maps[sid].size)
    for f in ("mean", "variance", "min", "max", "max_magnitude"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-12, atol=1e-15, err_msg=f)
    np.testing.assert_array_equal(got.num_nonzeros, want.num_nonzeros)
    assert got.count == want.count == 1200
    # across processes on a process of its own: the same statistics
    alone = summarize_chunks(chunks, maps[sid].size, cross_process=True)
    for f in ("mean", "variance", "min", "max", "max_magnitude", "num_nonzeros"):
        np.testing.assert_array_equal(getattr(alone, f), getattr(got, f), err_msg=f)
    assert alone.count == got.count


def _glm_data(task=TaskType.LOGISTIC_REGRESSION, n=900, d=6, seed=3):
    rng = np.random.default_rng(seed)
    X = (0.7 * rng.normal(size=(n, d)) + 0.3).astype(np.float32)
    X[:, 0] = 1.0
    m = X @ rng.normal(size=d)
    if task is TaskType.LOGISTIC_REGRESSION:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    else:
        y = (m + 0.5 * rng.normal(size=n)).astype(np.float32)
    return X, y


SWEEPS = {
    "l2_sweep": dict(),
    "l1": dict(reg=RegularizationType.L1, weights=(0.5, 5.0)),
    "tron": dict(optimizer=OptimizerType.TRON),
    "normalization": dict(norm=NormalizationType.STANDARDIZATION),
    "simple": dict(variance=VarianceComputationType.SIMPLE, task=TaskType.LINEAR_REGRESSION),
    "full": dict(variance=VarianceComputationType.FULL),
    "prior": dict(prior=True),
}


@pytest.mark.parametrize("case", list(SWEEPS))
def test_train_glm_streamed_matches_the_reference(case):
    spec = SWEEPS[case]
    task = spec.get("task", TaskType.LOGISTIC_REGRESSION)
    X, y = _glm_data(task)
    tr, va = slice(0, 700), slice(700, None)
    chunks = streaming.dense_chunks(X[tr], y[tr], 256)
    val = streaming.dense_chunks(X[va], y[va], 256)
    d = X.shape[1]
    reg = spec.get("reg", RegularizationType.L2)
    weights = spec.get("weights", (0.1, 1.0, 10.0))
    opt = spec.get("optimizer", OptimizerType.LBFGS)
    variance = spec.get("variance", VarianceComputationType.NONE)
    tol = 1e-3 if task is TaskType.LOGISTIC_REGRESSION else 1e-4
    kw, jkw = {}, {}
    if "norm" in spec:
        s = summarize_chunks(chunks, d)
        kw["normalization"] = s.normalization(spec["norm"], 0, device="cpu")
        rs = ref_summarize_chunks(chunks, d)
        jkw["normalization"] = ref_build_normalization(JNormType(spec["norm"].value), rs.mean, rs.variance,
                                                       rs.max_magnitude, 0)
    if spec.get("prior"):
        mean = (0.3 * np.random.default_rng(1).normal(size=d)).astype(np.float32)
        var = np.random.default_rng(2).uniform(0.2, 2.0, size=d).astype(np.float32)
        kw.update(initial_model=glm_from_numpy(mean, var, task, device="cpu"), incremental=True)
        jkw.update(initial_model=JGLM(JCoefficients(jnp.asarray(mean), jnp.asarray(var)), JTask(task.value)),
                   incremental=True)
    got = training.train_glm_streamed(
        chunks, task, d, OptimizerConfig(optimizer_type=opt, max_iterations=60, tolerance=tol),
        RegularizationContext(reg), weights, intercept_index=0, validation_chunks=val,
        variance_computation=variance, device="cpu", **kw,
    )
    want = ref_training.train_glm_streamed(
        jstreaming.dense_chunks(X[tr], y[tr], 256), JTask(task.value),
        d, JConfig(optimizer_type=JOpt(opt.value), max_iterations=60, tolerance=tol), JReg(JRegType(reg.value)),
        weights, intercept_index=0, validation_chunks=jstreaming.dense_chunks(X[va], y[va], 256),
        variance_computation=JVar(variance.value), **jkw,
    )
    assert got.best_weight == want.best_weight
    for lam in weights:
        g, w = got.models[lam].coefficients, want.models[lam].coefficients
        np.testing.assert_allclose(g.means.numpy(), np.asarray(w.means), rtol=1e-3, atol=2e-4)
        if variance is VarianceComputationType.NONE:
            assert g.variances is None
        else:
            np.testing.assert_allclose(g.variances.numpy(), np.asarray(w.variances), rtol=1e-3, atol=1e-6)
        assert abs(got.trackers[lam].iterations - int(want.trackers[lam].iterations)) <= 1
        for k, v in want.validation[lam].metrics.items():
            assert got.validation[lam].metrics[k] == pytest.approx(float(v), rel=1e-4, abs=1e-5)


def test_streamed_sweep_matches_the_in_memory_sweep():
    from photon_ml_tpu_torch.supervised.training import train_glm

    X, y = _glm_data(n=600)
    weights = (0.1, 1.0)
    cfg = OptimizerConfig(max_iterations=80, tolerance=1e-6)
    got = training.train_glm_streamed(streaming.dense_chunks(X, y, 128), TaskType.LOGISTIC_REGRESSION, 6, cfg,
                                      regularization_weights=weights, intercept_index=0, device="cpu")
    want = train_glm(dense_batch_from_numpy(X, y, device="cpu"), TaskType.LOGISTIC_REGRESSION, cfg,
                     regularization_weights=weights, intercept_index=0, device="cpu")
    for lam in weights:
        np.testing.assert_allclose(got.models[lam].coefficients.means.numpy(),
                                   want.models[lam].coefficients.means.numpy(), rtol=1e-2, atol=1e-3)


def _sweep_args(X, y, weights, ckpt_dir, package):
    cfg = (OptimizerConfig if package == "port" else JConfig)(max_iterations=40, tolerance=1e-6)
    if package == "port":
        return dict(chunks=streaming.dense_chunks(X, y, 200), task=TaskType.LOGISTIC_REGRESSION,
                    num_features=X.shape[1], optimizer_config=cfg, regularization_weights=weights,
                    intercept_index=0, checkpoint_dir=ckpt_dir, device="cpu")
    return dict(chunks=jstreaming.dense_chunks(X, y, 200), task=JTask.LOGISTIC_REGRESSION,
                num_features=X.shape[1], optimizer_config=cfg, regularization_weights=weights,
                intercept_index=0, checkpoint_dir=ckpt_dir)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_streamed_sweep_resumes_across_packages(tmp_path, writer):
    X, y = _glm_data(n=500)
    ckpt = str(tmp_path / "ckpt")
    full = training.train_glm_streamed(**_sweep_args(X, y, (0.1, 1.0), None, "port"))
    port_ck = training._StreamedSweepCheckpoint(
        ckpt, TaskType.LOGISTIC_REGRESSION, streaming.dense_chunks(X, y, 200), 6,
        OptimizerConfig(max_iterations=40, tolerance=1e-6), RegularizationContext(RegularizationType.L2))
    ref_ck = ref_training._StreamedSweepCheckpoint(
        ckpt, JTask.LOGISTIC_REGRESSION, jstreaming.dense_chunks(X, y, 200), 6,
        JConfig(max_iterations=40, tolerance=1e-6), JReg(JRegType.L2))
    assert port_ck.fingerprint == ref_ck.fingerprint
    # λ 0.1 completed and λ 1 interrupted at its solution, written by one package
    first = ref_ck if writer == "ref" else port_ck
    first.save_completed(0.1, full.models[0.1].coefficients.means.numpy().astype(np.float64))
    first.save_partial(1.0, full.models[1.0].coefficients.means.numpy().astype(np.float64))
    if writer == "ref":
        resumed = training.train_glm_streamed(**_sweep_args(X, y, (0.1, 1.0), ckpt, "port"))
        assert list(resumed.trackers) == [1.0] and resumed.trackers[1.0].iterations <= 1
        got = {lam: m.coefficients.means.numpy() for lam, m in resumed.models.items()}
    else:
        resumed = ref_training.train_glm_streamed(**_sweep_args(X, y, (0.1, 1.0), ckpt, "ref"))
        assert list(resumed.trackers) == [1.0] and int(resumed.trackers[1.0].iterations) <= 1
        got = {lam: np.asarray(m.coefficients.means) for lam, m in resumed.models.items()}
    # λ 0.1 loads as saved; λ 1 restarts from the saved iterate (its first
    # value is the finished solve's) with a fresh history
    np.testing.assert_array_equal(got[0.1], full.models[0.1].coefficients.means.numpy())
    first = float(resumed.trackers[1.0].loss_history[0])
    assert first == pytest.approx(float(full.trackers[1.0].value), rel=1e-6)
    np.testing.assert_allclose(got[1.0], full.models[1.0].coefficients.means.numpy(), atol=5e-3)
    # another setup ignores the files: a different digest retrains
    other = training.train_glm_streamed(**_sweep_args(X[::-1].copy(), y[::-1].copy(), (0.1,), ckpt, "port"))
    assert list(other.trackers) == [0.1]


def _write_glm_avro(path, X, y):
    recs = [{"uid": f"r{i}", "response": float(label), "offset": None, "weight": None,
             "features": [{"name": "x", "term": str(j), "value": float(row[j])} for j in range(1, len(row))
                          if row[j] != 0.0],
             "metadataMap": None}
            for i, (row, label) in enumerate(zip(X, y))]
    write_avro_file(str(path), TRAINING_EXAMPLE_SCHEMA, recs)


def _best(out, name="best"):
    """The model file's coefficients by (name, term), in one order."""
    rec = ref_read(str(out / name / "model.avro"))[1][0]
    coef = {(r["name"], r["term"]): r["value"] for r in rec["means"]}
    return np.asarray([coef.get(k, 0.0) for k in sorted(coef)] + [len(coef)])


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
                  if not f.startswith("photon.log"))


@pytest.mark.parametrize("flags", ["plain", "all_flags", "tron"])
def test_driver_streamed_branch(tmp_path, flags):
    X, y = _glm_data(n=760, d=7, seed=8)
    X[np.random.default_rng(0).uniform(size=X.shape) < 0.2] = 0.0
    X[:, 0] = 1.0
    os.makedirs(tmp_path / "train")
    _write_glm_avro(tmp_path / "train" / "part-00000.avro", X[:300], y[:300])
    _write_glm_avro(tmp_path / "train" / "part-00001.avro", X[300:600], y[300:600])
    _write_glm_avro(tmp_path / "val.avro", X[600:], y[600:])
    common = ["--task", "LOGISTIC_REGRESSION", "--train-data", str(tmp_path / "train"), "--format", "avro",
              "--validation-data", str(tmp_path / "val.avro"), "--weights", "0.1", "1", "10",
              "--max-iterations", "80", "--tolerance", "1e-8", "--device", "cpu"]
    ref_kw = dict(data_format="avro", validation_data=[str(tmp_path / "val.avro")], weights=[0.1, 1.0, 10.0],
                  max_iterations=80, tolerance=1e-8)
    extra = []
    if flags == "all_flags":
        extra = ["--validate", "VALIDATE_FULL", "--summarize-features", "--normalization", "STANDARDIZATION",
                 "--variance", "SIMPLE", "--diagnostics"]
        ref_kw.update(validate=DataValidationType.VALIDATE_FULL, summarize_features=True,
                      normalization=JNormType.STANDARDIZATION, variance_computation=JVar.SIMPLE, diagnostics=True)
        from photon_ml_tpu.types import DataValidationType as JValidate

        ref_kw["validate"] = JValidate.VALIDATE_FULL
    elif flags == "tron":
        extra = ["--optimizer", "TRON"]
        ref_kw["optimizer"] = JOpt.TRON
    ref_run(JTask.LOGISTIC_REGRESSION, [str(tmp_path / "train")], str(tmp_path / "ref"),
            streaming_chunk_rows=128, **ref_kw)
    cli_main(common + extra + ["--streaming-chunk-rows", "128", "--output-dir", str(tmp_path / "port")])
    cli_main(common + extra + ["--output-dir", str(tmp_path / "memory")])
    assert _listing(tmp_path / "port") == _listing(tmp_path / "ref")
    rep, ref_rep = (json.loads((tmp_path / d / "report.json").read_text()) for d in ("port", "ref"))
    assert rep.keys() == ref_rep.keys() and rep["streaming_chunk_rows"] == 128
    assert rep["best_weight"] == ref_rep["best_weight"]
    assert (tmp_path / "port" / "_stage").read_text() == "VALIDATED"
    best = _best(tmp_path / "port")
    np.testing.assert_allclose(best, _best(tmp_path / "ref"), rtol=1e-2, atol=1e-3)
    mem_rep = json.loads((tmp_path / "memory" / "report.json").read_text())
    assert mem_rep["best_weight"] == rep["best_weight"]
    np.testing.assert_allclose(best, _best(tmp_path / "memory"), rtol=1e-2, atol=1e-3)
    for lam in ("0.1", "1", "10"):
        got = ref_read(str(tmp_path / "port" / "models" / f"lambda-{lam}" / "model.avro"))[1][0]
        want = ref_read(str(tmp_path / "ref" / "models" / f"lambda-{lam}" / "model.avro"))[1][0]
        assert [(r["name"], r["term"]) for r in got["means"]] == [(r["name"], r["term"]) for r in want["means"]]
    if flags == "plain":
        # each package's loader reads the other's streamed model as its own
        from photon_ml_tpu.io.model_io import load_glm as ref_load_glm
        from photon_ml_tpu_torch.io.model_io import load_glm

        port_map = AvroDataReader().streaming_ingest_stats(str(tmp_path / "train"))[0]["global"]
        ref_map = JReader().streaming_ingest_stats(str(tmp_path / "train"))[0]["global"]
        for d in ("port", "ref"):
            path = str(tmp_path / d / "best" / "model.avro")
            np.testing.assert_array_equal(load_glm(path, index_map=port_map, device="cpu").coefficients.means.numpy(),
                                          np.asarray(ref_load_glm(path, index_map=ref_map).coefficients.means))
        # a rerun into the same directory loads every λ from checkpoints/
        again = port_run(TaskType.LOGISTIC_REGRESSION, [str(tmp_path / "train")], str(tmp_path / "port"),
                         data_format="avro", validation_data=[str(tmp_path / "val.avro")],
                         weights=[0.1, 1.0, 10.0], max_iterations=80, tolerance=1e-8, streaming_chunk_rows=128,
                         device="cpu", logger=PhotonLogger(None))
        assert again.trackers == {} and again.best_weight == rep["best_weight"]
        np.testing.assert_allclose(_best(tmp_path / "port"), best, rtol=0, atol=1e-6)


def test_driver_streamed_rejections_and_validation(tmp_path, monkeypatch):
    X, y = _glm_data(n=200, seed=4)
    _write_glm_avro(tmp_path / "t.avro", X, y)
    base = ["--task", "LOGISTIC_REGRESSION", "--train-data", str(tmp_path / "t.avro"), "--format", "avro",
            "--device", "cpu", "--streaming-chunk-rows", "64", "--output-dir", str(tmp_path / "o")]
    with pytest.raises(ValueError, match="NEWTON_CHOLESKY"):
        cli_main(base + ["--optimizer", "NEWTON_CHOLESKY"])
    with pytest.raises(ValueError, match="TRON with --regularization L1"):
        cli_main(base + ["--optimizer", "TRON", "--regularization", "L1"])
    with pytest.raises(ValueError, match="requires --format avro"):
        cli_main([a if a != "avro" else "libsvm" for a in base])
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="multihost initialization failed"):
        cli_main(base + ["--multihost"])  # no process group to join
    with pytest.raises(ValueError, match="--multihost requires --streaming-chunk-rows"):
        cli_main(base[:-4] + base[-2:] + ["--multihost"])
    # ROADMAP item 13 is ported: the flags run, and write the sweep's
    # profiler trace and a valid telemetry run
    fresh = base[:-2] + ["--output-dir", str(tmp_path / "o-item13")]  # a fresh run: no resume
    cli_main(fresh + ["--profile-dir", str(tmp_path / "p")])
    assert (tmp_path / "p" / "glm-sweep-streamed" / "trace.json").stat().st_size > 0
    cli_main(base[:-2] + ["--output-dir", str(tmp_path / "o-item13-t"), "--telemetry-dir", str(tmp_path / "t")])
    from photon_ml_tpu_torch.obs.report import load_run, validate_run

    (run,) = [f for f in os.listdir(tmp_path / "t") if f.endswith(".jsonl")]
    records = load_run(str(tmp_path / "t" / run))
    assert validate_run(records) == [] and any(r["event"] == "optim_result" for r in records)
    from photon_ml_tpu_torch.data.validation import DataValidationError

    y_bad = y.copy()
    y_bad[150] = 3.0
    _write_glm_avro(tmp_path / "bad.avro", X, y_bad)
    bad = [a if a != str(tmp_path / "t.avro") else str(tmp_path / "bad.avro") for a in base]
    with pytest.raises(DataValidationError, match=r"chunk 2 \(rows 128\.\.192"):
        cli_main(bad + ["--validate", "VALIDATE_FULL"])


def test_cross_validate_glm_matches_the_reference():
    X, y = _glm_data(n=400, seed=12)
    weights = (0.1, 1.0, 10.0)
    got = cross_validate_glm(dense_batch_from_numpy(X, y, device="cpu"), TaskType.LOGISTIC_REGRESSION, k=3,
                             regularization_weights=weights, seed=4, intercept_index=0,
                             optimizer_config=OptimizerConfig(max_iterations=60, tolerance=1e-3), device="cpu")
    jb = JDense(X=jnp.asarray(X), labels=jnp.asarray(y), offsets=jnp.zeros(len(y), jnp.float32),
                weights=jnp.ones(len(y), jnp.float32))
    want = ref_cv(jb, JTask.LOGISTIC_REGRESSION, k=3, regularization_weights=weights, seed=4, intercept_index=0,
                  optimizer_config=JConfig(max_iterations=60, tolerance=1e-3))
    assert got.best_weight == want.best_weight and got.metric_name == want.metric_name
    for lam in weights:
        # AUC on 133 held-out rows: one flipped pair moves it by about 2e-4
        np.testing.assert_allclose(got.metric_values[lam], want.metric_values[lam], atol=1e-3)
    np.testing.assert_allclose(got.final.best_model.coefficients.means.numpy(),
                               np.asarray(want.final.best_model.coefficients.means), rtol=1e-2, atol=1e-3)
    assert got.summary()["per_weight"].keys() == want.summary()["per_weight"].keys()
    with pytest.raises(ValueError, match="k >= 2"):
        cross_validate_glm(dense_batch_from_numpy(X, y, device="cpu"), TaskType.LOGISTIC_REGRESSION, k=1,
                           device="cpu")
