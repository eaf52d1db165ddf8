"""The PyTorch port stands alone: no module of ``photon_ml_tpu_torch`` (nor
``chip_smoke.py``) imports ``jax`` or the JAX package, importing the port
loads no JAX, and its entry points run on CUDA unless asked for the CPU."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "photon_ml_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "photon_ml_tpu")


def _port_sources() -> list[str]:
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, filenames in os.walk(PORT):
        paths += [os.path.join(dirpath, f) for f in filenames if f.endswith(".py")]
    return sorted(paths)


def _forbidden(module: str) -> bool:
    # by whole dotted component: ``photon_ml_tpu_torch`` is not ``photon_ml_tpu``
    return module.split(".")[0] in FORBIDDEN


def _imports(path: str) -> list[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", None))
            in ("__import__", "import_module")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            names.append(node.args[0].value)
    return names


def test_forbidden_matches_by_component():
    assert _forbidden("photon_ml_tpu") and _forbidden("photon_ml_tpu.ops.glm")
    assert _forbidden("jax.numpy") and _forbidden("jax")
    assert not _forbidden("photon_ml_tpu_torch.ops.glm")
    assert not _forbidden("jaxtyping_like_name_torch")


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_module_imports_no_jax(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_import_port_loads_no_jax():
    code = (
        "import sys, photon_ml_tpu_torch\n"
        "import photon_ml_tpu_torch.supervised.training, photon_ml_tpu_torch.cli.train_glm\n"
        "import photon_ml_tpu_torch.convert, photon_ml_tpu_torch.data.synthetic\n"
        "import photon_ml_tpu_torch.ops.sparse_tiled, photon_ml_tpu_torch.ops._cuda\n"
        "import photon_ml_tpu_torch.cli.train, photon_ml_tpu_torch.io.native_ingest\n"
        "import photon_ml_tpu_torch.hyperparameter.tuning, photon_ml_tpu_torch.diagnostics\n"
        "import photon_ml_tpu_torch.ops.streaming, photon_ml_tpu_torch.ops.prefetch\n"
        "import photon_ml_tpu_torch.ops.tile_cache, photon_ml_tpu_torch.optim.host_lbfgs\n"
        "import photon_ml_tpu_torch.optim.host_tron, photon_ml_tpu_torch.supervised.cross_validation\n"
        "import photon_ml_tpu_torch.game.streaming, photon_ml_tpu_torch.io.data_reader\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'photon_ml_tpu'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_import_sets_float32_matmul_precision():
    import photon_ml_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _entry_calls(tmp_path):
    from photon_ml_tpu_torch.cli.train_glm import run
    from photon_ml_tpu_torch.convert import dense_batch_from_numpy, sparse_batch_from_numpy
    from photon_ml_tpu_torch.data.libsvm import read_libsvm, to_padded_sparse
    from photon_ml_tpu_torch.data.summary import summarize
    from photon_ml_tpu_torch.data.synthetic import synthetic_glm_data
    from photon_ml_tpu_torch.config import FixedEffectCoordinateConfig, GameTrainingConfig
    from photon_ml_tpu_torch.game.projector import RandomProjector
    from photon_ml_tpu_torch.game.streaming import StreamedGameTrainer
    from photon_ml_tpu_torch.io.avro import write_avro_file
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA
    from photon_ml_tpu_torch.normalization import build_normalization, no_normalization
    from photon_ml_tpu_torch.ops.glm import make_objective
    from photon_ml_tpu_torch.ops.batch import dense_batch_from_arrays
    from photon_ml_tpu_torch.ops.losses import logistic_loss
    from photon_ml_tpu_torch.ops.streaming import StreamingGLMObjective, dense_chunks, stream_scores
    from photon_ml_tpu_torch.supervised.cross_validation import cross_validate_glm
    from photon_ml_tpu_torch.supervised.training import train_glm, train_glm_streamed
    from photon_ml_tpu_torch.types import NormalizationType, TaskType

    rng = np.random.default_rng(0)
    cpu_batch = dense_batch_from_numpy(
        rng.normal(size=(8, 3)).astype(np.float32), np.ones(8, np.float32), device="cpu"
    )
    data = tmp_path / "d.libsvm"
    data.write_text("1 1:0.5\n-1 2:1.5\n")
    task = TaskType.LOGISTIC_REGRESSION
    stats = (np.zeros(3), np.ones(3), np.ones(3))
    summary = summarize(cpu_batch)
    chunks = dense_chunks(rng.normal(size=(8, 3)).astype(np.float32), np.ones(8, np.float32), 4)
    avro = tmp_path / "d.avro"
    write_avro_file(str(avro), TRAINING_EXAMPLE_SCHEMA, [
        {"uid": None, "response": float(i % 2), "offset": None, "weight": None,
         "features": [{"name": "x", "term": "", "value": float(i)}], "metadataMap": None}
        for i in range(8)
    ])
    return {
        "synthetic_glm_data": lambda **kw: synthetic_glm_data(rng, 8, 3, **kw),
        "make_objective": lambda **kw: make_objective(cpu_batch, logistic_loss, **kw),
        "train_glm": lambda **kw: train_glm(cpu_batch, task, **kw),
        "cli.run": lambda **kw: run(task, [str(data)], str(tmp_path / "out"), **kw),
        "dense_batch_from_numpy": lambda **kw: dense_batch_from_numpy(
            np.ones((2, 2), np.float32), np.ones(2, np.float32), **kw
        ),
        "sparse_batch_from_numpy": lambda **kw: sparse_batch_from_numpy(
            np.zeros((2, 1), np.int64), np.ones((2, 1), np.float32), np.ones(2, np.float32),
            num_features=3, **kw
        ),
        "read_libsvm": lambda **kw: read_libsvm(str(data), **kw),
        "to_padded_sparse": lambda **kw: to_padded_sparse(
            np.ones(2, np.float32), [np.array([0]), np.array([1])],
            [np.ones(1, np.float32), np.ones(1, np.float32)], **kw
        ),
        "no_normalization": lambda **kw: no_normalization(3, **kw),
        "build_normalization": lambda **kw: build_normalization(
            NormalizationType.SCALE_WITH_STANDARD_DEVIATION, *stats, **kw
        ),
        "FeatureSummary.normalization": lambda **kw: summary.normalization(
            NormalizationType.STANDARDIZATION, intercept_index=None, **kw
        ),
        "RandomProjector.build": lambda **kw: RandomProjector.build(3, 2, **kw),
        "dense_batch_from_arrays": lambda **kw: dense_batch_from_arrays(
            np.ones((2, 2), np.float32), np.ones(2, np.float32), **kw
        ),
        "StreamingGLMObjective": lambda **kw: StreamingGLMObjective(chunks, logistic_loss, 3, **kw),
        "stream_scores": lambda **kw: stream_scores(chunks, np.zeros(3, np.float32), 8, **kw),
        "train_glm_streamed": lambda **kw: train_glm_streamed(chunks, task, 3, **kw),
        "cross_validate_glm": lambda **kw: cross_validate_glm(cpu_batch, task, k=2, **kw),
        "cli.run --streaming-chunk-rows": lambda **kw: run(
            task, [str(avro)], str(tmp_path / "streamed"), data_format="avro", streaming_chunk_rows=4, **kw
        ),
        "StreamedGameTrainer": lambda **kw: StreamedGameTrainer(
            GameTrainingConfig(fixed_effect_coordinates={"fixed": FixedEffectCoordinateConfig()}), **kw
        ),
    }


@pytest.mark.parametrize(
    "name",
    [
        "synthetic_glm_data", "make_objective", "train_glm", "cli.run", "dense_batch_from_numpy",
        "sparse_batch_from_numpy", "read_libsvm", "to_padded_sparse", "no_normalization",
        "build_normalization", "FeatureSummary.normalization", "RandomProjector.build",
        "dense_batch_from_arrays", "StreamingGLMObjective", "stream_scores", "train_glm_streamed",
        "cross_validate_glm", "cli.run --streaming-chunk-rows", "StreamedGameTrainer",
    ],
)
def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path, monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_calls(tmp_path)[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    call(device="cpu")  # the CPU only when asked for


def test_entry_point_rejects_data_on_another_device():
    from photon_ml_tpu_torch.convert import dense_batch_from_numpy
    from photon_ml_tpu_torch.ops.glm import make_objective
    from photon_ml_tpu_torch.ops.losses import logistic_loss

    batch = dense_batch_from_numpy(np.ones((2, 2), np.float32), np.ones(2, np.float32), device="cpu")
    with pytest.raises(ValueError, match="lies on cpu"):
        make_objective(batch, logistic_loss, device="meta")
