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
    from photon_ml_tpu_torch.convert import dense_batch_from_numpy
    from photon_ml_tpu_torch.data.synthetic import synthetic_glm_data
    from photon_ml_tpu_torch.ops.glm import make_objective
    from photon_ml_tpu_torch.ops.losses import logistic_loss
    from photon_ml_tpu_torch.supervised.training import train_glm
    from photon_ml_tpu_torch.types import TaskType

    rng = np.random.default_rng(0)
    cpu_batch = dense_batch_from_numpy(
        rng.normal(size=(8, 3)).astype(np.float32), np.ones(8, np.float32), device="cpu"
    )
    data = tmp_path / "d.libsvm"
    data.write_text("1 1:0.5\n-1 2:1.5\n")
    task = TaskType.LOGISTIC_REGRESSION
    return {
        "synthetic_glm_data": lambda **kw: synthetic_glm_data(rng, 8, 3, **kw),
        "make_objective": lambda **kw: make_objective(cpu_batch, logistic_loss, **kw),
        "train_glm": lambda **kw: train_glm(cpu_batch, task, **kw),
        "cli.run": lambda **kw: run(task, [str(data)], str(tmp_path / "out"), **kw),
        "dense_batch_from_numpy": lambda **kw: dense_batch_from_numpy(
            np.ones((2, 2), np.float32), np.ones(2, np.float32), **kw
        ),
    }


@pytest.mark.parametrize(
    "name",
    ["synthetic_glm_data", "make_objective", "train_glm", "cli.run", "dense_batch_from_numpy"],
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
