"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At first use they are
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``photon_ml_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the source so an edited kernel is rebuilt, and loaded with ``ctypes``.
Nothing here runs at import: the CPU test suite imports every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_glm.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfused_glm_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library built from this exact source
    exists. ``nvcc``'s report (registers, shared memory, spills per
    kernel) is kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # X, x_bf16, y, off, wt, u, sc, n, d, loss, max_grid, part, out, stream
        lib.photon_fused_vg.argtypes = [p, i, p, p, p, p, p, ll, i, i, i, p, p, p]
        lib.photon_fused_vg.restype = i
        # X, x_bf16, y, off, wt, u, v, sc, n, d, loss, max_grid, part, out, stream
        lib.photon_fused_hvp.argtypes = [p, i, p, p, p, p, p, p, ll, i, i, i, p, p, p]
        lib.photon_fused_hvp.restype = i
        _lib = lib
    return _lib
