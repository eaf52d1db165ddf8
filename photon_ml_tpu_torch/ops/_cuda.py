"""Build and load the port's CUDA kernels.

Every source under ``csrc/`` (the kernels, ``SOURCES``) and
``csrc/graphs/`` (the CUDA graph helpers of ``ops/graphs.py``,
``GRAPH_SOURCES``) has a plain C interface. At first use each is
compiled with ``nvcc`` for ``sm_90a`` into an object, all at once in
parallel, and the objects are linked into one shared library under
``photon_ml_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash
of all the sources, the headers they include (``csrc/*.cuh``) and the
flags, so editing any of them rebuilds it, and
loaded with ``ctypes``. Nothing here runs at import: the CPU test suite
imports every module on a machine with no ``nvcc``.

A build's wall seconds go to the metrics registry's timer
``cuda.build_s`` (the counterpart of the reference's XLA compile timer,
``jax.compile_s``), so a run's telemetry shows what the first kernel call
paid; a library already built costs nothing there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
GRAPH_SOURCES = tuple(sorted((_PKG / "csrc" / "graphs").glob("*.cu")))
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + GRAPH_SOURCES + HEADERS:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libphoton_kernels_{digest.hexdigest()[:16]}.so"


def log_path(library: Path, source: Path) -> Path:
    """``nvcc``'s report for one source (registers, shared memory and
    spills per kernel), kept beside the library."""
    return library.with_name(f"{library.stem}.{source.stem}.log")


def build() -> Path:
    """Compile the kernels unless a library built from these exact sources
    exists: one ``nvcc -c`` per source, all started together, then one
    link."""
    out = library_path()
    if out.exists():
        return out
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    procs: list[subprocess.Popen] = []
    try:
        nvcc = _nvcc()
        sources = SOURCES + GRAPH_SOURCES
        objects = [tmp / f"{src.stem}.o" for src in sources]
        logs = [tmp / f"{src.stem}.log" for src in sources]
        for src, obj, log in zip(sources, objects, logs):
            with open(log, "w") as f:  # the child keeps its own descriptor
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=f, stderr=subprocess.STDOUT,
                ))
        codes = [p.wait() for p in procs]
        for src, code, log in zip(sources, codes, logs):
            if code != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log.read_text()}")
        linked = tmp / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(linked), *map(str, objects)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stderr}")
        for src, log in zip(sources, logs):
            os.replace(log, log_path(out, src))
        os.replace(linked, out)
    finally:
        for p in procs:  # none outlives the build, whatever failed
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    from photon_ml_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.timer_add("cuda.build_s", time.perf_counter() - t0)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        # X, x_bf16, y, off, wt, u, c_ptr, c, n, d, loss, device, max_grid, part, out, stream
        vg = [p, i, p, p, p, p, p, f, ll, i, i, i, i, p, p, p]
        lib.photon_fused_vg.argtypes = vg
        lib.photon_fused_vg.restype = i
        # the same, then the layout (-1 by the rule, 0 rows, 1 tiles)
        lib.photon_fused_vg_layout.argtypes = vg + [i]
        lib.photon_fused_vg_layout.restype = i
        # X, x_bf16, y, off, wt, u, v, c_ptr, cv_ptr, c, cv, n, d, loss, device,
        # max_grid, part, out, stream
        lib.photon_fused_hvp.argtypes = [p, i, p, p, p, p, p, p, p, f, f, ll, i, i, i, i, p, p, p]
        lib.photon_fused_hvp.restype = i
        # offsets, read, values, storage, scale, scale_ld, src, read_len,
        # write_len, nnz, tile_write, carry, square, out, stream
        lib.photon_sparse_apply.argtypes = [p, p, p, i, p, ll, p, ll, ll, ll, p, p, i, p, p]
        lib.photon_sparse_apply.restype = i
        # csrc/graphs/while_loops.cu: graphs, nodes and execs pass as void pointers
        pp, ull = ctypes.POINTER(ctypes.c_void_p), ctypes.c_ulonglong
        for name, args in (("photon_graph_create", [pp]), ("photon_graph_destroy", [p]),
                           ("photon_graph_node_count", [p, ctypes.POINTER(ull)]),
                           ("photon_graph_add_child", [p, p, p, pp]),
                           ("photon_graph_add_while", [p, p, p, pp, pp, ctypes.POINTER(ull)]),
                           ("photon_graph_add_set", [p, p, ull, p, pp]),
                           ("photon_graph_instantiate", [p, pp]), ("photon_graph_launch", [p, p]),
                           ("photon_graph_exec_destroy", [p])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i
        _lib = lib
    return _lib
