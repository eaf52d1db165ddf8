"""Build and load the port's native (C++) host library.

``index_store.cc`` (the mmap'd feature-index store) and ``avro_ingest.cc``
(the columnar Avro decoder) are compiled together at first use with the system ``g++``
(``-O2 -shared -fPIC -std=c++17``, linked against zlib) into the cache
directory ``PHOTON_ML_TPU_CACHE``, or else ``photon_ml_tpu_torch_native``
under the temporary directory (the reference's rule, read at call time:
nothing is written into the package, which may be read-only), named by a
hash of both sources and the flags, so an edit rebuilds it. Concurrent builds
(test workers) each compile to their own temporary name and rename the
result into place atomically. A failed build raises with the compiler's
output: the readers never fall back to the Python codec because the
library is missing. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(Path(__file__).resolve().parent / f for f in ("index_store.cc", "avro_ingest.cc"))
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz",)

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def build_dir() -> Path:
    """``PHOTON_ML_TPU_CACHE``, or ``photon_ml_tpu_torch_native`` under the
    temporary directory when it is unset or empty."""
    root = os.environ.get("PHOTON_ML_TPU_CACHE")
    return Path(root) if root else Path(tempfile.gettempdir()) / "photon_ml_tpu_torch_native"


def library_path() -> Path:
    digest = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, *LIBS)).encode())
    for src in SOURCES:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return build_dir() / f"libphoton_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless one built from these exact sources and
    flags exists; raises ``RuntimeError`` with the compiler's output when
    the build fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")
    os.close(fd)
    try:
        try:
            proc = subprocess.run(
                [CXX, *CXX_FLAGS, *map(str, SOURCES), "-o", tmp, *LIBS],
                capture_output=True, text=True,
            )
        except OSError as e:
            raise RuntimeError(f"building the native library failed: {CXX}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native library failed ({CXX} exit {proc.returncode}):\n"
                f"{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic against concurrent builds
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The loaded library with its ctypes signatures (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    charp = ctypes.POINTER(ctypes.c_char)
    # ---- the feature-index store (index_store.cc) ----
    lib.pidx_build.argtypes = [ctypes.c_char_p, ctypes.c_char_p, u64p, ctypes.c_uint64, i64p]
    lib.pidx_build.restype = ctypes.c_int
    lib.pidx_open.argtypes = [ctypes.c_char_p]
    lib.pidx_open.restype = ctypes.c_void_p
    lib.pidx_close.argtypes = [ctypes.c_void_p]
    lib.pidx_close.restype = None
    lib.pidx_size.argtypes = [ctypes.c_void_p]
    lib.pidx_size.restype = ctypes.c_uint64
    lib.pidx_num_slots.argtypes = [ctypes.c_void_p]
    lib.pidx_num_slots.restype = ctypes.c_uint64
    lib.pidx_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.pidx_get.restype = ctypes.c_int64
    lib.pidx_get_many.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u64p, ctypes.c_uint64, i64p]
    lib.pidx_get_many.restype = None
    lib.pidx_entry.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64, i64p]
    lib.pidx_entry.restype = ctypes.c_int64
    # ---- the columnar Avro decoder (avro_ingest.cc) ----
    # path, ops, n_ops, defaults, n_slots, tags blob, tag lengths, n_tags,
    # n_bags, capture uid, error buffer, its length
    lib.pavro_ingest.argtypes = [
        ctypes.c_char_p, u32p, ctypes.c_uint32, f64p, ctypes.c_uint32,
        ctypes.c_char_p, u32p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.pavro_ingest.restype = ctypes.c_void_p
    lib.pavro_free.argtypes = [ctypes.c_void_p]
    lib.pavro_free.restype = None
    lib.pavro_num_rows.argtypes = [ctypes.c_void_p]
    lib.pavro_num_rows.restype = ctypes.c_uint64
    lib.pavro_numeric.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.pavro_numeric.restype = f64p
    for name, restype in (
        ("pavro_bag_nnz", ctypes.c_uint64),
        ("pavro_bag_rowptr", i64p),
        ("pavro_bag_ids", u32p),
        ("pavro_bag_values", ctypes.POINTER(ctypes.c_float)),
        ("pavro_bag_num_uniq", ctypes.c_uint64),
        ("pavro_bag_uniq_blob", charp),
        ("pavro_bag_uniq_offsets", u64p),
        ("pavro_tag_ids", ctypes.POINTER(ctypes.c_int32)),
        ("pavro_tag_num_uniq", ctypes.c_uint64),
        ("pavro_tag_uniq_blob", charp),
        ("pavro_tag_uniq_offsets", u64p),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        fn.restype = restype
    for name, restype in (
        ("pavro_uid_blob", charp),
        ("pavro_uid_offsets", u64p),
        ("pavro_uid_kinds", ctypes.POINTER(ctypes.c_uint8)),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = restype
    return lib
