"""Python face of the C++ mmap index store (port of
``photon_ml_tpu/native/index_store.py``).

``NativeIndexStore`` mirrors the lookup surface of ``data.index_map.IndexMap``
(get / lookup_all / size / items) over the mmap'd store, so the two are
interchangeable wherever feature keys are resolved. Builders produce one
store file per feature shard (the reference's partitioned PalDB layout
collapses to one mmap per shard on a single host). The file format is the
reference's: a store either package builds from the same items is the same
file, and each package opens the other's.

There is no fallback: the library comes from ``native.build.load()``,
which raises with the compiler's output when it cannot be built.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterable, Iterator

import numpy as np

from photon_ml_tpu_torch.native.build import load

_DUPLICATE_KEY = -17  # pidx_build's code for a key given twice

_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _pack_keys(keys: list[bytes]) -> tuple[bytes, np.ndarray]:
    offsets = np.zeros(len(keys) + 1, np.uint64)
    offsets[1:] = np.cumsum(np.fromiter(map(len, keys), np.uint64, len(keys)))
    return b"".join(keys), offsets


class NativeIndexStore:
    """Read handle over a built store file."""

    def __init__(self, path: str):
        self._handle = None
        self._lib = load()
        self._handle = self._lib.pidx_open(path.encode())
        if not self._handle:
            raise OSError(f"cannot open index store {path!r}")
        self.path = path

    # -- builder -------------------------------------------------------------
    @classmethod
    def build(cls, path: str, items: Iterable[tuple[str, int]]) -> "NativeIndexStore":
        lib = load()
        pairs = list(items)
        keys = [k.encode() for k, _ in pairs]
        values = np.asarray([v for _, v in pairs], np.int64)
        blob, offsets = _pack_keys(keys)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        rc = lib.pidx_build(path.encode(), blob, offsets.ctypes.data_as(_u64p), len(keys),
                            values.ctypes.data_as(_i64p))
        if rc == _DUPLICATE_KEY:
            raise ValueError("duplicate key while building index store")
        if rc != 0:
            raise OSError(f"pidx_build failed with code {rc}")
        return cls(path)

    # -- lookups -------------------------------------------------------------
    @property
    def size(self) -> int:
        return int(self._lib.pidx_size(self._handle))

    def __len__(self) -> int:
        return self.size

    def get(self, key: str, default: int = -1) -> int:
        raw = key.encode()
        v = int(self._lib.pidx_get(self._handle, raw, len(raw)))
        return v if v >= 0 else default

    def __contains__(self, key: str) -> bool:
        return self.get(key) >= 0

    def lookup_all(self, keys) -> np.ndarray:
        """Bulk lookup (one C call); unknown keys → -1."""
        encoded = [str(k).encode() for k in keys]
        blob, offsets = _pack_keys(encoded)
        out = np.empty(len(encoded), np.int64)
        self._lib.pidx_get_many(self._handle, blob, offsets.ctypes.data_as(_u64p), len(encoded),
                                out.ctypes.data_as(_i64p))
        return out

    def items(self) -> Iterator[tuple[str, int]]:
        num_slots = int(self._lib.pidx_num_slots(self._handle))
        buf = ctypes.create_string_buffer(1 << 16)
        value = ctypes.c_int64()
        for s in range(num_slots):
            n = self._lib.pidx_entry(self._handle, s, buf, len(buf), ctypes.byref(value))
            if n >= 0:
                yield buf.raw[: int(n)].decode(), int(value.value)

    def close(self) -> None:
        if self._handle:
            self._lib.pidx_close(self._handle)
            self._handle = None

    def __del__(self):  # best-effort; mmaps are cheap to leak at exit
        try:
            self.close()
        except Exception:
            pass
