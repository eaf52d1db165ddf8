"""Durable atomic file replacement, fsync → rename → directory fsync (own
copy of ``photon_ml_tpu/utils/atomic_io.py``).

The descent checkpoint needs this guarantee: a reader (or a resume after a
crash) sees either the PREVIOUS complete file or the NEW complete file,
never a truncated hybrid. ``os.replace`` alone is
atomic only in the namespace; it says nothing about data blocks, so a
kill between rename and writeback can commit a truncated file under the
final name. The full sequence is: write to a temp file in the SAME
directory, fsync the data, atomically rename over the final path, then
fsync the directory so the rename itself is durable. On any failure the
temp file is removed and the final path is untouched.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable


def atomic_replace(
    directory: str, final_path: str, write: "Callable[[object], None]"
) -> None:
    """Run ``write(fileobj)`` against a temp file and durably commit it to
    ``final_path`` (fsync → atomic rename → directory fsync). ``write``
    receives a binary file object; an exception from it removes the temp
    file and leaves any existing ``final_path`` byte-for-byte intact."""
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:
        os.replace(tmp, final_path)
    except BaseException:
        # a failed rename (final path is a directory, permissions, stale
        # NFS handle) must not leave a .tmp turd either
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    dfd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def atomic_replace_bytes(directory: str, final_path: str, data: bytes) -> None:
    """Durably commit ``data`` to ``final_path`` through a same-directory
    temp file."""
    atomic_replace(directory, final_path, lambda f: f.write(data))


def atomic_savez(directory: str, final_path: str, payload: dict) -> None:
    """Durably write an ``.npz`` payload (the descent checkpoint). Writing
    through a file OBJECT sidesteps ``np.savez``'s implicit ``.npz``
    suffix games on path names."""
    import numpy as np

    atomic_replace(directory, final_path, lambda f: np.savez(f, **payload))
