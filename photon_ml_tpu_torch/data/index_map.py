"""Feature index maps: (name, term) → dense column index (own copy of
``photon_ml_tpu/data/index_map.py``, without the feature-range sharding of
ROADMAP queue 1 item 12d).

The feature key is name + DELIMITER + term, as the reference's
``AvroDataReader`` forms it. A map is a sorted string array and each key's
index, saved as ``.npz`` in the reference's layout (so either package loads
the other's maps); bulk translation is a numpy ``searchsorted``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

# The reference separates feature name and term with a special delimiter and
# uses a reserved key for the intercept (Constants.INTERCEPT_KEY).
DELIMITER = "\x01"
INTERCEPT_KEY = "(INTERCEPT)"


def feature_key(name: str, term: str = "") -> str:
    return f"{name}{DELIMITER}{term}" if term else name


@dataclass
class IndexMap:
    """Immutable feature-key → index map with O(log n) numpy bulk lookup."""

    _keys: np.ndarray  # sorted unicode array
    _indices: np.ndarray  # int64, index of each sorted key

    @classmethod
    def build(cls, keys: Iterable[str], add_intercept: bool = False) -> "IndexMap":
        """Assign dense ids 0..d-1 in first-seen order (deterministic).
        The intercept, when requested, always gets the LAST index — matching
        the convention used across the framework (intercept_index = d-1)."""
        seen: dict[str, int] = {}
        for k in keys:
            if k == INTERCEPT_KEY:
                continue
            if k not in seen:
                seen[k] = len(seen)
        if add_intercept:
            seen[INTERCEPT_KEY] = len(seen)
        arr = np.array(list(seen.keys()), dtype=np.str_)
        idx = np.array(list(seen.values()), dtype=np.int64)
        order = np.argsort(arr)
        return cls(_keys=arr[order], _indices=idx[order])

    @property
    def size(self) -> int:
        return len(self._keys)

    @property
    def intercept_index(self) -> int | None:
        pos = np.searchsorted(self._keys, INTERCEPT_KEY)
        if pos < len(self._keys) and self._keys[pos] == INTERCEPT_KEY:
            return int(self._indices[pos])
        return None

    def get(self, key: str, default: int = -1) -> int:
        pos = np.searchsorted(self._keys, key)
        if pos < len(self._keys) and self._keys[pos] == key:
            return int(self._indices[pos])
        return default

    def __contains__(self, key: str) -> bool:
        return self.get(key) >= 0

    def __len__(self) -> int:
        return self.size

    def lookup_all(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized lookup: unknown keys map to -1 (callers drop them, the
        reference does the same for features absent from the index)."""
        keys = np.asarray(keys, dtype=np.str_)
        # widen to a common itemsize: casting queries DOWN to the stored
        # width would truncate long unseen keys onto shorter stored ones
        width = max(self._keys.dtype.itemsize, keys.dtype.itemsize) // 4
        keys = keys.astype(f"<U{width}")
        stored = self._keys.astype(f"<U{width}")
        pos = np.searchsorted(stored, keys)
        pos = np.clip(pos, 0, len(stored) - 1)
        found = stored[pos] == keys
        return np.where(found, self._indices[pos], -1)

    def items(self) -> Iterator[tuple[str, int]]:
        for k, i in zip(self._keys, self._indices):
            yield str(k), int(i)

    def keys_for(self, indices) -> list[str]:
        """Reverse lookup (index → feature key) for a FEW indices: one
        vectorized O(d) integer membership test selects just the matching
        entries — no d-sized string allocation, no Python-dict inversion —
        so reporting paths resolve a handful of top features out of 10⁷+
        cheaply. Unknown indices resolve to their decimal string."""
        indices = np.asarray(indices, dtype=np.int64)
        mask = np.isin(self._indices, indices)
        found = {
            int(i): str(k)
            for i, k in zip(self._indices[mask], self._keys[mask])
        }
        return [found.get(int(j), str(int(j))) for j in indices]

    # -- persistence (PalDB-store equivalent: one mmap-able npz per shard) ----
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 keys=self._keys, indices=self._indices)

    @classmethod
    def load(cls, path: str) -> "IndexMap":
        z = np.load(path if path.endswith(".npz") else path + ".npz",
                    allow_pickle=False)
        return cls(_keys=z["keys"], _indices=z["indices"])
