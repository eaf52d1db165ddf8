"""Feature index maps: (name, term) → dense column index, and the
feature-range plan of the sharded fixed effect (own copy of
``photon_ml_tpu/data/index_map.py``).

The feature key is name + DELIMITER + term, as the reference's
``AvroDataReader`` forms it. A map is a sorted string array and each key's
index, saved as ``.npz`` in the reference's layout (so either package loads
the other's maps); bulk translation is a numpy ``searchsorted``.

``PHOTON_FE_SHARD=1`` splits the feature space [0, d) into P contiguous
ranges, one a process (``plan_feature_ranges``), and the streamed
fixed-effect objective (``ops/streaming.py``) then holds only its range:
its packed K3 layouts, its coefficients and its gradient shrink to about
1/P. The plan reads only the global per-feature nonzero counts and P, so
every process derives the same boundaries without a word exchanged. Like
every fleet knob it must be set alike on all processes.
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

# Feature-range sharding of the streamed fixed effect (PHOTON_FE_SHARD):
# 0 (default) keeps every process on the whole feature space, bit for bit;
# 1 gives each process one range of ``plan_feature_ranges``.
FE_SHARD = 0

# The axis the ranges balance (PHOTON_FE_SPLIT_WEIGHT): "nnz" (default)
# cuts the per-feature nonzero prefix sum, so a hot block of columns does
# not pin one process's packed bytes at a multiple of the mean; "width"
# cuts the index space evenly.
FE_SPLIT_WEIGHT = "nnz"

_FE_SPLIT_WEIGHT_MODES = ("nnz", "width")


def fe_shard_enabled() -> bool:
    """``PHOTON_FE_SHARD`` (a non-empty variable wins over ``FE_SHARD``),
    parsed as an int: a typo raises instead of running the knob off."""
    env = os.environ.get("PHOTON_FE_SHARD")
    if env is not None and env != "":
        return int(env) != 0
    return int(FE_SHARD) != 0


def fe_split_weight() -> str:
    """``PHOTON_FE_SPLIT_WEIGHT`` (a non-empty variable wins over
    ``FE_SPLIT_WEIGHT``); an unknown axis raises."""
    env = os.environ.get("PHOTON_FE_SPLIT_WEIGHT")
    mode = str(env if (env is not None and env != "") else FE_SPLIT_WEIGHT)
    if mode not in _FE_SPLIT_WEIGHT_MODES:
        raise ValueError(
            f"PHOTON_FE_SPLIT_WEIGHT must be one of {_FE_SPLIT_WEIGHT_MODES}, got {mode!r}")
    return mode


@dataclass(frozen=True)
class FeatureRangePlan:
    """[0, d) cut into ``num_ranges`` half-open ranges
    ``[boundaries[p], boundaries[p + 1])``: disjoint, covering every
    feature once, so per-range segments concatenate to the full vector."""

    boundaries: tuple[int, ...]  # num_ranges + 1 ascending ints, [0] = 0, [-1] = d
    weights: tuple[float, ...]  # each range's weight (nonzeros or width)

    @property
    def num_ranges(self) -> int:
        return len(self.boundaries) - 1

    @property
    def num_features(self) -> int:
        return int(self.boundaries[-1])

    @property
    def balance(self) -> float:
        """The heaviest range's weight over the mean (1.0 when all weigh 0)."""
        w = np.asarray(self.weights, dtype=np.float64)
        mean = float(w.mean()) if len(w) else 0.0
        return float(w.max() / mean) if mean > 0 else 1.0

    def range_of(self, pid: int) -> tuple[int, int]:
        return int(self.boundaries[pid]), int(self.boundaries[pid + 1])


def plan_feature_ranges(weights, num_ranges: int, mode: str | None = None) -> FeatureRangePlan:
    """Cut [0, d) into ``num_ranges`` contiguous, non-empty ranges.

    ``weights`` is the global per-feature histogram (nonzero counts on the
    default axis). Each boundary sits where the prefix sum comes nearest
    k·total/P (the tie goes to the lower index), kept ascending and leaving
    room for the cuts after it. ``mode`` "width", or a histogram of zeros,
    cuts the index space evenly. ``mode`` defaults to ``fe_split_weight()``."""
    w = np.asarray(weights, dtype=np.float64).ravel()
    d = len(w)
    p = int(num_ranges)
    if p <= 0:
        raise ValueError(f"num_ranges must be positive, got {num_ranges}")
    if d < p:
        raise ValueError(f"cannot split {d} features into {p} ranges")
    mode = fe_split_weight() if mode is None else mode
    if mode not in _FE_SPLIT_WEIGHT_MODES:
        raise ValueError(f"feature split mode must be one of {_FE_SPLIT_WEIGHT_MODES}, got {mode!r}")
    if mode == "width" or float(w.sum()) <= 0.0:
        cuts = [round(k * d / p) for k in range(p + 1)]
    else:
        prefix = np.concatenate([[0.0], np.cumsum(w)])
        total = float(prefix[-1])
        cuts = [0]
        for k in range(1, p):
            target = k * total / p
            pos = int(np.searchsorted(prefix, target))
            if pos > 0 and (pos > d or target - prefix[pos - 1] <= prefix[pos] - target):
                pos -= 1
            cuts.append(min(max(pos, cuts[-1] + 1), d - (p - k)))
        cuts.append(d)
    bounds = tuple(int(c) for c in cuts)
    return FeatureRangePlan(boundaries=bounds,
                            weights=tuple(float(w[lo:hi].sum()) for lo, hi in zip(bounds, bounds[1:])))


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
