"""A byte-budgeted LRU map (port of ``photon_ml_tpu/ops/bytelru.py``): an
ordered map of entries with a byte cost, a budget read at call time, and
hit / miss / eviction hooks in bytes. Serving's hot model store keeps its
per-entity coefficient rows in one (``serve/store.py``).

Two rules: an entry larger than the whole budget is never admitted (one
oversized entry must not empty the working set and then pin itself), and
eviction walks strictly least-recently-used until the budget holds.

The hooks carry no metric names: a caller wires them to its own registry
counters (``serve.hot.*`` for the model store). They run outside the
instance lock, so a hook may call back into the map.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable

_NOOP: Callable[[int], None] = lambda nbytes: None


class ByteBudgetLRU:
    """Byte-budgeted LRU map of ``key -> (value, nbytes)``.

    ``budget_fn`` is read on every admission, so a retuned knob takes
    effect without rebuilding the map. ``get`` refreshes recency on a hit;
    ``put`` admits the entry, then evicts least-recently-used entries until
    the budget holds. An entry whose ``nbytes`` exceeds the whole budget is
    not admitted."""

    def __init__(
        self,
        budget_fn: Callable[[], int],
        on_hit: Callable[[int], None] = _NOOP,
        on_miss: Callable[[int], None] = _NOOP,
        on_evict: Callable[[int], None] = _NOOP,
    ) -> None:
        self._budget_fn = budget_fn
        self._on_hit = on_hit
        self._on_miss = on_miss
        self._on_evict = on_evict
        self._entries: OrderedDict[Hashable, tuple[Any, int]] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    @property
    def bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def get(self, key: Hashable):
        """The cached value (recency refreshed, the hit hook fired with the
        entry's bytes), or None. A miss fires no hook here: only ``put``
        knows the missing entry's bytes, so the miss hook fires there."""
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                return None
            self._entries.move_to_end(key)
            value, nbytes = hit
        self._on_hit(nbytes)
        return value

    def put(self, key: Hashable, value: Any, nbytes: int) -> Any:
        """Admit ``key`` (the miss hook fires with ``nbytes``), evicting
        least-recently-used entries over budget, and return ``value``. An
        existing key is replaced in place (bytes counted again, recency
        refreshed)."""
        nbytes = int(nbytes)
        evicted: list[int] = []
        budget = max(int(self._budget_fn()), 0)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            if nbytes <= budget:
                self._entries[key] = (value, nbytes)
                self._bytes += nbytes
                while self._bytes > budget and self._entries:
                    _, (_, b_old) = self._entries.popitem(last=False)
                    self._bytes -= b_old
                    evicted.append(b_old)
        self._on_miss(nbytes)
        for b in evicted:
            self._on_evict(b)
        return value

    def drop(self, key: Hashable) -> None:
        """Remove one entry if present. No hook fires: an invalidation (a
        refreshed row replacing its stale copy) is not an eviction."""
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes}
