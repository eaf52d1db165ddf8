"""Typed process-wide metrics registry: counters, gauges, histograms and
timers (own copy of ``photon_ml_tpu/obs/metrics.py``).

The registry is the always-on half of run telemetry: instruments
accumulate in host memory under one lock whether or not a JSONL sink is
configured. ``utils/profiling.py``'s stage timers are a view of the timer
kind here. A snapshot is a plain JSON-serializable dict, so it rides in a
telemetry ``run_end`` record or a test assertion without translation.

Instrument kinds:

- **Counter**: an accumulating float (``inc``); e.g. chunk-cache hit and
  miss bytes, evictions, streamed passes and chunks.
- **Gauge**: last write wins (``set``); e.g. a run's dropped-row fraction
  per grouped-evaluator tag.
- **Histogram**: ``observe`` keeps count, sum, min, max and log2 bucket
  counts; e.g. the host solvers' iterations per solve.
- **Timer**: accumulating wall seconds and a call count, the shape
  ``counter_snapshot`` returns (``{"seconds", "calls"}``).

Thread-safe: prefetch workers and the consumer thread update the same
instruments. The one lock is a leaf (no instrument takes another lock), so
callers may update from inside their own critical sections.
"""

from __future__ import annotations

import math
import threading


class Counter:
    __slots__ = ("value", "calls")

    def __init__(self):
        self.value = 0.0
        self.calls = 0


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class Histogram:
    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: dict[int, int] = {}  # log2 bucket index -> count

    def _observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        b = -1 if v <= 0 else int(math.floor(math.log2(v)))
        self.buckets[b] = self.buckets.get(b, 0) + 1


class Timer:
    __slots__ = ("seconds", "calls")

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0


class MetricsRegistry:
    """Name → instrument maps, one lock, JSON-plain snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._timers: dict[str, Timer] = {}

    # -- writes ------------------------------------------------------------

    def counter_inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            c.value += value
            c.calls += 1

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            g.value = float(value)

    def histogram_observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            h._observe(float(value))

    def timer_add(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self._timers.get(name)
            if t is None:
                t = self._timers[name] = Timer()
            t.seconds += float(seconds)
            t.calls += 1

    # -- reads -------------------------------------------------------------

    def timer_snapshot(self, prefix: str | None = None) -> dict:
        """``{name: {"seconds", "calls"}}``: the stage-timer shape
        ``utils/profiling.counter_snapshot`` returns."""
        with self._lock:
            return {
                k: {"seconds": t.seconds, "calls": t.calls}
                for k, t in self._timers.items()
                if prefix is None or k.startswith(prefix)
            }

    def snapshot(self, prefix: str | None = None) -> dict:
        """Every instrument as a JSON-plain dict (the telemetry
        ``run_end`` record, report tables)."""

        def keep(k):
            return prefix is None or k.startswith(prefix)

        with self._lock:
            return {
                "counters": {
                    k: {"value": c.value, "calls": c.calls}
                    for k, c in self._counters.items() if keep(k)
                },
                "gauges": {
                    k: g.value for k, g in self._gauges.items() if keep(k)
                },
                "histograms": {
                    k: {
                        "count": h.count,
                        "sum": h.sum,
                        "min": None if h.count == 0 else h.min,
                        "max": None if h.count == 0 else h.max,
                        "log2_buckets": {str(b): n for b, n in sorted(h.buckets.items())},
                    }
                    for k, h in self._histograms.items() if keep(k)
                },
                "timers": {
                    k: {"seconds": t.seconds, "calls": t.calls}
                    for k, t in self._timers.items() if keep(k)
                },
            }

    # -- resets ------------------------------------------------------------

    def reset_timers(self, prefix: str | None = None) -> None:
        with self._lock:
            for k in [k for k in self._timers
                      if prefix is None or k.startswith(prefix)]:
                del self._timers[k]

    def reset(self, prefix: str | None = None) -> None:
        with self._lock:
            for m in (self._counters, self._gauges, self._histograms,
                      self._timers):
                for k in [k for k in m
                          if prefix is None or k.startswith(prefix)]:
                    del m[k]


# the process-wide registry (a module-level singleton, as the tile-layout
# and chunk caches are)
REGISTRY = MetricsRegistry()
