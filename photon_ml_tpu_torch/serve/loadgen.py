"""The Zipf open-loop load generator of the serving path (port of
``photon_ml_tpu/serve/loadgen.py``).

Open loop: arrivals are scheduled, not paced by completions. Request i's
arrival comes from a Poisson process at a fixed rate, fixed before the
trace starts, and its latency runs from that scheduled arrival to its
score. A server that falls behind pays the queueing delay in its tail
latency instead of slowing the generator down.

Entity popularity is bounded Zipf: rank k of E entities is drawn with
probability proportional to 1/(k+1)^s, and ranks map to ids through a
seeded permutation, so the hot head is scattered over the id space.
Zipf(1) with the hot set at 25% of the random-effect bytes is the gated
operating point (hit rate >= 0.8).

The trace loop runs on the wall clock: sleep to the earlier of the next
arrival and the server's ``next_deadline()``, then submit or poll. At the
end the summary goes to the registry as the gauges
``serve.latency_p50_ms``, ``serve.latency_p99_ms``, ``serve.hot.hit_rate``
and ``serve.window.occupancy_mean``.
"""

from __future__ import annotations

import time

import numpy as np

from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.serve.router import MicroWindowServer, ScoreRequest
from photon_ml_tpu_torch.serve.store import HotModelStore


def zipf_entity_trace(num_entities: int, n: int, s: float = 1.0, rng: np.random.Generator | None = None) -> np.ndarray:
    """(n,) int64 entity ids drawn bounded-Zipf(s) over ``num_entities``,
    ranks mapped to ids through a seeded permutation."""
    rng = rng or np.random.default_rng(0)
    ranks = np.arange(1, int(num_entities) + 1, dtype=np.float64)
    p = ranks ** (-float(s))
    p /= p.sum()
    perm = rng.permutation(int(num_entities))
    return perm[rng.choice(int(num_entities), size=int(n), p=p)].astype(np.int64)


def open_loop_arrivals(n: int, rate_hz: float, rng: np.random.Generator | None = None) -> np.ndarray:
    """(n,) float64 scheduled arrival times (seconds from the trace's
    start) of a Poisson process at ``rate_hz``, fixed up front."""
    rng = rng or np.random.default_rng(0)
    return np.cumsum(rng.exponential(1.0 / float(rate_hz), size=int(n)))


def run_serve_trace(store: HotModelStore, requests: list[ScoreRequest], max_batch: int | None = None,
                    max_wait_ms: float | None = None, clock=time.monotonic, sleep=time.sleep) -> dict:
    """Drive one open-loop trace against a fresh ``MicroWindowServer`` over
    ``store``. Each request's ``arrival_s`` is its scheduled arrival
    (seconds from the trace's start); requests come in arrival order.
    ``clock`` / ``sleep`` may be replaced for simulated time. Returns the
    latency summary (and each request's score under ``scores``) and sets
    the trace-end gauges."""
    completion_s: dict[int, float] = {}
    scores: dict[int, float] = {}
    t0 = clock()

    def _on_scores(window, window_scores):
        done = clock() - t0
        for r, sc in zip(window, window_scores):
            completion_s[r.rid] = done
            scores[r.rid] = float(sc)

    server = MicroWindowServer(store, on_scores=_on_scores, max_batch=max_batch, max_wait_ms=max_wait_ms,
                               clock=clock)
    for req in requests:
        target = t0 + float(req.arrival_s)
        while True:
            now = clock()
            deadline = server.next_deadline()
            if deadline is not None and deadline <= min(now, target):
                server.poll(now)
                continue
            if now >= target:
                break
            until = target if deadline is None else min(target, deadline)
            sleep(max(until - now, 0.0))
        server.submit(req)

    # the tail: pending windows age out on their own deadlines (draining at
    # once would report a better tail than the knobs allow)
    while True:
        deadline = server.next_deadline()
        if deadline is None:
            break
        sleep(max(deadline - clock(), 0.0))
        server.poll()

    lat_ms = np.asarray([(completion_s[r.rid] - float(r.arrival_s)) * 1e3 for r in requests], np.float64)
    summary = {
        "requests": len(requests),
        "windows": server.windows,
        "latency_p50_ms": float(np.percentile(lat_ms, 50)),
        "latency_p99_ms": float(np.percentile(lat_ms, 99)),
        "latency_mean_ms": float(lat_ms.mean()),
        "hot_hit_rate": store.hit_rate(),
        "window_occupancy_mean": server.occupancy_mean(),
        "elapsed_s": float(clock() - t0),
        "scores": scores,
    }
    REGISTRY.gauge_set("serve.latency_p50_ms", summary["latency_p50_ms"])
    REGISTRY.gauge_set("serve.latency_p99_ms", summary["latency_p99_ms"])
    REGISTRY.gauge_set("serve.hot.hit_rate", summary["hot_hit_rate"])
    REGISTRY.gauge_set("serve.window.occupancy_mean", summary["window_occupancy_mean"])
    return summary
