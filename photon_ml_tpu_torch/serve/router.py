"""Request routing and micro-window scoring (port of
``photon_ml_tpu/serve/router.py``).

**Micro-windows.** Requests queue in arrival order and flush as one
scoring launch when the window holds ``PHOTON_SERVE_MAX_BATCH`` requests
or its oldest request has waited ``PHOTON_SERVE_MAX_WAIT_MS``
milliseconds. Every window is padded to exactly the max batch, so the
scorer sees one (B, d) shape for the server's lifetime.

**Scoring parity.** A window's scores are bitwise the batch scorer's
(``GameModel.score``, ``GameTransformer``) on the same rows:

- fixed effects go through the batch ``DenseBatch.matvec`` (``X @ w``,
  ``DenseFeatures.score``'s product) on the window's rows;
- random effects take the same row-wise dot as ``random_effect_scores``
  over per-entity rows from the ``HotModelStore``, masked as
  ``RandomEffectModel.score_rows`` masks out-of-range ids. Padding rows
  carry invalid ids and zero features, and each row's result depends on
  that row alone, so trimming the padding leaves the batch scorer's bits.

**Cross-owner routing.** Across processes each process owns the entities
its ``EntityRouter`` plan gives it (``parallel/placement.py``
``plan_entity_placement``). A serving step is collective: every process
contributes the requests that arrived at it, rows travel to their owners
over ``multihost.exchange_rows``, owners score through their hot set, and
the scores travel home the same way. A peer lost mid-step raises
``PeerLost``; the caller degrades in place (roll call, survivor group,
``EntityRouter.replan`` over the survivors) and retries the step.

Telemetry: counters ``serve.requests``, ``serve.windows`` and
``serve.forwarded``, timer ``serve.window_s``, histogram
``serve.window.occupancy`` (the fill of each window), span
``serve/window`` a flush.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from photon_ml_tpu_torch.game.models import FixedEffectModel, RandomEffectModel
from photon_ml_tpu_torch.obs import span
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.ops import prefetch
from photon_ml_tpu_torch.ops.batch import DenseBatch
from photon_ml_tpu_torch.serve.store import HotModelStore

SERVE_MAX_BATCH = 32  # micro-window flush size, and the padded window shape
SERVE_MAX_WAIT_MS = 2.0  # the oldest request's wait that forces a flush


def serve_max_batch() -> int:
    """The micro-window max batch, read at call time (the environment
    before the module global)."""
    env = os.environ.get("PHOTON_SERVE_MAX_BATCH")
    if env is not None and env != "":
        return max(int(env), 1)
    return max(int(SERVE_MAX_BATCH), 1)


def serve_max_wait_ms() -> float:
    """The micro-window max wait in ms, read at call time (the environment
    before the module global): the one float serving knob, parsed
    strictly."""
    env = os.environ.get("PHOTON_SERVE_MAX_WAIT_MS")
    if env is not None and env != "":
        return max(float(env), 0.0)
    return max(float(SERVE_MAX_WAIT_MS), 0.0)


@dataclass
class ScoreRequest:
    """One scoring request: a feature vector per shard and the dense entity
    id per entity-id tag (one ``GameBatch`` row)."""

    rid: int
    features: dict[str, np.ndarray]  # shard id -> (d_shard,) float
    id_tags: dict[str, int]  # entity-id tag -> dense entity id
    offset: float = 0.0
    arrival_s: float = 0.0  # scheduled arrival (the load generator's clock)
    submit_s: float = field(default=0.0, repr=False)


def _window_features(requests: list[ScoreRequest], shard_id: str, B: int, device) -> torch.Tensor:
    d = len(np.asarray(requests[0].features[shard_id]))
    X = np.zeros((B, d), np.float32)
    for i, r in enumerate(requests):
        X[i] = np.asarray(r.features[shard_id], np.float32)
    return torch.from_numpy(X).to(device)


def _score_window(store: HotModelStore, requests: list[ScoreRequest], max_batch: int) -> np.ndarray:
    """One micro-window's scores, padded to ``max_batch`` rows on the
    store's device; returns the (len(requests),) scores."""
    B, n, dev = max_batch, len(requests), store.device
    total = np.zeros((B,), np.float32)
    total[:n] = [float(r.offset) for r in requests]
    total = torch.from_numpy(total).to(dev)
    zeros = torch.zeros((B,), dtype=torch.float32, device=dev)
    for cid, sub in store.model.models.items():
        if isinstance(sub, FixedEffectModel):
            X = _window_features(requests, sub.feature_shard_id, B, dev)
            total = total + DenseBatch(X=X, labels=zeros, offsets=zeros, weights=zeros).matvec(
                store.fixed_coefficients[cid])
        elif isinstance(sub, RandomEffectModel):
            X = _window_features(requests, sub.feature_shard_id, B, dev)
            ids = np.full((B,), -1, np.int64)
            ids[:n] = [int(r.id_tags.get(sub.random_effect_type, -1)) for r in requests]
            in_range = (ids >= 0) & (ids < store.num_entities(cid))
            W_rows = store.rows_for(cid, np.where(in_range, ids, 0), valid=in_range)
            # random_effect_scores' row dot and score_rows' mask: both act
            # row by row, so a window row scores as the batch scorer's row
            raw = torch.einsum("nd,nd->n", X.float(), W_rows)
            total = total + torch.where(torch.from_numpy(in_range).to(dev), raw, torch.zeros_like(raw))
    return total.cpu().numpy()[:n]


class MicroWindowServer:
    """The one-process micro-window scoring loop over a ``HotModelStore``.

    ``submit`` queues a request and flushes full windows; ``poll`` flushes
    a partial window whose oldest request has waited past the max wait;
    ``drain`` flushes everything. ``on_scores(requests, scores)`` gets every
    flushed window, in submit order."""

    def __init__(self, store: HotModelStore, on_scores=None, max_batch: int | None = None,
                 max_wait_ms: float | None = None, clock=time.monotonic) -> None:
        self.store = store
        self._on_scores = on_scores or (lambda requests, scores: None)
        self._max_batch = max_batch
        self._max_wait_ms = max_wait_ms
        self._clock = clock
        self._pending: list[ScoreRequest] = []
        self.windows = 0
        self.requests = 0
        self._occupancy_sum = 0.0

    def max_batch(self) -> int:
        return self._max_batch if self._max_batch else serve_max_batch()

    def max_wait_ms(self) -> float:
        if self._max_wait_ms is not None:
            return self._max_wait_ms
        return serve_max_wait_ms()

    def submit(self, request: ScoreRequest) -> None:
        request.submit_s = self._clock()
        self._pending.append(request)
        REGISTRY.counter_inc("serve.requests", 1)
        self.requests += 1
        # a burst larger than the max batch flushes full windows back to back
        while len(self._pending) >= self.max_batch():
            self._flush(self._pending[: self.max_batch()])

    def poll(self, now: float | None = None) -> None:
        """Flush a partial window once its oldest request has waited past
        the max wait."""
        if not self._pending:
            return
        now = self._clock() if now is None else now
        # the same float expression as next_deadline(): a caller that sleeps
        # exactly to the deadline sees the flush as due
        if now >= self._pending[0].submit_s + self.max_wait_ms() / 1e3:
            self._flush(self._pending[: self.max_batch()])

    def next_deadline(self) -> float | None:
        """The clock time by which the oldest pending request must flush
        (None when idle): the load generator's sleep bound."""
        if not self._pending:
            return None
        return self._pending[0].submit_s + self.max_wait_ms() / 1e3

    def drain(self) -> None:
        while self._pending:
            self._flush(self._pending[: self.max_batch()])

    def occupancy_mean(self) -> float:
        return self._occupancy_sum / self.windows if self.windows else 0.0

    def _flush(self, window: list[ScoreRequest]) -> None:
        prefetch.require_stream_executor_off("serve")
        del self._pending[: len(window)]
        t0 = self._clock()
        with span("serve/window", requests=len(window)):
            scores = _score_window(self.store, window, self.max_batch())
        dt = self._clock() - t0
        occupancy = len(window) / self.max_batch()
        self.windows += 1
        self._occupancy_sum += occupancy
        REGISTRY.counter_inc("serve.windows", 1)
        REGISTRY.timer_add("serve.window_s", dt)
        REGISTRY.histogram_observe("serve.window.occupancy", occupancy)
        self._on_scores(window, scores)


class EntityRouter:
    """Entity → owning process, by ``plan_entity_placement`` (each entity
    one atom: all its requests land at its owner). ``entity_rows`` weighs
    the plan: expected traffic, as training weighs it by rows."""

    def __init__(self, entity_rows: np.ndarray, num_processes: int, skew_aware: bool = True) -> None:
        from photon_ml_tpu_torch.parallel.placement import plan_entity_placement

        self.plan = plan_entity_placement(np.asarray(entity_rows, np.float64), num_processes,
                                          skew_aware=skew_aware)
        self.owner = np.asarray(self.plan.owner, np.int64)
        self.num_processes = int(num_processes)
        self._reset_traffic()

    def _reset_traffic(self) -> None:
        E, P = len(self.owner), self.num_processes
        # request counts by entity and arrival process (the locality
        # signal) and, by owner, forwarded and local requests (the measured
        # cost): replan_from_traffic reads a window of both, then zeroes them
        self._arrivals = np.zeros((E, P), np.float64)
        self._fwd_by_owner = np.zeros(P, np.float64)
        self._hit_by_owner = np.zeros(P, np.float64)

    def note_traffic(self, entities, sources) -> None:
        """Record one window's requests: ``entities[i]`` arrived at process
        ``sources[i]``. A request that arrived away from its entity's owner
        was forwarded; out-of-range entities (the modular fallback) are not
        planned and are skipped."""
        ents = np.asarray(entities, np.int64).ravel()
        srcs = np.asarray(sources, np.int64).ravel()
        ok = (ents >= 0) & (ents < len(self.owner))
        ents, srcs = ents[ok], srcs[ok]
        if not len(ents):
            return
        np.add.at(self._arrivals, (ents, srcs), 1.0)
        own = self.owner[ents]
        fwd = own != srcs
        np.add.at(self._fwd_by_owner, own[fwd], 1.0)
        np.add.at(self._hit_by_owner, own[~fwd], 1.0)

    def forwarded_fraction(self) -> float:
        """The forwarded share of the recorded traffic (what a re-plan
        shrinks)."""
        total = float(self._arrivals.sum())
        return float(self._fwd_by_owner.sum()) / total if total else 0.0

    def replan_from_traffic(self, slack: float = 0.25, forward_cost: float = 2.0) -> int:
        """Move ownership toward the recorded traffic at a window boundary.
        Each entity's cost is its request count at its owner's measured
        rate (``measured_entity_costs`` over per-owner walls = local
        requests + ``forward_cost`` × forwarded ones). Entities are placed
        by descending cost at the process most of their requests arrive
        at, unless that process would pass ``(1 + slack)`` × the balanced
        load, else at the least loaded one. Entities without traffic keep
        their owner. Host arithmetic only: across processes every caller
        passes the same (allreduced) traffic. Resets the traffic window;
        returns the number of migrations."""
        from photon_ml_tpu_torch.parallel.placement import measured_entity_costs, plan_from_owner

        traffic = self._arrivals.sum(axis=1)
        total = float(traffic.sum())
        P = self.num_processes
        if total <= 0.0 or P <= 1:
            self._reset_traffic()
            return 0
        walls = self._hit_by_owner + forward_cost * self._fwd_by_owner
        costs = measured_entity_costs(traffic, self.owner, walls)
        new_owner = self.owner.copy()
        loads = np.zeros(P, np.float64)
        seen = traffic > 0.0
        cap = (1.0 + float(slack)) * float(costs[seen].sum()) / P
        seen_ids = np.flatnonzero(seen)
        # stable descending cost: ties place the lower entity id first
        for e in np.argsort(-costs[seen], kind="stable"):
            ent = int(seen_ids[e])
            pref = int(np.argmax(self._arrivals[ent]))
            if loads[pref] + costs[ent] > cap:
                pref = int(np.argmin(loads))
            loads[pref] += costs[ent]
            new_owner[ent] = pref
        migrated = int(np.sum(new_owner != self.owner))
        REGISTRY.counter_inc("serve.replan.count", 1)
        REGISTRY.counter_inc("serve.replan.migrations", migrated)
        self.owner = new_owner
        self.plan = plan_from_owner(new_owner, np.maximum(traffic, 1e-12), P)
        self._reset_traffic()
        return migrated

    def owner_of(self, entity: int) -> int:
        if 0 <= entity < len(self.owner):
            return int(self.owner[entity])
        # an unseen entity: the modular fallback (its random effect scores
        # 0 anywhere; the fixed effects are on every process)
        return int(entity) % self.num_processes if entity >= 0 else 0

    def replan(self, entity_rows: np.ndarray, survivors) -> None:
        """Degrade in place: plan ownership again over the survivors (the
        degraded group's ranks) after a peer loss."""
        from photon_ml_tpu_torch.parallel.placement import plan_entity_placement

        self.num_processes = len(survivors)
        self.plan = plan_entity_placement(np.asarray(entity_rows, np.float64), self.num_processes)
        self.owner = np.asarray(self.plan.owner, np.int64)
        # the degraded group has new ranks: an old traffic window would
        # name processes that no longer exist
        self._reset_traffic()


def serve_step_collective(server: MicroWindowServer, router: EntityRouter, requests: list[ScoreRequest],
                          re_tag: str, shard_ids: tuple[str, ...], shard_dims: dict[str, int] | None = None,
                          tag: str = "serve_step") -> np.ndarray:
    """One collective serving step over the current (whole or degraded)
    group: every process passes the requests that arrived at it, rows go
    to their owners over ``exchange_rows``, owners score them through their
    hot set, and the scores come back the same way. Returns this process's
    scores in its submit order.

    Every process of the group calls it at the same program point. A peer
    lost mid-exchange raises ``PeerLost``: the caller runs the degrade
    recipe (roll call, ``set_degraded_group``, ``router.replan``) and calls
    again."""
    from photon_ml_tpu_torch.parallel.multihost import effective_process_index, exchange_rows

    me = effective_process_index()
    n = len(requests)
    ents = np.asarray([int(r.id_tags.get(re_tag, -1)) for r in requests], np.int64)
    dest = np.asarray([router.owner_of(int(e)) for e in ents], np.int64)
    REGISTRY.counter_inc("serve.forwarded", int(np.sum(dest != me)))
    # this step's local arrivals for the re-planner (callers allreduce the
    # traffic across processes before they re-plan)
    router.note_traffic(ents, np.full((n,), me, np.int64))
    payload = {
        "rid": np.asarray([r.rid for r in requests], np.int64),
        "src": np.full((n,), me, np.int64),
        "entity": ents,
        "offset": np.asarray([r.offset for r in requests], np.float32),
    }
    for sid in shard_ids:
        if n:
            payload[f"x_{sid}"] = np.stack([np.asarray(r.features[sid], np.float32) for r in requests])
        else:
            # a process without requests still sends the shard's true width
            payload[f"x_{sid}"] = np.zeros((0, (shard_dims or {}).get(sid, 1)), np.float32)
    recv = exchange_rows(payload, dest, tag=tag)

    owned = [
        ScoreRequest(rid=int(recv["rid"][i]), features={sid: recv[f"x_{sid}"][i] for sid in shard_ids},
                     id_tags={re_tag: int(recv["entity"][i])}, offset=float(recv["offset"][i]))
        for i in range(len(recv["rid"]))
    ]
    scored: dict[int, float] = {}

    def _collect(window, scores):
        for r, s in zip(window, scores):
            scored[int(r.rid)] = float(s)

    prev = server._on_scores
    server._on_scores = _collect
    try:
        for r in owned:
            server.submit(r)
        server.drain()
    finally:
        server._on_scores = prev

    back = exchange_rows(
        {"rid": np.asarray(recv["rid"], np.int64),
         "score": np.asarray([scored[int(rid)] for rid in recv["rid"]], np.float32)},
        np.asarray(recv["src"], np.int64), tag=tag + "_return")
    by_rid = {int(rid): float(s) for rid, s in zip(back["rid"], back["score"])}
    return np.asarray([by_rid[r.rid] for r in requests], np.float32)
