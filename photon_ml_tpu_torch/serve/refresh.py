"""Incremental per-entity refresh: new events for one entity warm-start
that entity's solve alone (port of ``photon_ml_tpu/serve/refresh.py``).

The refresh runs the chunked lane solvers (``optim.common.
select_chunked_solver``: ``init``, ``run`` to absolute bounds c, 2c, ...,
``finalize``) on one lane, the entity's events as a (1, C, d) bucket. The
one-shot lane solve is the same three pieces run once to the iteration
bound, so:

- **refresh parity**: the refreshed row is bitwise the offline
  warm-start solve of the same bucket (``solve_entity_offline``: the same
  lane objective, the same start, ``make_optimizer``'s solver), on the
  CPU and on the card alike, since both run one lane of the same shapes;
- **untouched entities**: a refresh replaces one row of the coefficient
  matrix; every other row keeps its bytes, so its scores do too.

NEWTON_CHOLESKY has no chunked twin: its refresh is the one-shot solve.

``PHOTON_SERVE_REFRESH_EVERY`` is the trigger: ``RefreshBuffer`` holds
labeled events per entity and reports an entity ready once it holds that
many (0: never; explicit calls always work). A serving loop publishes the
refreshed model through ``io/model_io.publish_game_model`` and installs
the row in its live store (``HotModelStore.install_refreshed_row``).

Telemetry: counter ``serve.refresh.count``, timer ``serve.refresh_s``,
span ``serve/refresh``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.game.models import GameModel, RandomEffectModel
from photon_ml_tpu_torch.obs import span
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.ops import prefetch, stream_executor
from photon_ml_tpu_torch.ops.batch import DenseBatch
from photon_ml_tpu_torch.ops.glm import make_lane_objective
from photon_ml_tpu_torch.ops.losses import loss_for_task

SERVE_REFRESH_EVERY = 0  # events per entity that trigger a refresh; 0 = off

#: the step between the chunked run's absolute bounds: any positive value
#: gives the same bits (the chunked contract)
_CHUNK_STEP = 8


def serve_refresh_every() -> int:
    """The refresh trigger, read at call time (the environment before the
    module global); 0 turns event-count triggering off."""
    env = os.environ.get("PHOTON_SERVE_REFRESH_EVERY")
    if env is not None and env != "":
        return max(int(env), 0)
    return max(int(SERVE_REFRESH_EVERY), 0)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


_EVENT_KEYS = ("X", "labels", "offsets", "weights")  # DenseBatch's field order


def entity_event_batch(X: np.ndarray, labels: np.ndarray, offsets: np.ndarray | None = None,
                       weights: np.ndarray | None = None, device=None) -> DenseBatch:
    """One entity's event rows as a bucket, padded to a power of two with
    zero-weight rows (inert in the objective), on ``device`` (CUDA unless
    the caller asks for another): the tensor both the refresh and its
    offline comparator solve."""
    dev = resolve_device(device)
    host = _event_arrays(X, labels, offsets, weights)
    return DenseBatch(*(torch.from_numpy(host[k]).to(dev) for k in _EVENT_KEYS))


def _event_arrays(X, labels, offsets, weights) -> dict:
    """``entity_event_batch``'s padded host arrays."""
    X = np.asarray(X, np.float32)
    n, d = X.shape
    C = _next_pow2(n)
    Xp = np.zeros((C, d), np.float32)
    yp, op, wp = (np.zeros((C,), np.float32) for _ in range(3))
    Xp[:n] = X
    yp[:n] = np.asarray(labels, np.float32)
    if offsets is not None:
        op[:n] = np.asarray(offsets, np.float32)
    wp[:n] = 1.0 if weights is None else np.asarray(weights, np.float32)
    return dict(zip(_EVENT_KEYS, (Xp, yp, op, wp)))


def _lane_problem(re_model: RandomEffectModel, entity: int, batch: DenseBatch, l2_weight: float):
    """The one-lane objective over ``batch`` and the entity's (1, d) warm
    start, on the batch's device."""
    lane = DenseBatch(*(a.unsqueeze(0) for a in (batch.X, batch.labels, batch.offsets, batch.weights)))
    obj = make_lane_objective(lane, loss_for_task(re_model.task_type), l2_weight=l2_weight)
    w0 = re_model.coefficients[int(entity)].detach().to(batch.X.device, torch.float32).unsqueeze(0)
    return obj, w0


def solve_entity_offline(re_model: RandomEffectModel, entity: int, batch: DenseBatch, config: OptimizerConfig,
                         l2_weight: float = 0.0, l1_weight: float = 0.0):
    """The offline comparator: the one-shot solve of the same bucket from
    the same warm start (no prior, no normalization). Returns the lane
    ``OptimizationResult`` (``w`` (1, d))."""
    from photon_ml_tpu_torch.optim.common import make_optimizer

    obj, w0 = _lane_problem(re_model, entity, batch, l2_weight)
    return make_optimizer(config, l1_weight)(obj, w0)


def refresh_entity(model: GameModel, cid: str, entity: int, batch: DenseBatch, config: OptimizerConfig,
                   l2_weight: float = 0.0, l1_weight: float = 0.0, chunk: int = _CHUNK_STEP):
    """Refresh one entity's coefficients from ``batch`` (its events, padded
    by ``entity_event_batch``), warm-started from its current row.

    Returns ``(updated_model, result)``: ``result`` is the lane
    ``OptimizationResult``, ``result.w[0]`` bitwise
    ``solve_entity_offline``'s, and the model has that one row replaced."""
    from photon_ml_tpu_torch.optim.common import make_optimizer, select_chunked_solver

    re_model = model[cid]
    assert isinstance(re_model, RandomEffectModel), cid
    t0 = time.monotonic()
    with span("serve/refresh", coordinate=cid, entity=int(entity)):
        obj, w0 = _lane_problem(re_model, entity, batch, l2_weight)
        solver, extra = select_chunked_solver(config, l1_weight)
        if solver is None:
            # NEWTON_CHOLESKY: the one-shot solve is the offline solve
            res = make_optimizer(config, l1_weight)(obj, w0)
        else:
            state = solver.init(obj, w0, config, **extra)
            bound = int(chunk)
            # absolute bounds c, 2c, 3c, ... until the lane is done (each
            # run also stops at config.max_iterations, so the ladder ends)
            while not bool(state.done.all()):
                state = solver.run(obj, state, config, bound, **extra)
                if bound > int(config.max_iterations) + int(chunk):
                    break
                bound += int(chunk)
            res = solver.finalize(state)
    REGISTRY.counter_inc("serve.refresh.count", 1)
    REGISTRY.timer_add("serve.refresh_s", time.monotonic() - t0)

    W = re_model.coefficients.detach().clone()
    W[int(entity)] = res.w[0].to(W.device, W.dtype)
    updated = RandomEffectModel(coefficients=W, variances=re_model.variances,
                                random_effect_type=re_model.random_effect_type,
                                feature_shard_id=re_model.feature_shard_id, task_type=re_model.task_type)
    return model.updated(cid, updated), res


def refresh_stream(model: GameModel, items: list, config: OptimizerConfig, l2_weight: float = 0.0,
                   l1_weight: float = 0.0, chunk: int = _CHUNK_STEP, device=None):
    """A batch of ready refreshes in item order: ``items`` is a list of
    ``(cid, entity, X, labels, offsets, weights)`` host tuples (e.g. what
    ``RefreshBuffer`` reported ready this window). The model threads
    through the items in order, so the result is the per-item
    ``refresh_entity`` loop's. Returns ``(updated_model, [result, ...])``.

    With ``PHOTON_STREAM_EXECUTOR=1`` the items are the executor's stream
    "refresh" (priority 10: an active serve window holds it to one item
    ahead): a worker pads item i+k on the host and issues its copy on the
    copy stream, and the solve waits for that copy's event; solves stay on
    this thread in item order, so the model is the loop's, bit for bit."""
    if not stream_executor.stream_executor_enabled():
        batches = (entity_event_batch(X, y, offsets=off, weights=w, device=device)
                   for _, _, X, y, off, w in items)
    else:
        dev = resolve_device(device)
        consumer = prefetch.consumer_stream(dev)

        def prepare(i):
            _, _, X, y, off, w = items[i]
            return prefetch.device_put(_event_arrays(X, y, off, w), dev, consumer)

        def waited(puts):
            for put in puts:
                prefetch.wait(put, consumer)
                yield DenseBatch(*(put[k] for k in _EVENT_KEYS))

        batches = waited(stream_executor.stream("refresh", len(items), prepare))
    results = []
    for i, batch in enumerate(batches):
        cid, entity = items[i][0], items[i][1]
        model, res = refresh_entity(model, cid, entity, batch, config, l2_weight=l2_weight, l1_weight=l1_weight,
                                    chunk=chunk)
        results.append(res)
    return model, results


class RefreshBuffer:
    """Per-entity event buffer behind the refresh trigger: the serving
    loop adds labeled events; once an entity holds
    ``PHOTON_SERVE_REFRESH_EVERY`` of them (and the knob is not 0),
    ``pop_ready`` hands back its rows as a bucket and clears them."""

    def __init__(self) -> None:
        self._events: dict[tuple[str, int], list[tuple]] = {}

    def add(self, cid: str, entity: int, x: np.ndarray, label: float, offset: float = 0.0,
            weight: float = 1.0) -> bool:
        """Buffer one event; True when the entity has just become ready."""
        rows = self._events.setdefault((cid, int(entity)), [])
        rows.append((np.asarray(x, np.float32), float(label), float(offset), float(weight)))
        every = serve_refresh_every()
        return bool(every) and len(rows) >= every

    def count(self, cid: str, entity: int) -> int:
        return len(self._events.get((cid, int(entity)), ()))

    def pop_ready(self, cid: str, entity: int, device=None) -> DenseBatch | None:
        rows = self._events.pop((cid, int(entity)), None)
        if not rows:
            return None
        X = np.stack([r[0] for r in rows])
        y, off, w = (np.asarray([r[i] for r in rows], np.float32) for i in (1, 2, 3))
        return entity_event_batch(X, y, offsets=off, weights=w, device=device)
