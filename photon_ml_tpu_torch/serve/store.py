"""The device view a server scores from: one published GAME model (port of
``photon_ml_tpu/serve/store.py``).

Training keeps each random effect as one (E, d) device matrix; a serving
replica of a model with millions of entities cannot, and sees mostly the
Zipf head of them anyway. So residency splits by effect kind:

- **fixed effects**: each (d,) coefficient vector stays on the device for
  the store's lifetime (small, and on every request's path);
- **random effects**: the (E, d) matrices stay in host memory (the cold
  store, a writable copy: a refresh swaps rows in place), and a
  byte-budgeted LRU **hot set** (``ops/bytelru``) keeps per-entity (d,)
  rows on the device.

Budget: ``PHOTON_SERVE_HOT_BYTES`` (the environment before the module
global, read at call time); 0 means ``_DEFAULT_MODEL_FRACTION`` (25%) of
the random-effect coefficient bytes.

Accounting, in bytes at the device row's size: ``serve.hot.hit_bytes``,
``serve.hot.miss_bytes``, ``serve.hot.evictions``; ``hit_rate()`` is the
store's lifetime request hit rate, the number the Zipf trace gates.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.game.models import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.ops.bytelru import ByteBudgetLRU

SERVE_HOT_BYTES = 0  # hot-set byte budget; 0 = 25% of the random-effect bytes

#: the hot set's default share of the random-effect coefficient bytes: the
#: Zipf(1) trace's hit-rate gate (>= 0.8) is written against this share
_DEFAULT_MODEL_FRACTION = 0.25


def serve_hot_budget_bytes() -> int:
    """The hot-set byte budget, read at call time (the environment before
    the module global); 0 = derived from the model when the store is
    built."""
    env = os.environ.get("PHOTON_SERVE_HOT_BYTES")
    if env is not None and env != "":
        return max(int(env), 0)
    return max(int(SERVE_HOT_BYTES), 0)


def _hit(nbytes: int) -> None:
    REGISTRY.counter_inc("serve.hot.hit_bytes", nbytes)


def _miss(nbytes: int) -> None:
    REGISTRY.counter_inc("serve.hot.miss_bytes", nbytes)


def _evict(nbytes: int) -> None:
    REGISTRY.counter_inc("serve.hot.evictions", 1)


class HotModelStore:
    """Serving residency for one ``GameModel`` snapshot on ``device``
    (CUDA unless the caller asks for another).

    ``rows_for(cid, ids, valid)`` gives the (B, d) device matrix of one
    micro-window's per-entity rows, each bitwise the model's row, through
    the hot set. Rows that are not valid (window padding, out-of-range
    ids) get the zero row without touching the hot set, so the hit rate is
    a function of the request trace alone."""

    def __init__(self, model: GameModel, budget_bytes: int | None = None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.fixed_coefficients: dict[str, torch.Tensor] = {}
        self._re_host: dict[str, np.ndarray] = {}
        self._re_models: dict[str, RandomEffectModel] = {}
        for cid, sub in model.models.items():
            if isinstance(sub, FixedEffectModel):
                self.fixed_coefficients[cid] = sub.coefficient_means.detach().to(self.device)
            elif isinstance(sub, RandomEffectModel):
                # a copy of our own: a refresh writes single rows into it
                self._re_host[cid] = np.array(sub.coefficients.detach().cpu().numpy())
                self._re_models[cid] = sub
        self.total_re_bytes = int(sum(a.nbytes for a in self._re_host.values()))
        self._explicit_budget = budget_bytes
        self._zeros: dict[str, torch.Tensor] = {}
        self._lock = threading.Lock()
        self.hot = ByteBudgetLRU(self.budget_bytes, on_hit=_hit, on_miss=_miss, on_evict=_evict)
        self._hits = 0
        self._misses = 0

    def budget_bytes(self) -> int:
        """The budget now: the constructor's, else the knob, else 25% of
        the random-effect bytes (at least 1)."""
        if self._explicit_budget is not None:
            return max(int(self._explicit_budget), 0)
        knob = serve_hot_budget_bytes()
        if knob > 0:
            return knob
        return max(int(self.total_re_bytes * _DEFAULT_MODEL_FRACTION), 1)

    def random_effect(self, cid: str) -> RandomEffectModel:
        return self._re_models[cid]

    def num_entities(self, cid: str) -> int:
        return int(self._re_host[cid].shape[0])

    def host_row(self, cid: str, entity: int) -> np.ndarray:
        return self._re_host[cid][entity]

    def _zero_row(self, cid: str) -> torch.Tensor:
        z = self._zeros.get(cid)
        if z is None:
            host = self._re_host[cid]
            z = torch.zeros(host.shape[1], dtype=torch.from_numpy(host[:0]).dtype, device=self.device)
            self._zeros[cid] = z
        return z

    def shard_for(self, cid: str, entity: int) -> torch.Tensor:
        """One entity's (d,) device row through the hot set; the zero row,
        uncounted, for an id out of range."""
        entity = int(entity)
        host = self._re_host[cid]
        if not (0 <= entity < host.shape[0]):
            return self._zero_row(cid)
        key = (cid, entity)
        row = self.hot.get(key)
        if row is not None:
            self._hits += 1
            return row
        self._misses += 1
        dev = torch.tensor(host[entity], device=self.device)
        return self.hot.put(key, dev, dev.element_size() * dev.numel())

    def rows_for(self, cid: str, ids: np.ndarray, valid: np.ndarray | None = None) -> torch.Tensor:
        """The (B, d) device rows of one micro-window (one stack: windows
        are padded to the max batch, so B is the same for every window).
        Rows not marked ``valid`` get the zero row without a hot-set
        lookup."""
        ids = np.asarray(ids)
        if valid is None:
            return torch.stack([self.shard_for(cid, e) for e in ids])
        return torch.stack([self.shard_for(cid, e) if ok else self._zero_row(cid)
                            for e, ok in zip(ids, np.asarray(valid))])

    def install_refreshed_row(self, cid: str, entity: int, row) -> None:
        """Swap one entity's coefficients in place (after the refresh's
        publish): the cold row is replaced bit for bit and its stale hot row
        dropped, so the next request admits the fresh one. Every other
        entity's bytes stay as they were."""
        with self._lock:
            host = self._re_host[cid]
            host[entity] = np.asarray(row.detach().cpu().numpy() if isinstance(row, torch.Tensor) else row,
                                      host.dtype)
            self.hot.drop((cid, int(entity)))
            sub = self._re_models[cid]
            self._re_models[cid] = RandomEffectModel(
                coefficients=torch.tensor(host, device=sub.coefficients.device),
                variances=sub.variances,
                random_effect_type=sub.random_effect_type,
                feature_shard_id=sub.feature_shard_id,
                task_type=sub.task_type,
            )
            self.model = self.model.updated(cid, self._re_models[cid])

    def hit_rate(self) -> float:
        """The lifetime hit rate of in-range requests (a count; the byte
        counters are the registry's)."""
        total = self._hits + self._misses
        return float(self._hits) / total if total else 0.0

    def stats(self) -> dict:
        out = self.hot.stats()
        out.update(budget_bytes=self.budget_bytes(), total_re_bytes=self.total_re_bytes, hits=self._hits,
                   misses=self._misses, hit_rate=self.hit_rate())
        return out
