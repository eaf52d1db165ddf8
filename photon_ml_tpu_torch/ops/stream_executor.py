"""One scheduled pipeline for every streamed consumer (port of
``photon_ml_tpu/ops/stream_executor.py``).

Seven consumers stream host items through the card: the chunk
objective's passes ("objective"), both scorers ("scores"), the out-of-core
GAME trainer's bucket gathers ("re_gather") and per-visit scoring
("re_scores"), cross-validation's fold ingest ("cv"), the serving
micro-window ("serve") and the refresh stream ("refresh"). With
``PHOTON_STREAM_EXECUTOR=1`` they all ride this module; with it off (the
default) each keeps its own ``prefetch`` branch, byte for byte.

- **Registration** (``register``): a consumer has a name, a scheduling
  priority and, optionally, a share of the chunk cache's budget. The
  executor emits the span ``stream/<name>`` and the counters
  ``stream.<name>.items`` / ``.wait_s`` / ``.hit_bytes`` /
  ``.miss_bytes`` / ``.yields`` and the gauge ``.charged_bytes``.
- **Scheduling** (``stream``): ``prefetch.prefetch_iter``'s pipeline (the
  same worker pool, items yielded in order, a worker's error raised at
  its item), except that the depth is read again at every top-up: while a
  stream of strictly higher priority is active (``active_stream``: the
  serve window marks itself active while it scores), a stream tops up to
  depth 1 only. Only preparation is scheduled; kernels and accumulation
  stay on the consumer's thread in item order, so outputs are bitwise the
  same at any interleaving.
- **Arbitration** (``cached_device_put``): one process-wide chunk cache
  for all consumers, keyed by the content of each array (a blake2b-16
  fingerprint, memoized by host storage) × its transfer dtype × a context
  (the feature range under ``PHOTON_FE_SHARD``) × the device. A second
  stream that replays the same content through fresh host arrays (a
  validation loader's copy of the training chunks) reuses the resident
  tensors instead of copying them again. Every holder of an entry is
  charged its bytes; a consumer over its share releases its own
  least-recently-used holds first, and an entry leaves the card only when
  its last holder releases it. Over the device's budget the global LRU
  releases every holder of the victim.

On the card an entry keeps the event of its copy: every hit waits on it
(``prefetch.wait`` with the chunk's ``events``), and its tensors are
marked as used by the hitting consumer's stream (``record_stream``), so
the caching allocator cannot hand the block out again while a kernel of
that stream still reads it after the last holder released it.

Knobs (the environment before the module global, read at call time,
parsed strictly): ``PHOTON_STREAM_EXECUTOR`` (flag),
``PHOTON_STREAM_PRIORITY`` (``name=int,...``) and ``PHOTON_STREAM_SHARE``
(``name=fraction,...``, each in (0, 1], of ``chunk_cache_budget_bytes``).

Counters: ``stream.streams``, ``stream.cache.hit_bytes`` /
``.shared_hit_bytes`` (hits on an entry another consumer holds) /
``.miss_bytes`` (the bytes copied) / ``.evictions``, besides the
per-consumer family above.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Iterator

import numpy as np
import torch

from photon_ml_tpu_torch.obs import span
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.ops import prefetch

STREAM_EXECUTOR = 0  # 1: the consumers ride the executor
STREAM_PRIORITY = ""  # "name=int,...": per-consumer priority overrides
STREAM_SHARE = ""  # "name=fraction,...": per-consumer caps on charged bytes


def stream_executor_enabled() -> bool:
    """The executor's switch, read at call time (the environment before
    the module global; a strict int)."""
    env = os.environ.get("PHOTON_STREAM_EXECUTOR")
    if env is not None and env != "":
        return bool(int(env))
    return bool(int(STREAM_EXECUTOR))


def stream_priority_spec() -> str:
    """The raw ``name=int,...`` priority overrides (the environment before
    the module global)."""
    env = os.environ.get("PHOTON_STREAM_PRIORITY")
    return env if env is not None else str(STREAM_PRIORITY)


def stream_share_spec() -> str:
    """The raw ``name=fraction,...`` budget shares (the environment before
    the module global)."""
    env = os.environ.get("PHOTON_STREAM_SHARE")
    return env if env is not None else str(STREAM_SHARE)


def _parse_spec(spec: str, knob: str, cast) -> dict:
    out: dict = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, sep, raw = item.partition("=")
        if not sep or not name.strip():
            raise ValueError(f"{knob}: malformed entry {item!r} — expected 'consumer=value[,consumer=value...]'")
        out[name.strip()] = cast(raw.strip())
    return out


# serving preempts everything, refresh yields to everything; the training
# streams share the middle band (no training entry point runs two of them at once)
_DEFAULT_PRIORITY = {
    "serve": 100,
    "objective": 50,
    "scores": 50,
    "re_gather": 50,
    "re_scores": 50,
    "cv": 50,
    "refresh": 10,
}
_FALLBACK_PRIORITY = 50

# -- registration ---------------------------------------------------------------------
_reg_lock = threading.Lock()
_registered: dict[str, int] = {}  # name -> priority at registration
_active: dict[str, int] = {}  # name -> live streams and windows (re-entrant)


def register(name: str, priority: int | None = None) -> None:
    """Declare a consumer (idempotent); ``priority`` defaults to the
    default table's; the environment's spec wins over both."""
    with _reg_lock:
        if priority is not None:
            _registered[name] = int(priority)
        else:
            _registered.setdefault(name, _DEFAULT_PRIORITY.get(name, _FALLBACK_PRIORITY))


def priority_of(name: str) -> int:
    """The priority in force: the spec, else the registration, else the
    default table, else 50."""
    overrides = _parse_spec(stream_priority_spec(), "PHOTON_STREAM_PRIORITY", int)
    if name in overrides:
        return int(overrides[name])
    with _reg_lock:
        if name in _registered:
            return _registered[name]
    return _DEFAULT_PRIORITY.get(name, _FALLBACK_PRIORITY)


def share_fraction(name: str) -> float:
    """The consumer's cap on charged bytes as a fraction of the chunk
    cache's budget; 1.0 when the spec does not name it."""
    frac = float(_parse_spec(stream_share_spec(), "PHOTON_STREAM_SHARE", float).get(name, 1.0))
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"PHOTON_STREAM_SHARE: share for {name!r} must be in (0, 1], got {frac}")
    return frac


class active_stream:
    """Mark ``name`` active while the block runs, so that streams of lower
    priority yield their look-ahead (the serve window scores inside it).
    Re-entrant."""

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "active_stream":
        register(self.name)
        with _reg_lock:
            _active[self.name] = _active.get(self.name, 0) + 1
        return self

    def __exit__(self, *exc) -> None:
        with _reg_lock:
            n = _active.get(self.name, 0) - 1
            if n <= 0:
                _active.pop(self.name, None)
            else:
                _active[self.name] = n


def _higher_priority_active(name: str) -> bool:
    mine = priority_of(name)
    with _reg_lock:
        others = [n for n in _active if n != name]
    return any(priority_of(n) > mine for n in others)


# -- the scheduled stream ---------------------------------------------------------------
def stream(name: str, num_items: int, prepare: Callable[[int], Any], depth: int | None = None) -> Iterator[Any]:
    """Yield ``prepare(0..num_items-1)`` in order, preparing up to ``depth``
    items ahead on the prefetch workers (``None`` reads
    ``PHOTON_PREFETCH_DEPTH``; 0 prepares on this thread). Each top-up
    checks whether a stream of strictly higher priority is active; then it
    fills to depth 1 only and counts one ``.yields``. A preparation's error
    is raised at its item's turn and the queued items are cancelled."""
    register(name)
    if num_items <= 0:
        return
    base = prefetch.prefetch_depth() if depth is None else max(int(depth), 0)
    if threading.current_thread().name.startswith(prefetch._WORKER_PREFIX):
        base = 0  # a pool worker waiting on the pool could starve it
    REGISTRY.counter_inc("stream.streams")
    REGISTRY.counter_inc(f"stream.{name}.items", num_items)
    with active_stream(name), span(f"stream/{name}", items=num_items):
        if base <= 0 or num_items <= 1:
            for i in range(num_items):
                yield prepare(i)
            return
        pool = prefetch._worker_pool()
        futs: deque = deque()
        nxt = 0

        def top_up() -> None:
            nonlocal nxt
            eff = min(base, 1) if _higher_priority_active(name) else base
            while nxt < num_items and len(futs) < eff:
                futs.append(pool.submit(prefetch._timed_prepare, prepare, nxt))
                nxt += 1
            if nxt < num_items and eff < base:
                REGISTRY.counter_inc(f"stream.{name}.yields")

        try:
            top_up()
            while futs:
                f = futs.popleft()
                t0 = time.perf_counter()
                try:
                    out = f.result()  # a worker's exception is raised here
                finally:
                    dt = time.perf_counter() - t0
                    prefetch._add_seconds("consumer_wait_s", dt)
                    REGISTRY.timer_add(f"stream.{name}.wait_s", dt)
                top_up()
                yield out
        finally:
            for f in futs:  # the consumer stopped early: drop the rest
                f.cancel()


# -- the multi-tenant arbiter -------------------------------------------------------------
# content fingerprints by host storage, so a repeat pass over unchanged
# arrays hashes nothing; an entry holds its array, so the data pointer in
# its key cannot be reused while it is remembered
_fp_lock = threading.Lock()
_FP_MEMO_CAP = 4096
_fp_memo: "OrderedDict[tuple, tuple]" = OrderedDict()  # storage key -> (array, digest)


def _content_fingerprint(a: np.ndarray) -> bytes:
    skey = prefetch._storage_key(a)
    with _fp_lock:
        hit = _fp_memo.get(skey)
        if hit is not None:
            _fp_memo.move_to_end(skey)
            return hit[1]
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((str(a.dtype), a.shape)).encode())
    h.update(np.ascontiguousarray(a).reshape(-1).view(np.uint8))  # hashed in place, the GIL released
    digest = h.digest()
    with _fp_lock:
        _fp_memo[skey] = (a, digest)
        while len(_fp_memo) > _FP_MEMO_CAP:
            _fp_memo.popitem(last=False)
    return digest


class _Entry:
    __slots__ = ("tensor", "event", "nbytes", "holders")

    def __init__(self, tensor: torch.Tensor, event, nbytes: int) -> None:
        self.tensor = tensor
        self.event = event  # the copy's event (None on the CPU)
        self.nbytes = int(nbytes)
        self.holders: "OrderedDict[str, None]" = OrderedDict()


_arb_lock = threading.Lock()
_entries: "OrderedDict[tuple, _Entry]" = OrderedDict()  # the global LRU; a key's last field is its device
_device_bytes: dict[str, int] = {}  # device -> resident bytes
_charges: dict[tuple, int] = {}  # (consumer, device) -> charged bytes
_holder_lru: dict[str, "OrderedDict[tuple, None]"] = {}  # consumer -> its holds, LRU first
_arb_stats = {"hits": 0, "shared_hits": 0, "misses": 0, "evictions": 0}
_saw_traffic = False


def _charged(name: str) -> int:
    return sum(v for (n, _), v in _charges.items() if n == name)


def _release_locked(name: str, key: tuple) -> None:
    """Drop ``name``'s hold on ``key``; the entry leaves the card only when
    its last holder releases it."""
    e = _entries.get(key)
    if e is None or name not in e.holders:
        return
    dk = key[-1]
    del e.holders[name]
    _charges[(name, dk)] = _charges.get((name, dk), 0) - e.nbytes
    _holder_lru.get(name, OrderedDict()).pop(key, None)
    if not e.holders:
        del _entries[key]
        _device_bytes[dk] -= e.nbytes
        _arb_stats["evictions"] += 1
        REGISTRY.counter_inc("stream.cache.evictions")


def _enforce_locked(name: str, dk: str, budget: int) -> None:
    """After ``name`` held an entry on device ``dk``: first its share (its
    own LRU holds there go, a neighbour's are untouched), then the
    device's budget (the global LRU's victims lose every holder)."""
    share = int(budget * share_fraction(name))
    lru = _holder_lru.setdefault(name, OrderedDict())
    while _charges.get((name, dk), 0) > share:
        own = next((k for k in lru if k[-1] == dk), None)
        if own is None:
            break
        _release_locked(name, own)
    while _device_bytes.get(dk, 0) > budget:
        victim = next((k for k in _entries if k[-1] == dk), None)
        if victim is None:
            break
        for h in list(_entries[victim].holders):
            _release_locked(h, victim)


def _hold_locked(name: str, key: tuple, e: _Entry) -> None:
    if name not in e.holders:
        e.holders[name] = None
        _charges[(name, key[-1])] = _charges.get((name, key[-1]), 0) + e.nbytes
    lru = _holder_lru.setdefault(name, OrderedDict())
    lru[key] = None
    lru.move_to_end(key)
    _entries.move_to_end(key)


def _hit(name: str, e: _Entry, consumer) -> tuple[torch.Tensor, Any]:
    if consumer is not None:
        # a kernel on this consumer's stream may read the tensor after its
        # last holder released it: the allocator must wait for that stream
        e.tensor.record_stream(consumer)
    return e.tensor, e.event


def _arb_put_one(name: str, arr_name: str, a, context, dev: torch.device, consumer,
                 budget: int) -> tuple[torch.Tensor, Any]:
    """One host array → (its tensor on ``dev``, the copy's event) through
    the shared arbiter."""
    a = np.asarray(a)
    tdt = prefetch.transfer_dtype()
    packs = tdt != "f32" and arr_name in prefetch._PACK_KEYS and a.dtype == np.float32
    dk = str(dev)
    # the transfer dtype keys an entry: a bf16 entry never serves an f32 pass
    key = (_content_fingerprint(a), tdt if packs else "raw", context, dk)
    with _arb_lock:
        e = _entries.get(key)
        if e is not None:
            _arb_stats["hits"] += 1
            shared = name not in e.holders
            if shared:
                _arb_stats["shared_hits"] += 1
            _hold_locked(name, key, e)
            _enforce_locked(name, dk, budget)
            charged = _charged(name)
            out = _hit(name, e, consumer)
        else:
            _arb_stats["misses"] += 1
    if e is not None:  # the registry takes its own (leaf) lock
        REGISTRY.counter_inc("stream.cache.hit_bytes", e.nbytes)
        if shared:
            REGISTRY.counter_inc("stream.cache.shared_hit_bytes", e.nbytes)
        REGISTRY.counter_inc(f"stream.{name}.hit_bytes", e.nbytes)
        REGISTRY.gauge_set(f"stream.{name}.charged_bytes", charged)
        return out
    # the copy runs outside the lock; two racing misses of one key both
    # copy, and the first one inserted serves both
    staged = prefetch._pack_for_transfer(a) if packs else a
    t, ev = prefetch._copy_to(staged, dev, consumer)
    nbytes = t.numel() * t.element_size()
    REGISTRY.counter_inc("stream.cache.miss_bytes", nbytes)
    REGISTRY.counter_inc(f"stream.{name}.miss_bytes", nbytes)
    with _arb_lock:
        e = _entries.get(key)
        if e is None:
            e = _Entry(t, ev, nbytes)
            _entries[key] = e
            _device_bytes[dk] = _device_bytes.get(dk, 0) + nbytes
        _hold_locked(name, key, e)
        _enforce_locked(name, dk, budget)
        charged = _charged(name)
        out = (t, ev) if e.tensor is t else _hit(name, e, consumer)
    REGISTRY.gauge_set(f"stream.{name}.charged_bytes", charged)
    return out


def cached_device_put(name: str, host_tree: dict, device, consumer=None, context: Any = None) -> prefetch.DeviceChunk:
    """A host chunk's arrays on ``device`` through the multi-tenant
    arbiter: entries are keyed by content × transfer dtype × ``context``
    (the feature range under ``PHOTON_FE_SHARD``) × device, so a second
    stream that replays the same content, even through fresh host arrays,
    gets the resident tensors, charged to both holders. ``consumer`` is
    the stream the kernels will read the chunk on; wait for the chunk's
    ``events`` there (``prefetch.wait``). Thread-safe: workers for
    different chunks race here."""
    global _saw_traffic
    _saw_traffic = True
    register(name)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # "cuda" and "cuda:0" are one card's entries
        dev = torch.device("cuda", torch.cuda.current_device())
    budget = prefetch.chunk_cache_budget_bytes(dev)
    arrays, events = {}, []
    for k, v in host_tree.items():
        arrays[k], ev = _arb_put_one(name, k, v, context, dev, consumer, budget)
        if ev is not None:
            events.append(ev)
    return prefetch.DeviceChunk(arrays, events)


def cache_stats() -> dict:
    """The arbiter's counts, its entries and bytes, and each consumer's
    charged bytes: the ``stream_cache`` of a run's ``run_end`` record."""
    with _arb_lock:
        names = sorted({n for n, _ in _charges})
        charges = {n: _charged(n) for n in names}
        return dict(_arb_stats, entries=len(_entries), bytes=sum(_device_bytes.values()),
                    charges={k: v for k, v in charges.items() if v})


def traffic_seen() -> bool:
    """True once a stream went through the arbiter in this process: the
    sink writes ``stream_cache`` only then, so an executor-off run's
    ``run_end`` record keeps its keys."""
    return _saw_traffic


def drop_entries() -> None:
    """Drop every entry and charge, keeping the counts and the fingerprint
    memo (``prefetch.quiesce``: nothing of an aborted visit stays
    resident)."""
    with _arb_lock:
        _entries.clear()
        _device_bytes.clear()
        _charges.clear()
        _holder_lru.clear()


def clear() -> None:
    """Drop every entry, charge, count and remembered fingerprint, and the
    active marks (between arms); the registrations and the worker pool
    stay."""
    global _saw_traffic
    drop_entries()
    with _arb_lock:
        for k in _arb_stats:
            _arb_stats[k] = 0
        _saw_traffic = False
    with _fp_lock:
        _fp_memo.clear()
    with _reg_lock:
        _active.clear()
