"""Bounded-depth prefetch pipeline and device-resident chunk cache (port of
``photon_ml_tpu/ops/prefetch.py``).

The streamed consumers (``ops/streaming.py``'s chunk objective and scorer,
``supervised/cross_validation.py``'s fold ingest) share one shape: a host
preparation per item (staging, the copy to the card) followed by device
work, item after item, pass after pass. ``prefetch_iter`` prepares item
``i+k`` on worker threads while the consumer computes item ``i``.

- **Only preparation is reordered.** Workers produce inputs; every kernel
  call and every accumulation stays on the consumer thread in item order,
  so results are bitwise those of the synchronous schedule.
  ``PHOTON_PREFETCH_DEPTH=0`` prepares each item on the consumer thread,
  just before its turn; the chunk cache serves every depth alike.
- **Errors propagate, never deadlock.** A worker's exception is raised
  again in the consumer when that item's turn comes; the queued work is
  cancelled. The pool is process-wide and no task waits on another.

The chunk cache: the streamed solvers stage the same chunk sequence on
every pass, so passes 2..N should find the chunks already on the card.
``cached_device_put`` keeps a process-wide LRU per array, keyed by the host
array's storage (data pointer and layout; the entry holds the array, so the
address cannot be reused while it is cached), byte-budgeted against the
card's memory (``chunk_cache_budget_bytes``). A packed entry (a feature
array cast to bfloat16 on the reduced rungs) evicted from the device tier
spills to a host tier that keeps the cast array, so a re-entry pays one
copy and no second cast; an entry at its own dtype has nothing to keep and
is dropped. The host budget (``host_spill_budget_bytes``, the device
tier's) bounds both the spilled arrays and the host memory that device
entries pin (a view pins its whole base, counted once however many
entries view it). Cached host arrays must not be mutated in place.
``clear_cache`` drops both tiers.

Copies to the card: a chunk's numpy arrays are pageable, and an
asynchronous copy needs page-locked memory, so each array is first copied
into pinned staging memory taken from PyTorch's caching host allocator
(``Tensor.pin_memory``; it keeps freed pinned blocks for reuse, so the
pinned memory held is about the arrays in flight: depth + 1 chunks), then
copied with ``non_blocking=True`` on one copy stream per card, from the
worker thread. An event is recorded after each copy; the consumer makes
its stream wait on it (``wait``) before the kernel reads the chunk, and the
copy's buffers are marked as used by the consumer's stream
(``Tensor.record_stream``), so the caching allocator cannot hand a buffer
out again while a kernel still reads it. A failed pinned allocation or
copy raises. On the CPU an array is wrapped without a copy.

Knobs, read from the environment at call time:
``PHOTON_PREFETCH_DEPTH`` (default 2; 0 = synchronous) and
``PHOTON_CHUNK_CACHE_BUDGET`` (bytes; default a quarter of the card's
memory). On the bf16 and int8 rungs of ``PHOTON_KERNEL_DTYPE`` the raw
feature columns (``X``, ``values``) cross to the card in bfloat16.

The stages' wall seconds are the metrics registry's timers
``prefetch.host_pack_s`` (worker preparation besides the copies),
``prefetch.device_put_s`` (staging and issuing copies) and
``prefetch.consumer_wait_s`` (time the consumer waited for a prepared
item), so they land in a run's telemetry; ``stage_seconds`` is a view of
them by stage name. ``copied`` counts the arrays and bytes copied to a
card. ``reset_stage_seconds`` zeroes both. The cache's registry counters
are the reference's: ``prefetch.cache.hit_bytes`` (device hits, at the
device size), ``host_hit_bytes``, ``miss_bytes`` (the staged bytes a
miss copies) and ``evictions``, fed from the increments behind
``cache_stats()``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator

import numpy as np
import torch

from photon_ml_tpu_torch.obs.metrics import REGISTRY as _REGISTRY
from photon_ml_tpu_torch.utils import profiling

_DEFAULT_PREFETCH_DEPTH = 2  # items prepared ahead of the consumer; 0 = synchronous
# a minority of the card: the streamed paths run when the data exceed the
# residency budget, so the cache leaves most of the memory to the kernels
_DEFAULT_HBM_FRACTION = 0.25
_device_budget_memo: dict[str, int] = {}

_STAGES = ("host_pack_s", "device_put_s", "consumer_wait_s")
copied = {"arrays": 0, "bytes": 0}
_stage_lock = threading.Lock()


class _StageSeconds(Mapping):
    """The stage timers by stage name (``host_pack_s``, ...): a read-only
    view of the registry's ``prefetch.*`` timers."""

    def __getitem__(self, name: str) -> float:
        if name not in _STAGES:
            raise KeyError(name)
        t = profiling.counter_snapshot(f"prefetch.{name}").get(f"prefetch.{name}")
        return 0.0 if t is None else t["seconds"]

    def __iter__(self):
        return iter(_STAGES)

    def __len__(self) -> int:
        return len(_STAGES)


stage_seconds = _StageSeconds()


def _add_seconds(name: str, dt: float) -> None:
    profiling.add_seconds(f"prefetch.{name}", dt)


def reset_stage_seconds() -> None:
    for name in _STAGES:
        profiling.reset_counters(f"prefetch.{name}")
    with _stage_lock:
        copied["arrays"] = copied["bytes"] = 0


def prefetch_depth() -> int:
    """The pipeline depth, read at call time."""
    env = os.environ.get("PHOTON_PREFETCH_DEPTH")
    return max(int(env), 0) if env else _DEFAULT_PREFETCH_DEPTH


def chunk_cache_budget_bytes(device=None) -> int:
    """The device tier's byte budget, read at call time: the environment,
    else a quarter of ``device``'s memory (2 GB without CUDA)."""
    env = os.environ.get("PHOTON_CHUNK_CACHE_BUDGET")
    if env:
        return max(int(env), 0)
    key = str(device)
    if key not in _device_budget_memo:
        from photon_ml_tpu_torch.ops.streaming import device_hbm_budget_bytes

        # an idempotent memo of a fixed quantity: a racing write stores the same value
        _device_budget_memo[key] = int(
            device_hbm_budget_bytes(default=2e9, fraction=_DEFAULT_HBM_FRACTION, device=device)
        )
    return _device_budget_memo[key]


def host_spill_budget_bytes(device=None) -> int:
    """The host tier's byte budget: the device tier's."""
    return chunk_cache_budget_bytes(device)


# -- the bounded-depth pipeline ----------------------------------------------------
_pool_lock = threading.Lock()
_pool: ThreadPoolExecutor | None = None
_WORKER_PREFIX = "photon-prefetch"


def _worker_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 2), thread_name_prefix=_WORKER_PREFIX
            )
        return _pool


# per-thread copy seconds, so host_pack_s and device_put_s stay disjoint
_stage_tls = threading.local()


def _timed_prepare(prepare: Callable[[int], Any], i: int) -> Any:
    t0 = time.perf_counter()
    _stage_tls.put_s = 0.0
    try:
        return prepare(i)
    finally:
        dt = time.perf_counter() - t0 - _stage_tls.put_s
        del _stage_tls.put_s
        _add_seconds("host_pack_s", max(dt, 0.0))


def prefetch_iter(num_items: int, prepare: Callable[[int], Any], depth: int | None = None) -> Iterator[Any]:
    """Yield ``prepare(0..num_items-1)`` in order, preparing up to ``depth``
    items ahead on worker threads (``None`` reads the knob; 0 runs
    synchronously). A preparation's error is raised at that item's turn,
    and the queued items are cancelled (running ones finish, dropped)."""
    if depth is None:
        depth = prefetch_depth()
    if threading.current_thread().name.startswith(_WORKER_PREFIX):
        depth = 0  # a pool worker waiting on the pool could starve it
    if depth <= 0 or num_items <= 1:
        for i in range(num_items):
            yield prepare(i)
        return
    pool = _worker_pool()
    futs: deque = deque()
    nxt = 0
    try:
        while nxt < num_items and len(futs) < depth:
            futs.append(pool.submit(_timed_prepare, prepare, nxt))
            nxt += 1
        while futs:
            f = futs.popleft()
            t0 = time.perf_counter()
            try:
                out = f.result()  # a worker's exception is raised here
            finally:
                _add_seconds("consumer_wait_s", time.perf_counter() - t0)
            if nxt < num_items:
                futs.append(pool.submit(_timed_prepare, prepare, nxt))
                nxt += 1
            yield out
    finally:
        for f in futs:  # the consumer stopped early: drop the rest
            f.cancel()


# -- copies to the device ------------------------------------------------------------
class DeviceChunk(dict):
    """A chunk's arrays on the device; ``events`` are the copies the
    consumer's stream must wait for (``wait``)."""

    def __init__(self, arrays: dict, events: list):
        super().__init__(arrays)
        self.events = events


_copy_streams: dict[int, torch.cuda.Stream] = {}


def _copy_stream(dev: torch.device) -> "torch.cuda.Stream":
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    with _pool_lock:
        if idx not in _copy_streams:
            _copy_streams[idx] = torch.cuda.Stream(device=idx)
        return _copy_streams[idx]


def consumer_stream(dev: torch.device):
    """The stream the calling thread's kernels run on (None on the CPU)."""
    return torch.cuda.current_stream(dev) if dev.type == "cuda" else None


def _host_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def _copy_to(staged, dev: torch.device, consumer) -> tuple[torch.Tensor, Any]:
    """One host array on ``dev``: (tensor, copy event or None)."""
    t0 = time.perf_counter()
    try:
        host = _host_tensor(staged)
        if dev.type == "cpu":
            return host, None
        if dev.type != "cuda":
            raise ValueError(f"chunks stream to CPU or CUDA devices, not {dev}")
        pinned = host.pin_memory()  # page-locked staging; raises if it cannot be had
        stream = _copy_stream(dev)
        with torch.cuda.stream(stream):
            out = pinned.to(dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        if consumer is not None:
            out.record_stream(consumer)
        with _stage_lock:
            copied["arrays"] += 1
            copied["bytes"] += _nbytes(host)
        return out, ev
    finally:
        dt = time.perf_counter() - t0
        _add_seconds("device_put_s", dt)
        if hasattr(_stage_tls, "put_s"):
            _stage_tls.put_s += dt


def device_put(host_tree: dict, device, consumer=None) -> DeviceChunk:
    """A prepared host chunk on ``device`` without the cache (the module
    scorer's single pass)."""
    dev = torch.device(device)
    arrays, events = {}, []
    for k, v in host_tree.items():
        arrays[k], ev = _copy_to(v, dev, consumer)
        if ev is not None:
            events.append(ev)
    return DeviceChunk(arrays, events)


def wait(chunk, consumer) -> None:
    """Make the consumer's stream wait for the chunk's copies."""
    if consumer is not None:
        for ev in getattr(chunk, "events", ()):
            consumer.wait_event(ev)


# -- transfer dtype ------------------------------------------------------------------
_PACK_KEYS = ("values", "X")


def transfer_dtype() -> str:
    """The raw chunks' transfer rung at call time: "f32" or "bf16"."""
    from photon_ml_tpu_torch.ops.sparse_tiled import kernel_dtype

    return "f32" if kernel_dtype() == "f32" else "bf16"


def _pack_for_transfer(a):
    """A float32 feature array → its bfloat16 twin (a host tensor)."""
    if isinstance(a, np.ndarray) and a.dtype == np.float32:
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    return a


def pack_host_chunk(host_tree: dict) -> dict:
    """A host chunk with its feature arrays at the transfer dtype (the same
    chunk on the f32 rung)."""
    if transfer_dtype() == "f32":
        return host_tree
    return {k: _pack_for_transfer(np.asarray(v)) if k in _PACK_KEYS else v for k, v in host_tree.items()}


# -- the device-resident chunk cache ------------------------------------------------
_cache_lock = threading.Lock()
# key -> (host_ref, staged, device tensor, event, device bytes, packed host bytes); LRU order
_device_tier: "OrderedDict[tuple, tuple]" = OrderedDict()
_device_bytes = 0
_device_host_bytes = 0  # host memory the device tier's entries pin
# key -> (host_ref, staged, host bytes): spilled packed entries
_host_tier: "OrderedDict[tuple, tuple]" = OrderedDict()
_host_bytes = 0
_cache_stats = {"device_hits": 0, "host_hits": 0, "misses": 0, "evictions": 0}


def _storage_key(a: np.ndarray) -> tuple:
    ai = a.__array_interface__
    return (ai["data"], a.shape, ai["strides"], str(a.dtype))


def _pinned_nbytes(a: np.ndarray) -> int:
    """Host bytes an entry pins: a view keeps its whole base alive."""
    base = a.base
    return int(base.nbytes) if isinstance(base, np.ndarray) else int(a.nbytes)


# the device tier's pinned bases: id(base) -> [entries viewing it, its bytes].
# Chunks that are views of one host array (the out-of-core GAME trainer's
# feature chunks) pin that array once, not once per chunk
_device_bases: dict[int, list] = {}


def _base_key(a: np.ndarray) -> int:
    return id(a.base) if isinstance(a.base, np.ndarray) else id(a)


def _pin_base_locked(a: np.ndarray) -> int:
    """Count one more device entry over ``a``'s base; the host bytes that
    adds (the base's, for its first entry)."""
    ref = _device_bases.setdefault(_base_key(a), [0, _pinned_nbytes(a)])
    ref[0] += 1
    return ref[1] if ref[0] == 1 else 0


def _unpin_base_locked(a: np.ndarray) -> int:
    """One device entry over ``a``'s base fewer; the host bytes that frees."""
    key = _base_key(a)
    ref = _device_bases[key]
    ref[0] -= 1
    if ref[0]:
        return 0
    del _device_bases[key]
    return ref[1]


def _nbytes(x) -> int:
    return int(x.nbytes) if isinstance(x, np.ndarray) else x.numel() * x.element_size()


def _evict_over_budget_locked(dev) -> None:
    global _device_bytes, _device_host_bytes, _host_bytes
    budget = chunk_cache_budget_bytes(dev)
    host_budget = host_spill_budget_bytes(dev)
    while _device_tier and (_device_bytes > budget or _device_host_bytes > host_budget):
        key, (host_ref, staged, _dev, _ev, nb_dev, nb_extra) = _device_tier.popitem(last=False)
        _device_bytes -= nb_dev
        _device_host_bytes -= nb_extra + _unpin_base_locked(host_ref)
        _cache_stats["evictions"] += 1
        _REGISTRY.counter_inc("prefetch.cache.evictions")
        if staged is host_ref:  # at its own dtype: nothing to keep
            continue
        nb_host = _pinned_nbytes(host_ref) + nb_extra
        if key not in _host_tier:
            _host_bytes += nb_host
        _host_tier[key] = (host_ref, staged, nb_host)
        _host_tier.move_to_end(key)
    while _host_tier and _host_bytes > host_budget:
        _, (_ref, _staged, nb) = _host_tier.popitem(last=False)
        _host_bytes -= nb


def _cached_put_one(name: str, a, dev: torch.device, consumer):
    """One host array → (device tensor, copy event) through the LRU."""
    global _device_bytes, _device_host_bytes, _host_bytes
    a = np.asarray(a)
    tdt = transfer_dtype()
    packs = tdt != "f32" and name in _PACK_KEYS and a.dtype == np.float32
    # the transfer dtype keys packed arrays: a bf16 entry never serves an f32 pass
    key = _storage_key(a) + (str(dev),) + ((tdt,) if packs else ())
    staged = None
    with _cache_lock:
        hit = _device_tier.get(key)
        if hit is not None:
            _device_tier.move_to_end(key)
            _cache_stats["device_hits"] += 1
        else:
            spilled = _host_tier.pop(key, None)
            if spilled is not None:
                _host_bytes -= spilled[2]
                _cache_stats["host_hits"] += 1
                staged = spilled[1]
            else:
                _cache_stats["misses"] += 1
    # the registry's twins take their own (leaf) lock
    if hit is not None:
        _REGISTRY.counter_inc("prefetch.cache.hit_bytes", hit[4])
        if consumer is not None:
            hit[2].record_stream(consumer)
        return hit[2], hit[3]
    if staged is None:
        staged = _pack_for_transfer(a) if packs else a
        _REGISTRY.counter_inc("prefetch.cache.miss_bytes", _nbytes(staged))
    else:
        _REGISTRY.counter_inc("prefetch.cache.host_hit_bytes", _nbytes(staged))
    dev_t, ev = _copy_to(staged, dev, consumer)  # outside the lock: the expensive part
    nb_dev = dev_t.numel() * dev_t.element_size()
    nb_extra = _nbytes(staged) if staged is not a else 0  # a packed copy, beside the base
    with _cache_lock:
        if (nb_dev <= chunk_cache_budget_bytes(dev)
                and _pinned_nbytes(a) + nb_extra <= host_spill_budget_bytes(dev)):
            prev = _device_tier.pop(key, None)
            if prev is not None:  # a racing miss inserted it first
                _device_bytes -= prev[4]
                _device_host_bytes -= prev[5] + _unpin_base_locked(prev[0])
            _device_tier[key] = (a, staged, dev_t, ev, nb_dev, nb_extra)
            _device_bytes += nb_dev
            _device_host_bytes += nb_extra + _pin_base_locked(a)
            _evict_over_budget_locked(dev)
    return dev_t, ev


def cached_device_put(host_tree: dict, device, consumer=None) -> DeviceChunk:
    """A host chunk's arrays on ``device`` through the process-wide
    per-array cache: a repeat pass over the same host storage gets the
    resident tensors back, and a chunk whose offsets alone changed copies
    only its offsets. Thread-safe: workers for different chunks race here.
    ``consumer`` is the stream the kernels will read the chunk on."""
    dev = torch.device(device)
    arrays, events = {}, []
    for k, v in host_tree.items():
        arrays[k], ev = _cached_put_one(k, v, dev, consumer)
        if ev is not None:
            events.append(ev)
    return DeviceChunk(arrays, events)


def cache_stats() -> dict:
    with _cache_lock:
        return dict(
            _cache_stats,
            device_entries=len(_device_tier),
            device_bytes=_device_bytes,
            device_host_pinned_bytes=_device_host_bytes,
            host_entries=len(_host_tier),
            host_bytes=_host_bytes,
        )


def quiesce() -> None:
    """End an aborted pipeline's device work: wait for every running
    preparation (the worker pool is shut down and made anew at its next
    use), wait for every copy stream and drop the chunk cache. A recovery
    calls it before it re-plans, so nothing of the aborted visit is in
    flight or resident, in this cache or in the stream executor's."""
    global _pool
    with _pool_lock:
        pool, _pool = _pool, None
        streams = list(_copy_streams.values())
    if pool is not None:
        pool.shutdown(wait=True, cancel_futures=True)
    for st in streams:
        st.synchronize()
    clear_cache()
    from photon_ml_tpu_torch.ops import stream_executor

    stream_executor.drop_entries()  # the executor's cache too: its registrations stay


def clear_cache() -> None:
    global _device_bytes, _device_host_bytes, _host_bytes
    with _cache_lock:
        _device_tier.clear()
        _device_bases.clear()
        _host_tier.clear()
        _device_bytes = _device_host_bytes = _host_bytes = 0
        for k in _cache_stats:
            _cache_stats[k] = 0
