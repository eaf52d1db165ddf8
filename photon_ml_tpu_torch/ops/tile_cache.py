"""Process-wide cache of K3's sparse layouts (port of
``photon_ml_tpu/ops/tile_cache.py``).

Packing a padded-sparse batch into K3's per-direction layouts
(``ops/sparse_tiled.py`` ``tile_sparse_batch``: a sort and a scatter over
every nonzero) was paid again for the same sparsity structure wherever an
objective was rebuilt over the same data: each ``StreamingGLMObjective``
of a λ sweep, a second objective over the same chunks, the module scorer.
This cache keys the layouts by

    (sparsity fingerprint, device, K3's constants)

where the fingerprint hashes the nonzero structure (index and value bytes,
shape, feature count) and the constants are the port's own, read at call
time (``TILE_NNZ``, the int8 cell ``SLAB`` and the storage rung), so a
change of them misses by key. Only the layouts are cached; labels, offsets
and weights always come from the caller's batch.

Thread-safe: the prefetch workers look layouts up concurrently. The lock
guards the LRU's mutation and bookkeeping only; the pack runs outside it
(two racing misses of one key both pack, and the later insert wins). The
cache is bounded both by entries (``CAPACITY``) and by the layouts' device
bytes (``BYTE_BUDGET``, against a running total), both read at call time;
``clear()`` drops all.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

CAPACITY = 32
# an A2 chunk's layouts (2^16 rows, 32 nonzeros a row, both directions) take
# about 34 MB, so the budget holds many chunks or a few whole datasets
BYTE_BUDGET = 2 * 1024**3

_lock = threading.Lock()
_entries: "OrderedDict[tuple, tuple]" = OrderedDict()
_entry_bytes: dict = {}
_total_bytes = 0
_stats = {"hits": 0, "misses": 0}


def tuned_constants() -> tuple:
    """K3's layout-shaping constants, read at call time."""
    import photon_ml_tpu_torch.ops.sparse_tiled as st

    return (st.TILE_NNZ, st.SLAB, st.kernel_dtype())


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def structure_fingerprint(indices, values) -> tuple:
    """Byte-exact hash of the nonzero structure alone (shape, index and
    value bytes); labels, offsets and weights are left out on purpose."""
    idx = np.ascontiguousarray(_host(indices))
    val = np.ascontiguousarray(_host(values).astype(np.float32, copy=False))
    return (
        idx.shape,
        hashlib.sha256(idx.tobytes()).hexdigest(),
        hashlib.sha256(val.tobytes()).hexdigest(),
    )


def sparsity_fingerprint(indices, values, num_features: int) -> tuple:
    """The key's data half: the structure and the feature width."""
    shape, h_idx, h_val = structure_fingerprint(indices, values)
    return (shape, int(num_features), h_idx, h_val)


def stats() -> dict:
    with _lock:
        return dict(_stats, entries=len(_entries), bytes=_total_bytes)


def _evict_over_limits_locked() -> None:
    global _total_bytes
    while _entries and (len(_entries) > CAPACITY or _total_bytes > BYTE_BUDGET):
        key, _ = _entries.popitem(last=False)
        _total_bytes -= _entry_bytes.pop(key, 0)


def clear() -> None:
    global _total_bytes
    with _lock:
        _entries.clear()
        _entry_bytes.clear()
        _total_bytes = 0
        _stats["hits"] = 0
        _stats["misses"] = 0


def _layout_nbytes(tb) -> int:
    return sum(lay.stream_bytes() + sum(lay.tile_bytes()) for lay in (tb.m, tb.g))


def tiled_layout_for(batch, fingerprint: tuple | None = None, device=None):
    """A ``TiledSparseBatch`` for the padded-sparse ``batch`` on ``device``
    (the batch's own by default), reusing the cached layouts when the same
    structure was packed there under the current constants. The result
    carries the caller's labels, offsets and weights. ``fingerprint`` lets a
    caller that already hashed the chunk skip the second hash."""
    import photon_ml_tpu_torch.ops.sparse_tiled as st
    from photon_ml_tpu_torch.ops.batch import SparseBatch

    dev = torch.device(device) if device is not None else batch.device
    if fingerprint is None:
        fingerprint = sparsity_fingerprint(batch.indices, batch.values, batch.num_features)
    key = (fingerprint, str(dev), tuned_constants())
    with _lock:
        cached = _entries.get(key)
        if cached is not None:
            _entries.move_to_end(key)
            _stats["hits"] += 1
    if cached is None:
        # pack outside the lock, through the module attribute (so a wrapped
        # builder sees the misses)
        packed = st.tile_sparse_batch(SparseBatch(
            indices=batch.indices.to(dev), values=batch.values.to(dev),
            labels=batch.labels, offsets=batch.offsets, weights=batch.weights,
            num_features=batch.num_features,
        ))
        cached = (packed.m, packed.g)
        nbytes = _layout_nbytes(packed)
        global _total_bytes
        with _lock:
            _stats["misses"] += 1
            prev = _entry_bytes.pop(key, None)
            # the pack is accounted once per new entry: a racing miss on
            # the same key packed the same layouts
            record_pack = prev is None
            if prev is not None:  # a racing miss inserted this key first
                _total_bytes -= prev
                _entries.pop(key, None)
            if nbytes <= BYTE_BUDGET:  # an over-budget layout is never pinned
                _entries[key] = cached
                _entry_bytes[key] = nbytes
                _total_bytes += nbytes
            _evict_over_limits_locked()
        if record_pack:
            from photon_ml_tpu_torch.obs import devcost

            devcost.record_layout_pack(nbytes=nbytes, chunks=1)
    m, g = cached
    return st.TiledSparseBatch(
        m=m, g=g, labels=batch.labels, offsets=batch.offsets, weights=batch.weights,
        num_features=batch.num_features,
    )
