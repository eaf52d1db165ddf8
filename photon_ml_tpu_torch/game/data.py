"""GAME data: the columnar batch, entity grouping and bucketing (port of
``photon_ml_tpu/game/data.py``).

- ``GameBatch`` holds labels, offsets, weights, one feature container per
  shard and one integer entity-id column per random-effect type, all on one
  device.
- ``group_by_entity`` sorts the rows by entity id once, on the host, and
  reservoir-samples entities above ``active_upper_bound`` (the rows left
  out are scored, never trained on).
- ``bucket_entities`` pads entities into buckets of one capacity each, so
  every bucket is one (k, C, d) tensor that the random-effect solver takes
  as k lanes. Grouping and bucketing are host numpy and give the
  reference's integer arrays bit for bit (the same seeded ``rng.choice``).

The entity lanes' static tensors are gathered on the device by
``game/random_effect.py`` ``prepare_buckets``; ``gather_bucket_host``
here gathers one bucket from host columns (the out-of-core trainer's
per-visit gather, into page-locked memory), and ``gather_bucket`` is that
gather on the features' device. The owner-placement helpers
(``placement_atoms``, ``split_entity_buckets``) wait for ROADMAP queue 1
item 12d.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.ops.batch import Batch, DenseBatch, SparseBatch

Tensor = torch.Tensor


@dataclass(frozen=True)
class DenseFeatures:
    """(n, d) dense feature block for one shard."""

    X: Tensor

    @property
    def num_features(self) -> int:
        return self.X.shape[-1]

    @property
    def num_rows(self) -> int:
        return self.X.shape[0]

    def to_batch(self, labels: Tensor, offsets: Tensor, weights: Tensor) -> DenseBatch:
        return DenseBatch(X=self.X, labels=labels, offsets=offsets, weights=weights)

    def score(self, w: Tensor) -> Tensor:
        return self.X @ w

    def take(self, rows: Tensor) -> "DenseFeatures":
        return DenseFeatures(X=self.X[rows])


@dataclass(frozen=True)
class SparseFeatures:
    """Padded sparse rows for one shard: (n, k) int64 indices and values,
    padded with (0, 0.0)."""

    indices: Tensor
    values: Tensor
    num_features: int

    @property
    def num_rows(self) -> int:
        return self.indices.shape[0]

    def to_batch(self, labels: Tensor, offsets: Tensor, weights: Tensor) -> SparseBatch:
        return SparseBatch(
            indices=self.indices, values=self.values, labels=labels, offsets=offsets,
            weights=weights, num_features=self.num_features,
        )

    def score(self, w: Tensor) -> Tensor:
        return torch.sum(self.values * w[self.indices], dim=-1)

    def take(self, rows: Tensor) -> "SparseFeatures":
        return SparseFeatures(self.indices[rows], self.values[rows], self.num_features)


Features = DenseFeatures | SparseFeatures


@dataclass(frozen=True)
class GameBatch:
    """Columnar GAME dataset on one device. ``features[shard_id]`` is a
    shard's feature container; ``id_tags[tag]`` is an (n,) int64 entity-id
    column, used as a random effect's entity key."""

    labels: Tensor
    offsets: Tensor
    weights: Tensor
    features: dict[str, Features]
    id_tags: dict[str, Tensor]

    @property
    def num_rows(self) -> int:
        return self.labels.shape[0]

    @property
    def device(self) -> torch.device:
        return self.labels.device

    def to(self, device) -> "GameBatch":
        """The batch on ``device`` (itself when it lies there already)."""
        device = torch.device(device)
        if self.device == device:
            return self

        def move(f):
            if isinstance(f, DenseFeatures):
                return DenseFeatures(X=f.X.to(device))
            return SparseFeatures(f.indices.to(device), f.values.to(device), f.num_features)

        return GameBatch(labels=self.labels.to(device), offsets=self.offsets.to(device),
                         weights=self.weights.to(device), features={k: move(f) for k, f in self.features.items()},
                         id_tags={k: v.to(device) for k, v in self.id_tags.items()})

    def batch_for(self, shard_id: str, offsets: Tensor | None = None) -> Batch:
        """One coordinate's ``Batch``: the shard's features, the global
        labels and weights, and ``offsets`` (the residual scores during
        coordinate descent; the batch's own offsets when None)."""
        off = self.offsets if offsets is None else offsets
        return self.features[shard_id].to_batch(self.labels, off, self.weights)


def make_game_batch(
    labels,
    features: Mapping[str, object],
    id_tags: Mapping[str, object] | None = None,
    offsets=None,
    weights=None,
    dtype=torch.float32,
    device=None,
) -> GameBatch:
    """A ``GameBatch`` on ``device`` (CUDA unless the caller asks for
    another; raises without it) from numpy arrays or tensors. A 2-D feature
    array becomes ``DenseFeatures`` stored in ``dtype``; a prebuilt
    container passes through (it must lie on ``device``). Absent offsets
    are 0 and absent weights 1."""
    dev = resolve_device(device)
    n = len(labels)
    f32 = dict(dtype=torch.float32, device=dev)

    def col(a, fill):
        return torch.full((n,), fill, **f32) if a is None else torch.as_tensor(a, **f32)

    feats: dict[str, Features] = {}
    for sid, f in features.items():
        if isinstance(f, (DenseFeatures, SparseFeatures)):
            feats[sid] = f
        else:
            feats[sid] = DenseFeatures(X=torch.as_tensor(f, dtype=dtype, device=dev))
    return GameBatch(
        labels=col(labels, 0.0),
        offsets=col(offsets, 0.0),
        weights=col(weights, 1.0),
        features=feats,
        id_tags={k: torch.as_tensor(v, dtype=torch.int64, device=dev) for k, v in (id_tags or {}).items()},
    )


# ---------------------------------------------------------------------------
# entity grouping: the ingest-time "shuffle"
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class EntityGrouping:
    """Per-entity row segments of one random effect. ``active_rows[j]`` are
    the (at most ``active_upper_bound``) rows entity j trains on."""

    num_entities: int
    counts: np.ndarray  # (E,) rows per entity
    active_counts: np.ndarray  # (E,) rows trained on
    active_rows: list[np.ndarray]  # E arrays of row indices


def group_by_entity(
    entity_ids: np.ndarray,
    num_entities: int | None = None,
    active_upper_bound: int | None = None,
    seed: int = 0,
) -> EntityGrouping:
    """Group rows by integer entity id (host numpy): one stable argsort,
    split into per-entity segments; entities with more than
    ``active_upper_bound`` rows keep a seeded random subset of that size."""
    entity_ids = np.asarray(entity_ids)
    if len(entity_ids) and entity_ids.min() < 0:
        raise ValueError(
            "group_by_entity: negative entity ids (the unseen-entity sentinel "
            "-1 is a scoring-time concept; training ids must be dense >= 0)"
        )
    max_id = int(entity_ids.max()) + 1 if len(entity_ids) else 0
    if num_entities is None:
        num_entities = max_id
    elif num_entities < max_id:
        raise ValueError(
            f"group_by_entity: num_entities={num_entities} < max entity id + 1 = {max_id}"
        )
    order = np.argsort(entity_ids, kind="stable")
    counts = np.bincount(entity_ids, minlength=num_entities)
    rng = np.random.default_rng(seed)
    # np.split of zero segments still yields one empty array: guard E = 0
    active_rows = np.split(order, np.cumsum(counts)[:-1]) if num_entities else []
    active_counts = np.minimum(
        counts, active_upper_bound if active_upper_bound is not None else counts.max(initial=0)
    )
    if active_upper_bound is not None:
        for e in np.flatnonzero(counts > active_upper_bound):
            active_rows[e] = rng.choice(active_rows[e], size=active_upper_bound, replace=False)
    return EntityGrouping(
        num_entities=num_entities, counts=counts, active_counts=active_counts,
        active_rows=active_rows,
    )


# ---------------------------------------------------------------------------
# bucketing: variable-size entities → fixed-geometry tensors
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class EntityBuckets:
    """Entities grouped by padded row capacity: for bucket b,
    ``entity_ids[b]`` is (k_b,) and ``row_indices[b]`` is (k_b, C_b) with
    -1 padding."""

    capacities: tuple[int, ...]
    entity_ids: list[np.ndarray]
    row_indices: list[np.ndarray]

    @property
    def num_entities(self) -> int:
        return sum(len(e) for e in self.entity_ids)


def default_capacities(max_count: int, smallest: int = 8, growth: int = 2) -> tuple[int, ...]:
    """The geometric capacity ladder [8, 16, 32, ...] up to max_count."""
    caps = [smallest]
    while caps[-1] < max_count:
        caps.append(caps[-1] * growth)
    return tuple(caps)


def _capacity_slots(
    active_counts: np.ndarray,
    capacities: tuple[int, ...] | None,
    target_buckets: int,
    max_padded_ratio: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(active entity indices, each one's capacity slot, the ladder): the
    class assignment ``bucket_entities`` and ``capacity_classes`` share."""
    counts = np.asarray(active_counts)
    active = np.flatnonzero(counts > 0)
    if len(active) == 0:
        return active, np.zeros(0, np.int64), np.zeros(0, np.int64)
    max_count = int(counts[active].max())
    explicit = capacities is not None
    if capacities is None:
        capacities = default_capacities(max_count)
    caps = np.asarray(sorted(capacities))
    if caps[-1] < max_count:
        raise ValueError(
            f"largest bucket capacity {caps[-1]} < max active entity size {max_count}"
        )
    slot = np.searchsorted(caps, counts[active])  # smallest capacity >= count
    if not explicit:
        slot, caps = _merge_bucket_classes(
            slot, caps, counts[active], target_buckets, max_padded_ratio
        )
    return active, slot, caps


def bucket_entities(
    grouping: EntityGrouping,
    capacities: tuple[int, ...] | None = None,
    target_buckets: int = 8,
    max_padded_ratio: float = 0.5,
) -> EntityBuckets:
    """Put each entity with at least one active row into the smallest
    capacity that holds it, and build the padded row-index matrices. Without
    explicit ``capacities`` the geometric ladder is then merged greedily
    toward ``target_buckets`` classes while the padding merging adds stays
    under ``max_padded_ratio`` × the active rows."""
    active, slot, caps = _capacity_slots(
        grouping.active_counts, capacities, target_buckets, max_padded_ratio
    )
    if len(active) == 0:
        return EntityBuckets(capacities=(), entity_ids=[], row_indices=[])
    ent_ids: list[np.ndarray] = []
    row_idx: list[np.ndarray] = []
    used_caps: list[int] = []
    for b, cap in enumerate(caps):
        members = active[slot == b]
        if len(members) == 0:
            continue
        rows = np.full((len(members), cap), -1, dtype=np.int64)
        for i, e in enumerate(members):
            seg = grouping.active_rows[e]
            rows[i, : len(seg)] = seg
        used_caps.append(int(cap))
        ent_ids.append(members.astype(np.int64))
        row_idx.append(rows)
    return EntityBuckets(capacities=tuple(used_caps), entity_ids=ent_ids, row_indices=row_idx)


def capacity_classes(
    active_counts: np.ndarray,
    capacities: tuple[int, ...] | None = None,
    target_buckets: int = 8,
    max_padded_ratio: float = 0.5,
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The (used capacities, entities per class) that ``bucket_entities``
    would give for these active counts, without building row matrices.
    After the merge every entity's class is the smallest surviving capacity
    that holds it, so bucketing any subset with these capacities passed
    explicitly gives each entity the same capacity."""
    active, slot, caps = _capacity_slots(
        active_counts, capacities, target_buckets, max_padded_ratio
    )
    if len(active) == 0:
        return (), ()
    pops = np.bincount(slot, minlength=len(caps))
    used = np.flatnonzero(pops > 0)
    return tuple(int(caps[b]) for b in used), tuple(int(pops[b]) for b in used)


def _merge_bucket_classes(
    slot: np.ndarray,
    caps: np.ndarray,
    active_counts: np.ndarray,
    target_buckets: int,
    max_padded_ratio: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Merge adjacent capacity classes, cheapest added padding first, until
    at most ``target_buckets`` non-empty classes remain or the padding the
    merges add would pass ``max_padded_ratio`` × the active rows (the
    ladder's own padding does not count against that budget)."""
    budget = max_padded_ratio * float(active_counts.sum())
    counts_per_class = np.bincount(slot, minlength=len(caps)).astype(np.int64)
    added = 0.0
    while np.count_nonzero(counts_per_class) > max(target_buckets, 1):
        used = np.flatnonzero(counts_per_class)
        if len(used) < 2:
            break
        # cost of merging used class lo into the next used class above it
        add, lo, hi = min(
            (counts_per_class[lo] * (caps[hi] - caps[lo]), lo, hi)
            for lo, hi in zip(used[:-1], used[1:])
        )
        if added + add > budget:
            break
        slot = np.where(slot == lo, hi, slot)
        counts_per_class[hi] += counts_per_class[lo]
        counts_per_class[lo] = 0
        added += add
    return slot, caps


def _host_array(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def gather_bucket_host(
    features: Features,
    labels: np.ndarray,
    offsets: np.ndarray,
    weights: np.ndarray,
    row_indices: np.ndarray,
    columns: np.ndarray | None = None,
    pin_memory: bool = False,
) -> dict[str, torch.Tensor]:
    """One bucket's (k, C, …) columns gathered on the host as CPU tensors
    (page-locked with ``pin_memory``, so a copy to the card can run
    asynchronously), written in place by numpy. Padded slots (row index
    -1) get weight 0, which keeps them inert in the objective, and zeroed
    feature values, so nothing that reads raw values sees a phantom copy
    of row 0 (a sparse slot keeps row 0's indices). ``columns`` (per-entity
    (k, p) column maps) narrows dense features to width p on the host,
    before any copy pays for the full width."""
    idx = np.maximum(row_indices, 0)
    mask = (row_indices >= 0).astype(np.float32)

    def take(src: np.ndarray, masked: bool) -> torch.Tensor:
        out = torch.empty(idx.shape + src.shape[1:], dtype=torch.from_numpy(src[:0]).dtype,
                          pin_memory=pin_memory)
        o = out.numpy()
        np.take(src, idx, axis=0, out=o)
        if masked:
            np.multiply(o, mask.reshape(mask.shape + (1,) * (src.ndim - 1)), out=o)
        return out

    out = {k: take(np.asarray(a, np.float32), True)
           for k, a in (("labels", labels), ("offsets", offsets), ("weights", weights))}
    if isinstance(features, DenseFeatures):
        X = _host_array(features.X)
        if columns is None:
            out["X"] = take(X, True)
        else:
            full = X[idx] * mask[:, :, None]
            narrow = np.take_along_axis(full, np.asarray(columns)[:, None, :], axis=2)
            out["X"] = torch.empty(narrow.shape, dtype=torch.from_numpy(narrow[:0]).dtype,
                                   pin_memory=pin_memory)
            out["X"].numpy()[...] = narrow
        return out
    if columns is not None:
        raise ValueError("subspace column maps require dense features")
    out["indices"] = take(_host_array(features.indices), False)
    out["values"] = take(_host_array(features.values), True)
    return out


def bucket_batch(arrays: dict, num_features: int) -> Batch:
    """A gathered bucket's columns (``gather_bucket_host``, or their copies
    on a device) as the lanes' batch: a (k, C, d) ``DenseBatch`` or a
    (k, C, nnz) ``SparseBatch`` with int64 indices."""
    cols = dict(labels=arrays["labels"], offsets=arrays["offsets"], weights=arrays["weights"])
    if "X" in arrays:
        return DenseBatch(X=arrays["X"], **cols)
    return SparseBatch(indices=arrays["indices"].long(), values=arrays["values"],
                       num_features=num_features, **cols)


def gather_bucket(
    features: Features,
    labels: np.ndarray,
    offsets: np.ndarray,
    weights: np.ndarray,
    row_indices: np.ndarray,
    columns: np.ndarray | None = None,
) -> Batch:
    """One bucket's (k, C, …) batch gathered on the host from host columns
    (``gather_bucket_host``), on the features' device (the CPU for numpy
    features)."""
    src = features.X if isinstance(features, DenseFeatures) else features.values
    dev = src.device if isinstance(src, torch.Tensor) else torch.device("cpu")
    arrays = gather_bucket_host(features, labels, offsets, weights, row_indices, columns)
    return bucket_batch({k: v.to(dev) for k, v in arrays.items()}, features.num_features)
