"""Out-of-core GAME training: coordinate descent over host-resident data
(port of ``photon_ml_tpu/game/streaming.py``: one process, and several
with every fleet knob off).

The in-memory ``CoordinateDescent`` (``game/descent.py``) needs the whole
``GameBatch`` on the card. This trainer keeps the dataset in host memory
as numpy columns (``StreamedGameData``) and holds on the card, at a time,
the fixed effect's chunks (through the chunk cache of ``ops/prefetch.py``)
or a few random-effect buckets, and the models. The residual bookkeeping
``base_offsets + total − own_score`` is float32 host numpy over each
process's own rows, in the reference's order.

- **Fixed effect**: a ``StreamingGLMObjective`` over the shard's uniform
  chunks, solved by the host L-BFGS / OWL-QN / TRON
  (``select_minimize_fn(host=True)``): a dense chunk runs K1 (and K2 under
  TRON), a sparse one K3 where ``auto_tile_streaming`` tiles it. The
  feature chunks are built once per fit (views, and one padded copy of
  the last chunk), so their storage is stable and the cache keeps them on
  the card across visits; each visit binds fresh residual-offset arrays,
  never written in place, and the objective is kept per coordinate with
  only its ``chunks`` swapped.
- **Random effects**: entities are grouped and bucketed once per fit on
  the host (``game/data.py``). Every visit gathers each bucket's rows on
  the host into page-locked memory and copies them to the card on the copy
  stream of ``ops/prefetch.py`` (an event orders the solve after the
  copy); bucket i+1's gather and copy are issued before bucket i's
  results are read back, one bucket late. The lanes solve with
  ``game/random_effect.py`` ``solve_bucket_lanes`` (L-BFGS, OWL-QN, TRON
  or Newton), and the coefficient and variance matrices stay on the host,
  in the original feature space.

Across processes (``multihost=True``, in a ``parallel/multihost.py``
process group) the rows are partitioned: each process holds its own slice
of the data, and no process holds the dataset.

- The fixed effect streams each process's own chunks and sums every pass
  over the processes (``StreamingGLMObjective(cross_process=True)``).
- Entity e belongs to process e % P. At set-up each random effect's rows
  travel to their owners in rounds of ``chunk_rows`` rows of
  ``exchange_rows`` (the number of rounds set by the largest process, so
  an empty process takes part); the owner groups, buckets and solves its
  entities. Every visit, the residual offsets flow to the owners and the
  scores flow back, point to point; nothing is broadcast.
- Validation rows are routed the same way once; scalar metrics combine
  per-process partials (``evaluation/host_sharded.py``), grouped ones
  per-owner partials of complete groups, so no process gathers a global
  column.
- Checkpoints: each process writes its own scores to
  ``scores-shard-{pid:05d}.npz`` and process 0 the model (sharded, the
  default), or process 0 alone gathers every score
  (``sharded_checkpoints=False``). Process 0 reads the checkpoint and every
  process adopts its bytes.

Validation is scored after every coordinate visit (``validation_history``)
on the port's evaluators, grouped ones included. ``checkpoint_dir`` keeps
a resumable checkpoint per visit (every ``checkpoint_every_n_visits``-th)
in the reference's format and fingerprint, so either package resumes the
other's. Normalization from a streamed summary, SIMPLE and FULL variances,
down-sampling of the fixed effect, the incremental prior, warm starts and
the subspace and random projections of random effects are supported, with
the reference's construction-time rejections.

The fleet knobs (skew-aware placement and its re-planner, the overlapped
exchanges, device split, projection) and peer loss and rejoin are ROADMAP
queue 1 item 12d, and the knobs raise naming it.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import warnings
import zipfile
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from photon_ml_tpu_torch.config import GameTrainingConfig, OptimizationConfig
from photon_ml_tpu_torch.data.summary import shard_normalization_context, summarize_chunks
from photon_ml_tpu_torch.evaluation import EvaluationResults, evaluate_all, evaluate_host_sharded, make_evaluator
from photon_ml_tpu_torch.game.coordinate import _require_prior_l2
from photon_ml_tpu_torch.game.data import (
    DenseFeatures,
    EntityBuckets,
    Features,
    SparseFeatures,
    bucket_batch,
    bucket_entities,
    gather_bucket_host,
    group_by_entity,
)
from photon_ml_tpu_torch.game.models import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.game.projector import RandomProjector, subspace_columns
from photon_ml_tpu_torch.game.random_effect import DeferredLaunchAccounting, solve_bucket_lanes
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.obs import REGISTRY, emit_event, span
from photon_ml_tpu_torch.ops import prefetch
from photon_ml_tpu_torch.ops.glm import GaussianPrior, compute_variances
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.streaming import StreamingGLMObjective, dense_chunks, sparse_chunks, stream_scores
from photon_ml_tpu_torch.optim.common import select_minimize_fn
from photon_ml_tpu_torch.parallel import multihost as mh
from photon_ml_tpu_torch.sampling import down_sample
from photon_ml_tpu_torch.types import NormalizationType, VarianceComputationType
from photon_ml_tpu_torch.utils.atomic_io import atomic_savez

Tensor = torch.Tensor

# the reference's fleet knobs: each changes how entities or buckets are
# placed over processes or devices
_FLEET_KNOBS = ("PHOTON_RE_SHARD", "PHOTON_RE_PROJECT", "PHOTON_RE_DEVICE_SPLIT")


def _waits_for_item_12d(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} waits for ROADMAP queue 1 item 12d (the fleet knobs)")


@dataclass
class StreamedGameData:
    """Host-resident GAME dataset columns (plain or memory-mapped numpy).

    ``features[shard_id]`` is a dense (n, d) array, a ``DenseFeatures`` or
    a ``SparseFeatures`` (padded (n, k) indices and values) holding numpy
    arrays; nothing here touches the device. ``id_tags[tag]`` holds the
    per-row dense global entity ids of one id tag (-1: an entity unseen in
    training, on validation data). ``decoder`` says which Avro decoder
    read the rows, when a reader did. Across processes it holds this
    process's rows only."""

    labels: np.ndarray
    features: Mapping[str, Any]
    id_tags: Mapping[str, np.ndarray] = field(default_factory=dict)
    offsets: np.ndarray | None = None
    weights: np.ndarray | None = None
    decoder: str | None = None

    @property
    def num_rows(self) -> int:
        return len(self.labels)

    def feature_container(self, shard_id: str) -> Features:
        f = self.features[shard_id]
        if isinstance(f, (DenseFeatures, SparseFeatures)):
            return f
        return DenseFeatures(X=np.asarray(f))


@dataclass
class StreamedCoordinateInfo:
    """Last-visit solve diagnostics for one coordinate. For a random effect
    they aggregate the per-entity solves: ``iterations`` is the largest
    entity's count and ``converged`` holds only when every trained entity
    converged."""

    final_loss: float
    iterations: int
    converged: bool


def _chunk_ranges(n: int, chunk_rows: int) -> list[tuple[int, int]]:
    return [(lo, min(lo + chunk_rows, n)) for lo in range(0, n, chunk_rows)]


def seq_scores_init(cfg: GameTrainingConfig, model: GameModel) -> list[str]:
    """The update sequence's coordinates that the warm-start model carries."""
    return [cid for cid in cfg.coordinate_update_sequence if cid in model.models]


def _host_digest(labels: np.ndarray, weights: np.ndarray) -> str:
    """The reference's host digest of the data a checkpoint's scores belong
    to: the first and last 256 labels and the float64 sums of the labels
    and weights, read on the host (the columns never go to the card)."""
    return hashlib.sha256(
        labels[:256].tobytes()
        + labels[-256:].tobytes()
        + np.float64(labels.sum(dtype=np.float64)).tobytes()
        + np.float64(weights.sum(dtype=np.float64)).tobytes()
    ).hexdigest()


def _re_chunk_scores_dense(W_rows: Tensor, X: Tensor) -> Tensor:
    return torch.sum(W_rows * X, dim=1)


def _re_chunk_scores_sparse(W_rows: Tensor, idx: Tensor, val: Tensor) -> Tensor:
    return torch.sum(val * torch.gather(W_rows, 1, idx.long()), dim=1)


def _feature_arrays(f: Features) -> dict[str, np.ndarray]:
    """A feature container's row arrays, as plain arrays (no copy)."""
    if isinstance(f, DenseFeatures):
        return {"X": np.asarray(f.X)}
    return {"indices": np.asarray(f.indices), "values": np.asarray(f.values)}


def _features_from_arrays(arrays: dict[str, np.ndarray], like: Features) -> Features:
    """A container of ``like``'s kind over ``_feature_arrays``-keyed rows."""
    if isinstance(like, DenseFeatures):
        return DenseFeatures(X=arrays["X"])
    return SparseFeatures(indices=arrays["indices"], values=arrays["values"], num_features=like.num_features)


def _slice_features(f: Features, idx: np.ndarray) -> Features:
    """Host row-slice of a feature container."""
    return _features_from_arrays({k: v[idx] for k, v in _feature_arrays(f).items()}, f)


def _feature_chunk_dicts(feats: Features, labels: np.ndarray, chunk_rows: int,
                         offsets: np.ndarray, weights: np.ndarray) -> list[dict]:
    if isinstance(feats, DenseFeatures):
        return dense_chunks(np.asarray(feats.X), labels, chunk_rows, offsets=offsets, weights=weights)
    return sparse_chunks(np.asarray(feats.indices), np.asarray(feats.values), labels, chunk_rows,
                         offsets=offsets, weights=weights)


class _ChunkedShard:
    """One feature shard's rows as uniform chunks, built once per fit: the
    feature arrays (views for whole chunks, one zero-padded copy of the
    last), the labels and the weights (padding rows weigh 0) keep their
    storage from visit to visit, so the chunk cache keeps them on the
    card. ``chunks(offsets)`` binds one visit's residual offsets, which
    must be a fresh array: a cached array is never written in place."""

    def __init__(self, feats: Features, labels: np.ndarray, weights: np.ndarray, chunk_rows: int):
        self.num_rows = len(labels)
        self.chunk_rows = chunk_rows
        self.ranges = _chunk_ranges(self.num_rows, chunk_rows)
        cols = _feature_arrays(feats)
        self._static = []
        for lo, hi in self.ranges:
            chunk = {**{k: v[lo:hi] for k, v in cols.items()}, "labels": labels[lo:hi],
                     "weights": weights[lo:hi]}
            self._static.append({k: self._pad(v) for k, v in chunk.items()})

    def _pad(self, a: np.ndarray) -> np.ndarray:
        pad = self.chunk_rows - a.shape[0]
        return a if not pad else np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

    def chunks(self, offsets: np.ndarray) -> list[dict]:
        out = []
        for (lo, hi), static in zip(self.ranges, self._static):
            chunk = dict(static)
            chunk["offsets"] = self._pad(offsets[lo:hi])
            out.append(chunk)
        return out


@dataclass
class _ReShard:
    """One random-effect coordinate's rows that this process solves and
    scores: the training shard, or a validation shard (rows of entities
    seen in training only; the rest score 0 for this coordinate). Across
    processes they are the rows of the entities this process owns, after
    the exchange, and ``grow`` keys the per-visit exchanges."""

    ent_local: np.ndarray  # (m,) int64 owner-local dense entity ids (global id // P)
    labels: np.ndarray  # (m,) float32
    weights: np.ndarray  # (m,) float32
    features: Features | None  # m rows, in the solve space (projected under a random projection)
    # (m,) int64 global row ids of the rows, or None for every row of this
    # process's data in order (one process)
    grow: np.ndarray | None
    num_entities: int  # the coordinate's entity count over every process
    num_entities_local: int
    buckets: EntityBuckets | None  # None on a validation shard: it never solves
    # per-bucket (k, p) subspace column maps (None entries: full width)
    subspace_cols: tuple | None = None
    # the per-visit routing across processes, found once at set-up
    grow_sorted: np.ndarray | None = None  # sort(grow)
    grow_order: np.ndarray | None = None  # argsort(grow)
    origin_grow: np.ndarray | None = None  # (n_kept,) this process's kept rows' global ids
    origin_dest: np.ndarray | None = None  # (n_kept,) each kept row's owner process
    owner_dest: np.ndarray | None = None  # (m,) each owned row's origin process


def _slice_owned_rows(M_full: np.ndarray, pid: int, P: int, limit: int | None = None) -> np.ndarray:
    """This process's rows of a global (E, d) matrix (a warm start, a prior,
    a resume): owner p holds entities p, p + P, ... as its rows 0, 1, ....
    Always a writable copy: the bucket solves write rows in place."""
    out = M_full[pid::P] if P > 1 else M_full
    return (out if limit is None else out[:limit]).copy()


class StreamedGameTrainer:
    """Block coordinate descent over a ``StreamedGameData`` dataset, on
    ``device`` (CUDA unless the caller passes another; raises without it).

    The coordinate configuration is the ``GameTrainingConfig`` the
    in-memory estimator takes; only where the data live differs.
    ``checkpoint_dir`` checkpoints after every ``checkpoint_every_n_visits``-th
    coordinate visit and resumes from what is there. After ``fit``,
    ``validation_history[k]`` holds the evaluators' results after the k-th
    visit (with validation data and evaluators), ``resumed_from`` the
    (outer iteration, coordinate index) the fit resumed at (None from
    scratch), and ``visit_stats`` each visit's solve seconds with, for the
    fixed effect, its objective passes and, for a random effect, its bucket
    pipeline: host gather seconds, seconds issuing the copies, bytes copied
    and result read-backs. ``num_entities`` (id tag → dictionary size)
    floors each random effect's entity count, so a warm-start model's rows
    for entities absent from the data survive.

    ``multihost=True`` trains across the processes of the process group
    (the initialization error without one), each with its own rows (module
    docstring). Every process then calls ``fit`` with its slice; only
    process 0 writes the checkpoint's model, and ``sharded_checkpoints``
    picks per-process score files (a checkpoint directory every process
    can reach by the same path, the reference's shared file system; each
    reads back only its own file) over gathering every score on process
    0. ``exchange_totals`` holds the seconds, bytes sent and calls of each
    kind of row exchange (``ingest/<cid>``, ``validation/<cid>``,
    ``offsets``, ``scores``), and each random-effect visit's
    ``visit_stats`` its offset and score exchanges'."""

    def __init__(
        self,
        config: GameTrainingConfig,
        chunk_rows: int = 1 << 20,
        intercept_indices: Mapping[str, int | None] | None = None,
        logger=None,
        multihost: bool = False,
        checkpoint_dir: str | None = None,
        evaluators: Sequence[str] = (),
        num_entities: Mapping[str, int] | None = None,
        checkpoint_every_n_visits: int = 1,
        device=None,
        sharded_checkpoints: bool = True,
    ):
        if multihost:
            mh.require_process_group()
        self.multihost = bool(multihost)
        self.sharded_checkpoints = bool(sharded_checkpoints)
        self.device = resolve_device(device)
        self.config = config
        self.chunk_rows = int(chunk_rows)
        self.intercept_indices = dict(intercept_indices or {})
        self._log = logger or (lambda msg: None)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_n_visits = max(int(checkpoint_every_n_visits), 1)
        self.evaluators = list(evaluators)
        self.validation_history: list[dict[str, Any]] = []
        self.resumed_from: tuple[int, int] | None = None
        self.visit_stats: list[dict] = []
        self.exchange_totals: dict[str, dict] = {}
        self._entity_count_base: dict[str, int] = dict(num_entities or {})
        self._entity_count_floor: dict[str, int] = dict(self._entity_count_base)
        self._fixed_objectives: dict[str, StreamingGLMObjective] = {}
        self._fixed_shards: dict[str, tuple] = {}
        self._norm_contexts: dict[str, Any] = {}
        self._projectors: dict[str, RandomProjector] = {}
        has_projection = any(c.random_projection_dim is not None
                             for c in config.random_effect_coordinates.values())
        if has_projection and checkpoint_dir is not None:
            raise NotImplementedError(
                "streamed GAME checkpointing is not supported with random-projected coordinates: "
                "checkpoints store the original-space model, and projecting it again only "
                "approximates the projected descent state (P^T P != I); run projected configs "
                "without checkpoint_dir"
            )
        if has_projection and config.normalization is not NormalizationType.NONE:
            raise NotImplementedError(
                "normalization is not supported together with random projection (the projected "
                "columns have no per-feature statistics), as in the in-memory coordinate"
            )
        has_subspace = any(c.features_to_samples_ratio_upper_bound is not None
                           for c in config.random_effect_coordinates.values())
        if has_subspace and config.normalization is not NormalizationType.NONE:
            raise NotImplementedError(
                "normalization is not supported together with per-entity subspace projection "
                "(the per-entity column maps would need per-entity normalization slices), as in "
                "the in-memory coordinate"
            )

    # -- processes, entities and shards --------------------------------------------
    def _distributed(self) -> bool:
        return self.multihost and mh.process_count() > 1

    def _ranks(self) -> tuple[int, int]:
        """(this process's index, the process count) of the descent: (0, 1)
        unless it is distributed."""
        return (mh.process_index(), mh.process_count()) if self._distributed() else (0, 1)

    def _global_layout(self, n_local: int) -> tuple[int, int, tuple[int, ...]]:
        """(global row count, this process's first global row, every
        process's row count), from one gather. The row counts enter the
        checkpoint's fingerprint: global row ids follow them, so a resume
        under another process count or file assignment is refused."""
        if not self._distributed():
            return n_local, 0, (n_local,)
        counts = mh.allgather_host(np.asarray([n_local], np.int64)).reshape(-1)
        return int(counts.sum()), int(counts[:mh.process_index()].sum()), tuple(int(c) for c in counts)

    def _global_num_entities(self, ids: np.ndarray, tag: str) -> int:
        """The largest dense id over the processes + 1, floored by the
        declared dictionary size (a warm start keeps rows for entities
        absent from the data)."""
        seen = int(ids.max()) + 1 if len(ids) else 0
        if self._distributed():
            seen = int(mh.allgather_host(np.asarray([seen], np.int64)).max())
        return max(seen, self._entity_count_floor.get(tag, 0))

    def _exchange(self, kind: str, arrays: dict, dest: np.ndarray, tag: str) -> dict:
        """``exchange_rows``, its seconds, bytes sent and calls added to
        ``exchange_totals[kind]``."""
        t0 = time.perf_counter()
        recv = mh.exchange_rows(arrays, dest, tag=tag)
        tot = self.exchange_totals.setdefault(kind, {"seconds": 0.0, "bytes": 0, "calls": 0})
        tot["seconds"] += time.perf_counter() - t0
        tot["bytes"] += int(mh.LAST_EXCHANGE_STATS["bytes_sent"])
        tot["calls"] += 1
        return recv

    def _exchange_to_owners(self, kind: str, arrays: dict[str, np.ndarray],
                            row_layout: tuple[int, ...]) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
        """Every row of ``arrays`` (``ent``: the global entity id, ``grow``:
        the global row id) at its entity's owner, ``ent`` % P, in rounds of
        ``chunk_rows`` rows of ``exchange_rows`` (peak memory O(P · chunk),
        each row sent once). The largest process sets the number of rounds,
        so a process with fewer rows, or none, sends empty rounds and still
        takes part. Returns the owned rows (grouped by source process) and
        the routing of the per-visit exchanges (``_ReShard``'s fields)."""
        P = mh.process_count()
        n = len(arrays["ent"])
        keep: dict[str, list[np.ndarray]] = {k: [] for k in arrays}
        for r in range(max(-(-max(row_layout) // self.chunk_rows), 1)):
            lo = min(r * self.chunk_rows, n)
            sub = {k: v[lo:lo + self.chunk_rows] for k, v in arrays.items()}
            recv = self._exchange(kind, sub, sub["ent"] % P, tag=kind)
            for k, v in recv.items():
                keep[k].append(v)
        owned = {k: np.concatenate(v) for k, v in keep.items()}
        grow = owned["grow"]
        order = np.argsort(grow)
        # an owned row's origin: the process whose global rows hold its id
        row_starts = np.concatenate([[0], np.cumsum(np.asarray(row_layout, np.int64))])
        route = dict(grow=grow, grow_sorted=grow[order], grow_order=order, origin_grow=arrays["grow"],
                     origin_dest=arrays["ent"] % P,
                     owner_dest=(np.searchsorted(row_starts, grow, side="right") - 1).astype(np.int64))
        return owned, route

    def _build_re_shard(self, cid: str, data: StreamedGameData, row_base: int = 0,
                        row_layout: tuple[int, ...] | None = None, drop_unseen: bool = False) -> _ReShard:
        """The coordinate's rows, grouped by entity and bucketed on the host
        (a training shard), or, with ``drop_unseen``, the validation rows of
        entities seen in training (ids >= 0; the others keep score 0).
        Across processes the rows first travel to their entities' owners
        (``row_base`` and ``row_layout``: ``_global_layout``'s), keeping
        their global row ids, and the owner buckets its own entities."""
        for knob in _FLEET_KNOBS:
            if os.environ.get(knob) not in (None, "", "0"):
                raise _waits_for_item_12d(f"{knob} (placement over processes or devices)")
        c = self.config.random_effect_coordinates[cid]
        feats = data.feature_container(c.feature_shard_id)
        ids = np.asarray(data.id_tags[c.random_effect_type], np.int64)
        labels = np.asarray(data.labels, np.float32)
        weights = (np.ones(data.num_rows, np.float32) if data.weights is None
                   else np.asarray(data.weights, np.float32))
        rows = None
        if drop_unseen and len(ids) and ids.min() < 0:
            rows = np.flatnonzero(ids >= 0)
            feats, ids, labels, weights = _slice_features(feats, rows), ids[rows], labels[rows], weights[rows]
        E = self._global_num_entities(ids, c.random_effect_type)
        pid, P = self._ranks()
        ent, E_local, route = ids, E, {"grow": rows}
        if P > 1:
            origin_grow = row_base + (np.arange(len(ids), dtype=np.int64) if rows is None else rows.astype(np.int64))
            arrays = {"ent": ids, "label": labels, "weight": weights, "grow": origin_grow,
                      **_feature_arrays(feats)}
            kind = f"{'validation' if drop_unseen else 'ingest'}/{cid}"
            owned, route = self._exchange_to_owners(kind, arrays, row_layout)
            labels, weights, feats = owned["label"], owned["weight"], _features_from_arrays(owned, feats)
            ent, E_local = owned["ent"] // P, (E - pid + P - 1) // P
        if c.random_projection_dim is not None:
            # one shared projection, applied to the rows once: solves and
            # scores run projected, and the model maps back score-exactly
            if not isinstance(feats, DenseFeatures):
                raise ValueError("random projection requires dense features")
            proj = self._projectors.get(cid)
            if proj is None:
                proj = RandomProjector.build(feats.num_features, c.random_projection_dim, seed=0, device="cpu")
                self._projectors[cid] = proj
            feats = DenseFeatures(X=np.asarray(feats.X, np.float32) @ proj.matrix.numpy())
        shard = _ReShard(ent_local=ent, labels=labels, weights=weights, features=feats, num_entities=E,
                         num_entities_local=E_local, buckets=None, **route)
        if drop_unseen:
            return shard
        grouping = group_by_entity(ent, num_entities=E_local, active_upper_bound=c.active_data_upper_bound)
        shard.buckets = bucket_entities(grouping, c.sample_bucket_sizes, target_buckets=c.bucket_target_count,
                                        max_padded_ratio=c.bucket_max_padded_ratio)
        if c.features_to_samples_ratio_upper_bound is not None and isinstance(feats, DenseFeatures):
            # each entity's column map, once per fit, from the rows its
            # owner holds: the visits' gathers then copy width-p rows only
            X = np.asarray(feats.X)
            intercept = None if cid in self._projectors else self.intercept_indices.get(c.feature_shard_id)
            cols_list = []
            for rows_b in shard.buckets.row_indices:
                mask = (rows_b >= 0).astype(np.float32)
                Xb = X[np.maximum(rows_b, 0)] * mask[:, :, None]
                cols_b = subspace_columns(torch.from_numpy(Xb), c.features_to_samples_ratio_upper_bound,
                                          intercept)
                cols_list.append(None if cols_b is None else cols_b.numpy())
            shard.subspace_cols = tuple(cols_list)
        return shard

    def _build_val_route(self, tag: str, validation: StreamedGameData, row_base: int,
                         row_layout: tuple[int, ...]) -> _ReShard:
        """The owner routing of a grouped evaluator's id tag that no random
        effect has: each kept row's (entity id, label, global row id) goes
        to the entity's owner once, at set-up; every visit only the current
        total scores follow (``_offsets_to_owners``). A shard of grouping
        columns, with nothing to solve."""
        ids = np.asarray(validation.id_tags[tag], np.int64)
        keep = np.flatnonzero(ids >= 0)
        arrays = {"ent": ids[keep], "label": np.asarray(validation.labels, np.float32)[keep],
                  "grow": row_base + keep.astype(np.int64)}
        owned, route = self._exchange_to_owners(f"validation/{tag}", arrays, row_layout)
        return _ReShard(ent_local=owned["ent"] // mh.process_count(), labels=owned["label"],
                        weights=np.ones(len(owned["grow"]), np.float32), features=None, num_entities=0,
                        num_entities_local=0, buckets=None, **route)

    def _offsets_to_owners(self, shard: _ReShard, offs_local: np.ndarray, row_base: int,
                           kind: str = "offsets") -> np.ndarray:
        """This visit's per-row values (the residual offsets) for the
        shard's rows: across processes each row's value goes to its
        entity's owner only; on one process, the rows' own."""
        if not self._distributed():
            return offs_local if shard.grow is None else offs_local[shard.grow]
        recv = self._exchange(kind, {"grow": shard.origin_grow,
                                     "off": offs_local[shard.origin_grow - row_base].astype(np.float32)},
                              shard.origin_dest, tag=kind)
        # each received value at its owned row's position, found by global row id
        out = np.zeros(len(shard.grow), np.float32)
        if len(shard.grow):
            g = recv["grow"]
            pos = np.minimum(np.searchsorted(shard.grow_sorted, g), len(shard.grow) - 1)
            match = shard.grow_sorted[pos] == g
            out[shard.grow_order[pos[match]]] = recv["off"][match]
        return out

    def _scores_to_origin(self, shard: _ReShard, scores_re: np.ndarray, n_local: int, row_base: int,
                          kind: str = "scores") -> np.ndarray:
        """The shard's row scores at this process's n_local rows (0 where
        it has no row): across processes, back from the owners to the
        processes that hold the rows."""
        if not self._distributed() and shard.grow is None:
            return scores_re
        out = np.zeros(n_local, np.float32)
        if not self._distributed():
            out[shard.grow] = scores_re
            return out
        recv = self._exchange(kind, {"grow": shard.grow, "score": scores_re.astype(np.float32)}, shard.owner_dest,
                              tag=kind)
        out[recv["grow"] - row_base] = recv["score"]
        return out

    def _gather_global(self, local: np.ndarray, row_base: int, n_global: int, collect: bool = True):
        """The global (n_global,) column from every process's rows (a
        gathered checkpoint's scores), in rounds of ``chunk_rows``.
        ``collect=False`` takes part in every round but keeps nothing, so
        only the writer ever holds a global column. The column itself on
        one process."""
        local = np.asarray(local)
        if not self._distributed():
            return local if collect else None
        grow = row_base + np.arange(len(local), dtype=np.int64)
        out = np.zeros(n_global, local.dtype) if collect else None
        for rnd in mh.allgather_row_chunks({"grow": grow, "v": local}, self.chunk_rows, pad_values={"grow": -1}):
            if collect:
                g, v = rnd["grow"].reshape(-1), rnd["v"].reshape(-1)
                out[g[g >= 0]] = v[g >= 0]
        return out

    def _exchanges_since(self, before: dict) -> dict:
        """The offset and score exchanges' seconds and bytes sent since the
        ``exchange_totals`` snapshot ``before``."""
        out = {}
        for kind in ("offsets", "scores"):
            now, was = (t.get(kind, {"seconds": 0.0, "bytes": 0}) for t in (self.exchange_totals, before))
            out[f"{kind}_exchange_s"] = now["seconds"] - was["seconds"]
            out[f"{kind}_exchange_bytes"] = now["bytes"] - was["bytes"]
        return out

    def _full_re_matrix(self, W_local: np.ndarray, E: int) -> np.ndarray:
        """The (E, d) matrix of every process's owned rows (owner p holds
        entities p, p + P, ... as its rows 0, 1, ...), from one gather;
        ``W_local`` itself on one process."""
        if not self._distributed():
            return W_local
        P = mh.process_count()
        padded = np.zeros((max(-(-E // P), 1), W_local.shape[1]), np.float32)
        padded[:len(W_local)] = W_local
        stacked = mh.allgather_host(padded)
        W = np.zeros((E, W_local.shape[1]), np.float32)
        for p in range(P):
            own = np.arange(p, E, P)
            W[own] = stacked[p][:len(own)]
        return W

    # -- coordinate training ------------------------------------------------------
    def _normalization_contexts(self, data: StreamedGameData) -> dict[str, Any]:
        """Per-shard contexts from a streamed summary of every shard the
        coordinates read (the estimator's policy, the no-intercept
        STANDARDIZATION degrade included). Across processes the summary
        sums over them, so every process builds the same contexts."""
        cfg = self.config
        if cfg.normalization is NormalizationType.NONE:
            return {}
        shard_ids = ({c.feature_shard_id for c in cfg.fixed_effect_coordinates.values()}
                     | {c.feature_shard_id for c in cfg.random_effect_coordinates.values()})
        n = data.num_rows
        weights = np.ones(n, np.float32) if data.weights is None else np.asarray(data.weights, np.float32)
        labels = np.asarray(data.labels, np.float32)
        contexts = {}
        for sid in sorted(shard_ids):
            feats = data.feature_container(sid)
            chunks = _feature_chunk_dicts(feats, labels, self.chunk_rows, np.zeros(n, np.float32), weights)
            contexts[sid] = shard_normalization_context(
                summarize_chunks(chunks, num_features=feats.num_features, cross_process=self._distributed()),
                cfg.normalization, sid,
                self.intercept_indices.get(sid), log=self._log, device=self.device,
            )
        return contexts

    def _fixed_chunks(self, cid: str, feats: Features, data: StreamedGameData, rate: float):
        """(training chunks, all-rows chunks or None, training rows or None)
        of a fixed-effect coordinate, built once per fit. Down-sampling
        (rate < 1) draws a seeded row subset once and reweights it (each
        process its own rows, seeded by its index); scoring always covers
        every row."""
        if cid not in self._fixed_shards:
            n = data.num_rows
            weights = np.ones(n, np.float32) if data.weights is None else np.asarray(data.weights, np.float32)
            labels = np.asarray(data.labels, np.float32)
            full = _ChunkedShard(feats, labels, weights, self.chunk_rows)
            train, rows = full, None
            if rate < 1.0:
                rows, scale = down_sample(self.config.task_type, labels, rate, seed=self._ranks()[0])
                t_weights = weights[rows] if scale is None else weights[rows] * scale
                train = _ChunkedShard(_slice_features(feats, rows), labels[rows], t_weights, self.chunk_rows)
            self._fixed_shards[cid] = (train, None if rows is None else full, rows)
        return self._fixed_shards[cid]

    def _train_fixed(self, cid: str, feats: Features, data: StreamedGameData, offs: np.ndarray,
                     opt: OptimizationConfig, w0: np.ndarray, intercept_index: int | None, norm=None,
                     compute_var: bool = False, prior: tuple | None = None):
        """One fixed-effect visit: (w, scores, result, variances or None),
        the coefficients and variances in the original space."""
        n, d = data.num_rows, feats.num_features
        train, full, rows = self._fixed_chunks(cid, feats, data, opt.down_sampling_rate)
        obj_chunks = train.chunks(offs if rows is None else offs[rows])
        loss = loss_for_task(self.config.task_type)
        l1 = opt.regularization.l1_weight(opt.regularization_weight)
        l2 = opt.regularization.l2_weight(opt.regularization_weight)
        sobj = self._fixed_objectives.get(cid)
        if sobj is None:
            prior_mean = prior_precision = None
            if prior is not None:
                # incremental training: the loaded model as a Gaussian MAP
                # prior in the solver's space, added outside the stream
                p = GaussianPrior.from_coefficients(
                    torch.as_tensor(prior[0], device=self.device),
                    None if prior[1] is None else torch.as_tensor(prior[1], device=self.device), norm,
                )
                prior_mean, prior_precision = p.means, p.precisions
            sobj = StreamingGLMObjective(
                obj_chunks, loss, num_features=d, l2_weight=l2, intercept_index=intercept_index,
                norm=norm, prior_mean=prior_mean, prior_precision=prior_precision,
                # FULL variance densifies the raw chunks, which K3's layouts drop
                tile_sparse=(False if self.config.variance_computation is VarianceComputationType.FULL
                             else None),
                cross_process=self._distributed(), fe_shard=False, device=self.device,
            )
            self._fixed_objectives[cid] = sobj
        else:
            sobj.chunks = obj_chunks  # this visit's residual offsets; the layouts stay
        minimize_fn, extra = select_minimize_fn(opt.optimizer, l1, host=True)
        # the solver works in the normalized space, the trainer's state
        # stays in the original one
        w0_t = torch.as_tensor(np.asarray(w0, np.float32), device=self.device)
        if norm is not None:
            w0_t = norm.model_from_original_space(w0_t)
        res = minimize_fn(sobj, w0_t.cpu().numpy(), opt.optimizer, **extra)
        var = None
        if compute_var and self.config.variance_computation is not VarianceComputationType.NONE:
            # one more streamed pass at the last visit's solution
            var = compute_variances(sobj, res.w, self.config.variance_computation)
        w_model = res.w
        if norm is not None:
            w_model, _ = norm.model_to_original_space(w_model)
            if var is not None:
                var = norm.factors**2 * var
        w = w_model.detach().cpu().numpy().astype(np.float32)
        # scores with the original-space coefficients (the normalized
        # margins by construction), through the objective's own layouts
        # when it trained on every row
        if rows is None:
            scores = sobj.stream_scores(w, num_rows=n)
        else:
            scores = stream_scores(full.chunks(offs), w, num_rows=n, num_features=d, device=self.device)
        return w, scores, res, None if var is None else var.detach().cpu().numpy().astype(np.float32)

    def _solve_re_buckets(self, shard: _ReShard, offs_re: np.ndarray, opt: OptimizationConfig,
                          W: np.ndarray, intercept_index: int | None, norm=None,
                          V: np.ndarray | None = None, W_prior: np.ndarray | None = None,
                          V_prior: np.ndarray | None = None) -> tuple[float, int, bool, dict]:
        """Solve every bucket against this visit's offsets ``offs_re`` (the
        shard's rows), writing the coefficient rows into the host (E, d)
        matrix ``W`` (and SIMPLE / FULL variances into ``V``), both in the
        original space. Bucket i+1's host gather and copy run ahead on the
        prefetch workers while bucket i solves, and bucket i's results are
        read back after bucket i+1's solve is issued. Under a subspace
        projection each bucket solves at width p and its rows are written
        back with zeros outside the subspace. Returns (Σ per-entity final
        objective, most iterations of any entity, every entity converged,
        the bucket pipeline's record: buckets, host gather seconds, seconds
        issuing the copies, bytes copied, result read-backs)."""
        loss = loss_for_task(self.config.task_type)
        l1 = opt.regularization.l1_weight(opt.regularization_weight)
        l2 = torch.as_tensor(opt.regularization.l2_weight(opt.regularization_weight), dtype=torch.float32,
                             device=self.device)
        minimize_fn, extra = select_minimize_fn(opt.optimizer, l1)
        variance_computation = (self.config.variance_computation if V is not None
                                else VarianceComputationType.NONE)
        buckets = shard.buckets
        sub_cols = shard.subspace_cols or (None,) * len(buckets.entity_ids)
        units = list(zip(buckets.entity_ids, buckets.row_indices, sub_cols))
        dev = self.device
        consumer = prefetch.consumer_stream(dev)
        pin = dev.type == "cuda"
        d_full = shard.features.num_features
        gather_s = [0.0] * len(units)
        issue_s = [0.0] * len(units)
        nbytes = [0] * len(units)
        agg = {"max_iters": 0, "converged": True, "readbacks": 0}
        bucket_loss: dict[int, float] = {}

        def gather(i):
            # reads ingest-time columns and this visit's offsets only, never
            # W, which collect() below writes in bucket order
            _, rows, cols = units[i]
            t0 = time.perf_counter()
            arrays = gather_bucket_host(shard.features, shard.labels, offs_re, shard.weights, rows,
                                        columns=cols, pin_memory=pin)
            t1 = time.perf_counter()
            put = prefetch.device_put(arrays, dev, consumer)
            gather_s[i], issue_s[i] = t1 - t0, time.perf_counter() - t1
            nbytes[i] = sum(a.numel() * a.element_size() for a in arrays.values())
            return put

        def collect(i, ent_ids, cols, out):
            w_b, f_b, it_b, reason_b, var_b = out
            if norm is not None:
                w_b = norm.model_to_original_space(w_b)[0]
                var_b = norm.factors**2 * var_b
            w_h, var_h = w_b.cpu().numpy(), var_b.cpu().numpy()
            f_h, it_h, reason_h = f_b.cpu().numpy(), it_b.cpu().numpy(), reason_b.cpu().numpy()
            agg["readbacks"] += 1
            if cols is not None:
                full = np.zeros((len(ent_ids), W.shape[1]), np.float32)
                np.put_along_axis(full, cols, w_h.astype(np.float32), axis=1)
                W[ent_ids] = full
                if V is not None:
                    vfull = np.zeros_like(full)
                    np.put_along_axis(vfull, cols, var_h.astype(np.float32), axis=1)
                    V[ent_ids] = vfull
            else:
                W[ent_ids] = w_h
                if V is not None:
                    V[ent_ids] = var_h
            bucket_loss[i] = float(np.sum(f_h, dtype=np.float32))
            agg["max_iters"] = max(agg["max_iters"], int(np.max(it_h)))
            agg["converged"] = agg["converged"] and bool(np.all(reason_h != 0))  # 0: MAX_ITERATIONS

        accounting = DeferredLaunchAccounting()
        pending = None
        for i, put in enumerate(prefetch.prefetch_iter(len(units), gather)):
            ent_ids, _, cols = units[i]
            prefetch.wait(put, consumer)
            bucket = bucket_batch(put, d_full)
            prior_mu = prior_var = None
            if W_prior is not None:
                mu_rows = W_prior[ent_ids]
                var_rows = None if V_prior is None else V_prior[ent_ids]
                if cols is not None:
                    mu_rows = np.take_along_axis(mu_rows, cols, axis=1)
                    if var_rows is not None:
                        var_rows = np.take_along_axis(var_rows, cols, axis=1)
                prior_mu = torch.as_tensor(mu_rows, dtype=torch.float32, device=dev)
                if var_rows is not None:
                    prior_var = torch.as_tensor(var_rows, dtype=torch.float32, device=dev)
            b_intercept = intercept_index
            if cols is not None and intercept_index is not None:
                b_intercept = cols.shape[1] - 1  # the intercept is each subspace's last slot
            w0_rows = W[ent_ids]
            if cols is not None:
                w0_rows = np.take_along_axis(w0_rows, cols, axis=1)
            w0 = torch.as_tensor(w0_rows, dtype=torch.float32, device=dev)
            if norm is not None:
                w0 = norm.model_from_original_space(w0)
            out = solve_bucket_lanes(
                bucket, w0, l2, norm, prior_mu, prior_var, minimize_fn=minimize_fn, loss=loss,
                config=opt.optimizer, intercept_index=b_intercept,
                variance_computation=variance_computation, accounting=accounting, **extra,
            )
            if pending is not None:
                collect(*pending)  # waits for the previous bucket only
            pending = (i, ent_ids, cols, out)
        if pending is not None:
            collect(*pending)
        accounting.flush()
        pipeline = dict(buckets=len(units), gather_s=sum(gather_s), copy_issue_s=sum(issue_s),
                        bytes_copied=sum(nbytes), result_readbacks=agg["readbacks"])
        if not units:
            return 0.0, 0, True, pipeline
        loss_sum = 0.0
        for i in range(len(units)):
            loss_sum += bucket_loss[i]
        return loss_sum, agg["max_iters"], agg["converged"], pipeline

    def _score_re_rows(self, shard: _ReShard, W: np.ndarray) -> np.ndarray:
        """Scores w_{e(i)}·x_i of the shard's rows, chunk by chunk (one
        gathered (c, d) block of coefficient rows on the card at a time).
        The feature slices are the same storage every visit and come
        through the chunk cache; the gathered rows are copied afresh."""
        m = len(shard.ent_local)
        if m == 0:
            return np.zeros(0, np.float32)
        f = shard.features
        dense = isinstance(f, DenseFeatures)
        cols = _feature_arrays(f)
        ranges = _chunk_ranges(m, self.chunk_rows)
        dev = self.device
        consumer = prefetch.consumer_stream(dev)

        def prepare(i):
            lo, hi = ranges[i]
            w_rows = prefetch.device_put({"W": W[shard.ent_local[lo:hi]]}, dev, consumer)
            feat = prefetch.cached_device_put({k: v[lo:hi] for k, v in cols.items()}, dev, consumer)
            return w_rows, feat

        outs = []
        for w_rows, feat in prefetch.prefetch_iter(len(ranges), prepare):
            prefetch.wait(w_rows, consumer)
            prefetch.wait(feat, consumer)
            if dense:
                outs.append(_re_chunk_scores_dense(w_rows["W"], feat["X"].float()))
            else:
                outs.append(_re_chunk_scores_sparse(w_rows["W"], feat["indices"], feat["values"].float()))
        return torch.cat(outs).cpu().numpy()

    # -- model assembly -----------------------------------------------------------
    def _assemble_model(self, model_state: dict[str, Any], device=None) -> GameModel:
        """The model of the host state, its tensors copied to ``device``
        (the trainer's by default). Across processes the random effects'
        rows are gathered from their owners: a collective."""
        cfg = self.config
        dev = self.device if device is None else torch.device(device)

        def t(a):
            return None if a is None else torch.tensor(np.asarray(a, np.float32), device=dev)

        models: dict[str, Any] = {}
        fixed_var = model_state.get("fixed_var") or {}
        re_V = model_state.get("re_V") or {}
        for cid, c in cfg.fixed_effect_coordinates.items():
            models[cid] = FixedEffectModel(
                model=GeneralizedLinearModel(Coefficients(t(model_state["fixed_w"][cid]), t(fixed_var.get(cid))),
                                             cfg.task_type),
                feature_shard_id=c.feature_shard_id,
            )
        for cid, c in cfg.random_effect_coordinates.items():
            E = model_state["re_E"][cid]
            V_local = re_V.get(cid)
            W_out = t(self._full_re_matrix(model_state["re_W"][cid], E))
            V_out = None if V_local is None else t(self._full_re_matrix(V_local, E))
            if cid in self._projectors:
                # back to the original feature space, score-exactly
                W_out = self._projectors[cid].coefficients_to_original(W_out.cpu()).to(dev)
                V_out = None
            models[cid] = RandomEffectModel(
                coefficients=W_out, variances=V_out, random_effect_type=c.random_effect_type,
                feature_shard_id=c.feature_shard_id, task_type=cfg.task_type,
            )
        return GameModel(models=models, task_type=cfg.task_type)

    # -- validation ---------------------------------------------------------------
    # beyond this fraction of rows dropped by a grouped metric (unseen
    # entities, id -1), the metric is flagged: it covers a minority sample
    GROUPED_DROPPED_WARN_FRACTION = 0.5

    def _log_grouped_dropped(self, validation: StreamedGameData) -> dict[str, float]:
        """Per grouped evaluator's id tag: the fraction of validation rows
        (over every process) with the unseen-entity id -1, which every
        grouped metric leaves out; logged once per fit, with a warning when
        it is large."""
        fracs: dict[str, float] = {}
        for spec in self.evaluators:
            tag = make_evaluator(spec).group_by
            if tag is None or tag in fracs or tag not in validation.id_tags:
                continue
            ids = np.asarray(validation.id_tags[tag])
            counts = np.asarray([(ids < 0).sum(), len(ids)], np.int64)
            if self._distributed():
                counts = mh.allreduce_sum_host(counts)
            dropped, total = int(counts[0]), int(counts[1])
            frac = dropped / total if total else 0.0
            fracs[tag] = frac
            # the registry and the run's telemetry carry the count too
            REGISTRY.gauge_set(f"game.grouped_dropped_frac.{tag}", frac)
            emit_event("dropped_rows", tag=tag, dropped=dropped, total=total, fraction=frac)
            self._log(f"grouped metrics on tag {tag!r}: {dropped}/{total} validation rows ({frac:.1%}) "
                      "carry the -1 unseen-entity sentinel and are dropped")
            if frac >= self.GROUPED_DROPPED_WARN_FRACTION:
                emit_event("log", level="WARN", tag=tag, fraction=frac,
                           message=f"grouped metrics on tag {tag!r} drop {frac:.1%} of validation rows "
                                   "(unseen-entity sentinel -1)")
                warnings.warn(
                    f"grouped metrics on tag {tag!r} drop {frac:.1%} of validation rows (unseen-entity "
                    f"sentinel -1): the reported score covers only the remaining {total - dropped} rows "
                    "and is NOT a full-validation metric",
                    RuntimeWarning, stacklevel=2,
                )
        return fracs

    def _prepare_validation(self, validation: StreamedGameData) -> dict[str, Any]:
        """Per-visit validation state: each fixed shard's chunks, each random
        effect's validation shard, the running per-coordinate scores and
        total, and what the evaluators read: on one process the columns on
        the card, across processes the host columns and, per grouped id
        tag, the shard whose owners hold each group whole (the tag's random
        effect's, or a routing of its own)."""
        cfg = self.config
        n = validation.num_rows
        _, val_base, val_layout = self._global_layout(n)
        labels = np.asarray(validation.labels, np.float32)
        weights = np.ones(n, np.float32) if validation.weights is None else np.asarray(validation.weights,
                                                                                       np.float32)
        base = np.zeros(n, np.float32) if validation.offsets is None else np.asarray(validation.offsets,
                                                                                     np.float32)
        state: dict[str, Any] = {
            "n": n, "base": val_base, "fixed": {}, "re_shards": {}, "zeros": np.zeros(n, np.float32),
            "scores": {cid: np.zeros(n, np.float32) for cid in cfg.coordinate_update_sequence},
            "total": base.copy(),
        }
        for cid, c in cfg.fixed_effect_coordinates.items():
            state["fixed"][cid] = _ChunkedShard(validation.feature_container(c.feature_shard_id), labels,
                                                np.ones(n, np.float32), self.chunk_rows)
        for cid in cfg.random_effect_coordinates:
            state["re_shards"][cid] = self._build_re_shard(cid, validation, val_base, val_layout, drop_unseen=True)
        # in the evaluators' order: across processes each routing is a collective
        tags = list(dict.fromkeys(t for t in (make_evaluator(s).group_by for s in self.evaluators) if t))
        missing = sorted(t for t in tags if t not in validation.id_tags)
        if missing:
            raise KeyError(f"evaluators {self.evaluators}: validation data carries no id tag {missing}")
        if self._distributed():
            by_type = {c.random_effect_type: cid for cid, c in cfg.random_effect_coordinates.items()}
            state.update(labels=labels, weights=weights, owner_grouped={
                t: state["re_shards"][by_type[t]] if t in by_type
                else self._build_val_route(t, validation, val_base, val_layout)
                for t in tags
            })
        else:
            state.update(labels=torch.as_tensor(labels, device=self.device),
                         weights=torch.as_tensor(weights, device=self.device),
                         group_ids={t: torch.as_tensor(np.asarray(validation.id_tags[t], np.int64),
                                                       device=self.device) for t in tags})
        state["grouped_dropped"] = self._log_grouped_dropped(validation)
        return state

    def _val_scores_for(self, cid: str, vstate: dict[str, Any], fixed_w: dict, re_W: dict) -> np.ndarray:
        """This coordinate's current scores of this process's validation rows."""
        n = vstate["n"]
        if cid in self.config.fixed_effect_coordinates:
            shard = vstate["fixed"][cid]
            d = len(fixed_w[cid])
            return stream_scores(shard.chunks(vstate["zeros"]), fixed_w[cid], num_rows=n, num_features=d,
                                 device=self.device)
        shard: _ReShard = vstate["re_shards"][cid]
        return self._scores_to_origin(shard, self._score_re_rows(shard, re_W[cid]), n, vstate["base"],
                                      kind="validation/scores")

    def _validate_after_visit(self, cid: str, vstate: dict[str, Any], fixed_w: dict,
                              re_W: dict) -> EvaluationResults:
        """Rescore the coordinate just trained on the validation rows,
        update the running total and evaluate: across processes from
        per-process partials (scalar metrics) and per-owner partials of
        complete groups (grouped ones), no process gathering a column."""
        new = self._val_scores_for(cid, vstate, fixed_w, re_W)
        vstate["total"] = vstate["total"] - vstate["scores"][cid] + new
        vstate["scores"][cid] = new
        if not self._distributed():
            return evaluate_all(self.evaluators, torch.as_tensor(vstate["total"], device=self.device),
                                vstate["labels"], vstate["weights"], group_ids=vstate["group_ids"])
        owner_grouped = {}
        for tag, shard in vstate["owner_grouped"].items():
            owned = self._offsets_to_owners(shard, vstate["total"], vstate["base"], kind="validation/totals")
            owner_grouped[tag] = (owned, shard.labels, shard.ent_local)
        res = evaluate_host_sharded(self.evaluators, vstate["total"], vstate["labels"], vstate["weights"],
                                    owner_grouped)
        return EvaluationResults(metrics=res.metrics, primary_name=make_evaluator(self.evaluators[0]).name)

    # -- checkpoints --------------------------------------------------------------
    def _fingerprint(self, data: StreamedGameData, n_global: int | None = None,
                     row_layout: tuple[int, ...] | None = None, initial_model: GameModel | None = None) -> str:
        """The reference's trajectory fingerprint: the configuration less its
        non-trajectory fields, the chunk size (it sets the float summation
        order), the entity-count floors, the global row count and every
        process's row count (global row ids follow them; one process by
        default), the shards' widths and a hash of the warm-start
        coefficients."""
        cfg = self.config.to_dict()
        for k in ("coordinate_descent_iterations", "evaluators", "output_mode",
                  "hyperparameter_tuning_iters", "model_input_dir"):
            cfg.pop(k, None)
        warm_hash = None
        if initial_model is not None:
            warm_hash = {
                cid: hashlib.sha256(np.ascontiguousarray(
                    sub.coefficient_means.detach().cpu().numpy()).tobytes()).hexdigest()
                for cid, sub in sorted(initial_model.models.items())
            }
        n = data.num_rows
        payload = {
            "training_config": cfg,
            "chunk_rows": self.chunk_rows,
            "initial_model": warm_hash,
            "entity_count_floor": sorted(self._entity_count_floor.items()),
            "data": {
                "num_rows_global": n if n_global is None else n_global,
                "row_layout": [n] if row_layout is None else list(row_layout),
                "shards": {sid: data.feature_container(sid).num_features for sid in sorted(data.features)},
            },
        }
        return hashlib.sha256(json.dumps(payload, sort_keys=True, default=str).encode()).hexdigest()

    def _shard_path(self, pid: int) -> str:
        return os.path.join(self.checkpoint_dir, f"scores-shard-{pid:05d}.npz")

    def _save_visit_checkpoint(self, model_state: dict[str, Any], scores: dict[str, np.ndarray],
                               total: np.ndarray, next_iteration: int, next_coordinate: int,
                               fingerprint: str, digest: str | None, row_base: int = 0,
                               n_global: int | None = None) -> None:
        """The model, the residual scores and total, and the next visit: one
        ``ckpt.npz`` on one process (the reference's gathered form). Across
        processes every process takes part in the model's gather; then,
        sharded, each writes its own scores, total and the checkpoint's
        markers (with its ``row_base``) to its score file by
        write-and-rename, all meet, and process 0 writes the model's file
        without scores, the commit point; gathered, process 0 alone
        collects every score (the others keep nothing) and writes one
        file."""
        model = self._assemble_model(model_state, device="cpu")
        meta = dict(fingerprint=fingerprint, data_digest=digest, next_iteration=next_iteration,
                    next_coordinate=next_coordinate)
        if not self._distributed():
            save_checkpoint(self.checkpoint_dir, model, scores=scores, total=total, **meta)
            return
        writer = mh.is_output_process()
        if self.sharded_checkpoints:
            payload = {f"s__{cid}": np.asarray(s, np.float32) for cid, s in scores.items()}
            payload["total"] = np.asarray(total, np.float32)
            payload["meta"] = np.frombuffer(json.dumps(dict(meta, row_base=int(row_base))).encode(), dtype=np.uint8)
            atomic_savez(self.checkpoint_dir, self._shard_path(mh.process_index()), payload)
            mh.sync_processes("streamed-game-score-shards")
            if writer:
                save_checkpoint(self.checkpoint_dir, model, scores=None, total=None, **meta)
            return
        g_scores = {cid: self._gather_global(s, row_base, n_global, collect=writer) for cid, s in scores.items()}
        g_total = self._gather_global(total, row_base, n_global, collect=writer)
        if writer:
            save_checkpoint(self.checkpoint_dir, model, scores=g_scores, total=g_total, **meta)

    def _load_resume_state(self, fingerprint: str, digest: str | None) -> dict | None:
        """The checkpoint to resume from, or None. Across processes process
        0 reads the model's file and every process adopts its bytes, so all
        take one decision (the data digest checked is process 0's, which
        that file holds); the scores come from the file when it holds them
        (gathered: global columns), else from each process's own score file,
        checked against the model's markers and this process's data. A
        stale, torn or missing score file on any process is a miss for
        all."""
        if not self._distributed():
            ckpt = load_checkpoint(self.checkpoint_dir, fingerprint=fingerprint, data_digest=digest,
                                   device="cpu")
            if ckpt is None or ckpt.scores is None or ckpt.total is None:
                return None
            return {"model": ckpt.model, "next_iteration": ckpt.next_iteration,
                    "next_coordinate": ckpt.next_coordinate, "scores": ckpt.scores, "total": ckpt.total,
                    "scores_local": False}
        ckpt = load_checkpoint(self.checkpoint_dir, fingerprint=fingerprint,
                               data_digest=str(mh.broadcast_from_host0(digest)), device="cpu",
                               across_processes=True)
        if ckpt is None:
            return None
        state = {"model": ckpt.model, "next_iteration": ckpt.next_iteration,
                 "next_coordinate": ckpt.next_coordinate}
        if ckpt.scores is not None and ckpt.total is not None:
            return dict(state, scores=ckpt.scores, total=ckpt.total, scores_local=False)
        local = self._load_score_shard(fingerprint, digest, ckpt.next_iteration, ckpt.next_coordinate)
        found = mh.allreduce_sum_host(np.asarray([0.0 if local is None else 1.0]))
        if int(found[0]) != mh.process_count():
            return None
        return dict(state, scores=local[0], total=local[1], scores_local=True)

    def _load_score_shard(self, fingerprint: str, digest: str | None, next_iteration: int,
                          next_coordinate: int) -> tuple[dict[str, np.ndarray], np.ndarray] | None:
        """This process's score file, if it belongs to the checkpoint: the
        same fingerprint, this process's data digest and the same next
        visit. A file from another visit or setup, or a torn one, is a
        miss."""
        path = self._shard_path(mh.process_index())
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["meta"]).decode())
                if (meta.get("fingerprint") != fingerprint or meta.get("data_digest") != digest
                        or meta.get("next_iteration") != next_iteration
                        or meta.get("next_coordinate") != next_coordinate):
                    return None
                scores = {k[len("s__"):]: np.asarray(z[k], np.float32) for k in z.files if k.startswith("s__")}
                return scores, np.asarray(z["total"], np.float32)
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            return None

    # -- descent ------------------------------------------------------------------
    def fit(
        self,
        data: StreamedGameData,
        validation: StreamedGameData | None = None,
        initial_model: GameModel | None = None,
    ) -> tuple[GameModel, dict[str, StreamedCoordinateInfo]]:
        """Train; returns the model (on the trainer's device) and each
        coordinate's last-visit diagnostics. ``initial_model`` warm-starts
        every coordinate it holds (its random-effect rows aligned to this
        data's dense entity ids; the driver pads new entities with zero
        rows), and its scores enter the residuals before the first visit,
        as in the in-memory descent. Across processes (``multihost``) every
        process calls it with its own rows and gets the same model.

        Telemetry (``obs``; no-ops with no sink): the span ``game/fit``
        holds ``ingest/re-shard`` (a coordinate's entity layout and
        exchange) and ``descent/iter`` → ``descent/visit``,
        ``descent/validation``, ``descent/checkpoint``; a ``visit_result``
        record follows every visit."""
        with span("game/fit", rows=int(data.num_rows), chunk_rows=int(self.chunk_rows),
                  coordinates=list(self.config.coordinate_update_sequence)):
            return self._fit(data, validation, initial_model)

    def _fit(self, data: StreamedGameData, validation: StreamedGameData | None,
             initial_model: GameModel | None) -> tuple[GameModel, dict[str, StreamedCoordinateInfo]]:
        cfg = self.config
        n = data.num_rows
        self._entity_count_floor = dict(self._entity_count_base)
        if initial_model is not None:
            for w_cid, w_c in cfg.random_effect_coordinates.items():
                sub = initial_model.models.get(w_cid)
                if isinstance(sub, RandomEffectModel):
                    tag = w_c.random_effect_type
                    self._entity_count_floor[tag] = max(self._entity_count_floor.get(tag, 0),
                                                        int(sub.num_entities))
        n_global, row_base, row_layout = self._global_layout(n)
        pid, P = self._ranks()
        base = np.zeros(n, np.float32) if data.offsets is None else np.asarray(data.offsets, np.float32)
        self._norm_contexts = self._normalization_contexts(data)
        self._fixed_objectives = {}
        self._fixed_shards = {}
        self._projectors = {}
        self.visit_stats = []
        self.exchange_totals = {}

        # the entity exchange to the owners, once a fit
        re_shards = {}
        for cid in cfg.random_effect_coordinates:
            with span("ingest/re-shard", coordinate=cid):
                re_shards[cid] = self._build_re_shard(cid, data, row_base, row_layout)
        fixed_w: dict[str, np.ndarray] = {}
        re_W: dict[str, np.ndarray] = {}
        re_E: dict[str, int] = {}
        shard_dims: dict[str, int] = {}
        for cid, c in cfg.fixed_effect_coordinates.items():
            d = data.feature_container(c.feature_shard_id).num_features
            if (cfg.variance_computation is VarianceComputationType.FULL
                    and d > StreamingGLMObjective.FULL_HESSIAN_MAX_D):
                # before any descent work, not at the last visit
                raise ValueError(
                    f"streamed FULL variance supports fixed-effect shards of d <= "
                    f"{StreamingGLMObjective.FULL_HESSIAN_MAX_D} (coordinate {cid!r} has d={d}); use SIMPLE"
                )
            shard_dims[cid] = d
            fixed_w[cid] = np.zeros(d, np.float32)
        for cid in cfg.random_effect_coordinates:
            shard = re_shards[cid]
            re_E[cid] = shard.num_entities
            re_W[cid] = np.zeros((shard.num_entities_local, shard.features.num_features), np.float32)
        want_var = cfg.variance_computation is not VarianceComputationType.NONE
        fixed_var: dict[str, np.ndarray | None] = {c_: None for c_ in fixed_w}
        # diagonal variances do not survive the projection's map back
        re_V = {c_: np.zeros_like(re_W[c_]) if want_var and c_ not in self._projectors else None for c_ in re_W}

        warm = initial_model is not None
        if warm:
            for cid, sub in initial_model.models.items():
                if cid in fixed_w:
                    w0 = sub.model.coefficients.means.detach().cpu().numpy().astype(np.float32)
                    if w0.shape[0] != shard_dims[cid]:
                        raise ValueError(f"warm-start coordinate {cid}: {w0.shape[0]} features != current "
                                         f"shard {shard_dims[cid]}")
                    fixed_w[cid] = w0.copy()
                elif cid in re_W:
                    W_full = sub.coefficients.detach().cpu().numpy().astype(np.float32)
                    if W_full.shape[0] < re_E[cid]:
                        raise ValueError(f"warm-start coordinate {cid}: {W_full.shape[0]} entities < current "
                                         f"{re_E[cid]}; pad new entities with zero rows before fit")
                    if cid in self._projectors:
                        # the warm start arrives in the original space; the
                        # descent runs projected (the in-memory contract)
                        W_full = W_full @ self._projectors[cid].matrix.numpy()
                    re_W[cid] = _slice_owned_rows(W_full, pid, P, limit=len(re_W[cid]))

        # incremental training: the loaded model, held fixed, is every
        # visit's Gaussian MAP prior. Fixed priors stay in the original
        # space (mapped when the objective is built); random-effect priors
        # are mapped into the solver's space once, here
        prior_fixed: dict[str, tuple] = {}
        re_W_prior: dict[str, np.ndarray] = {}
        re_V_prior: dict[str, np.ndarray | None] = {}
        if cfg.incremental:
            if not warm:
                raise ValueError("incremental training requires a prior model (model_input_dir)")
            for cid, sub in initial_model.models.items():
                if cid in fixed_w:
                    _require_prior_l2(cfg.fixed_effect_coordinates[cid].optimization)
                    co = sub.model.coefficients
                    prior_fixed[cid] = (co.means.detach().cpu().numpy().astype(np.float32),
                                        None if co.variances is None
                                        else co.variances.detach().cpu().numpy().astype(np.float32))
                elif cid in re_W:
                    _require_prior_l2(cfg.random_effect_coordinates[cid].optimization)
                    V_loc = None
                    if cid not in self._projectors and sub.variances is not None:
                        V_loc = _slice_owned_rows(sub.variances.detach().cpu().numpy().astype(np.float32), pid, P,
                                                  limit=len(re_W[cid]))
                    c_norm = self._norm_contexts.get(cfg.random_effect_coordinates[cid].feature_shard_id)
                    pr = GaussianPrior.from_coefficients(
                        torch.as_tensor(re_W[cid], device=self.device),
                        None if V_loc is None else torch.as_tensor(V_loc, device=self.device), c_norm,
                    )
                    re_W_prior[cid] = pr.means.cpu().numpy().astype(np.float32)
                    re_V_prior[cid] = None if pr.variances is None else pr.variances.cpu().numpy().astype(np.float32)

        scores = {cid: np.zeros(n, np.float32) for cid in cfg.coordinate_update_sequence}
        info: dict[str, StreamedCoordinateInfo] = {}
        total = base.copy()
        self.validation_history = []
        self.resumed_from = None

        if warm:
            # the warm model's scores enter the residuals before the first visit
            for cid in seq_scores_init(cfg, initial_model):
                if cid in cfg.fixed_effect_coordinates:
                    c = cfg.fixed_effect_coordinates[cid]
                    train, full, _ = self._fixed_chunks(cid, data.feature_container(c.feature_shard_id), data,
                                                        c.optimization.down_sampling_rate)
                    scores[cid] = stream_scores((full or train).chunks(np.zeros(n, np.float32)), fixed_w[cid],
                                                num_rows=n, num_features=shard_dims[cid], device=self.device)
                else:
                    scores[cid] = self._scores_to_origin(re_shards[cid],
                                                         self._score_re_rows(re_shards[cid], re_W[cid]), n, row_base)
                total = total + scores[cid]

        vstate = None
        # no evaluators, no per-visit validation (the in-memory descent's contract)
        if validation is not None and self.evaluators:
            vstate = self._prepare_validation(validation)

        seq = list(cfg.coordinate_update_sequence)
        start_it, start_ci = 0, 0
        fingerprint = digest = None
        if self.checkpoint_dir is not None:
            fingerprint = self._fingerprint(data, n_global, row_layout, initial_model=initial_model)
            # each process's own rows (a score file is checked against its process's)
            digest = _host_digest(np.asarray(data.labels, np.float32),
                                  np.ones(n, np.float32) if data.weights is None
                                  else np.asarray(data.weights, np.float32))
            resume = self._load_resume_state(fingerprint, digest)
            if resume is not None:
                start_it, start_ci = resume["next_iteration"], resume["next_coordinate"]
                for cid, sub in resume["model"].models.items():
                    if cid in fixed_w:
                        fixed_w[cid] = sub.model.coefficients.means.numpy().astype(np.float32).copy()
                        v = sub.model.coefficients.variances
                        if v is not None and want_var:
                            fixed_var[cid] = v.numpy().astype(np.float32).copy()
                    elif cid in re_W:
                        # copies: the bucket solves write rows in place
                        re_W[cid] = _slice_owned_rows(sub.coefficients.numpy().astype(np.float32), pid, P)
                        if sub.variances is not None and want_var:
                            re_V[cid] = _slice_owned_rows(sub.variances.numpy().astype(np.float32), pid, P)
                # a gathered checkpoint holds global columns, a score file this process's rows
                lo = 0 if resume["scores_local"] else row_base
                for cid in seq:
                    scores[cid] = np.asarray(resume["scores"][cid], np.float32)[lo:lo + n].copy()
                total = np.asarray(resume["total"], np.float32)[lo:lo + n].copy()
                self.resumed_from = (start_it, start_ci)
                self._log(f"resuming streamed descent at outer iteration {start_it}, coordinate index {start_ci}")

        if vstate is not None and (warm or self.resumed_from is not None):
            # the validation residuals reflect the warm or resumed model
            for cid0 in seq:
                new0 = self._val_scores_for(cid0, vstate, fixed_w, re_W)
                vstate["total"] = vstate["total"] - vstate["scores"][cid0] + new0
                vstate["scores"][cid0] = new0

        for it in range(start_it, cfg.coordinate_descent_iterations):
            ci0 = start_ci if it == start_it else 0
            with span("descent/iter", iteration=it):
                for ci in range(ci0, len(seq)):
                    cid = seq[ci]
                    with span("descent/visit", iteration=it, coordinate=cid):
                        offs = total - scores[cid]  # a fresh array: the chunk cache keys by storage
                        t_visit = time.perf_counter()
                        if cid in cfg.fixed_effect_coordinates:
                            c = cfg.fixed_effect_coordinates[cid]
                            w, new_scores, res, var = self._train_fixed(
                                cid, data.feature_container(c.feature_shard_id), data, offs, c.optimization,
                                fixed_w[cid], self.intercept_indices.get(c.feature_shard_id),
                                norm=self._norm_contexts.get(c.feature_shard_id),
                                compute_var=it == cfg.coordinate_descent_iterations - 1,
                                prior=prior_fixed.get(cid),
                            )
                            fixed_w[cid] = w
                            if var is not None:
                                fixed_var[cid] = var
                            info[cid] = StreamedCoordinateInfo(final_loss=float(res.value),
                                                               iterations=int(res.iterations),
                                                               converged=bool(res.converged))
                            self.visit_stats.append(dict(iteration=it, coordinate=cid,
                                                         solve_wall_s=time.perf_counter() - t_visit,
                                                         objective_passes=res.objective_passes))
                        else:
                            c = cfg.random_effect_coordinates[cid]
                            shard = re_shards[cid]
                            before = {k: dict(v) for k, v in self.exchange_totals.items()}
                            loss_sum, max_it, conv, pipeline = self._solve_re_buckets(
                                shard, self._offsets_to_owners(shard, offs, row_base), c.optimization, re_W[cid],
                                None if cid in self._projectors else self.intercept_indices.get(c.feature_shard_id),
                                norm=self._norm_contexts.get(c.feature_shard_id), V=re_V[cid],
                                W_prior=re_W_prior.get(cid), V_prior=re_V_prior.get(cid),
                            )
                            solve_wall = time.perf_counter() - t_visit
                            REGISTRY.timer_add("re_solve.visit_wall_s", solve_wall)
                            if P > 1:
                                # the owners' partial diagnostics: losses sum, iterations max, flags and
                                agg = mh.allgather_host(
                                    np.asarray([loss_sum, max_it, 0.0 if conv else 1.0])).reshape(-1, 3)
                                loss_sum, max_it = float(agg[:, 0].sum()), int(agg[:, 1].max())
                                conv = bool((agg[:, 2] == 0).all())
                            self.visit_stats.append(dict(iteration=it, coordinate=cid,
                                                         solve_wall_s=time.perf_counter() - t_visit, **pipeline))
                            new_scores = self._scores_to_origin(shard, self._score_re_rows(shard, re_W[cid]), n,
                                                                row_base)
                            if P > 1:
                                self.visit_stats[-1].update(self._exchanges_since(before))
                            info[cid] = StreamedCoordinateInfo(final_loss=loss_sum, iterations=max_it, converged=conv)
                        total = offs + new_scores
                        scores[cid] = new_scores
                    emit_event("visit_result", iteration=it, coordinate=cid, loss=info[cid].final_loss,
                               iterations=info[cid].iterations, converged=info[cid].converged)
                    self._log(f"iter {it} coordinate {cid}: loss={info[cid].final_loss:.6g} "
                              f"iterations={info[cid].iterations} converged={info[cid].converged}")

                    if vstate is not None:
                        with span("descent/validation", iteration=it, coordinate=cid):
                            res_v = self._validate_after_visit(cid, vstate, fixed_w, re_W)
                        self.validation_history.append({cid: res_v})
                        self._log(f"iter {it} coordinate {cid}: validation {res_v}")

                    visit_index = it * len(seq) + ci
                    if self.checkpoint_dir is not None and (visit_index + 1) % self.checkpoint_every_n_visits == 0:
                        nxt_it, nxt_ci = (it, ci + 1) if ci + 1 < len(seq) else (it + 1, 0)
                        with span("descent/checkpoint", iteration=it, coordinate=cid):
                            self._save_visit_checkpoint(
                                {"fixed_w": fixed_w, "re_W": re_W, "re_E": re_E, "fixed_var": fixed_var,
                                 "re_V": re_V},
                                scores, total, nxt_it, nxt_ci, fingerprint, digest, row_base, n_global,
                            )

        model = self._assemble_model({"fixed_w": fixed_w, "re_W": re_W, "re_E": re_E, "fixed_var": fixed_var,
                                      "re_V": re_V})
        return model, info
