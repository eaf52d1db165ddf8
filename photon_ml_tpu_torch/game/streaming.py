"""Out-of-core GAME training: coordinate descent over host-resident data
(port of ``photon_ml_tpu/game/streaming.py``: one process, and several,
with skew-aware placement and its overlapped exchanges).

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
- Entity e belongs to process e % P (``placement.modular_owner``). At
  set-up each random effect's rows travel to their owners in rounds of
  ``chunk_rows`` rows of ``exchange_rows`` (the number of rounds set by
  the largest process, so an empty process takes part); the owner
  groups, buckets and solves its entities. Every visit, the residual offsets flow to the owners and the
  scores flow back, point to point; nothing is broadcast.
- ``PHOTON_RE_SHARD=1`` (``parallel/placement.py``) places entities by
  their rows instead: one allreduced bincount gives the global rows per
  entity, the global capacity ladder (so an entity's bucket capacity does
  not depend on its owner) and the owners, by LPT. A one-entity bucket of
  a larger global class solves beside one padding lane (the lane floor):
  on the card a lane of a small batch of two or more keeps its bits in
  other small batches (``scripts/lane_bits.py``; at larger lane counts the
  batched products change kernels), and a batch of one gives others.
  Each visit the offsets exchange is issued before the solve and joined
  by the first bucket gather, and the scores exchange rides under the
  diagnostics gather, both on the exchange worker
  (``multihost.exchange_rows_async``). With
  ``PHOTON_RE_REPLAN_IMBALANCE`` the owners are re-planned between outer
  iterations from the measured solve walls (``_maybe_replan_re_shards``).
  On one process the knob changes nothing.
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

The random-effect schedule knobs act here as in memory
(``game/random_effect.py``): ``PHOTON_RE_FUSE_BUCKETS`` groups the
buckets of one geometry into one launch unit, ``PHOTON_RE_COMPACT_EVERY``
compacts each unit's lanes, and ``PHOTON_RE_PROJECT`` solves each capacity
class over its support (hashed under ``hash``), from a ladder the
processes agree on under skew-aware placement. Under skew-aware
placement ``PHOTON_RE_SPLIT`` places the sub-bucket atoms of the global
ladder (``placement_atoms``, weighed by projected lane bytes under
``PHOTON_RE_SPLIT_WEIGHT=bytes``) instead of single entities, and the
re-planner keeps them; ``PHOTON_RE_DEVICE_SPLIT`` places each process's
buckets over its ``local_devices``, each launch unit gathered to and
solved on its device.

Peer loss (ROADMAP 12d-v-a): across processes with a ``checkpoint_dir``
and ``PHOTON_P2P_RETRIES`` > 0, a lost peer surfaces as
``multihost.PeerLost`` (retries exhausted on the exchange mesh, or a gloo
collective failing). ``fit`` then confirms the loss with a roll call,
shrinks the process group to the survivors (``multihost.set_degraded_group``),
quiesces the aborted visit's device work (``prefetch.quiesce``) and runs
the fit again: ingest re-plans the placement over the survivors (the same
host arithmetic on each) and the resume accepts the last checkpoint,
written under the layout before the loss (``resume_fingerprints``,
``resume_row_base``). The survivors' model is bitwise a clean run on their
rows resumed from that checkpoint. ``PHOTON_RE_STRAGGLER`` delays the
named process's bucket solves (the re-planner's drill).

Elastic rejoin (``PHOTON_REJOIN=1``). A process booted by
``multihost.bootstrap_rejoin`` waits in ``fit`` for the survivors' invite
(``_join_as_rejoiner``) before any collective. While the group is
degraded, every visit boundary probes the lost processes
(``_maybe_admit_rejoin``; the first boundary after a degrade waits up to
``PHOTON_REJOIN_WINDOW_S`` for them, later ones probe once); whoever
answers is invited, one roll call over survivors and rejoiners agrees on
the group, the survivors hand the rejoiners their resume fingerprints and
``fit`` runs again over the expanded group from the last checkpoint, as
after a loss. Rejoined before any degraded visit was checkpointed, the
model is bitwise an uninterrupted run of the whole group. A rejoiner never
takes a gathered checkpoint that a degraded layout wrote: that layout held
none of its rows.
"""

from __future__ import annotations

import dataclasses
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
# The module, not its names: ``checkpoint`` imports ``game.models``, whose
# package imports this module, so the names may not exist yet here.
from photon_ml_tpu_torch import checkpoint as ckpt_io
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
from photon_ml_tpu_torch.game.projector import (
    RandomProjector,
    class_activity,
    projection_ladder,
    re_project_dim,
    re_project_mode,
    subspace_columns,
)
from photon_ml_tpu_torch.game.data import capacity_classes, placement_atoms
from photon_ml_tpu_torch.game.random_effect import (
    DeferredLaunchAccounting,
    _hash_expand_lanes,
    _hash_fold_lanes,
    _pad_lanes,
    fuse_buckets,
    plan_fusion_groups,
    solve_bucket_lanes,
)
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.obs import REGISTRY, emit_event, span
from photon_ml_tpu_torch.ops import prefetch, stream_executor
from photon_ml_tpu_torch.ops.glm import GaussianPrior, compute_variances
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.ops.streaming import StreamingGLMObjective, dense_chunks, sparse_chunks, stream_scores
from photon_ml_tpu_torch.optim.common import select_minimize_fn
from photon_ml_tpu_torch.parallel import faults
from photon_ml_tpu_torch.parallel import multihost as mh
from photon_ml_tpu_torch.parallel.mesh import data_mesh
from photon_ml_tpu_torch.parallel.placement import (
    PlacementPlan,
    measured_entity_costs,
    modular_owner,
    placement_weights,
    plan_device_placement,
    plan_entity_placement,
    plan_from_owner,
    plan_shard_placement,
    re_device_split_enabled,
    re_shard_enabled,
    re_split_factor,
    re_split_weight,
    record_device_placement_metrics,
    record_placement_metrics,
    record_projection_metrics,
    replan_excluding,
    replan_imbalance_threshold,
)
from photon_ml_tpu_torch.sampling import down_sample
from photon_ml_tpu_torch.types import NormalizationType, VarianceComputationType
from photon_ml_tpu_torch.utils.atomic_io import atomic_savez

Tensor = torch.Tensor

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

    ent_local: np.ndarray  # (m,) int64 owner-local dense entity ids (rank among owned_global)
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
    # each global entity's owner (the same map on every process: the
    # modular rule, or skew-aware placement under PHOTON_RE_SHARD=1 across
    # processes) and this process's owned ids, ascending (its local entity e
    # is owned_global[e]); None only on a grouping route (_build_val_route)
    entity_owner: np.ndarray | None = None  # (E,) int64
    owned_global: np.ndarray | None = None  # (E_local,) int64
    entity_rows: np.ndarray | None = None  # (E,) int64 global rows per entity, the plan's weights
    # per bucket 1 where a one-entity bucket of a globally larger capacity
    # class solves with one all-padding lane beside it: a one-lane solve
    # does not give the bits of a lane in a batch
    lane_floor_pad: tuple | None = None
    # per bucket the capacity class's projection (PHOTON_RE_PROJECT), None
    # entries at full width; None when no class is projected
    project: tuple | None = None
    # PHOTON_RE_SPLIT: the entity groups the owner plan placed whole (the
    # sub-bucket atoms, from the global counts: the same on every
    # process), kept so the re-planner re-plans over the same atoms; None
    # places entities one by one
    placement_atoms: tuple | None = None
    # PHOTON_RE_DEVICE_SPLIT: each bucket's local device ordinal (the
    # trainer's ``local_devices``), placed whole with its fusion group;
    # None solves every bucket on the trainer's device
    bucket_device: tuple | None = None


def _slice_owned_rows(M_full: np.ndarray, shard: _ReShard) -> np.ndarray:
    """This process's rows of a global (E, d) matrix (a warm start, a prior,
    a resume) in the shard's owner layout, its owned ids in order. Always a
    writable copy: the bucket solves write rows in place."""
    return M_full[shard.owned_global].copy()


class _RejoinResume(Exception):
    """Raised at a visit boundary once the expanded group has agreed (or a
    rejoin roll call dropped a survivor): ``fit`` runs again, ingest
    re-plans over the new group and the resume takes the last checkpoint,
    as after a loss."""


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
    ``visit_stats`` its offset and score exchanges'. Under skew-aware
    placement ``placements`` holds each random effect's plan in force
    (``PlacementPlan``: owners, Σ rows per owner, balance), the
    re-planner's after a re-plan.

    ``local_devices`` are the devices ``PHOTON_RE_DEVICE_SPLIT`` places a
    process's buckets on: every local card on a CUDA trainer, the
    trainer's device alone otherwise, unless the caller names them (e.g.
    ``["cpu", "cpu"]``); the split is off with fewer than two."""

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
        local_devices=None,
    ):
        if multihost:
            mh.require_process_group()
        self.multihost = bool(multihost)
        self.sharded_checkpoints = bool(sharded_checkpoints)
        self.device = resolve_device(device)
        if local_devices is None:
            local_devices = None if self.device.type == "cuda" else (self.device,)
        self.local_devices = data_mesh(None, local_devices)
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
        self._re_layouts: dict[str, np.ndarray] = {}
        self._re_solve_wall: dict[str, float] = {}
        self._skew_aware = False
        self.placements: dict[str, PlacementPlan] = {}
        # peer-loss recovery: the fingerprints of other process layouts whose
        # checkpoints a resume accepts (the layout before a loss: its row
        # layout, part of the fingerprint, differs from the survivors'), and
        # this process's row base in the layout that wrote such a
        # checkpoint, to slice its gathered scores. ``_prepare_recovery``
        # sets both mid-fit; a driver restarting a degraded run from a
        # checkpoint of another layout may set them too
        self.resume_fingerprints: list[str] = []
        self.resume_row_base: int | None = None
        # the layouts this fit itself ran before a loss: their checkpoints
        # hold this process's own rows at its registered base
        self._own_anchor_fingerprints: set[str] = set()
        # elastic rejoin: whether this degrade already spent its
        # PHOTON_REJOIN_WINDOW_S wait at a visit boundary, and whether this
        # rejoin-booted process was admitted
        self._rejoin_waited = False
        self._rejoined = False
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

    def _exchange_async(self, kind: str, arrays: dict, dest: np.ndarray, tag: str, finish) -> mh.ExchangeHandle:
        """``multihost.exchange_rows_async`` with its host epilogue
        ``finish(rows)``; when it is joined, the handle's worker seconds,
        blocked seconds and bytes sent, and one call, go to
        ``exchange_totals[kind]``."""
        tot = self.exchange_totals.setdefault(kind, {"seconds": 0.0, "bytes": 0, "calls": 0})

        def booked(recv, stats):
            tot["seconds"] += stats["seconds"]
            tot["wait_s"] = tot.get("wait_s", 0.0) + stats["wait_s"]
            tot["bytes"] += int(stats["bytes_sent"])
            tot["calls"] += 1
            return finish(recv)

        return mh.exchange_rows_async(arrays, dest, tag=tag, finish=booked)

    def _exchange_to_owners(self, kind: str, arrays: dict[str, np.ndarray], row_layout: tuple[int, ...],
                            entity_owner: np.ndarray) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
        """Every row of ``arrays`` (``ent``: the global entity id, ``grow``:
        the global row id) at its entity's owner ``entity_owner[ent]``, in rounds of
        ``chunk_rows`` rows of ``exchange_rows`` (peak memory O(P · chunk),
        each row sent once). The largest process sets the number of rounds,
        so a process with fewer rows, or none, sends empty rounds and still
        takes part. Returns the owned rows (grouped by source process) and
        the routing of the per-visit exchanges (``_ReShard``'s fields)."""
        n = len(arrays["ent"])
        keep: dict[str, list[np.ndarray]] = {k: [] for k in arrays}
        for r in range(max(-(-max(row_layout) // self.chunk_rows), 1)):
            lo = min(r * self.chunk_rows, n)
            sub = {k: v[lo:lo + self.chunk_rows] for k, v in arrays.items()}
            recv = self._exchange(kind, sub, entity_owner[sub["ent"]], tag=kind)
            for k, v in recv.items():
                keep[k].append(v)
        owned = {k: np.concatenate(v) for k, v in keep.items()}
        grow = owned["grow"]
        order = np.argsort(grow)
        # an owned row's origin: the process whose global rows hold its id
        row_starts = np.concatenate([[0], np.cumsum(np.asarray(row_layout, np.int64))])
        route = dict(grow=grow, grow_sorted=grow[order], grow_order=order, origin_grow=arrays["grow"],
                     origin_dest=entity_owner[arrays["ent"]],
                     owner_dest=(np.searchsorted(row_starts, grow, side="right") - 1).astype(np.int64))
        return owned, route

    def _plan_entities(self, cid: str, ids: np.ndarray, E: int, P: int, pid: int,
                       entity_owner_override: np.ndarray | None, feats: Features | None = None) -> dict:
        """The owners of a training shard's entities. The modular rule
        (``modular_owner``) unless skew-aware placement is on
        (``self._skew_aware``); then the global rows per entity from one
        allreduced bincount, the global capacity ladder from them (so an
        entity's bucket capacity does not depend on its owner or on P), and
        the owners by LPT over the rows (``plan_entity_placement``), or the
        re-planner's map ``entity_owner_override``. The same plan on every
        process; its gauges go to the registry and the plan to
        ``placements``. Under ``PHOTON_RE_PROJECT`` (``feats`` given) the
        capacity classes' projections come from here too, before any row
        moves: each local row's columns count toward its entity's global
        class, one allreduce sums the counts, and every process derives the
        same ladder from them."""
        if not self._skew_aware:
            owner = modular_owner(E, P)
            return dict(entity_owner=owner, owned_global=np.flatnonzero(owner == pid))
        c = self.config.random_effect_coordinates[cid]
        counts = np.bincount(ids[ids >= 0], minlength=E).astype(np.float64)
        counts_g = np.rint(mh.allreduce_sum_host(counts)).astype(np.int64)
        active_g = counts_g if c.active_data_upper_bound is None else np.minimum(counts_g,
                                                                                  c.active_data_upper_bound)
        caps, pops = capacity_classes(active_g, c.sample_bucket_sizes, target_buckets=c.bucket_target_count,
                                      max_padded_ratio=c.bucket_max_padded_ratio)
        ladder = None
        if feats is not None and len(caps):
            caps_arr = np.asarray(caps, np.int64)
            cls_of_entity = np.minimum(np.searchsorted(caps_arr, active_g), len(caps_arr) - 1)
            activity = np.zeros((len(caps_arr), feats.num_features), np.int64)
            rows = np.flatnonzero(ids >= 0)
            if len(rows):
                np.add.at(activity, cls_of_entity[ids[rows]], (np.asarray(feats.X)[rows] != 0).astype(np.int64))
            activity = np.rint(mh.allreduce_sum_host(activity.astype(np.float64))).astype(np.int64)
            ladder = projection_ladder(caps, activity, feats.num_features, re_project_mode(), re_project_dim(),
                                       self.intercept_indices.get(c.feature_shard_id))
        ent_bytes = None
        if ladder is not None and re_split_weight() == "bytes":
            # the byte axis under a projection: an active entity is one
            # combine segment row of its class's solved width
            dims = np.asarray([float(feats.num_features) if ladder[int(cp)] is None else float(ladder[int(cp)].dim)
                               for cp in caps], np.float64)
            ent_bytes = placement_weights(active_g > 0, counts_g, dims[cls_of_entity])
        atoms, split_classes = None, None
        if re_split_factor() > 0:
            # placement units: the sub-bucket atoms of the global ladder,
            # the same rule the in-memory owned preparation cuts by
            members, _, split_classes = placement_atoms(
                active_g, weights=counts_g, capacities=c.sample_bucket_sizes,
                target_buckets=c.bucket_target_count, max_padded_ratio=c.bucket_max_padded_ratio,
                split=re_split_factor(), byte_weights=ent_bytes)
            atoms = tuple(members)
        weights = counts_g if ent_bytes is None else ent_bytes
        if entity_owner_override is not None:
            plan = plan_from_owner(entity_owner_override, counts_g, P)
        elif atoms is not None:
            plan = plan_shard_placement(weights, P, groups=[list(a) for a in atoms])
        else:
            plan = plan_entity_placement(weights, P)
        record_placement_metrics(plan, shard=pid, atoms=None if atoms is None else len(atoms),
                                 split_classes=split_classes)
        self.placements[cid] = plan
        return dict(entity_owner=plan.owner, owned_global=np.flatnonzero(plan.owner == pid).astype(np.int64),
                    entity_rows=counts_g, caps=caps, pops=pops, ladder=ladder, atoms=atoms)

    def _build_re_shard(self, cid: str, data: StreamedGameData, row_base: int = 0,
                        row_layout: tuple[int, ...] | None = None, drop_unseen: bool = False,
                        reuse_layout: _ReShard | None = None,
                        entity_owner_override: np.ndarray | None = None) -> _ReShard:
        """The coordinate's rows, grouped by entity and bucketed on the host
        (a training shard), or, with ``drop_unseen``, the validation rows of
        entities seen in training (ids >= 0; the others keep score 0).
        Across processes the rows first travel to their entities' owners
        (``row_base`` and ``row_layout``: ``_global_layout``'s), keeping
        their global row ids, and the owner buckets its own entities.

        A training shard's owners come from ``_plan_entities`` (or the
        re-planner's forced map ``entity_owner_override``), and under
        skew-aware placement its buckets from the global capacity ladder,
        with the lane floor; a validation shard follows its training
        shard's owners (``reuse_layout``), since the coefficient rows are
        laid out by them.

        ``PHOTON_RE_PROJECT`` gives a training shard one projection per
        bucket (``_ReShard.project``) and the class support as its column
        map: from the global ladder under skew-aware placement, else from
        the owner's rows (exact for the solves it makes)."""
        c = self.config.random_effect_coordinates[cid]
        feats = data.feature_container(c.feature_shard_id)
        project_mode = "0" if drop_unseen else re_project_mode()
        if project_mode != "0":
            # at shard build, before any exchange or solve
            if c.features_to_samples_ratio_upper_bound is not None:
                raise ValueError("PHOTON_RE_PROJECT and features_to_samples_ratio_upper_bound are mutually "
                                 "exclusive (two competing per-entity column maps)")
            if c.random_projection_dim is not None:
                raise ValueError("PHOTON_RE_PROJECT and random_projection_dim are mutually exclusive "
                                 "(the random projection already re-bases the feature axis)")
            if self.config.normalization is not NormalizationType.NONE:
                raise NotImplementedError("normalization is not supported together with per-entity feature "
                                          "projection — same contract as the subspace-ratio knob")
            if not isinstance(feats, DenseFeatures):
                raise ValueError("PHOTON_RE_PROJECT requires dense features (sparse rows are already "
                                 "width-bounded)")
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
        if reuse_layout is not None:
            if len(ids) and int(ids.max()) >= len(reuse_layout.entity_owner):
                raise ValueError(f"coordinate {cid!r}: validation entity id {int(ids.max())} outside the training "
                                 f"dictionary (E={len(reuse_layout.entity_owner)}); unseen entities must carry -1")
            placed = dict(entity_owner=reuse_layout.entity_owner, owned_global=reuse_layout.owned_global)
        else:
            placed = self._plan_entities(cid, ids, E, P, pid, entity_owner_override,
                                         feats if project_mode != "0" else None)
        if P > 1:
            origin_grow = row_base + (np.arange(len(ids), dtype=np.int64) if rows is None else rows.astype(np.int64))
            arrays = {"ent": ids, "label": labels, "weight": weights, "grow": origin_grow,
                      **_feature_arrays(feats)}
            kind = f"{'validation' if drop_unseen else 'ingest'}/{cid}"
            owned, route = self._exchange_to_owners(kind, arrays, row_layout, placed["entity_owner"])
            labels, weights, feats = owned["label"], owned["weight"], _features_from_arrays(owned, feats)
            # owner-local id: the rank among this process's owned ids
            ent = np.searchsorted(placed["owned_global"], owned["ent"]).astype(np.int64)
            E_local = len(placed["owned_global"])
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
                         num_entities_local=E_local, buckets=None, **route,
                         entity_owner=placed["entity_owner"], owned_global=placed["owned_global"],
                         entity_rows=placed.get("entity_rows"), placement_atoms=placed.get("atoms"))
        if drop_unseen:
            return shard
        grouping = group_by_entity(ent, num_entities=E_local, active_upper_bound=c.active_data_upper_bound)
        caps = placed.get("caps")
        shard.buckets = bucket_entities(grouping, caps if caps else c.sample_bucket_sizes,
                                        target_buckets=c.bucket_target_count,
                                        max_padded_ratio=c.bucket_max_padded_ratio)
        if caps:
            population = dict(zip(caps, placed["pops"]))
            shard.lane_floor_pad = tuple(
                int(len(e) == 1 and population.get(int(r.shape[1]), 0) >= 2)
                for e, r in zip(shard.buckets.entity_ids, shard.buckets.row_indices)
            )
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
        if project_mode != "0":
            ladder = placed.get("ladder")
            if ladder is None:
                classes, activity = class_activity(np.asarray(feats.X), shard.buckets.capacities,
                                                   shard.buckets.row_indices)
                ladder = projection_ladder(classes, activity, feats.num_features, project_mode, re_project_dim(),
                                           self.intercept_indices.get(c.feature_shard_id))
            project = tuple(ladder.get(int(r.shape[1])) for r in shard.buckets.row_indices)
            d = feats.num_features
            record_projection_metrics([(len(e), d if p is None else p.dim)
                                       for p, e in zip(project, shard.buckets.entity_ids)], d)
            if any(p is not None for p in project):
                # the support gather rides the subspace column maps
                shard.subspace_cols = tuple(None if p is None else np.broadcast_to(p.columns, (len(e), p.support_dim))
                                            for p, e in zip(project, shard.buckets.entity_ids))
                shard.project = project
        shard.bucket_device = self._plan_bucket_devices(shard)
        return shard

    def _plan_bucket_devices(self, shard: _ReShard) -> tuple | None:
        """The second placement level (``PHOTON_RE_DEVICE_SPLIT``): this
        process's buckets on its ``local_devices`` by LPT over rows (lanes,
        at the projected width, under ``PHOTON_RE_SPLIT_WEIGHT=bytes``),
        each fusion group whole, so the units that fuse lie on one device.
        Rebuilt with the shard (a re-plan re-derives it). None with the
        knob off or fewer than two local devices."""
        if not re_device_split_enabled() or len(self.local_devices) < 2:
            return None
        buckets = shard.buckets
        lanes = [len(e) for e in buckets.entity_ids]
        d = shard.features.num_features
        weights = placement_weights(lanes, [int((rows >= 0).sum()) for rows in buckets.row_indices],
                                    None if shard.project is None else
                                    [d if p is None else p.dim for p in shard.project])
        cols = shard.subspace_cols or (None,) * len(lanes)
        keys = [(int(r.shape[1]), None if c_ is None else int(c_.shape[1])) for r, c_ in zip(buckets.row_indices, cols)]
        device, plan = plan_device_placement(weights, np.zeros(len(lanes), np.int64), 0, len(self.local_devices),
                                             groups=[idxs for idxs, _ in plan_fusion_groups(keys, lanes)])
        record_device_placement_metrics(plan)
        return tuple(int(x) for x in device)

    def _build_val_route(self, tag: str, validation: StreamedGameData, row_base: int,
                         row_layout: tuple[int, ...]) -> _ReShard:
        """The owner routing of a grouped evaluator's id tag that no random
        effect has: each kept row's (entity id, label, global row id) goes
        to the entity's owner once, at set-up; every visit only the current
        total scores follow (``_offsets_to_owners``). A shard of grouping
        columns, with nothing to solve. No coefficient rows are laid out by
        this tag, so its owners are the modular ones under every knob, as in
        the reference, and its groups keep their global ids (the grouped
        metrics read only their order)."""
        ids = np.asarray(validation.id_tags[tag], np.int64)
        keep = np.flatnonzero(ids >= 0)
        arrays = {"ent": ids[keep], "label": np.asarray(validation.labels, np.float32)[keep],
                  "grow": row_base + keep.astype(np.int64)}
        owner = modular_owner(int(ids.max(initial=-1)) + 1, mh.process_count())
        owned, route = self._exchange_to_owners(f"validation/{tag}", arrays, row_layout, owner)
        return _ReShard(ent_local=owned["ent"], labels=owned["label"],
                        weights=np.ones(len(owned["grow"]), np.float32), features=None, num_entities=0,
                        num_entities_local=0, buckets=None, **route)

    @staticmethod
    def _offsets_payload(shard: _ReShard, offs_local: np.ndarray, row_base: int) -> dict:
        """The owner-ward offsets exchange's rows, one definition for the
        blocking and the overlapped schedule."""
        return {"grow": shard.origin_grow, "off": offs_local[shard.origin_grow - row_base].astype(np.float32)}

    @staticmethod
    def _scatter_offsets(shard: _ReShard, recv: dict) -> np.ndarray:
        """Each received value at its owned row's position, found by global row id."""
        out = np.zeros(len(shard.grow), np.float32)
        if len(shard.grow):
            g = recv["grow"]
            pos = np.minimum(np.searchsorted(shard.grow_sorted, g), len(shard.grow) - 1)
            match = shard.grow_sorted[pos] == g
            out[shard.grow_order[pos[match]]] = recv["off"][match]
        return out

    def _offsets_to_owners(self, shard: _ReShard, offs_local: np.ndarray, row_base: int,
                           kind: str = "offsets") -> np.ndarray:
        """This visit's per-row values (the residual offsets) for the
        shard's rows: across processes each row's value goes to its
        entity's owner only; on one process, the rows' own."""
        if not self._distributed():
            return offs_local if shard.grow is None else offs_local[shard.grow]
        recv = self._exchange(kind, self._offsets_payload(shard, offs_local, row_base), shard.origin_dest, tag=kind)
        return self._scatter_offsets(shard, recv)

    def _offsets_to_owners_async(self, shard: _ReShard, offs_local: np.ndarray,
                                 row_base: int) -> mh.ExchangeHandle:
        """The overlapped twin of ``_offsets_to_owners`` (``PHOTON_RE_SHARD=1``
        across processes): issued here, joined by the visit's first bucket
        gather; the same values."""
        return self._exchange_async("offsets", self._offsets_payload(shard, offs_local, row_base),
                                    shard.origin_dest, "offsets", lambda recv: self._scatter_offsets(shard, recv))

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

    def _scores_to_origin_async(self, shard: _ReShard, scores_re: np.ndarray, n_local: int,
                                row_base: int) -> mh.ExchangeHandle:
        """The overlapped twin of ``_scores_to_origin``: issued right after
        the owner's scoring, joined after the visit's diagnostics
        collective; the same values."""
        def finish(recv):
            out = np.zeros(n_local, np.float32)
            out[recv["grow"] - row_base] = recv["score"]
            return out

        return self._exchange_async("scores", {"grow": shard.grow, "score": scores_re.astype(np.float32)},
                                    shard.owner_dest, "scores", finish)

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
            if "wait_s" in now:  # the overlapped schedule: the seconds its consumer blocked
                out[f"{kind}_wait_s"] = now["wait_s"] - was.get("wait_s", 0.0)
        return out

    def _full_re_matrix(self, W_local: np.ndarray, E: int, entity_owner: np.ndarray) -> np.ndarray:
        """The (E, d) matrix of every process's owned rows (owner p holds the
        ids ``entity_owner`` gives it, ascending, as its rows 0, 1, ...),
        from one gather; ``W_local`` itself on one process."""
        if not self._distributed():
            return W_local
        P = mh.process_count()
        rows = int(np.bincount(entity_owner, minlength=P).max(initial=0))
        padded = np.zeros((max(rows, 1), W_local.shape[1]), np.float32)
        padded[:len(W_local)] = W_local
        stacked = mh.allgather_host(padded)
        W = np.zeros((E, W_local.shape[1]), np.float32)
        for p in range(P):
            own = np.flatnonzero(entity_owner == p)
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

    def _solve_re_buckets(self, shard: _ReShard, offs_re: np.ndarray | mh.ExchangeHandle, opt: OptimizationConfig,
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
        issuing the copies, bytes copied, result read-backs).

        ``offs_re`` may be an offsets exchange in flight
        (``_offsets_to_owners_async``): the first gather joins it. A bucket
        with a lane-floor pad (``_ReShard.lane_floor_pad``) solves with one
        all-padding lane (zero start, zero-mean unit-variance prior) whose
        outputs are dropped.

        ``PHOTON_RE_FUSE_BUCKETS`` groups buckets of one (capacity, solve
        width) into one launch unit (``plan_fusion_groups``; a one-lane
        bucket, lane-floor ones included, stays alone), and
        ``solve_bucket_lanes`` runs each unit, compacted under
        ``PHOTON_RE_COMPACT_EVERY``; the per-bucket losses are summed in
        bucket order either way. Under a hash projection
        (``_ReShard.project``) the gathered support columns are folded on
        the card, the warm-start and prior rows on the host, and the
        solutions expanded on the host before the write-back."""
        # PHOTON_RE_STRAGGLER: a real sleep inflates this process's measured
        # solve wall (the re-planner reads it) and touches no math
        faults.maybe_straggle()
        loss = loss_for_task(self.config.task_type)
        l1 = opt.regularization.l1_weight(opt.regularization_weight)
        l2 = torch.as_tensor(opt.regularization.l2_weight(opt.regularization_weight), dtype=torch.float32,
                             device=self.device)
        minimize_fn, extra = select_minimize_fn(opt.optimizer, l1)
        variance_computation = (self.config.variance_computation if V is not None
                                else VarianceComputationType.NONE)
        buckets = shard.buckets
        nb = len(buckets.entity_ids)
        sub_cols = shard.subspace_cols or (None,) * nb
        pads = shard.lane_floor_pad or (0,) * nb
        specs = shard.project or (None,) * nb
        bdevs = shard.bucket_device
        if fuse_buckets() and nb > 1:
            keys = [(r.shape[1], None if c_ is None else c_.shape[1]) for r, c_ in zip(buckets.row_indices, sub_cols)]
            if bdevs is not None:
                # only buckets on one device fuse (the device plan places
                # fusion groups whole, so the same groups form)
                keys = [(k, bdevs[i]) for i, k in enumerate(keys)]
            plan = plan_fusion_groups(keys, [len(e) for e in buckets.entity_ids])
        else:
            plan = [([i], [(i, 0, len(buckets.entity_ids[i]))]) for i in range(nb)]
        units = []  # (members, entity ids, rows, column maps or None, projection or None, lane-floor pad)
        for idxs, members in plan:
            if len(idxs) == 1:
                i = idxs[0]
                rows = buckets.row_indices[i]
                if pads[i]:
                    rows = np.concatenate([rows, np.full((1, rows.shape[1]), -1, rows.dtype)])
                units.append((members, buckets.entity_ids[i], rows, sub_cols[i], specs[i], pads[i]))
                continue
            # one geometry: one capacity, so one class and one projection
            units.append((members, np.concatenate([buckets.entity_ids[i] for i in idxs]),
                          np.concatenate([buckets.row_indices[i] for i in idxs]),
                          None if sub_cols[idxs[0]] is None else np.concatenate([sub_cols[i] for i in idxs]),
                          specs[idxs[0]], 0))
        # PHOTON_RE_DEVICE_SPLIT: each unit gathers to and solves on its
        # buckets' device; the results come back to the host matrices
        unit_dev = [self.device if bdevs is None else self.local_devices[bdevs[u[0][0][0]]] for u in units]
        folds: dict = {}  # per (hashed projection, device): its fold there

        def fold_of(spec, dev=self.device):
            if (id(spec), dev) not in folds:
                folds[id(spec), dev] = torch.from_numpy(spec.hash_matrix()).to(dev)
            return folds[id(spec), dev]

        offsets = offs_re.result if isinstance(offs_re, mh.ExchangeHandle) else (lambda: offs_re)
        consumers = {dev: prefetch.consumer_stream(dev) for dev in set(unit_dev)}
        l2_on = {dev: l2 if dev == self.device else l2.to(dev) for dev in consumers}
        norm_on = {dev: norm if norm is None or dev == self.device else norm.to(dev) for dev in consumers}
        d_full = shard.features.num_features
        gather_s = [0.0] * len(units)
        issue_s = [0.0] * len(units)
        nbytes = [0] * len(units)
        agg = {"max_iters": 0, "converged": True, "readbacks": 0}
        bucket_loss: dict[int, float] = {}

        def gather(i):
            # reads ingest-time columns and this visit's offsets only, never
            # W, which collect() below writes in bucket order
            _, _, rows, cols, _, _ = units[i]
            offs = offsets()  # joins the exchange in flight: its wait is not the gather's
            t0 = time.perf_counter()
            if cols is not None and len(cols) < len(rows):  # the padding lane takes any columns
                cols = np.concatenate([cols, cols[:1]])
            dev = unit_dev[i]
            arrays = gather_bucket_host(shard.features, shard.labels, offs, shard.weights, rows,
                                        columns=cols, pin_memory=dev.type == "cuda")
            t1 = time.perf_counter()
            put = prefetch.device_put(arrays, dev, consumers[dev])
            gather_s[i], issue_s[i] = t1 - t0, time.perf_counter() - t1
            nbytes[i] = sum(a.numel() * a.element_size() for a in arrays.values())
            return put

        def collect(members, ent_ids, cols, spec, out, dev):
            w_b, f_b, it_b, reason_b, var_b = out
            if norm is not None:
                w_b = norm_on[dev].model_to_original_space(w_b)[0]
                var_b = norm_on[dev].factors**2 * var_b
            if spec is not None and spec.hash_dim is not None:
                w_b, var_b = _hash_expand_lanes(w_b, var_b, fold_of(spec, dev))  # back at the support's width
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
            for i, lo, hi in members:  # per bucket, summed in bucket order below
                bucket_loss[i] = float(np.sum(f_h if lo == 0 and hi == len(ent_ids) else f_h[lo:hi],
                                              dtype=np.float32))
            agg["max_iters"] = max(agg["max_iters"], int(np.max(it_h)))
            agg["converged"] = agg["converged"] and bool(np.all(reason_h != 0))  # 0: MAX_ITERATIONS

        def rows_of(M, ent_ids, cols, dev):
            """A unit's rows of a host (E, d) matrix at its column maps, on the card."""
            if M is None:
                return None
            rows = M[ent_ids] if cols is None else np.take_along_axis(M[ent_ids], cols, axis=1)
            return torch.as_tensor(rows, dtype=torch.float32, device=dev)

        accounting = DeferredLaunchAccounting()
        pending = None
        # under the executor the gathers are scheduled only: each visit's
        # offsets are new, so caching a bucket by content would not pay
        units_iter = (stream_executor.stream("re_gather", len(units), gather)
                      if stream_executor.stream_executor_enabled() else prefetch.prefetch_iter(len(units), gather))
        for i, put in enumerate(units_iter):
            members, ent_ids, _, cols, spec, pad = units[i]
            dev = unit_dev[i]
            hashed = spec is not None and spec.hash_dim is not None
            prefetch.wait(put, consumers[dev])
            bucket = bucket_batch(put, d_full)
            if hashed:
                bucket = dataclasses.replace(bucket, X=bucket.X @ fold_of(spec, dev))
            # the warm start and the incremental prior (already in the solver's space)
            w0, prior_mu, prior_var = (rows_of(M, ent_ids, cols, dev)
                                       for M in (W, W_prior, None if W_prior is None else V_prior))
            if hashed:
                w0, prior_mu, prior_var = _hash_fold_lanes(w0, prior_mu, prior_var, fold_of(spec, dev))
            if pad:  # the padding lane: zero start, zero-mean unit-variance prior
                lanes = len(ent_ids) + 1
                w0, prior_mu, prior_var = _pad_lanes(w0, lanes), _pad_lanes(prior_mu, lanes), _pad_lanes(prior_var,
                                                                                                         lanes, 1.0)
            b_intercept = intercept_index
            if cols is not None and intercept_index is not None:
                b_intercept = cols.shape[1] - 1  # the intercept is each subspace's last slot
            if hashed and intercept_index is not None:
                b_intercept = int(spec.hash_dim) - 1  # the fold keeps the last slot for the intercept alone
            if norm is not None:
                w0 = norm_on[dev].model_from_original_space(w0)
            out = solve_bucket_lanes(
                bucket, w0, l2_on[dev], norm_on[dev], prior_mu, prior_var, minimize_fn=minimize_fn, loss=loss,
                config=opt.optimizer, intercept_index=b_intercept,
                variance_computation=variance_computation, accounting=accounting, **extra,
            )
            if pad:
                out = tuple(t[:len(ent_ids)] for t in out)
            if pending is not None:
                collect(*pending)  # waits for the previous bucket only
            pending = (members, ent_ids, cols, spec, out, dev)
        if pending is not None:
            collect(*pending)
        accounting.flush()
        pipeline = dict(buckets=len(units), gather_s=sum(gather_s), copy_issue_s=sum(issue_s),
                        bytes_copied=sum(nbytes), result_readbacks=agg["readbacks"])
        if not units:
            offsets()  # a process that owns no bucket still joins its offsets exchange
            return 0.0, 0, True, pipeline
        loss_sum = 0.0
        for i in range(nb):
            loss_sum += bucket_loss[i]
        return loss_sum, agg["max_iters"], agg["converged"], pipeline

    def _score_re_rows(self, shard: _ReShard, W: np.ndarray) -> np.ndarray:
        """Scores w_{e(i)}·x_i of the shard's rows, chunk by chunk (one
        gathered (c, d) block of coefficient rows on the card at a time).
        The feature slices are the same storage every visit and come
        through the chunk cache (the executor's arbiter, stream
        "re_scores", under ``PHOTON_STREAM_EXECUTOR=1``); the gathered rows
        are copied afresh."""
        m = len(shard.ent_local)
        if m == 0:
            return np.zeros(0, np.float32)
        f = shard.features
        dense = isinstance(f, DenseFeatures)
        cols = _feature_arrays(f)
        ranges = _chunk_ranges(m, self.chunk_rows)
        dev = self.device
        consumer = prefetch.consumer_stream(dev)

        executor = stream_executor.stream_executor_enabled()

        def prepare(i):
            lo, hi = ranges[i]
            w_rows = prefetch.device_put({"W": W[shard.ent_local[lo:hi]]}, dev, consumer)
            slices = {k: v[lo:hi] for k, v in cols.items()}
            feat = (stream_executor.cached_device_put("re_scores", slices, dev, consumer) if executor
                    else prefetch.cached_device_put(slices, dev, consumer))
            return w_rows, feat

        outs = []
        items = (stream_executor.stream("re_scores", len(ranges), prepare) if executor
                 else prefetch.prefetch_iter(len(ranges), prepare))
        for w_rows, feat in items:
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
            owner = self._re_layouts[cid]
            W_out = t(self._full_re_matrix(model_state["re_W"][cid], E, owner))
            V_out = None if V_local is None else t(self._full_re_matrix(V_local, E, owner))
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

    def _prepare_validation(self, validation: StreamedGameData,
                            re_shards: dict[str, _ReShard]) -> dict[str, Any]:
        """Per-visit validation state: each fixed shard's chunks, each random
        effect's validation shard (routed by its training shard's owners,
        ``re_shards``), the running per-coordinate scores and total, and
        what the evaluators read: on one process the columns on the card,
        across processes the host columns and, per grouped id tag, the shard
        whose owners hold each group whole (the tag's random effect's, or a
        routing of its own)."""
        cfg = self.config
        n = validation.num_rows
        _, val_base, val_layout = self._global_layout(n)
        labels = np.asarray(validation.labels, np.float32)
        weights = np.ones(n, np.float32) if validation.weights is None else np.asarray(validation.weights,
                                                                                       np.float32)
        base = np.zeros(n, np.float32) if validation.offsets is None else np.asarray(validation.offsets,
                                                                                     np.float32)
        state: dict[str, Any] = {
            "n": n, "base": val_base, "layout": val_layout, "fixed": {}, "re_shards": {},
            "zeros": np.zeros(n, np.float32),
            "scores": {cid: np.zeros(n, np.float32) for cid in cfg.coordinate_update_sequence},
            "total": base.copy(),
        }
        for cid, c in cfg.fixed_effect_coordinates.items():
            state["fixed"][cid] = _ChunkedShard(validation.feature_container(c.feature_shard_id), labels,
                                                np.ones(n, np.float32), self.chunk_rows)
        for cid in cfg.random_effect_coordinates:
            state["re_shards"][cid] = self._build_re_shard(cid, validation, val_base, val_layout, drop_unseen=True,
                                                           reuse_layout=re_shards[cid])
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
        if self._distributed():
            mh.drain_async_exchanges()
        model = self._assemble_model(model_state, device="cpu")
        meta = dict(fingerprint=fingerprint, data_digest=digest, next_iteration=next_iteration,
                    next_coordinate=next_coordinate)
        if not self._distributed():
            ckpt_io.save_checkpoint(self.checkpoint_dir, model, scores=scores, total=total, **meta)
            return
        writer = mh.is_output_process()
        if self.sharded_checkpoints:
            payload = {f"s__{cid}": np.asarray(s, np.float32) for cid, s in scores.items()}
            payload["total"] = np.asarray(total, np.float32)
            payload["meta"] = np.frombuffer(json.dumps(dict(meta, row_base=int(row_base))).encode(), dtype=np.uint8)
            atomic_savez(self.checkpoint_dir, self._shard_path(mh.original_process_index()), payload)
            mh.sync_processes("streamed-game-score-shards")
            if writer:
                ckpt_io.save_checkpoint(self.checkpoint_dir, model, scores=None, total=None, **meta)
            return
        g_scores = {cid: self._gather_global(s, row_base, n_global, collect=writer) for cid, s in scores.items()}
        g_total = self._gather_global(total, row_base, n_global, collect=writer)
        if writer:
            ckpt_io.save_checkpoint(self.checkpoint_dir, model, scores=g_scores, total=g_total, **meta)

    def _load_resume_state(self, fingerprint: str, digest: str | None) -> dict | None:
        """The checkpoint to resume from, or None. Across processes process
        0 reads the model's file and every process adopts its bytes, so all
        take one decision (the data digest checked is process 0's, which
        that file holds); the scores come from the file when it holds them
        (gathered: global columns), else from each process's own score file,
        checked against the model's markers and this process's data. A
        stale, torn or missing score file on any process is a miss for
        all. Every fingerprint of ``resume_fingerprints`` is accepted too;
        ``foreign`` says the checkpoint was written under one of them.

        A gathered checkpoint's data digest is its writer's rows'. One that
        this fit wrote itself before a loss (``_own_anchor_fingerprints``)
        holds every survivor's rows at the base it registered, so its
        digest is not compared: after the writer's loss it is another
        process's (the reference compares it, drops the scores, and its
        survivors restart from iteration 0). A rejoined process refuses a
        gathered checkpoint of another layout (the rejoin guard)."""
        accepted = (fingerprint, *self.resume_fingerprints)
        check = digest
        if (self._own_anchor_fingerprints and mh.is_output_process()
                and ckpt_io.peek_fingerprint(self.checkpoint_dir) in self._own_anchor_fingerprints):
            check = ""
        if not self._distributed():
            ckpt = ckpt_io.load_checkpoint(self.checkpoint_dir, fingerprint=accepted, data_digest=check or None,
                                           device="cpu")
            if ckpt is None or ckpt.scores is None or ckpt.total is None:
                return None
            return {"model": ckpt.model, "next_iteration": ckpt.next_iteration,
                    "next_coordinate": ckpt.next_coordinate, "scores": ckpt.scores, "total": ckpt.total,
                    "scores_local": False,
                    "foreign": ckpt.fingerprint is not None and ckpt.fingerprint != fingerprint}
        ckpt = ckpt_io.load_checkpoint(self.checkpoint_dir, fingerprint=accepted,
                                       data_digest=str(mh.broadcast_from_host0(check)) or None, device="cpu",
                                       across_processes=True)
        if ckpt is None:
            return None
        state = {"model": ckpt.model, "next_iteration": ckpt.next_iteration,
                 "next_coordinate": ckpt.next_coordinate,
                 "foreign": ckpt.fingerprint is not None and ckpt.fingerprint != fingerprint}
        if ckpt.scores is not None and ckpt.total is not None:
            if state["foreign"] and mh.rejoin_identity() is not None:
                # a gathered checkpoint of another layout is a degraded
                # group's, which held none of a rejoiner's rows: even an
                # in-bounds slice would copy another process's scores
                raise RuntimeError(
                    "this rejoined process was handed a checkpoint that a degraded layout wrote, which holds none "
                    "of its rows (a checkpoint written between the loss and the rejoin); restart from a "
                    "full-layout checkpoint or retrain")
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
        path = self._shard_path(mh.original_process_index())
        if not os.path.exists(path):
            return None
        accepted = (fingerprint, *self.resume_fingerprints)
        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["meta"]).decode())
                if (meta.get("fingerprint") not in accepted or meta.get("data_digest") != digest
                        or meta.get("next_iteration") != next_iteration
                        or meta.get("next_coordinate") != next_coordinate):
                    return None
                scores = {k[len("s__"):]: np.asarray(z[k], np.float32) for k in z.files if k.startswith("s__")}
                return scores, np.asarray(z["total"], np.float32)
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            return None

    # -- the re-planner -----------------------------------------------------------
    def _maybe_replan_re_shards(self, re_shards: dict, re_W: dict, re_V: dict, re_W_prior: dict,
                                re_V_prior: dict, data: StreamedGameData, validation: StreamedGameData | None,
                                vstate: dict | None, row_base: int, row_layout: tuple[int, ...],
                                re_E: dict[str, int], iteration: int) -> None:
        """Between outer iterations under ``PHOTON_RE_REPLAN_IMBALANCE``:
        every process's random-effect solve wall of the iteration is
        allgathered; where max / mean passes the threshold, the entities
        are re-planned by LPT over their measured costs
        (``measured_entity_costs``, ``replan_excluding`` with no lost
        shard) and migrate before the next visit. The shard is rebuilt
        through the ingest exchange under the new map, and ``W``, ``V``
        and the priors move by a gather under the old layout and a slice
        under the new: copies only, so the model stays bitwise the
        unmigrated run's. Every input is the same on every process, so all
        take the same decision. Off (threshold 0, one process, or the
        knob off) it returns at once, with no collective."""
        threshold = replan_imbalance_threshold()
        if threshold <= 0.0 or not self._skew_aware:
            self._re_solve_wall.clear()
            return
        P = mh.process_count()
        for cid in self.config.random_effect_coordinates:
            shard = re_shards[cid]
            wall_local = self._re_solve_wall.pop(cid, 0.0)
            walls = mh.allgather_host(np.asarray([wall_local], np.float64)).reshape(-1)
            mean = float(walls.mean())
            imbalance = float(walls.max()) / mean if mean > 0 else 1.0
            REGISTRY.counter_inc("re_replan.checks")
            REGISTRY.gauge_set("re_replan.last_imbalance", imbalance)
            emit_event("re_replan_check", coordinate=cid, iteration=iteration, imbalance=imbalance,
                       threshold=threshold, walls=[float(w) for w in walls])
            if imbalance <= threshold:
                continue
            counts = shard.entity_rows
            old_plan = plan_from_owner(shard.entity_owner, counts, P)
            # a split shard re-plans over the atoms it was placed by
            new_plan, migrated = replan_excluding(
                old_plan, [], measured_entity_costs(counts, shard.entity_owner, walls), survivors=range(P),
                groups=None if shard.placement_atoms is None else [list(a) for a in shard.placement_atoms])
            moved = int(migrated.sum())
            if moved == 0:
                emit_event("re_replan", coordinate=cid, iteration=iteration, imbalance=imbalance, migrated=0)
                continue
            mh.drain_async_exchanges()
            with span("replan/migrate", coordinate=cid, iteration=iteration):
                E, old = re_E[cid], shard.entity_owner
                full = {name: self._full_re_matrix(M[cid], E, old)
                        for name, M in (("W", re_W), ("V", re_V), ("Wp", re_W_prior), ("Vp", re_V_prior))
                        if M.get(cid) is not None}
                new_shard = self._build_re_shard(cid, data, row_base, row_layout,
                                                 entity_owner_override=new_plan.owner)
                re_shards[cid] = new_shard
                self._re_layouts[cid] = new_shard.entity_owner
                for name, M in (("W", re_W), ("V", re_V), ("Wp", re_W_prior), ("Vp", re_V_prior)):
                    if name in full:
                        M[cid] = _slice_owned_rows(full[name], new_shard)
                if vstate is not None and validation is not None:
                    # the validation rows follow the training owners, which just changed
                    old_val = vstate["re_shards"][cid]
                    vstate["re_shards"][cid] = self._build_re_shard(
                        cid, validation, vstate["base"], vstate["layout"], drop_unseen=True, reuse_layout=new_shard)
                    for tag, routed in vstate.get("owner_grouped", {}).items():
                        if routed is old_val:
                            vstate["owner_grouped"][tag] = vstate["re_shards"][cid]
            REGISTRY.counter_inc("re_replan.count")
            REGISTRY.counter_inc("re_replan.migrations", float(moved))
            emit_event("re_replan", coordinate=cid, iteration=iteration, imbalance=imbalance, threshold=threshold,
                       migrated=moved, old_balance=float(old_plan.balance), new_balance=float(new_plan.balance),
                       walls=[float(w) for w in walls])
            self._log(f"re-plan after iter {iteration}, coordinate {cid}: measured solve-wall imbalance "
                      f"{imbalance:.2f}x > {threshold:.2f}x, migrating {moved} entities")

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
            if mh.rejoin_identity() is not None and not self._rejoined:
                # a rejoin-booted process: seated in the expanded group
                # before any collective
                self._join_as_rejoiner()
            while True:
                try:
                    return self._fit(data, validation, initial_model)
                except mh.PeerLost as e:
                    # checkpoint-anchored recovery: confirm the loss, shrink
                    # the group and fit again over the survivors from the
                    # last checkpoint
                    self._prepare_recovery(e)
                except _RejoinResume:
                    # the group changed at a visit boundary (rejoiners
                    # admitted, or a survivor dropped): fit again over it
                    # from the last checkpoint, nothing of the old layout
                    # resident
                    self._quiesce()

    def _prepare_recovery(self, err) -> None:
        """Turn a ``PeerLost`` into a resume over the survivors, or raise
        why recovery is impossible. A survivor leaves with the group shrunk
        to the roll call's survivors, the layout's fingerprint and row base
        registered so the last checkpoint is accepted under the new
        layout, no device work of the aborted visit in flight, and the
        ``peer_lost`` / ``recovery`` records and ``fleet.*`` counters."""
        if self.checkpoint_dir is None or not self.multihost:
            raise RuntimeError(
                f"peer loss (process {err.peer}) with no recovery substrate: streamed peer-loss recovery needs "
                "multihost mode and a checkpoint_dir to resume from; re-run with checkpointing enabled or "
                "restart the whole job") from err
        self._log(f"peer loss: process {err.peer} unreachable after retries — starting roll call")
        group, survivors, lost = mh.confirm_peer_loss(err)
        if not lost:
            raise RuntimeError(
                f"roll call found every process alive after a reported peer loss (process {err.peer}): links "
                "flapped past the retry budget — raise PHOTON_P2P_RETRIES/BACKOFF_S rather than recovering "
                "around a live peer") from err
        self._register_degrade_anchors()
        mh.set_degraded_group(survivors)
        # a fresh degrade waits for returning peers again
        self._rejoin_waited = False
        self._quiesce()
        REGISTRY.counter_inc("fleet.recoveries")
        emit_event("recovery", survivors=[int(s) for s in survivors], lost=[int(p) for p in lost],
                   resume_fingerprints=len(self.resume_fingerprints))
        self._log(f"recovery: lost processes {lost}, surviving group {survivors} — re-planning placement and "
                  "resuming from the last checkpoint")

    def _quiesce(self) -> None:
        """No device work of an aborted visit in flight, and nothing of the
        layout being left resident: prefetch workers, copies, cached
        chunks."""
        prefetch.quiesce()
        for dev in {*self.local_devices, self.device}:
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize(dev)

    def _register_degrade_anchors(self) -> None:
        """Accept the current layout's checkpoints under whatever layout
        the fit re-enters with: its fingerprint joins the resume
        allow-list, and the row base of a resume from a checkpoint it
        wrote is this process's base in it."""
        fp = getattr(self, "_last_fingerprint", None)
        if fp is not None and fp not in self.resume_fingerprints:
            self.resume_fingerprints.append(fp)
        if fp is not None:
            self._own_anchor_fingerprints.add(fp)
        base = getattr(self, "_last_row_base", None)
        if base is not None:
            self.resume_row_base = int(base)

    # -- elastic rejoin (PHOTON_REJOIN) ------------------------------------------
    def _join_as_rejoiner(self) -> None:
        """The rejoin-booted side of the handshake: wait at this process's
        recorded address for the survivors' invite, enter the roll call they
        run, take the agreed group and the survivors' resume fingerprints.
        ``_fit`` then re-plans over the expanded group and resumes from the
        checkpoint."""
        if self.checkpoint_dir is None or not self.multihost:
            raise RuntimeError("rejoin boot without a recovery substrate: rejoining needs multihost mode and a "
                               "checkpoint_dir to resume from")
        # longer than a boundary's wait: the survivors may still be degrading
        # (the roll call, the re-entry) when this process comes back
        invite = mh.rejoin_wait(window_s=4.0 * mh.rejoin_window_s())
        if invite is None:
            raise RuntimeError(
                "rejoin: no invite arrived within 4x PHOTON_REJOIN_WINDOW_S — the surviving group is not probing "
                "(PHOTON_REJOIN unset there?) or this process's recorded address is stale")
        survivors = [int(s) for s in invite["survivors"]]
        agreed = mh.roll_call(candidates=invite["candidates"], guard_group=survivors)
        mh.set_degraded_group(agreed)
        ctrl = self._rejoin_ctrl_exchange(agreed, survivors, None)
        for fp in ctrl.get("fingerprints") or []:
            if fp not in self.resume_fingerprints:
                self.resume_fingerprints.append(fp)
        # no row base comes with the anchors: no degraded layout held this
        # process's rows, and the resume refuses such a checkpoint
        self._rejoined = True
        REGISTRY.counter_inc("fleet.rejoins")
        emit_event("rejoin", rejoined=[int(mh.original_process_index())], group=[int(p) for p in agreed],
                   role="rejoiner")
        self._log(f"rejoined the fleet as process {mh.original_process_index()}: group {sorted(agreed)}, "
                  "resuming from the last checkpoint")

    @staticmethod
    def _rejoin_ctrl_exchange(agreed, survivors, payload) -> dict:
        """The resume anchors over the expanded group: one allgather rooted
        at the lowest survivor still in the agreed group (rank 0 may be the
        rejoiner, which has nothing to give, and the roll call may have
        dropped a survivor). ``{}`` when no survivor is left."""
        agreed = sorted(int(p) for p in agreed)
        live = sorted(int(s) for s in survivors if int(s) in set(agreed))
        if not live:
            return {}
        root = live[0]
        views = mh.allgather_obj_p2p(payload if mh.original_process_index() == root else None, tag="rejoin_ctrl")
        return views[agreed.index(root)] or {}

    def _maybe_admit_rejoin(self, re_shards: dict, iteration: int, ci: int) -> None:
        """The survivors' side, at every visit boundary while the group is
        degraded: rank 0 probes the lost processes' addresses and broadcasts
        who answered (the first boundary after a degrade repeats the round
        every 0.5 s for up to ``PHOTON_REJOIN_WINDOW_S``, each process
        running the same rounds; later boundaries run one), invites them,
        and every survivor runs the roll call over survivors and rejoiners.
        An expanded group raises ``_RejoinResume`` after sending the
        rejoiners the resume fingerprints, with the entities each random
        effect moves back (the re-planner's preview) in the ``rejoin``
        record; a group that lost a survivor in that roll call raises it as
        a recovery; an unchanged one trains on."""
        if not self.multihost or not mh.rejoin_enabled():
            return
        dg = mh.degraded_group()
        if dg is None:
            return
        survivors = sorted(int(s) for s in dg["survivors"])
        lost = [p for p in range(mh.original_process_count()) if p not in survivors]
        if not lost:
            return
        window = 0.0 if self._rejoin_waited else mh.rejoin_window_s()
        self._rejoin_waited = True
        rank0 = mh.effective_process_index() == 0
        # counted rounds, not a deadline: the broadcast keeps every survivor
        # in the same round, so none waits in a receive past the mesh timeout
        poll_s = 0.5
        rounds = max(1, int(np.ceil(window / poll_s))) if window > 0 else 1
        present: list[int] = []
        for r in range(rounds):
            probed = mh.probe_rejoiners(lost, 0.0) if rank0 else []
            present = [int(p) for p in np.asarray(mh.broadcast_from_host0(np.asarray(probed, np.int64))).reshape(-1)]
            if present:
                break
            if r + 1 < rounds:
                time.sleep(poll_s)
        if not present:
            return
        candidates = sorted(set(survivors) | set(present))
        if rank0:
            mh.send_rejoin_invites(present, candidates, survivors)
        agreed = mh.roll_call(candidates=candidates, guard_group=survivors)
        mh.set_degraded_group(agreed)
        rejoined = sorted(set(agreed) - set(survivors))
        dropped = sorted(set(survivors) - set(agreed))
        if not rejoined and not dropped:
            return  # the probed peer vanished before the roll call: train on
        if not rejoined:
            # a survivor died between the probe and the roll call: the
            # visit's plans are keyed on the old ranks, so this is a loss
            self._register_degrade_anchors()
            self._rejoin_waited = False
            REGISTRY.counter_inc("fleet.recoveries")
            emit_event("recovery", survivors=[int(p) for p in agreed], lost=[int(p) for p in dropped],
                       resume_fingerprints=len(self.resume_fingerprints))
            self._log(f"iter {iteration}: rejoin roll call dropped {dropped} — group {sorted(agreed)}, "
                      "re-planning and resuming from the last checkpoint")
            raise _RejoinResume()
        # the re-planner's preview of the entities the expanded re-ingest moves
        migrated = {}
        for cid, shard in re_shards.items():
            if shard.entity_owner is None or shard.entity_rows is None:
                continue
            old_plan = plan_from_owner(shard.entity_owner, shard.entity_rows, len(survivors))
            _, moved = replan_excluding(old_plan, [], shard.entity_rows, survivors=range(len(agreed)),
                                        groups=None if shard.placement_atoms is None
                                        else [list(a) for a in shard.placement_atoms])
            migrated[cid] = int(moved.sum())
        fps: list[str] = []
        for fp in (getattr(self, "_last_fingerprint", None), *self.resume_fingerprints):
            if fp and fp not in fps:
                fps.append(fp)
        self._rejoin_ctrl_exchange(agreed, survivors, {"fingerprints": fps})
        # the survivors accept what they sent: the expanded layout's
        # fingerprint differs from the one that wrote the last checkpoint
        # (degraded or before the loss), and the row base is this process's
        # in the degraded layout that wrote a checkpoint since the loss
        self._register_degrade_anchors()
        self._rejoin_waited = False
        REGISTRY.counter_inc("fleet.rejoins")
        emit_event("rejoin", iteration=iteration, coordinate_index=ci, rejoined=[int(p) for p in rejoined],
                   group=[int(p) for p in agreed], migrated=migrated, role="survivor")
        self._log(f"iter {iteration}: processes {rejoined} rejoined — group {sorted(agreed)}, re-planning placement "
                  "and resuming from the last checkpoint")
        raise _RejoinResume()

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
        _, P = self._ranks()
        base = np.zeros(n, np.float32) if data.offsets is None else np.asarray(data.offsets, np.float32)
        self._norm_contexts = self._normalization_contexts(data)
        self._fixed_objectives = {}
        self._fixed_shards = {}
        self._projectors = {}
        self.visit_stats = []
        self.exchange_totals = {}
        # per coordinate, this outer iteration's random-effect solve wall,
        # which the re-planner reads between iterations
        self._re_solve_wall: dict[str, float] = {}
        # skew-aware placement, its overlapped exchanges and its re-planner
        # (PHOTON_RE_SHARD=1); one process ignores the knob, as the reference does
        self._skew_aware = P > 1 and re_shard_enabled()
        self.placements = {}

        # the entity exchange to the owners, once a fit
        re_shards = {}
        for cid in cfg.random_effect_coordinates:
            with span("ingest/re-shard", coordinate=cid):
                re_shards[cid] = self._build_re_shard(cid, data, row_base, row_layout)
        # the owner layouts that assemble the (E, d) matrices
        self._re_layouts = {cid: s.entity_owner for cid, s in re_shards.items()}
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
                    re_W[cid] = _slice_owned_rows(W_full, re_shards[cid])

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
                        V_loc = _slice_owned_rows(sub.variances.detach().cpu().numpy().astype(np.float32),
                                                  re_shards[cid])
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
            vstate = self._prepare_validation(validation, re_shards)

        seq = list(cfg.coordinate_update_sequence)
        start_it, start_ci = 0, 0
        fingerprint = digest = None
        if self.checkpoint_dir is not None:
            fingerprint = self._fingerprint(data, n_global, row_layout, initial_model=initial_model)
            # each process's own rows (a score file is checked against its process's)
            digest = _host_digest(np.asarray(data.labels, np.float32),
                                  np.ones(n, np.float32) if data.weights is None
                                  else np.asarray(data.weights, np.float32))
            # the recovery anchors: a loss mid-fit accepts this layout's checkpoints
            self._last_fingerprint, self._last_row_base = fingerprint, row_base
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
                        re_W[cid] = _slice_owned_rows(sub.coefficients.numpy().astype(np.float32), re_shards[cid])
                        if sub.variances is not None and want_var:
                            re_V[cid] = _slice_owned_rows(sub.variances.numpy().astype(np.float32), re_shards[cid])
                # a gathered checkpoint holds global columns, a score file this
                # process's rows; a checkpoint of the layout before a loss is
                # sliced at this process's base there
                lo = 0
                if not resume["scores_local"]:
                    lo = (self.resume_row_base if resume["foreign"] and self.resume_row_base is not None
                          else row_base)
                    ck_rows = int(np.asarray(resume["total"]).shape[0])
                    if lo + n > ck_rows:
                        raise RuntimeError(
                            f"checkpoint score state covers {ck_rows} global rows but this process expects rows "
                            f"[{lo}, {lo + n}) of the writing layout — the checkpoint was written by a layout "
                            "that did not hold this process's rows; restart from a full-layout checkpoint or "
                            "retrain")
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
                    # a degraded group admits returning processes here (a
                    # collective; raises _RejoinResume into fit's loop)
                    self._maybe_admit_rejoin(re_shards, it, ci)
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
                            # the overlapped schedule (PHOTON_RE_SHARD=1 across processes): the
                            # offsets exchange is issued here and joined by the first bucket
                            # gather, the scores exchange rides under the diagnostics gather;
                            # with the knob off, the blocking sequence
                            overlap = self._skew_aware
                            t_solve = time.perf_counter()
                            offs_re = (self._offsets_to_owners_async(shard, offs, row_base) if overlap
                                       else self._offsets_to_owners(shard, offs, row_base))
                            loss_sum, max_it, conv, pipeline = self._solve_re_buckets(
                                shard, offs_re, c.optimization, re_W[cid],
                                None if cid in self._projectors else self.intercept_indices.get(c.feature_shard_id),
                                norm=self._norm_contexts.get(c.feature_shard_id), V=re_V[cid],
                                W_prior=re_W_prior.get(cid), V_prior=re_V_prior.get(cid),
                            )
                            solve_wall = time.perf_counter() - (t_solve if overlap else t_visit)
                            REGISTRY.timer_add("re_solve.visit_wall_s", solve_wall)
                            self._re_solve_wall[cid] = self._re_solve_wall.get(cid, 0.0) + solve_wall
                            pending = None
                            if overlap:
                                pending = self._scores_to_origin_async(shard, self._score_re_rows(shard, re_W[cid]),
                                                                       n, row_base)
                            if P > 1:
                                # the owners' partial diagnostics: losses sum, iterations max, flags and
                                agg = mh.allgather_host(
                                    np.asarray([loss_sum, max_it, 0.0 if conv else 1.0])).reshape(-1, 3)
                                loss_sum, max_it = float(agg[:, 0].sum()), int(agg[:, 1].max())
                                conv = bool((agg[:, 2] == 0).all())
                            stats = dict(iteration=it, coordinate=cid, solve_wall_s=time.perf_counter() - t_visit,
                                         **pipeline)
                            if pending is not None:
                                new_scores = pending.result()
                            else:
                                new_scores = self._scores_to_origin(shard, self._score_re_rows(shard, re_W[cid]), n,
                                                                    row_base)
                            if P > 1:
                                stats.update(self._exchanges_since(before))
                            self.visit_stats.append(stats)
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

            if it + 1 < cfg.coordinate_descent_iterations:
                # between outer iterations, so a migration lands at a visit boundary
                self._maybe_replan_re_shards(re_shards, re_W, re_V, re_W_prior, re_V_prior, data, validation,
                                             vstate, row_base, row_layout, re_E, it)

        if self._distributed():
            mh.drain_async_exchanges()
        model = self._assemble_model({"fixed_w": fixed_w, "re_W": re_W, "re_E": re_E, "fixed_var": fixed_var,
                                      "re_V": re_V})
        return model, info
