"""Per-entity random-effect training over entity lanes (port of the
knob-off schedule of ``photon_ml_tpu/game/random_effect.py``).

Each bucket of ``game/data.py`` is k entities padded to one capacity C;
``prepare_buckets`` gathers its static tensors once, on the device: a
(k, C, d) ``DenseBatch`` for a dense shard, a (k, C, nnz) ``SparseBatch``
for a sparse one. Every coordinate-descent visit then gathers only the
residual offsets for the bucket's rows and solves all k entity GLMs
together on a ``LaneGLMObjective`` with the solver that
``select_minimize_fn`` picks, as the reference does: L-BFGS by default,
OWL-QN under an L1 weight, TRON or damped Newton when configured. Each
solver steps the lanes in lock step (the reference vmaps the same solve
over the lane), and the solutions are scattered back into the (E, d)
coefficient matrix. One bucket step per bucket.

Newton and FULL variances need the full Hessian, so they take dense
shards only and raise the reference's message on a sparse one.

``features_to_samples_ratio`` (the reference's
``numFeaturesToSamplesRatioUpperBound``) solves each entity in its own
subspace: a dense bucket of capacity C keeps every entity's p = min(d,
ceil(ratio · C)) most frequent columns (``game/projector.py``), gathered
once to (k, C, p); warm starts and priors are read at those columns, and
the solutions are written back with zeros elsewhere. A sparse shard
ignores the ratio, as in the reference.

Over a data mesh (``parallel/mesh.py``; the reference's lane-sharded
schedule) each bucket's k entity lanes pad with zero-weight lanes to a
multiple of the global shard count S and split in order: global shard s
solves lanes [s·⌈k/S⌉, (s+1)·⌈k/S⌉), derived from k and S alone, so P
processes × L shards solve exactly the lane sets of one process × P·L.
Each process gathers and stages only its shards' lanes, each on its
shard's device, and solves them with no collective; the solutions, the
variances and the per-entity diagnostics of every process then meet in
one host gather per visit, in rank order, and every process ends the
visit with the same (E, d) matrix.

``PHOTON_RE_SHARD=1`` with a mesh switches to owned buckets (the
reference's owned-bucket mode): placement is decided before any staging,
whole buckets balanced over the processes by Σ active rows
(``_plan_bucket_owners``, LPT over ``plan_fusion_groups``' groups, the
same plan on every process), and each process gathers, stages (on its
first local device) and solves only the buckets it owns, whole. One host
gather then brings every bucket's rows, variances and diagnostics to
every process in bucket order (``_combine_owned``). A bucket solves
exactly as without a mesh, so the result is bitwise the unsharded
solve's on one process and across processes.

Three knobs, read at call time, reshape the one-card solve:

- ``PHOTON_RE_COMPACT_EVERY=c`` (lane compaction) runs each bucket's
  lanes through the solver's chunked twins (``select_chunked_solver``) c
  iterations at a time. After each chunk the lanes' ``done`` and ``it``
  are read back once, and the still-active lanes are gathered into a
  smaller front (a power of two, never below 2 lanes for a bucket of more
  than one), so converged lanes stop costing iterations
  (``_solve_bucket_compacted``). Newton has no chunked twin and keeps one
  launch.
- ``PHOTON_RE_FUSE_BUCKETS=1`` concatenates buckets of one launch
  geometry (``_bucket_geometry``) into one launch unit
  (``_fusion_units``); a one-lane bucket stays alone.
- ``PHOTON_RE_PROJECT=support|hash`` solves every bucket of a capacity
  class over the class's active columns, folded to
  ``PHOTON_RE_PROJECT_DIM`` signed slots under ``hash``
  (``game/projector.py``): warm starts and priors are folded the same way
  (``_hash_fold_lanes``), and the solutions are expanded and written back
  with zeros off the support.

Compaction and fusion change the launch schedule and not the lanes'
arithmetic, but a front or a fused unit is a batch of another lane count,
and a lane's bits can move with it: on the CPU through ``torch.sigmoid``'s
vector body against its tail, on the card through the batched products'
and the reductions' kernel choice at larger lane counts (ROADMAP queue 3,
``scripts/lane_bits.py``). So the knob-on model is bitwise the knob-off
one where the shapes keep their kernels, and otherwise within the lane
solvers' tolerance. Over a lane-sharded mesh both keep the classic
schedule; owned buckets take them per bucket.

Under owned buckets three more knobs act (``parallel/placement.py``),
and a lane-sharded mesh or no mesh ignores them, as the reference does:

- ``PHOTON_RE_SPLIT`` cuts heavy capacity classes into sub-bucket
  placement atoms (``game/data.py`` ``split_entity_buckets``), each placed
  on its own (``PreparedBucket.parent`` names its class's bucket); the
  atoms one process owns of a class launch together again
  (``_parent_units``), so on one process the split launches exactly the
  unsplit buckets. ``PHOTON_RE_SPLIT_WEIGHT=bytes`` balances lanes (one
  combine segment row each, at the projected width under
  ``PHOTON_RE_PROJECT``) instead of rows.
- ``PHOTON_RE_DEVICE_SPLIT=1`` places a process's owned buckets on the
  mesh's local entries by a second LPT level (``PreparedBucket.device``):
  each entry solves on its own copy of the (E, d) matrices, folded back
  by row copies (``_combine_device_local``). Fewer than two entries: off.
- ``PHOTON_RE_COMBINE=segments`` (``re_combine_mode``) replaces the
  dense combine, which gathers Σ lanes rows from every process, by each
  owner's packed segments (``_combine_owned_segments``): O(E·d) bytes a
  process instead of O(P·E·d), on the exchange worker's gloo group, the
  same bits.

``solve_bucket_lanes`` is the one-bucket entry point of eager callers
(the out-of-core trainer, ``game/streaming.py``, which gathers each
bucket on the host every visit): the same lane solve, its results left
on the card, and its launch counted in ``launch_counts`` with the
iteration read deferred to one ``DeferredLaunchAccounting.flush``. Both
entry points count their launches into the metrics registry
(``re_solve.launches``: one per single-launch solve; init, each chunk
and finalize under compaction) and, while a telemetry sink is active or
with ``PHOTON_RE_ITER_ACCOUNTING=1``, the executed and useful entity
iterations (``re_solve.*``); otherwise nothing is read back for them. The
compacted schedule reads them between its chunks anyway and always
counts them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from photon_ml_tpu_torch._device import check_device
from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.game.data import DenseFeatures, EntityBuckets, Features, split_entity_buckets
from photon_ml_tpu_torch.game.projector import (
    class_activity,
    projection_ladder,
    re_project_dim,
    re_project_mode,
    subspace_columns,
)
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.obs import sink as obs_sink
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.obs.spans import emit_event
from photon_ml_tpu_torch.ops.batch import DenseBatch, SparseBatch
from photon_ml_tpu_torch.ops.glm import GaussianPrior, compute_variances, make_lane_objective
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.optim.common import (
    hash_expand_coefficients,
    hash_expand_variances,
    hash_fold_prior,
    hash_fold_warm_start,
    select_chunked_solver,
    select_minimize_fn,
)
from photon_ml_tpu_torch.parallel.mesh import Mesh, ProcessMesh, as_process_mesh, shard_extent
from photon_ml_tpu_torch.parallel.placement import (
    placement_weights,
    plan_device_placement,
    plan_shard_placement,
    re_device_split_enabled,
    re_shard_enabled,
    re_split_factor,
    re_split_weight,
    record_device_placement_metrics,
    record_placement_metrics,
    record_projection_metrics,
)
from photon_ml_tpu_torch.types import VarianceComputationType

Tensor = torch.Tensor

# The schedule knobs, read at call time (the environment over these module
# values): PHOTON_RE_COMPACT_EVERY iterations per chunk (0: one launch a
# bucket), PHOTON_RE_FUSE_BUCKETS (1: one launch per bucket geometry).
COMPACT_EVERY = 0
FUSE_BUCKETS = 0

# the owned-bucket combine's transport (PHOTON_RE_COMBINE): "allreduce",
# the dense buffer of every bucket's rows from every process, or
# "segments", each owner's packed rows alone
RE_COMBINE = "allreduce"
_RE_COMBINE_MODES = ("allreduce", "segments")


def re_combine_mode() -> str:
    """``PHOTON_RE_COMBINE`` (env > module global); a name outside
    ``_RE_COMBINE_MODES`` raises."""
    env = os.environ.get("PHOTON_RE_COMBINE")
    mode = env if env else str(RE_COMBINE)
    if mode not in _RE_COMBINE_MODES:
        raise ValueError(f"PHOTON_RE_COMBINE must be one of {_RE_COMBINE_MODES}, got {mode!r}")
    return mode


def compact_every() -> int:
    """``PHOTON_RE_COMPACT_EVERY`` (environment over ``COMPACT_EVERY``),
    0 = off."""
    env = os.environ.get("PHOTON_RE_COMPACT_EVERY")
    if env is not None and env != "":
        return max(int(env), 0)
    return max(int(COMPACT_EVERY), 0)


def fuse_buckets() -> bool:
    """``PHOTON_RE_FUSE_BUCKETS`` (environment over ``FUSE_BUCKETS``)."""
    env = os.environ.get("PHOTON_RE_FUSE_BUCKETS")
    if env is not None and env != "":
        return int(env) != 0
    return int(FUSE_BUCKETS) != 0


@dataclass(frozen=True)
class RandomEffectTrainingResult:
    """Per-entity models as one (E, d) coefficient matrix (and (E, d)
    variances when asked for). Entities with no active rows keep their
    warm-start row (zeros for a cold start).

    Per-entity diagnostics stay on the device (``diag_refs``: per bucket the
    host entity ids and the (k,) final objective, iterations, reason and
    objective passes) until ``loss_values`` / ``iterations`` /
    ``converged`` / ``objective_passes`` first reads them, in one
    transfer."""

    coefficients: Tensor | None
    variances: Tensor | None
    diag_refs: tuple = ()
    num_entities: int = 0

    def _materialize(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        cached = self.__dict__.get("_diag_cache")
        if cached is None:
            if self.__dict__.get("_released"):
                raise RuntimeError(
                    "per-entity diagnostics were released for this iteration's "
                    "tracker (coordinate descent keeps them only for each "
                    "coordinate's latest visit); read tracker.loss_values before "
                    "the next visit if you need per-iteration history"
                )
            loss_values = np.full((self.num_entities,), np.nan, np.float64)
            iterations = np.zeros((self.num_entities,), np.int64)
            converged = np.zeros((self.num_entities,), bool)
            passes = np.zeros((self.num_entities,), np.int64)
            if self.diag_refs:
                flat = torch.cat(
                    [torch.stack([v.double() for v in lane]) for _, *lane in self.diag_refs], dim=1,
                ).cpu().numpy()
                ids = np.concatenate([e for e, *_ in self.diag_refs])
                loss_values[ids] = flat[0]
                iterations[ids] = flat[1].astype(np.int64)
                converged[ids] = flat[2] != 0  # != MAX_ITERATIONS
                passes[ids] = flat[3].astype(np.int64)
            cached = (loss_values, iterations, converged, passes)
            object.__setattr__(self, "_diag_cache", cached)
        return cached

    @property
    def loss_values(self) -> np.ndarray:
        """(E,) final per-entity objective (NaN if untrained)."""
        return self._materialize()[0]

    @property
    def iterations(self) -> np.ndarray:
        """(E,) solver iterations (0 if untrained)."""
        return self._materialize()[1]

    @property
    def converged(self) -> np.ndarray:
        """(E,) per-entity convergence."""
        return self._materialize()[2]

    @property
    def objective_passes(self) -> np.ndarray:
        """(E,) the solver's objective passes (0 if untrained)."""
        return self._materialize()[3]

    def release_device_diagnostics(self) -> None:
        """Drop the device references without reading them (coordinate
        descent calls this on a coordinate's previous visit); values already
        read stay readable."""
        object.__setattr__(self, "_released", True)
        object.__setattr__(self, "diag_refs", ())
        object.__setattr__(self, "coefficients", None)
        object.__setattr__(self, "variances", None)


@dataclass(frozen=True)
class PreparedBucket:
    """One bucket's static tensors on the device, built once: descent
    visits change only the offsets. ``columns``, under subspace
    projection (and the capacity-class projection), maps each entity's p
    solve slots to its feature columns; the static features are already
    gathered to (k, C, p), and under a hash fold folded on to (k, C, m)
    by ``hash_S``."""

    entity_ids: np.ndarray  # (k,) entity ids (host)
    # the device tensors; None on a bucket another process owns (owned mode)
    ids: Tensor | None  # (k,) the same ids on the device (the (E, d) scatter key)
    static: DenseBatch | SparseBatch | None  # (k, C, d) or (k, C, nnz) features, (k, C) columns
    row_idx: Tensor | None  # (k, C) int64 row indices, padding clipped to 0
    mask: Tensor | None  # (k, C) 1.0 where the slot holds a real row
    columns: Tensor | None = None  # (k, p) int64 per-entity column map
    # over a mesh: the bucket these lanes belong to and their global shard;
    # the first num_real of the shard's ⌈k/S⌉ lanes are real, the rest pad
    bucket: int = 0
    shard: int | None = None
    # owned mode (PHOTON_RE_SHARD=1 over a mesh): the process that solves
    # this whole bucket; None in the lane-sharded and unsharded schedules
    owner: int | None = None
    # PHOTON_RE_SPLIT: the unsplit bucket this sub-bucket atom was cut
    # from (None on an unsplit preparation); PHOTON_RE_DEVICE_SPLIT: the
    # local mesh entry it is staged and solved on (None: the head)
    parent: int | None = None
    device: int | None = None
    # the capacity class's projection (PHOTON_RE_PROJECT; None: full
    # width), set on every bucket of a projected preparation, and its
    # (d_e, m) signed fold on the bucket's device when the class folds
    project: object | None = None
    hash_S: Tensor | None = None

    @property
    def num_real(self) -> int:
        return len(self.entity_ids)

    @property
    def capacity(self) -> int:
        return self.row_idx.shape[1]


def _prepare_one(
    features: Features,
    labels: Tensor,
    weights: Tensor,
    ent_ids: np.ndarray,
    rows: np.ndarray,
    features_to_samples_ratio: float | None,
    intercept_index: int | None,
    target: torch.device,
    spec=None,
    **where,
) -> PreparedBucket:
    """One bucket's (or one shard's lanes') static tensors, gathered where
    the features lie and staged on ``target``; ``spec`` (a dense bucket's
    ``ClassProjection``) gathers them to the class support and folds them
    when the class hashes."""
    dense = isinstance(features, DenseFeatures)
    src = (features.X if dense else features.values).device
    raw = torch.as_tensor(rows, dtype=torch.int64, device=src)
    mask = (raw >= 0).to(torch.float32)
    idx = torch.clamp_min(raw, 0)
    columns = dict(labels=(labels[idx] * mask).to(target), offsets=torch.zeros_like(mask, device=target),
                   weights=(weights[idx] * mask).to(target))
    cols = hash_S = None
    if dense:
        static = DenseBatch(X=(features.X[idx].float() * mask.unsqueeze(-1)).to(target), **columns)
        if spec is not None:
            # one shared column set per class; the intercept (the last
            # column) lands at slot d_e - 1
            cols = torch.as_tensor(spec.columns, device=target).expand(len(rows), -1).contiguous()
            X = static.X[:, :, cols[0]]
            if spec.hash_dim is not None:
                hash_S = torch.from_numpy(spec.hash_matrix()).to(target)
                X = X @ hash_S
            static = dataclasses.replace(static, X=X)
        if features_to_samples_ratio is not None:
            cols = subspace_columns(static.X, features_to_samples_ratio, intercept_index)
            if cols is not None:
                static = dataclasses.replace(
                    static, X=torch.gather(static.X, 2, cols.unsqueeze(1).expand(-1, static.X.shape[1], -1))
                )
    else:
        static = SparseBatch(
            indices=features.indices[idx].long().to(target),
            values=(features.values[idx].float() * mask.unsqueeze(-1)).to(target),
            num_features=features.num_features, **columns,
        )
    return PreparedBucket(
        entity_ids=np.asarray(ent_ids),
        ids=torch.as_tensor(ent_ids, dtype=torch.int64, device=target),
        static=static,
        row_idx=idx.to(target),
        mask=mask.to(target),
        columns=cols,
        project=spec,
        hash_S=hash_S,
        **where,
    )


def prepare_buckets(
    features: Features,
    labels: Tensor,
    weights: Tensor,
    buckets: EntityBuckets,
    features_to_samples_ratio: float | None = None,
    intercept_index: int | None = None,
    mesh: Mesh | ProcessMesh | None = None,
) -> list[PreparedBucket]:
    """Gather every bucket's static tensors with index operations where the
    features lie (one upload of the padded row-index matrix per bucket; on
    the card the rows themselves never leave it). Padded slots get weight 0
    and zeroed feature values (a sparse slot keeps row 0's indices, as the
    reference's ``gather_bucket`` does: its values are 0).
    ``features_to_samples_ratio`` gathers a dense bucket to its entities'
    subspaces (``subspace_columns``, with the intercept at slot p - 1).

    With ``mesh``, each bucket's lanes pad to a multiple of the global
    shard count and this process prepares only its shards' lanes, each on
    its shard's device (a shard with no real lane of a bucket gets none);
    the features may then lie on the host. Under ``PHOTON_RE_SHARD=1`` a
    mesh prepares owned buckets instead (module docstring): the buckets
    this process owns whole, on its first local device (on the entry the
    device split picks, under ``PHOTON_RE_DEVICE_SPLIT``), and host
    bookkeeping only (entity ids, owner) for the rest; ``PHOTON_RE_SPLIT``
    first cuts heavy buckets into sub-bucket atoms.

    ``PHOTON_RE_PROJECT`` (support / hash) derives one projection per
    capacity class from the classes' column activity over the whole batch
    (``class_activity``, ``projection_ladder``: the batch is the same on
    every process, so is the ladder) and gathers every dense bucket of a
    projected class to the class support (folded under ``hash``). It
    refuses ``features_to_samples_ratio`` (two column maps) and sparse
    features, as the reference does."""
    dense = isinstance(features, DenseFeatures)
    src = (features.X if dense else features.values).device
    ladder = _projection_ladder(features, buckets, features_to_samples_ratio, intercept_index)

    def spec_of(rows):
        return None if ladder is None else ladder.get(int(np.asarray(rows).shape[1]))

    def dims_of(bks):
        # each bucket's solved width, the segment row its lanes ship (None
        # without a projection, which keeps the weights of the unprojected
        # preparation)
        if ladder is None:
            return None
        return [float(features.num_features) if (p := ladder.get(int(c))) is None else float(p.dim)
                for c in bks.capacities]

    prepared = []
    owners = parents = devices = None
    if mesh is not None and re_shard_enabled():
        pm = as_process_mesh(mesh)
        # placement before any staging: device residency is O(owned buckets)
        buckets, parents, n_split = split_entity_buckets(buckets, re_split_factor(), weight=re_split_weight(),
                                                         byte_dims=dims_of(buckets))
        lane_dims = dims_of(buckets)
        owners = _plan_bucket_owners(buckets, pm.process_count, pm.process_index, parents, n_split, lane_dims)
        devices = _plan_bucket_devices(buckets, parents, owners, pm.process_index, len(pm.local), lane_dims)
    for b, (ent_ids, rows) in enumerate(zip(buckets.entity_ids, buckets.row_indices)):
        if owners is not None:
            owner = int(owners[b])
            parent = None if parents is None else int(parents[b])
            if owner != pm.process_index:
                prepared.append(PreparedBucket(entity_ids=np.asarray(ent_ids), ids=None, static=None, row_idx=None,
                                               mask=None, bucket=b, owner=owner, parent=parent,
                                               project=spec_of(rows)))
            else:
                dev = None if devices is None else int(devices[b])
                prepared.append(_prepare_one(features, labels, weights, ent_ids, rows, features_to_samples_ratio,
                                             intercept_index, pm.head if dev is None else pm.local[dev],
                                             spec=spec_of(rows), bucket=b, owner=owner, parent=parent,
                                             device=dev))
            continue
        if mesh is None:
            prepared.append(_prepare_one(features, labels, weights, ent_ids, rows, features_to_samples_ratio,
                                         intercept_index, src, spec=spec_of(rows)))
            continue
        pm = as_process_mesh(mesh)
        k = len(ent_ids)
        per = shard_extent(k, pm.num_shards)
        for shard, dev in zip(pm.global_shards(), pm.local):
            lo, hi = min(shard * per, k), min((shard + 1) * per, k)
            if lo == hi:
                continue
            lanes = np.full((per, rows.shape[1]), -1, dtype=np.asarray(rows).dtype)
            lanes[: hi - lo] = rows[lo:hi]
            prepared.append(_prepare_one(features, labels, weights, ent_ids[lo:hi], lanes,
                                         features_to_samples_ratio, intercept_index, dev,
                                         spec=spec_of(rows), bucket=b, shard=shard))
    if ladder is not None:
        d = int(features.num_features)
        record_projection_metrics([(pb.num_real, d if pb.project is None else pb.project.dim)
                                   for pb in prepared], d)
        emit_event("re_project", mode=re_project_mode(), full_dim=d, classes=[
            {"capacity": int(c), "support_dim": d if p is None else p.support_dim,
             "dim": d if p is None else p.dim, "hashed": bool(p is not None and p.hash_dim is not None)}
            for c, p in sorted(ladder.items())])
    return prepared


def _projection_ladder(features: Features, buckets: EntityBuckets, features_to_samples_ratio: float | None,
                       intercept_index: int | None) -> dict | None:
    """The capacity classes' projections under ``PHOTON_RE_PROJECT`` (None
    when it is off), with the reference's refusals."""
    mode = re_project_mode()
    if mode == "0":
        return None
    if features_to_samples_ratio is not None:
        raise ValueError("PHOTON_RE_PROJECT and features_to_samples_ratio are mutually exclusive "
                         "(two competing per-entity column maps)")
    if not isinstance(features, DenseFeatures):
        raise ValueError("PHOTON_RE_PROJECT requires dense features (sparse rows are already width-bounded)")
    classes, activity = class_activity(features.X, buckets.capacities, buckets.row_indices)
    return projection_ladder(classes, activity, features.num_features, mode, re_project_dim(), intercept_index)


def train_random_effects(
    features: Features,
    labels,
    offsets,
    weights,
    buckets: EntityBuckets,
    num_entities: int,
    loss: PointwiseLoss,
    config: OptimizerConfig,
    l2_weight: float = 0.0,
    l1_weight: float = 0.0,
    intercept_index: int | None = None,
    initial_coefficients: Tensor | None = None,
    variance_computation: VarianceComputationType = VarianceComputationType.NONE,
    norm: NormalizationContext | None = None,
    prior_coefficients: Tensor | None = None,
    prior_variances: Tensor | None = None,
    device=None,
    mesh: Mesh | ProcessMesh | None = None,
) -> RandomEffectTrainingResult:
    """Train every entity's GLM; returns the (E, d) coefficient matrix.
    Runs on ``device`` (CUDA unless the caller asks for another), which
    must hold ``features``; the per-row columns (numpy or tensors) are put
    there. With ``mesh`` the lanes split over its shards, ``features``
    may lie anywhere, and the matrix lies on the mesh's head device."""
    feats_dev = (features.X if isinstance(features, DenseFeatures) else features.values).device
    dev = check_device(feats_dev, device) if mesh is None else feats_dev
    head = dev if mesh is None else as_process_mesh(mesh).head

    def col(a, where=dev):
        return torch.as_tensor(a, dtype=torch.float32, device=where)

    prepared = prepare_buckets(features, col(labels), col(weights), buckets, intercept_index=intercept_index,
                               mesh=mesh)
    return train_prepared(
        prepared, col(offsets, head), features.num_features, num_entities, loss, config,
        l2_weight=l2_weight, l1_weight=l1_weight, intercept_index=intercept_index,
        initial_coefficients=initial_coefficients, variance_computation=variance_computation,
        norm=norm, prior_coefficients=prior_coefficients, prior_variances=prior_variances, mesh=mesh,
    )


def train_prepared(
    prepared: list[PreparedBucket],
    offsets: Tensor,
    num_features: int,
    num_entities: int,
    loss: PointwiseLoss,
    config: OptimizerConfig,
    l2_weight: float = 0.0,
    l1_weight: float = 0.0,
    intercept_index: int | None = None,
    initial_coefficients: Tensor | None = None,
    variance_computation: VarianceComputationType = VarianceComputationType.NONE,
    norm: NormalizationContext | None = None,
    prior_coefficients: Tensor | None = None,
    prior_variances: Tensor | None = None,
    mesh: Mesh | ProcessMesh | None = None,
    fusion_units: list | None = None,
) -> RandomEffectTrainingResult:
    """Solve every prepared bucket against the current (n,) residual
    ``offsets``, one bucket step per bucket. ``norm`` (shared by all
    entities) applies inside each objective; warm starts and priors arrive
    in the original feature space and the coefficients leave in it.
    ``prior_coefficients`` / ``prior_variances`` are (E, d) per-entity
    Gaussian MAP priors. The solver is ``select_minimize_fn(config,
    l1_weight)``'s, over each bucket's lanes. With ``mesh`` the buckets are
    ``prepare_buckets(mesh=)``'s shards, ``offsets`` lies on the mesh's
    head device and the visit ends with one combine (``_combine_shards``;
    owned buckets: this process's solved as without a mesh, then
    ``_combine_owned`` across processes).
    Every bucket solve counts ``re_solve.launches``; the entity-iteration
    counts read the iterations back once, at the end, only while
    ``iter_accounting_enabled``.

    Without a lane-sharded mesh, ``PHOTON_RE_FUSE_BUCKETS`` solves
    ``_fusion_units(prepared)`` (or the caller's ``fusion_units``, the same
    units staged once) and ``PHOTON_RE_COMPACT_EVERY`` runs each launch
    compacted (module docstring); the per-entity diagnostics come back per
    bucket either way."""
    if norm is not None and any(pb.columns is not None for pb in prepared):
        # before any bucket solves, not data-dependently mid-loop
        raise NotImplementedError(
            "normalization is not supported together with per-entity subspace projection "
            "(the per-entity column maps would need per-entity normalization slices)"
        )
    minimize_fn, extra = select_minimize_fn(config, l1_weight)
    dev = offsets.device
    d, E = num_features, num_entities
    if initial_coefficients is None:
        W = torch.zeros((E, d), dtype=torch.float32, device=dev)
    else:
        # a copy: W is written in place bucket by bucket
        W = torch.as_tensor(initial_coefficients, dtype=torch.float32, device=dev).clone()
        if norm is not None:
            W = norm.model_from_original_space(W)
    prior_mu = prior_var = None
    if prior_coefficients is not None:
        # the per-entity MAP prior arrives in the original feature space too
        prior = GaussianPrior.from_coefficients(
            torch.as_tensor(prior_coefficients, device=dev),
            None if prior_variances is None else torch.as_tensor(prior_variances, device=dev),
            norm,
        )
        prior_mu, prior_var = prior.means, prior.variances
    compute_variance = variance_computation is not VarianceComputationType.NONE
    V = torch.zeros((E, d), dtype=torch.float32, device=dev) if compute_variance else None
    l2 = torch.as_tensor(l2_weight, dtype=torch.float32, device=dev)

    kw = dict(loss=loss, config=config, intercept_index=intercept_index,
              variance_computation=variance_computation, minimize_fn=minimize_fn, minimize_kwargs=extra)
    acct = DeferredLaunchAccounting()
    owned = any(pb.owner is not None for pb in prepared)
    if owned or mesh is None:
        # whole buckets (owned mode: this process's, each as without a
        # mesh), in launch units: one per bucket, or fused by geometry
        ce = compact_every()
        chunked = select_chunked_solver(config, l1_weight)[0] if ce > 0 else None
        if fuse_buckets() and len(prepared) > 1:
            units = fusion_units if fusion_units is not None else _fusion_units(prepared)
        elif any(pb.parent is not None for pb in prepared):
            # a split's atoms launch per parent again, fusion or not
            units = fusion_units if fusion_units is not None else _parent_units(prepared)
        else:
            units = [(pb, [(i, 0, pb.num_real)]) for i, pb in enumerate(prepared)]
        pid = as_process_mesh(mesh).process_index if owned else None
        # PHOTON_RE_DEVICE_SPLIT: each mesh entry solves on its own copy of
        # the matrices, offsets and priors (its buckets' tensors lie there)
        local = {dv: {key: None if t is None else t.to(as_process_mesh(mesh).local[dv], copy=True)
                      for key, t in (("W", W), ("V", V), ("offsets", offsets), ("mu", prior_mu),
                                     ("var", prior_var))}
                 for dv in sorted({pb.device for pb in prepared if pb.device is not None})}
        diag = [None] * len(prepared)
        for pb, members in units:
            if owned and pb.owner != pid:
                continue  # another process's: its rows arrive in the combine
            st = local.get(pb.device)
            step = _bucket_step(
                W if st is None else st["W"], V if st is None else st["V"],
                offsets if st is None else st["offsets"], pb, l2 if st is None else l2.to(st["W"].device),
                norm if st is None or norm is None else norm.to(st["W"].device),
                prior_mu if st is None else st["mu"], prior_var if st is None else st["var"],
                chunked=chunked, compact_every_n=ce, **kw)
            if chunked is None:
                acct.add(step[1], pb.static.labels.shape[0])
            for i, lo, hi in members:
                whole = lo == 0 and hi == pb.num_real
                diag[i] = (prepared[i].entity_ids, *(t if whole else t[lo:hi] for t in step))
        if local:
            _combine_device_local(prepared, W, V, local, pid, diag)
        if owned and as_process_mesh(mesh).spans_processes:
            diag = _combine_owned_results(as_process_mesh(mesh), W, V, prepared, diag)
    else:
        solved = []
        for pb in prepared:
            step = _shard_step(W, offsets, pb, l2, norm, prior_mu, prior_var, **kw)
            acct.add(step[3], pb.static.labels.shape[0])
            solved.append((pb, step))
        diag = _combine_shards(as_process_mesh(mesh), W, V, solved)
    acct.flush()
    if norm is not None:
        W = norm.model_to_original_space(W)[0]
        if V is not None:
            V = norm.factors**2 * V
    return RandomEffectTrainingResult(
        coefficients=W, variances=V, diag_refs=tuple(diag), num_entities=E
    )


def _extract_lanes(M: Tensor | None, ids: Tensor, columns: Tensor | None) -> Tensor | None:
    """One bucket's rows of an (E, d) matrix (the warm-start / prior lanes),
    at each entity's subspace columns when given."""
    if M is None:
        return None
    rows = M[ids]
    return rows if columns is None else torch.gather(rows, 1, columns)


def _scatter_lanes(W: Tensor, V: Tensor | None, ids: Tensor, columns: Tensor | None,
                   w_b: Tensor, var_b: Tensor | None) -> None:
    """Write a solved bucket's lanes back into the (E, d) matrices; under
    subspace projection the columns outside an entity's subspace are 0."""
    for M, lanes in ((W, w_b), (V, var_b)):
        if M is None:
            continue
        if columns is None:
            M[ids] = lanes
        else:
            M[ids] = 0.0
            M[ids[:, None], columns] = lanes


def _solve_lanes(
    batch: DenseBatch | SparseBatch,
    w0: Tensor,
    l2_weight: Tensor,
    norm: NormalizationContext | None,
    prior_mu: Tensor | None,
    prior_var: Tensor | None,
    *,
    loss: PointwiseLoss,
    config: OptimizerConfig,
    intercept_index: int | None,
    variance_computation: VarianceComputationType,
    minimize_fn,
    minimize_kwargs: dict,
) -> tuple[Tensor, Tensor | None, Tensor, Tensor, Tensor, Tensor]:
    """Solve a bucket's k lanes together from the (k, d) start ``w0`` (the
    solver's space) under the per-lane prior rows; returns the lanes' (w,
    variances or None, final objective, iterations, reason, objective
    passes), all on the device."""
    obj = make_lane_objective(
        batch, loss, l2_weight=l2_weight, norm=norm, intercept_index=intercept_index,
        prior_mean=prior_mu, prior_variances=prior_var,
    )
    res = minimize_fn(obj, w0, config, **minimize_kwargs)
    var = compute_variances(obj, res.w, variance_computation)
    return res.w, var, res.value, res.iterations, res.reason, res.objective_passes


def _bucket_step(
    W: Tensor,
    V: Tensor | None,
    offsets: Tensor,
    pb: PreparedBucket,
    l2_weight: Tensor,
    norm: NormalizationContext | None,
    prior_mu: Tensor | None,
    prior_var: Tensor | None,
    *,
    loss: PointwiseLoss,
    config: OptimizerConfig,
    intercept_index: int | None,
    variance_computation: VarianceComputationType,
    minimize_fn,
    minimize_kwargs: dict,
    chunked=None,
    compact_every_n: int = 0,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """One bucket (or fused unit): gather its rows' residual offsets,
    extract the warm-start and prior lanes (folded under a hash
    projection), solve the k lanes together, in one launch or compacted
    (``chunked``), and scatter the solutions (and variances), expanded
    back to the support, into W (and V) in place. Returns the lanes' (k,)
    final objective, iterations, reason and objective passes."""
    batch = dataclasses.replace(pb.static, offsets=offsets[pb.row_idx] * pb.mask)
    w0, mu, var0 = (_extract_lanes(M, pb.ids, pb.columns) for M in (W, prior_mu, prior_var))
    intercept_index = _solve_intercept(pb, intercept_index)
    if pb.hash_S is not None:
        w0, mu, var0 = _hash_fold_lanes(w0, mu, var0, pb.hash_S)
    solve = _solve_lanes if chunked is None else functools.partial(
        _solve_bucket_compacted, chunked=chunked, compact_every_n=compact_every_n)
    w, var, *diag = solve(
        batch, w0, l2_weight, norm, mu, var0, loss=loss, config=config, intercept_index=intercept_index,
        variance_computation=variance_computation, minimize_fn=minimize_fn, minimize_kwargs=minimize_kwargs,
    )
    if pb.hash_S is not None:
        w, var = _hash_expand_lanes(w, var, pb.hash_S)
    _scatter_lanes(W, V, pb.ids, pb.columns, w, var)
    return tuple(diag)


def _solve_intercept(pb: PreparedBucket, intercept_index: int | None) -> int | None:
    """The intercept's slot in a bucket's solve: the last of each subspace
    (the intercept is the last column, columns ascend), and the last hash
    slot, which the fold keeps for it alone."""
    if intercept_index is None:
        return None
    if pb.hash_S is not None:
        return pb.hash_S.shape[1] - 1
    return intercept_index if pb.columns is None else pb.columns.shape[1] - 1


def _hash_fold_lanes(w0: Tensor, mu: Tensor | None, var: Tensor | None, hash_S: Tensor):
    """A bucket's support-width warm-start and prior lanes folded to the
    hash width: the prior's means and variances together (by precision),
    so the folded penalty is the full one restricted to the subspace; means
    alone fold like a warm start (no variances: the plain-L2 prior)."""
    w0 = hash_fold_warm_start(w0, hash_S)
    if mu is not None and var is not None:
        mu, var = hash_fold_prior(mu, var, hash_S)
    elif mu is not None:
        mu = hash_fold_warm_start(mu, hash_S)
    return w0, mu, var


def _hash_expand_lanes(w: Tensor, var: Tensor | None, hash_S: Tensor):
    return hash_expand_coefficients(w, hash_S), None if var is None else hash_expand_variances(var, hash_S)


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _pad_lanes(M: Tensor | None, lanes: int, fill: float = 0.0) -> Tensor | None:
    """``M``'s rows grown to ``lanes`` rows of ``fill`` (the padding lanes)."""
    if M is None or M.shape[0] == lanes:
        return M
    return torch.cat([M, M.new_full((lanes - M.shape[0],) + tuple(M.shape[1:]), fill)])


def _shard_step(
    W: Tensor,
    offsets: Tensor,
    pb: PreparedBucket,
    l2_weight: Tensor,
    norm: NormalizationContext | None,
    prior_mu: Tensor | None,
    prior_var: Tensor | None,
    **kw,
) -> tuple:
    """One shard's lanes of a bucket, on the shard's device: the residual
    offsets gathered there, the warm-start and prior rows of its real lanes
    (zeros, and unit prior variances, on the padding lanes), the lane
    solve. Returns the real lanes' (w, variances or None, final objective,
    iterations, reason, objective passes), on the shard's device."""
    dev = pb.static.labels.device
    k, lanes = pb.num_real, pb.static.labels.shape[0]
    cols = None if pb.columns is None else pb.columns[:k]
    intercept_index = _solve_intercept(pb, kw.pop("intercept_index"))
    with _on(dev):
        ids = pb.ids
        batch = dataclasses.replace(pb.static, offsets=offsets.to(dev)[pb.row_idx] * pb.mask)

        def lanes_of(M, fill=0.0):
            return None if M is None else _pad_lanes(_extract_lanes(M.to(dev), ids, cols), lanes, fill)

        w0, mu, var0 = lanes_of(W), lanes_of(prior_mu), lanes_of(prior_var, 1.0)
        if pb.hash_S is not None:
            w0, mu, var0 = _hash_fold_lanes(w0, mu, var0, pb.hash_S)
        w, var, *diag = _solve_lanes(
            batch, w0, l2_weight.to(dev), None if norm is None else norm.to(dev), mu, var0,
            intercept_index=intercept_index, **kw,
        )
        if pb.hash_S is not None:
            w, var = _hash_expand_lanes(w, var, pb.hash_S)
    return tuple(None if t is None else t[:k] for t in (w, var, *diag))


def _combine_shards(mesh: ProcessMesh, W: Tensor, V: Tensor | None, solved: list) -> list:
    """Write every shard's solutions into W (and V), on the head device, and
    return the per-entity diagnostics, one entry per (bucket, shard) in
    that order. Across processes every process's solved lanes (ids, rows,
    variances, column maps, diagnostics) travel in one host gather and are
    written in rank order, so every process ends with the same bytes."""
    head = W.device
    if not mesh.spans_processes:
        diag = []
        for pb, (w, var, *d) in solved:
            cols = None if pb.columns is None else pb.columns[: pb.num_real].to(head)
            _scatter_lanes(W, V, pb.ids.to(head), cols, w.to(head), None if var is None else var.to(head))
            diag.append(((pb.bucket, pb.shard), pb.entity_ids, *(t.to(head) for t in d)))
    else:
        from photon_ml_tpu_torch.parallel.multihost import _gather_objects

        def host(t):
            return None if t is None else t.detach().cpu().numpy()

        mine = [((pb.bucket, pb.shard), pb.entity_ids, host(w), host(var),
                 None if pb.columns is None else host(pb.columns[: pb.num_real]), [host(t) for t in d])
                for pb, (w, var, *d) in solved]
        diag = []
        for rank in _gather_objects(mine):
            for where, ids, w, var, cols, d in rank:
                ids_t = torch.as_tensor(ids, dtype=torch.int64, device=head)
                _scatter_lanes(W, V, ids_t, None if cols is None else torch.as_tensor(cols, device=head),
                               torch.as_tensor(w, device=head),
                               None if var is None else torch.as_tensor(var, device=head))
                diag.append((where, ids, *(torch.as_tensor(t) for t in d)))
    diag.sort(key=lambda e: e[0])
    return [e[1:] for e in diag]


# seconds, calls and bytes of the owned-bucket combines since the last reset
combine_stats: dict = {"seconds": 0.0, "calls": 0, "bytes": 0}


def reset_combine_stats() -> None:
    combine_stats.update(seconds=0.0, calls=0, bytes=0)


def _combine_device_local(prepared: list, W: Tensor, V: Tensor | None, local: dict, pid: int | None,
                          diag: list) -> None:
    """The device split's fold: each owned bucket's rows copied from its
    mesh entry's matrices into W (and V), and its diagnostics moved to W's
    device (the result reads every bucket's in one ``torch.cat``), in
    place. Entity ids partition the buckets, so the rows are disjoint and
    arrive with the bits their entry wrote."""
    for i, pb in enumerate(prepared):
        if pb.device is None or (pb.owner is not None and pb.owner != pid):
            continue
        st = local[pb.device]
        ids = torch.as_tensor(pb.entity_ids, dtype=torch.int64, device=W.device)
        W[ids] = st["W"][pb.ids].to(W.device)
        if V is not None:
            V[ids] = st["V"][pb.ids].to(V.device)
        diag[i] = (diag[i][0], *(t.to(W.device) for t in diag[i][1:]))


def _combine_owned_results(mesh: ProcessMesh, W: Tensor, V: Tensor | None, prepared: list, diag: list) -> list:
    """The owned-bucket combine by ``PHOTON_RE_COMBINE``: the dense buffer
    (``_combine_owned``) or each owner's segments
    (``_combine_owned_segments``), the same bits either way."""
    if re_combine_mode() == "segments":
        return _combine_owned_segments(mesh, W, V, prepared, diag)
    return _combine_owned(mesh, W, V, prepared, diag)


def _owned_rows(W: Tensor, V: Tensor | None, prepared: list, own: list):
    """This process's owned buckets' coefficient and variance rows, host
    float32 in owned-bucket order."""
    ids = np.concatenate([np.zeros(0, np.int64)] + [prepared[i].entity_ids for i in own])
    ids = torch.as_tensor(ids, dtype=torch.int64, device=W.device)
    return W[ids].cpu().numpy(), None if V is None else V[ids].cpu().numpy()


def _owned_diag(diag: list, own: list) -> np.ndarray:
    """The owned buckets' diagnostics as (4, Σ lanes) float64 in the same
    order: final objective, iterations, reason, objective passes."""
    return np.concatenate([np.zeros((4, 0))] + [torch.stack([t.detach().cpu().double() for t in diag[i][1:]])
                                                 .numpy() for i in own], axis=1)


def _fill_remote(W: Tensor, V: Tensor | None, pb: PreparedBucket, W_rows: np.ndarray, V_rows, D: np.ndarray):
    """A bucket another process owns: its rows written into W (and V) by
    overwrite, and its diagnostics entry, cast as the owner's were."""
    ids = torch.as_tensor(pb.entity_ids, dtype=torch.int64, device=W.device)
    W[ids] = torch.from_numpy(np.array(W_rows, np.float32)).to(W.device)
    if V is not None:
        V[ids] = torch.from_numpy(np.array(V_rows, np.float32)).to(V.device)
    return (pb.entity_ids, torch.from_numpy(D[0].astype(np.float32)).to(W.device),
            *(torch.from_numpy(D[j].astype(np.int64)).to(W.device) for j in (1, 2, 3)))


def _combine_owned(mesh: ProcessMesh, W: Tensor, V: Tensor | None, prepared: list, diag: list) -> list:
    """The owned-bucket combine: every process's owned buckets' rows,
    variances and diagnostics (final objective, iterations, reason,
    objective passes) packed in bucket order into one dense buffer of Σ
    lanes rows (zeros where another process owns the bucket), one host
    gather of every process's buffer, then each other-owned bucket's rows
    copied from its owner's buffer into W (and V) and its diagnostics
    filled in. Each row is taken from its owner's buffer by overwrite,
    never summed, so its bits arrive as the owner wrote them, -0.0
    included. Returns the diagnostics, one entry per bucket."""
    from photon_ml_tpu_torch.parallel.multihost import _gather_arrays

    t0 = time.perf_counter()
    ks = [pb.num_real for pb in prepared]
    offs = np.concatenate([[0], np.cumsum(ks)]).astype(np.int64)
    total, d = int(offs[-1]), int(W.shape[1])
    Wc = np.zeros((total, d), np.float32)
    Vc = np.zeros((total, d), np.float32) if V is not None else None
    Dc = np.zeros((4, total), np.float64)  # final objective, iterations, reason, objective passes
    own = [i for i, pb in enumerate(prepared) if pb.owner == mesh.process_index]
    (W_own, V_own), D_own = _owned_rows(W, V, prepared, own), _owned_diag(diag, own)
    lo = 0
    for i in own:
        a, b = int(offs[i]), int(offs[i + 1])
        Wc[a:b] = W_own[lo:lo + b - a]
        if Vc is not None:
            Vc[a:b] = V_own[lo:lo + b - a]
        Dc[:, a:b] = D_own[:, lo:lo + b - a]
        lo += b - a
    parts = [Wc, Dc] + ([] if Vc is None else [Vc])
    gathered = _gather_arrays(parts)
    nbytes = sum(a.nbytes for a in parts) * (mesh.process_count - 1)
    out = list(diag)
    for i, pb in enumerate(prepared):
        if pb.owner == mesh.process_index:
            continue
        a, b = int(offs[i]), int(offs[i + 1])
        got = gathered[pb.owner]
        out[i] = _fill_remote(W, V, pb, got[0][a:b], None if V is None else got[2][a:b], got[1][:, a:b])
    seconds = time.perf_counter() - t0
    combine_stats["seconds"] += seconds
    combine_stats["calls"] += 1
    combine_stats["bytes"] += nbytes
    REGISTRY.counter_inc("re_combine.exchanges")
    REGISTRY.counter_inc("re_combine.bytes_sent", float(nbytes))
    emit_event("re_combine", mode="allreduce", bytes_sent=int(nbytes), buckets_owned=len(own),
               buckets=len(prepared), seconds=seconds)
    return out


def _segment_widths(prepared: list, d: int) -> list[int]:
    """Each bucket's segment row width: the class support's under a
    projection (the zeros off it are rebuilt on arrival), else d."""
    return [d if pb.project is None else int(pb.project.support_dim) for pb in prepared]


def _pack_wv_segments(prepared: list, W_own: np.ndarray, V_own: np.ndarray | None, own: list) -> bytes:
    """This owner's coefficient rows, then its variance rows, as raw
    float32 in owned-bucket order, each bucket at its segment width. No
    header: every process derives each owner's buckets, lanes and widths
    from the same plan."""
    widths = _segment_widths(prepared, int(W_own.shape[1]))

    def pack(M):
        parts, lo = [], 0
        for i in own:
            hi = lo + prepared[i].num_real
            rows = M[lo:hi] if widths[i] == M.shape[1] else M[lo:hi][:, prepared[i].project.columns]
            parts.append(np.ascontiguousarray(rows, np.float32).tobytes())
            lo = hi
        return b"".join(parts)

    return pack(W_own) + (b"" if V_own is None else pack(V_own))


def _pack_diag_segments(D_own: np.ndarray) -> bytes:
    """The owned lanes' diagnostics: the final objectives as float32 (the
    solve's own type), then iterations, reasons and objective passes as
    int32; their casts on arrival give the dense combine's bits."""
    return (np.asarray(D_own[0], np.float32).tobytes() + np.asarray(D_own[1:], np.int32).tobytes())


def _apply_owner_segments(prepared: list, W: Tensor, V: Tensor | None, diag: list, wv_frames: list,
                          diag_frames: list, pid: int) -> list:
    """Every other owner's segments written into W (and V) and the
    diagnostics. Each frame's layout follows from the plan every process
    holds; a frame of another length means the processes' plans disagree,
    and raises."""
    d = int(W.shape[1])
    widths = _segment_widths(prepared, d)
    out = list(diag)
    for q, (wv, dg) in enumerate(zip(wv_frames, diag_frames)):
        if q == pid:
            continue
        mine = [i for i, pb in enumerate(prepared) if pb.owner == q]
        lanes = sum(prepared[i].num_real for i in mine)
        floats = sum(prepared[i].num_real * widths[i] for i in mine)
        if len(wv) != 4 * floats * (1 if V is None else 2) or len(dg) != 16 * lanes:
            raise RuntimeError(f"owner-segment combine: process {q}'s segments do not match this process's "
                               "placement plan (the plans disagree across processes)")
        flat = np.frombuffer(wv, np.float32)
        D = np.empty((4, lanes), np.float64)
        D[0] = np.frombuffer(dg, np.float32, count=lanes)
        D[1:] = np.frombuffer(dg, np.int32, offset=4 * lanes).reshape(3, lanes)
        lo = dlo = 0
        for i in mine:
            pb, k, width = prepared[i], prepared[i].num_real, widths[i]

            def rows(base):
                block = flat[base + lo:base + lo + k * width].reshape(k, width)
                if width == d:
                    return block
                full = np.zeros((k, d), np.float32)
                full[:, pb.project.columns] = block
                return full

            out[i] = _fill_remote(W, V, pb, rows(0), None if V is None else rows(floats), D[:, dlo:dlo + k])
            lo += k * width
            dlo += k
    return out


def _combine_owned_segments(mesh: ProcessMesh, W: Tensor, V: Tensor | None, prepared: list,
                            diag: list) -> list:
    """The owner-segment combine (``PHOTON_RE_COMBINE=segments``): each
    owner sends its packed segments alone (``_pack_wv_segments``,
    ``_pack_diag_segments``, raw bytes riding as one uint8 array) to every
    other process over the framed mesh on the exchange worker
    (``multihost.allgather_obj_p2p_async``, tags ``re_combine/wv`` and
    ``re_combine/diag``, as the reference's), the coefficient rows first,
    so their transfer overlaps the diagnostics' packing. O(E·d) bytes a
    process against the dense combine's O(P·E·d); each row is written by
    its one owner either way, so the result is the dense combine's bit for
    bit."""
    from photon_ml_tpu_torch.parallel import multihost as mh

    t0 = time.perf_counter()
    own = [i for i, pb in enumerate(prepared) if pb.owner == mesh.process_index]
    wv_stats, diag_stats = {}, {}

    def frames(payload: bytes) -> np.ndarray:
        return np.frombuffer(payload, np.uint8)

    wv_handle = mh.allgather_obj_p2p_async(frames(_pack_wv_segments(prepared, *_owned_rows(W, V, prepared, own),
                                                                     own)), tag="re_combine/wv", stats=wv_stats)
    diag_handle = mh.allgather_obj_p2p_async(frames(_pack_diag_segments(_owned_diag(diag, own))),
                                             tag="re_combine/diag", stats=diag_stats)
    t_wait = time.perf_counter()
    wv_frames = [np.asarray(f).tobytes() for f in wv_handle.result()]
    diag_frames = [np.asarray(f).tobytes() for f in diag_handle.result()]
    waited = time.perf_counter() - t_wait
    bytes_sent = int(wv_stats.get("bytes_sent", 0) + diag_stats.get("bytes_sent", 0))
    exchange_s = float(wv_stats.get("exchange_s", 0.0) + diag_stats.get("exchange_s", 0.0))
    REGISTRY.counter_inc("re_combine.exchanges")
    REGISTRY.counter_inc("re_combine.bytes_sent", float(bytes_sent))
    REGISTRY.timer_add("re_combine.exchange_s", exchange_s)
    REGISTRY.timer_add("re_combine.wait_s", waited)
    if exchange_s > 0.0:
        REGISTRY.gauge_set("re_combine.overlap_ratio", max(0.0, min(1.0, 1.0 - waited / exchange_s)))
    emit_event("re_combine", mode="segments", bytes_sent=bytes_sent, exchange_s=exchange_s, wait_s=waited,
               buckets_owned=len(own), buckets=len(prepared))
    out = _apply_owner_segments(prepared, W, V, diag, wv_frames, diag_frames, mesh.process_index)
    combine_stats["seconds"] += time.perf_counter() - t0
    combine_stats["calls"] += 1
    combine_stats["bytes"] += bytes_sent
    return out


def plan_fusion_groups(keys: list, lanes: list[int]) -> list[tuple[list[int], list[tuple[int, int, int]]]]:
    """The launch-fusion bookkeeping (the reference's, which its fused
    launch schedules and the owned-bucket placement share): an ordered
    group-by of ``keys`` with each member's ``(index, lo, hi)`` lane range
    in the group's concatenation, groups in first-seen key order. A bucket
    of fewer than 2 lanes never joins a group: a 1-lane solve does not
    give the bits of the same lane in a batch."""
    groups: dict = {}
    for i, key in enumerate(keys):
        if lanes[i] < 2:
            key = ("__solo__", i)
        groups.setdefault(key, []).append(i)
    plan = []
    for idxs in groups.values():
        members, lo = [], 0
        for i in idxs:
            members.append((i, lo, lo + lanes[i]))
            lo += lanes[i]
        plan.append((idxs, members))
    return plan


def _bucket_geometry(pb: PreparedBucket) -> tuple:
    """The launch geometry of a prepared bucket: its static tensors' kind,
    shapes past the lane axis and dtypes, its capacity, its solve width
    and its hash fold's. Buckets of one geometry solve as one launch
    unit with their lanes concatenated."""
    static = tuple(
        (f.name, tuple(v.shape[1:]), str(v.dtype)) if isinstance(v, Tensor) else (f.name, v)
        for f in dataclasses.fields(pb.static) for v in (getattr(pb.static, f.name),)
    )
    return (
        type(pb.static).__name__, static, tuple(pb.row_idx.shape[1:]), str(pb.row_idx.device),
        None if pb.columns is None else pb.columns.shape[1],
        None if pb.hash_S is None else tuple(pb.hash_S.shape),
    )


def _fusion_units(prepared: list[PreparedBucket]) -> list[tuple[PreparedBucket, list[tuple[int, int, int]]]]:
    """Same-geometry buckets fused into launch units (``PHOTON_RE_FUSE_BUCKETS``):
    ``(unit, members)`` pairs, ``members`` each bucket's ``(index, lo, hi)``
    lane range in the unit, through which the diagnostics are sliced back.
    Entity ids partition the buckets, so the unit's scatter writes the
    same rows. A bucket another process owns stays a unit of its own, and
    only buckets on one mesh entry fuse."""
    return _concat_units(prepared, [("__remote__", i) if pb.static is None else (_bucket_geometry(pb), pb.device)
                                    for i, pb in enumerate(prepared)])


def _parent_units(prepared: list[PreparedBucket]) -> list[tuple[PreparedBucket, list[tuple[int, int, int]]]]:
    """``PHOTON_RE_SPLIT``'s launch units with fusion off: the atoms of one
    parent that this process holds on one mesh entry, concatenated again.
    Atoms are contiguous in-order slices of their parent, so a parent held
    whole launches with the unsplit lanes in the unsplit order; a parent
    split between owners launches its owned lanes together (each atom has
    two lanes or more). Unsplit and remote buckets stay units of their own."""
    return _concat_units(prepared, [
        ("__remote__", i) if pb.static is None
        else ("__own_solo__", i) if pb.parent is None
        else ("__parent__", pb.parent, pb.device)
        for i, pb in enumerate(prepared)])


def _concat_units(prepared: list[PreparedBucket],
                  keys: list) -> list[tuple[PreparedBucket, list[tuple[int, int, int]]]]:
    """One launch unit per ``plan_fusion_groups`` group of ``keys``: the
    members' static tensors concatenated along the lanes (a copy), a
    group of one passed through."""
    units = []
    for idxs, members in plan_fusion_groups(keys, [pb.num_real for pb in prepared]):
        if len(idxs) == 1:
            units.append((prepared[idxs[0]], members))
            continue
        group = [prepared[i] for i in idxs]
        first = group[0]
        static = dataclasses.replace(first.static, **{
            f.name: torch.cat([getattr(pb.static, f.name) for pb in group])
            for f in dataclasses.fields(first.static) if isinstance(getattr(first.static, f.name), Tensor)})
        units.append((PreparedBucket(
            entity_ids=np.concatenate([pb.entity_ids for pb in group]), ids=torch.cat([pb.ids for pb in group]),
            static=static, row_idx=torch.cat([pb.row_idx for pb in group]),
            mask=torch.cat([pb.mask for pb in group]),
            columns=None if first.columns is None else torch.cat([pb.columns for pb in group]),
            bucket=first.bucket, owner=first.owner, parent=first.parent, device=first.device,
            project=first.project, hash_S=first.hash_S,
        ), members))
    return units


def _placement_weights(buckets: EntityBuckets, lane_dims) -> np.ndarray:
    """Each bucket's placement weight (``placement_weights``): its active
    rows, or its lanes at ``lane_dims`` floats."""
    return placement_weights([len(e) for e in buckets.entity_ids],
                             [int(np.sum(np.asarray(r) >= 0)) for r in buckets.row_indices], lane_dims)


def _placement_groups(buckets: EntityBuckets, parents) -> list | None:
    """The units placed whole: the fusion groups (keyed by capacity, which
    fixes a bucket's geometry before staging) of an unsplit preparation;
    every sub-bucket atom on its own under a split (``_parent_units``
    launches an owner's atoms of one class together again)."""
    if parents is not None:
        return None
    keys = [int(np.asarray(r).shape[1]) for r in buckets.row_indices]
    return [idxs for idxs, _ in plan_fusion_groups(keys, [len(e) for e in buckets.entity_ids])]


def _plan_bucket_owners(buckets: EntityBuckets, num_processes: int, process_index: int, parents=None,
                        split_classes: int = 0, lane_dims=None) -> np.ndarray:
    """Whole-bucket owners over ``num_processes``, decided before any
    staging: LPT over Σ active rows (Zipf traffic puts most rows behind a
    few head entities, so counting buckets or entities would not balance;
    lanes under ``PHOTON_RE_SPLIT_WEIGHT=bytes``), the placement units of
    ``_placement_groups`` placed whole. The same host arithmetic on the
    same buckets on every process gives every process the same plan; its
    gauges go to the registry (``record_placement_metrics``)."""
    groups = _placement_groups(buckets, parents)
    plan = plan_shard_placement(_placement_weights(buckets, lane_dims), num_processes, groups=groups)
    record_placement_metrics(plan, shard=process_index,
                             atoms=len(buckets.entity_ids) if groups is None else len(groups),
                             split_classes=split_classes)
    return plan.owner


def _plan_bucket_devices(buckets: EntityBuckets, parents, owners: np.ndarray, process_index: int,
                         num_devices: int, lane_dims=None) -> np.ndarray | None:
    """The second placement level (``PHOTON_RE_DEVICE_SPLIT``): this
    process's owned buckets on its ``num_devices`` local mesh entries by
    the same rule and units as the process level. Local entry ordinals,
    -1 for buckets another process owns; None with the knob off or fewer
    than two entries, which keeps the one-level preparation."""
    if not re_device_split_enabled() or num_devices < 2:
        return None
    device, plan = plan_device_placement(_placement_weights(buckets, lane_dims), owners, process_index,
                                         num_devices, groups=_placement_groups(buckets, parents))
    record_device_placement_metrics(plan)
    return device


# ---------------------------------------------------------------------------
# the eager bucket-solve entry point (the out-of-core trainer's)
# ---------------------------------------------------------------------------
# the lane solves since the last reset; the registry's ``re_solve.*``
# counters take the same increments
launch_counts = {"launches": 0, "executed_entity_iterations": 0, "useful_entity_iterations": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def iter_accounting_enabled() -> bool:
    """Whether a lane solve's iterations are read back for the executed and
    useful entity-iteration counts: a read of the card the solve loop does
    not otherwise need, so it is on only while a telemetry sink is active
    or with ``PHOTON_RE_ITER_ACCOUNTING=1`` (``=0`` forces it off), as in
    the reference."""
    env = os.environ.get("PHOTON_RE_ITER_ACCOUNTING")
    if env is not None and env != "":
        return int(env) != 0
    return obs_sink.is_active()


class DeferredLaunchAccounting:
    """Launch accounting that never waits for the card inside a solve
    loop: ``add`` counts the launch at once and, when
    ``iter_accounting_enabled``, keeps the per-lane iteration tensor;
    ``flush`` reads every kept tensor back in one transfer, after the loop
    has waited for its last solve anyway, and adds executed (lanes × the
    slowest lane's iterations: the lanes step in lock step) and useful (Σ
    iterations) entity iterations to ``launch_counts`` and the registry
    (``re_solve.*``, with the ``re_solve.active_lane_fraction`` gauge)."""

    def __init__(self) -> None:
        self._pending: list[tuple[Tensor, int]] = []

    def add(self, it_lane: Tensor, lanes: int) -> None:
        _count_launch()
        if iter_accounting_enabled():
            self._pending.append((it_lane, int(lanes)))

    def flush(self) -> None:
        if not self._pending:
            return
        flat = [torch.as_tensor(it).reshape(-1).long() for it, _ in self._pending]
        # one read-back: a mesh's shards meet on the first one's device first
        its = torch.cat([t.to(flat[0].device) for t in flat]).cpu().numpy()
        lo = 0
        for it, lanes in self._pending:
            n = torch.as_tensor(it).numel()
            part = its[lo:lo + n]
            lo += n
            executed, useful = int(part.max(initial=0)) * lanes, int(part.sum())
            _count_iterations(executed, useful)
            if executed:
                REGISTRY.gauge_set("re_solve.active_lane_fraction", useful / executed)
        self._pending.clear()


def _count_launch() -> None:
    launch_counts["launches"] += 1
    REGISTRY.counter_inc("re_solve.launches")


def _count_iterations(executed: int, useful: int) -> None:
    launch_counts["executed_entity_iterations"] += executed
    launch_counts["useful_entity_iterations"] += useful
    REGISTRY.counter_inc("re_solve.executed_entity_iterations", float(executed))
    REGISTRY.counter_inc("re_solve.useful_entity_iterations", float(useful))


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def _solve_bucket_compacted(
    batch: DenseBatch | SparseBatch,
    w0: Tensor,
    l2_weight: Tensor,
    norm: NormalizationContext | None,
    prior_mu: Tensor | None,
    prior_var: Tensor | None,
    *,
    chunked,
    compact_every_n: int,
    loss: PointwiseLoss,
    config: OptimizerConfig,
    intercept_index: int | None,
    variance_computation: VarianceComputationType,
    minimize_fn=None,
    minimize_kwargs: dict,
) -> tuple[Tensor, Tensor | None, Tensor, Tensor, Tensor, Tensor]:
    """``_solve_lanes``'s compacted twin (``PHOTON_RE_COMPACT_EVERY``): the
    same arguments and outputs, the solve run through ``chunked``'s init,
    one run per chunk of ``compact_every_n`` iterations, and finalize.

    After each chunk the front's ``done`` and ``it`` are read back once
    (that read is the design: it buys dropping converged lanes from every
    later chunk). The front's lanes go back to their slots in the full
    state only when a chunk reads the full state (a shrink, or the end);
    the still-active lanes are then gathered, with their batch rows, prior
    rows and solver state, into a front of the next power of two (at least
    2 lanes for a bucket of more than one, never more than the current
    front; no re-gather when it would not shrink), whose padding lanes
    replay the first active lane, marked done. The front's objective is
    built anew on the gathered rows. Counts ``re_solve.launches`` (init,
    each chunk, finalize) and, from the reads, the executed and useful
    entity iterations and ``re_solve.active_lane_fraction``."""
    k = int(batch.labels.shape[0])
    T = int(config.max_iterations)
    every = max(int(compact_every_n), 1)
    dev = w0.device

    def objective(b, mu, var):
        return make_lane_objective(b, loss, l2_weight=l2_weight, norm=norm, intercept_index=intercept_index,
                                   prior_mean=mu, prior_variances=var)

    full_obj = objective(batch, prior_mu, prior_var)
    full = chunked.init(full_obj, w0, config, **minimize_kwargs)
    _count_launch()
    state, front_obj = full, full_obj
    slots = np.arange(k, dtype=np.int64)  # each real front lane's slot in the bucket
    n_real, compacted = k, False
    it_prev = np.zeros(k, np.int64)
    executed_total = useful_total = bound = 0
    while True:
        bound = min(bound + every, T)
        state = chunked.run(front_obj, state, config, bound, **minimize_kwargs)
        _count_launch()
        read = torch.stack([state.done.to(torch.int64), state.it]).cpu().numpy()
        front_lanes = read.shape[1]  # padding lanes included
        done_f, it_f = read[0, :n_real] != 0, read[1, :n_real]
        # lanes step together: every active lane is at the shared step,
        # which keys the two-loop bound and the history column
        if not np.all(it_f[~done_f] == state.step):
            raise AssertionError(f"an active lane is not at the shared step {state.step}: {it_f[~done_f]}")
        delta = it_f - it_prev[slots]
        trips = int(delta.max(initial=0))
        executed_total += trips * front_lanes
        useful_total += int(delta.sum())
        _count_iterations(trips * front_lanes, int(delta.sum()))
        it_prev[slots] = it_f
        active = np.flatnonzero(~done_f)
        exit_loop = active.size == 0 or bound >= T
        if not exit_loop:
            front_n = _next_pow2(int(active.size))
            if k > 1:
                front_n = max(front_n, 2)
            front_n = min(front_n, front_lanes)
            if front_n == front_lanes:
                continue  # the front would not shrink: keep it as it is
        full = full.put(torch.as_tensor(slots, device=dev), state, n_real) if compacted else state
        if exit_loop:
            break
        orig_active = slots[active]
        n_real = int(orig_active.size)
        pad = front_n - n_real
        gather = np.concatenate([orig_active, np.repeat(orig_active[:1], pad)]) if pad else orig_active
        gidx = torch.as_tensor(gather, device=dev)
        state = full.take(gidx)
        if pad:
            state = state.retire(n_real)
        front_batch = dataclasses.replace(batch, **{
            f.name: getattr(batch, f.name)[gidx] for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), Tensor)})
        front_obj = objective(front_batch, None if prior_mu is None else prior_mu[gidx],
                              None if prior_var is None else prior_var[gidx])
        slots, compacted = orig_active, True
    if executed_total:
        REGISTRY.gauge_set("re_solve.active_lane_fraction", useful_total / executed_total)
    res = chunked.finalize(full)
    _count_launch()
    var = compute_variances(full_obj, res.w, variance_computation)
    return res.w, var, res.value, res.iterations, res.reason, res.objective_passes


def solve_bucket_lanes(
    bucket_batch: DenseBatch | SparseBatch,
    w0: Tensor,
    l2_weight: Tensor,
    norm: NormalizationContext | None,
    prior_mu: Tensor | None,
    prior_var: Tensor | None,
    *,
    minimize_fn,
    loss: PointwiseLoss,
    config: OptimizerConfig,
    intercept_index: int | None,
    variance_computation: VarianceComputationType,
    accounting: DeferredLaunchAccounting | None = None,
    **minimize_kwargs,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The bucket solve for eager callers (the out-of-core trainer): the
    bucket's k lanes from the (k, d) start ``w0`` in the solver's space,
    with per-lane prior rows. Returns the reference's tuple (w, final
    objective, iterations, reason, variances), on the device and unread;
    variances are zeros when none are asked for. ``accounting`` defers the
    iteration read to its ``flush``; without it the launch is accounted at
    once. ``PHOTON_RE_COMPACT_EVERY`` > 0 runs the solve compacted
    (``_solve_bucket_compacted``, which accounts for itself), except under
    Newton, which has no chunked twin."""
    ce = compact_every()
    chunked = select_chunked_solver(config, minimize_kwargs.get("l1_weight", 0.0))[0] if ce > 0 else None
    kw = dict(loss=loss, config=config, intercept_index=intercept_index,
              variance_computation=variance_computation, minimize_fn=minimize_fn, minimize_kwargs=minimize_kwargs)
    if chunked is not None:
        w, var, value, iterations, reason, _passes = _solve_bucket_compacted(
            bucket_batch, w0, l2_weight, norm, prior_mu, prior_var, chunked=chunked, compact_every_n=ce, **kw)
    else:
        w, var, value, iterations, reason, _passes = _solve_lanes(
            bucket_batch, w0, l2_weight, norm, prior_mu, prior_var, **kw)
        acct = accounting if accounting is not None else DeferredLaunchAccounting()
        acct.add(iterations, w.shape[0])
        if accounting is None:
            acct.flush()
    return w, value, iterations, reason, torch.zeros_like(w) if var is None else var


def random_effect_scores(features: Features, entity_ids: Tensor, W: Tensor) -> Tensor:
    """Per-row scores w_{e(i)}·x_i: one gather and a row-wise dot."""
    if isinstance(features, DenseFeatures):
        return torch.einsum("nd,nd->n", features.X.float(), W[entity_ids])
    return torch.sum(features.values * W[entity_ids[:, None], features.indices], dim=-1)
