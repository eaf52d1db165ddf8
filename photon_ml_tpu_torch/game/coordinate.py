"""Per-coordinate train and score units (port of the eager path of
``photon_ml_tpu/game/coordinate.py``). A coordinate binds one effect's
data view and optimization problem; coordinate descent drives it through
residual offsets with ``train(offsets, initial)`` and ``score(model)``.

- ``FixedEffectCoordinate`` solves one GLM over every row of its shard
  through ``make_objective`` and ``select_minimize_fn``: a dense float32
  shard on the card runs its objective passes on K1 (``auto_fused``).
- ``RandomEffectCoordinate`` solves every entity's GLM over the prepared
  buckets (``game/random_effect.py``), gathered once and reused, with the
  solver ``select_minimize_fn`` picks from its optimizer config and the
  L1 part of its regularization (L-BFGS, OWL-QN, TRON or Newton).

A random effect may solve in a per-entity subspace
(``features_to_samples_ratio``) or over a shared random projection of its
shard (``projector``), as the reference's ``IndexMapProjection`` and
``RandomProjection`` do. The reference's one-launch fused visit (ROADMAP
queue 1 item 10a.6) is not ported.

With a data mesh (``parallel/mesh.py``, one process or several) the batch
is every process's replicated copy (on the host or a card) and each
coordinate stages only this process's global shards on their devices:
the fixed effect solves row-sharded through ``ShardedGLMObjective`` (no
``optimize_batch_layout`` decision: the sharded layout rule decides), a
random effect solves its shards' entity lanes (``train_prepared(mesh=)``).
Each scores its shards' rows, and the (n,) score is put together from
every process's rows in rank order by one row gather
(``allgather_rows``), so every process can gather its lanes' residual
offsets; ``score_exchange_stats`` counts that exchange's seconds and
bytes.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Protocol

import torch

from photon_ml_tpu_torch.config import OptimizationConfig
from photon_ml_tpu_torch.game.data import (
    DenseFeatures,
    EntityBuckets,
    EntityGrouping,
    GameBatch,
    SparseFeatures,
)
from photon_ml_tpu_torch.game.models import FixedEffectModel, GameSubModel, RandomEffectModel
from photon_ml_tpu_torch.game.projector import RandomProjector
from photon_ml_tpu_torch.game.random_effect import (
    RandomEffectTrainingResult,
    _fusion_units,
    _parent_units,
    fuse_buckets,
    prepare_buckets,
    train_prepared,
)
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.normalization import NormalizationContext, require_intercept_for_shifts
from photon_ml_tpu_torch.ops.batch import DenseBatch, hbm_budget_bytes, optimize_batch_layout
from photon_ml_tpu_torch.ops.glm import GaussianPrior, compute_variances, make_objective
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optim.common import OptimizationResult, select_minimize_fn
from photon_ml_tpu_torch.parallel.distributed import (
    objective_over_shards,
    refuse_newton,
    shard_layout,
    shard_rows,
)
from photon_ml_tpu_torch.parallel.mesh import Mesh, ProcessMesh, as_process_mesh, effective_mesh, shard_extent
from photon_ml_tpu_torch.parallel.multihost import allgather_rows
from photon_ml_tpu_torch.parallel.placement import re_shard_enabled
from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

Tensor = torch.Tensor


class Coordinate(Protocol):
    """The contract coordinate descent drives."""

    coordinate_id: str

    def train(self, offsets: Tensor, initial: GameSubModel | None) -> tuple[GameSubModel, Any]: ...

    def score(self, model: GameSubModel) -> Tensor: ...


# seconds, calls and bytes of the score row gathers since the last reset
score_exchange_stats: dict = {"seconds": 0.0, "calls": 0, "bytes": 0}


def reset_score_exchange_stats() -> None:
    score_exchange_stats.update(seconds=0.0, calls=0, bytes=0)


def _assemble_scores(mesh: ProcessMesh, parts: list[Tensor], n: int) -> Tensor:
    """The (n,) score on the mesh's head device from this process's shards'
    row scores (each ⌈n/S⌉ rows, in global shard order) and, across
    processes, every other process's, gathered in rank order."""
    local = torch.cat([p.to(mesh.head) for p in parts])
    if mesh.spans_processes:
        t0 = time.perf_counter()
        rows = allgather_rows(local.cpu().numpy())
        local = torch.from_numpy(rows).to(mesh.head)
        score_exchange_stats["seconds"] += time.perf_counter() - t0
        score_exchange_stats["calls"] += 1
        score_exchange_stats["bytes"] += rows.nbytes
    return local[:n]


def _aligned(t: Tensor) -> Tensor:
    """``t``, or a copy of it where it does not start 16-byte aligned: K1
    picks its layout by its inputs' alignment, so a shard cut from a batch
    on the card (a view at any row) and the same rows copied from the host
    (a fresh, aligned tensor) take the same layout and give the same bits."""
    return t.clone() if t.data_ptr() % 16 else t


def _shard_features(feats, mesh: ProcessMesh, n: int) -> list:
    """This process's shards' rows of a feature container, each on its
    shard's device (zero rows past the end), aligned (``_aligned``)."""
    rows = shard_extent(n, mesh.num_shards)
    out = []
    for shard, dev in zip(mesh.global_shards(), mesh.local):
        if isinstance(feats, DenseFeatures):
            out.append(DenseFeatures(X=_aligned(shard_rows(feats.X, shard, rows, dev))))
        else:
            out.append(SparseFeatures(_aligned(shard_rows(feats.indices, shard, rows, dev)),
                                      _aligned(shard_rows(feats.values, shard, rows, dev)), feats.num_features))
    return out


def _require_prior_l2(config: OptimizationConfig) -> None:
    """The MAP prior's pull is λ₂·(1/variance): refuse a zero L2 weight,
    which would silently train unanchored."""
    if config.regularization.l2_weight(config.regularization_weight) <= 0.0:
        raise ValueError(
            "incremental training (prior_model) requires a positive L2 "
            "regularization weight: the prior's pull is l2_weight * (1/prior_variance)"
        )


@dataclass(frozen=True)
class FixedEffectCoordinate:
    """One GLM over every row of a feature shard. ``train_rows`` /
    ``train_weight_scale`` down-sample the training rows (scoring sees
    every row). ``prior_model`` (incremental training) is held fixed as a
    Gaussian MAP prior across every descent iteration. ``mesh`` solves
    row-sharded over it (module docstring)."""

    coordinate_id: str
    batch: GameBatch
    feature_shard_id: str
    config: OptimizationConfig
    task_type: TaskType
    intercept_index: int | None = None
    normalization: NormalizationContext | None = None
    variance_computation: VarianceComputationType = VarianceComputationType.NONE
    train_rows: Tensor | None = None
    train_weight_scale: Tensor | None = None
    prior_model: FixedEffectModel | None = None
    mesh: Mesh | ProcessMesh | None = None

    def __post_init__(self):
        require_intercept_for_shifts(self.normalization)

    def _device(self) -> torch.device:
        return self.batch.device if self.mesh is None else as_process_mesh(self.mesh).head

    def _mesh_layout(self) -> tuple[list, bool, int]:
        """This process's training shards in their layout (zero offsets;
        each visit re-binds its own), the kernels flag and the training
        row count: built once."""
        cached = self.__dict__.get("_mesh_cached")
        if cached is None:
            shard = self.batch.features[self.feature_shard_id]
            labels, weights = self.batch.labels, self.batch.weights
            if self.train_rows is not None:
                rows = self.train_rows.to(labels.device)
                shard, labels, weights = shard.take(rows), labels[rows], weights[rows]
                if self.train_weight_scale is not None:
                    weights = weights * self.train_weight_scale.to(weights.device)
            batch = shard.to_batch(labels, torch.zeros_like(labels), weights)
            shards, fused, _ = shard_layout(batch, self.mesh)
            shards = [DenseBatch(X=_aligned(b.X), labels=_aligned(b.labels), offsets=b.offsets,
                                 weights=_aligned(b.weights)) if isinstance(b, DenseBatch) else b
                      for b in shards]
            cached = (shards, fused, batch.num_rows)
            object.__setattr__(self, "_mesh_cached", cached)
        return cached

    def _mesh_objective(self, offsets: Tensor, loss, l2: float, norm, prior):
        pm = as_process_mesh(self.mesh)
        shards, fused, n = self._mesh_layout()
        if self.train_rows is not None:
            offsets = offsets[self.train_rows.to(offsets.device)]
        rows = shard_extent(n, pm.num_shards)
        shards = [dataclasses.replace(b, offsets=_aligned(shard_rows(offsets, s, rows, dev)))
                  for b, s, dev in zip(shards, pm.global_shards(), pm.local)]
        return objective_over_shards(shards, pm, loss, l2_weight=l2, norm=norm,
                                     intercept_index=self.intercept_index, fused=fused, prior=prior)

    def _training_batch(self, offsets: Tensor):
        shard = self.batch.features[self.feature_shard_id]
        if self.train_rows is None:
            batch = shard.to_batch(self.batch.labels, offsets, self.batch.weights)
            opt = self._optimized_layout(batch)
            # the cached layout depends on the features only: re-bind this
            # visit's residual offsets onto it
            return batch if opt is None else dataclasses.replace(opt, offsets=offsets)
        rows = self.train_rows
        w = self.batch.weights[rows]
        if self.train_weight_scale is not None:
            w = w * self.train_weight_scale
        return shard.take(rows).to_batch(self.batch.labels[rows], offsets[rows], w)

    def _optimized_layout(self, batch):
        """The ingest layout decision (densify a narrow sparse shard, or the
        sparse kernel's layout for a high-dimensional one), made once per
        coordinate; None when the shard's own layout is the right one."""
        cached = self.__dict__.get("_layout_cached", False)
        if cached is False:
            out = optimize_batch_layout(batch, hbm_budget_bytes=hbm_budget_bytes(batch.device))
            cached = None if out is batch else out
            object.__setattr__(self, "_layout_cached", cached)
        return cached

    def train(
        self, offsets: Tensor, initial: GameSubModel | None = None
    ) -> tuple[FixedEffectModel, OptimizationResult]:
        dev = self._device()
        norm = self.normalization
        prior = None
        if self.prior_model is not None:
            _require_prior_l2(self.config)
            coef = self.prior_model.model.coefficients
            prior = GaussianPrior.from_coefficients(
                coef.means.to(dev), None if coef.variances is None else coef.variances.to(dev),
                None if norm is None else norm.to(dev),
            )
        if initial is not None:
            w0 = torch.as_tensor(initial.model.coefficients.means, dtype=torch.float32, device=dev)
            if norm is not None:
                w0 = norm.to(dev).model_from_original_space(w0)
        else:
            d = self.batch.features[self.feature_shard_id].num_features
            w0 = torch.zeros((d,), dtype=torch.float32, device=dev)

        opt = self.config
        loss = loss_for_task(self.task_type)
        l1 = opt.regularization.l1_weight(opt.regularization_weight)
        l2 = opt.regularization.l2_weight(opt.regularization_weight)
        minimize_fn, extra = select_minimize_fn(opt.optimizer, l1)
        if self.mesh is not None:
            refuse_newton(minimize_fn)
            obj = self._mesh_objective(offsets, loss, l2, None if norm is None else norm.to(dev), prior)
        else:
            obj = make_objective(
                self._training_batch(offsets), loss, l2_weight=l2, norm=norm,
                intercept_index=self.intercept_index, prior=prior, device=dev,
            )
        result = minimize_fn(obj, w0, opt.optimizer, **extra)
        w = result.w
        variances = compute_variances(obj, w, self.variance_computation)
        if norm is not None:
            norm = norm.to(dev)
            w, _ = norm.model_to_original_space(w)
            if variances is not None:
                variances = norm.factors**2 * variances
        model = FixedEffectModel(
            model=GeneralizedLinearModel(Coefficients(w, variances), self.task_type),
            feature_shard_id=self.feature_shard_id,
        )
        return model, result

    def score(self, model: FixedEffectModel) -> Tensor:
        if self.mesh is not None:
            pm = as_process_mesh(self.mesh)
            w = model.model.coefficients.means
            if self.train_rows is None:  # the training shards hold every row
                parts = [b.matvec(w.to(b.device)) for b in self._mesh_layout()[0]]
            else:
                feats = self.__dict__.get("_mesh_rows")
                if feats is None:
                    feats = _shard_features(self.batch.features[self.feature_shard_id], pm, self.batch.num_rows)
                    object.__setattr__(self, "_mesh_rows", feats)
                parts = [f.score(w.to(dev)) for f, dev in zip(feats, pm.local)]
            return _assemble_scores(pm, parts, self.batch.num_rows)
        opt = self.__dict__.get("_layout_cached")
        if opt is not None:
            # margins over the same shard ride the optimized layout
            return opt.matvec(model.model.coefficients.means)
        return model.score(self.batch)


    def _reset_compiled_state(self) -> None:
        """Drop the cached layouts and shards, so the next visit builds them
        again from the batch (the descent's degrade in place calls it after
        the group shrinks)."""
        for key in ("_mesh_cached", "_mesh_rows", "_layout_cached"):
            self.__dict__.pop(key, None)

    def _degrade_blocker(self) -> str | None:
        """Why this coordinate cannot survive a group shrink in place, or
        None: a fixed effect solving over a mesh splits its rows over every
        process's shards, and the dead process's rows leave with it."""
        if self.mesh is not None:
            return f"fixed-effect coordinate {self.coordinate_id!r} solves over the full device mesh"
        return None


@dataclass(frozen=True)
class RandomEffectCoordinate:
    """Per-entity GLMs over one feature shard and entity column. The
    grouping and bucketing come in built; the buckets' static tensors are
    gathered on the device at the first ``train`` and reused by every
    visit and, through ``with_config``, every grid entry.

    ``features_to_samples_ratio`` (``numFeaturesToSamplesRatioUpperBound``)
    solves each entity in its subspace of most frequent columns;
    ``projector`` solves over the shard projected once by a shared random
    matrix and returns the coefficients in the original space, score-exact,
    without variances (a diagonal does not survive a dense map). ``mesh``
    solves the entity lanes sharded over it (module docstring)."""

    coordinate_id: str
    batch: GameBatch
    feature_shard_id: str
    random_effect_type: str
    config: OptimizationConfig
    grouping: EntityGrouping
    buckets: EntityBuckets
    task_type: TaskType
    num_entities: int
    intercept_index: int | None = None
    normalization: NormalizationContext | None = None
    variance_computation: VarianceComputationType = VarianceComputationType.NONE
    prior_model: RandomEffectModel | None = None
    features_to_samples_ratio: float | None = None
    projector: RandomProjector | None = None
    mesh: Mesh | ProcessMesh | None = None

    def __post_init__(self):
        if self.normalization is not None and self.projector is not None:
            raise NotImplementedError(
                "normalization is not supported together with random projection "
                "(the projected columns have no per-feature stats)"
            )
        if self.normalization is not None and self.features_to_samples_ratio is not None:
            raise NotImplementedError(
                "normalization is not supported together with per-entity subspace projection "
                "(the per-entity column maps would need per-entity normalization slices)"
            )
        require_intercept_for_shifts(self.normalization)

    def _features(self):
        feats = self.batch.features[self.feature_shard_id]
        if self.projector is None:
            return feats
        if not isinstance(feats, DenseFeatures):
            raise ValueError("random projection requires dense features")
        return DenseFeatures(X=self.projector.project_features(feats.X.to(self.projector.matrix.device)))

    @property
    def _prepared(self):
        cached = self.__dict__.get("_prepared_cache")
        if cached is None:
            # the projected shard is gathered into the buckets once and not kept
            cached = prepare_buckets(
                self._features(), self.batch.labels, self.batch.weights, self.buckets,
                features_to_samples_ratio=self.features_to_samples_ratio,
                intercept_index=None if self.projector is not None else self.intercept_index,
                mesh=self.mesh,
            )
            object.__setattr__(self, "_prepared_cache", cached)
        return cached

    def _staged_fusion_units(self):
        """The launch units of the prepared buckets, concatenated once and
        kept across visits, as the reference's coordinate keeps them:
        rebuilding them every visit would copy every static bucket tensor.
        Fused by geometry under ``PHOTON_RE_FUSE_BUCKETS``, else, on a
        ``PHOTON_RE_SPLIT`` preparation, the atoms of each parent together
        again (``_parent_units``). None when neither applies (one bucket,
        or lanes sharded over a mesh, which the prepared buckets, not the
        knob, tell)."""
        prepared = self._prepared
        lane_sharded = self.mesh is not None and not any(pb.owner is not None for pb in prepared)
        if lane_sharded or len(prepared) < 2:
            return None
        fuse = fuse_buckets()
        if not fuse and not any(pb.parent is not None for pb in prepared):
            return None
        cached = self.__dict__.get("_fusion_units_cache")
        if cached is None or cached[0] != fuse:
            cached = (fuse, _fusion_units(prepared) if fuse else _parent_units(prepared))
            object.__setattr__(self, "_fusion_units_cache", cached)
        return cached[1]

    def with_config(self, config: OptimizationConfig) -> "RandomEffectCoordinate":
        """A copy bound to another optimization config that shares the
        prepared bucket tensors and fused units (they depend on the data
        alone)."""
        new = dataclasses.replace(self, config=config)
        for key in ("_prepared_cache", "_fusion_units_cache"):
            cached = self.__dict__.get(key)
            if cached is not None:
                object.__setattr__(new, key, cached)
        return new

    def train(
        self, offsets: Tensor, initial: GameSubModel | None = None
    ) -> tuple[RandomEffectModel, RandomEffectTrainingResult]:
        opt = self.config
        P = None if self.projector is None else self.projector.matrix
        W0 = prior_W = prior_V = None
        if initial is not None:
            W0 = initial.coefficients
            if W0.shape[0] != self.num_entities:
                raise ValueError(f"warm-start entity count {W0.shape[0]} != {self.num_entities}")
            if P is not None:
                # P has no exact inverse; near-orthogonal (JL), so projecting
                # the original-space warm start is the standard choice
                W0 = W0 @ P
        if self.prior_model is not None:
            _require_prior_l2(self.config)
            prior_W, prior_V = self.prior_model.coefficients, self.prior_model.variances
            if prior_W.shape[0] != self.num_entities:
                raise ValueError(f"prior entity count {prior_W.shape[0]} != {self.num_entities}")
            if P is not None:
                # diagonal variances do not survive a dense projection: unit
                # precision in the projected space
                prior_W, prior_V = prior_W @ P, None
        norm = self.normalization
        result = train_prepared(
            self._prepared,
            offsets,
            self.batch.features[self.feature_shard_id].num_features if P is None else P.shape[1],
            self.num_entities,
            loss_for_task(self.task_type),
            opt.optimizer,
            l2_weight=opt.regularization.l2_weight(opt.regularization_weight),
            l1_weight=opt.regularization.l1_weight(opt.regularization_weight),
            intercept_index=None if P is not None else self.intercept_index,
            initial_coefficients=W0,
            variance_computation=self.variance_computation,
            norm=None if norm is None else norm.to(offsets.device),
            prior_coefficients=prior_W,
            prior_variances=prior_V,
            mesh=self.mesh,
            fusion_units=self._staged_fusion_units(),
        )
        coefficients, variances = result.coefficients, result.variances
        if P is not None:
            coefficients, variances = self.projector.coefficients_to_original(coefficients), None
        model = RandomEffectModel(
            coefficients=coefficients,
            variances=variances,
            random_effect_type=self.random_effect_type,
            feature_shard_id=self.feature_shard_id,
            task_type=self.task_type,
        )
        return model, result

    def _reset_compiled_state(self) -> None:
        """The degrade-in-place hook: drop the prepared buckets, the staged
        launch units and the scoring shards, and take the mesh over the
        current (survivor) group, so the next visit prepares its owned
        buckets by the placement re-planned over the survivors."""
        for key in ("_prepared_cache", "_fusion_units_cache", "_mesh_rows"):
            self.__dict__.pop(key, None)
        if self.mesh is not None:
            object.__setattr__(self, "mesh", effective_mesh(self.mesh))

    def _degrade_blocker(self) -> str | None:
        """Why this coordinate cannot survive a group shrink in place, or
        None. Owned buckets (``PHOTON_RE_SHARD=1`` under a mesh) degrade:
        each is staged whole on its owner and combined over the host mesh.
        Lanes sharded over the mesh keep the abort."""
        if self.mesh is None:
            return None
        prepared = self.__dict__.get("_prepared_cache")
        owned = any(pb.owner is not None for pb in prepared) if prepared is not None else re_shard_enabled()
        if owned:
            return None
        return (f"random-effect coordinate {self.coordinate_id!r} is lane-sharded over the full device mesh "
                "(enable PHOTON_RE_SHARD=1 owned-bucket placement — with the PHOTON_RE_COMBINE=segments "
                "host-collective combine — for a degradable in-memory solve)")

    def score(self, model: RandomEffectModel) -> Tensor:
        if self.mesh is None:
            return model.score(self.batch)
        pm = as_process_mesh(self.mesh)
        rows = self.__dict__.get("_mesh_rows")
        if rows is None:
            n = self.batch.num_rows
            ids = self.batch.id_tags[self.random_effect_type]
            rows = list(zip(_shard_features(self.batch.features[self.feature_shard_id], pm, n),
                            [_aligned(shard_rows(ids, s, shard_extent(n, pm.num_shards), dev))
                             for s, dev in zip(pm.global_shards(), pm.local)]))
            object.__setattr__(self, "_mesh_rows", rows)
        return _assemble_scores(pm, [model.score_rows(feats, ids) for feats, ids in rows], self.batch.num_rows)
