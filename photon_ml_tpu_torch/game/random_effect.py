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

Knobs that wait for other ROADMAP items raise when set: the capacity
class projection (``PHOTON_RE_PROJECT``, item 12d-ii) everywhere; the
sub-bucket split, its weight axis, the device split and the owner-segment
combine (``PHOTON_RE_SPLIT``, ``PHOTON_RE_SPLIT_WEIGHT``,
``PHOTON_RE_DEVICE_SPLIT``, ``PHOTON_RE_COMBINE=segments``, item 12d-iii)
under a mesh and out of core (``refuse_waiting_knobs``).

``solve_bucket_lanes`` is the one-bucket entry point of eager callers
(the out-of-core trainer, ``game/streaming.py``, which gathers each
bucket on the host every visit): the same lane solve, its results left
on the card, and its launch counted in ``launch_counts`` with the
iteration read deferred to one ``DeferredLaunchAccounting.flush``. Both
entry points count their launches into the metrics registry
(``re_solve.launches``) and, while a telemetry sink is active or with
``PHOTON_RE_ITER_ACCOUNTING=1``, the executed and useful entity
iterations (``re_solve.*``); otherwise nothing is read back for them. The
reference's compacted and fused launch schedules (ROADMAP queue 1 item
15) raise when their knobs are set.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from photon_ml_tpu_torch._device import check_device
from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.game.data import DenseFeatures, EntityBuckets, Features
from photon_ml_tpu_torch.game.projector import subspace_columns
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.obs import sink as obs_sink
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.obs.spans import emit_event
from photon_ml_tpu_torch.ops.batch import DenseBatch, SparseBatch
from photon_ml_tpu_torch.ops.glm import GaussianPrior, compute_variances, make_lane_objective
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.optim.common import select_minimize_fn
from photon_ml_tpu_torch.parallel.mesh import Mesh, ProcessMesh, as_process_mesh, shard_extent
from photon_ml_tpu_torch.parallel.placement import plan_shard_placement, re_shard_enabled, record_placement_metrics
from photon_ml_tpu_torch.types import VarianceComputationType

Tensor = torch.Tensor


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
    projection, maps each entity's p solve slots to its feature columns;
    the static features are already gathered to (k, C, p)."""

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
    device: torch.device,
    **where,
) -> PreparedBucket:
    """One bucket's (or one shard's lanes') static tensors, gathered where
    the features lie and staged on ``device``."""
    dense = isinstance(features, DenseFeatures)
    src = (features.X if dense else features.values).device
    raw = torch.as_tensor(rows, dtype=torch.int64, device=src)
    mask = (raw >= 0).to(torch.float32)
    idx = torch.clamp_min(raw, 0)
    columns = dict(labels=(labels[idx] * mask).to(device), offsets=torch.zeros_like(mask, device=device),
                   weights=(weights[idx] * mask).to(device))
    cols = None
    if dense:
        static = DenseBatch(X=(features.X[idx].float() * mask.unsqueeze(-1)).to(device), **columns)
        if features_to_samples_ratio is not None:
            cols = subspace_columns(static.X, features_to_samples_ratio, intercept_index)
            if cols is not None:
                static = dataclasses.replace(
                    static, X=torch.gather(static.X, 2, cols.unsqueeze(1).expand(-1, static.X.shape[1], -1))
                )
    else:
        static = SparseBatch(
            indices=features.indices[idx].long().to(device),
            values=(features.values[idx].float() * mask.unsqueeze(-1)).to(device),
            num_features=features.num_features, **columns,
        )
    return PreparedBucket(
        entity_ids=np.asarray(ent_ids),
        ids=torch.as_tensor(ent_ids, dtype=torch.int64, device=device),
        static=static,
        row_idx=idx.to(device),
        mask=mask.to(device),
        columns=cols,
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
    this process owns whole, on its first local device, and host
    bookkeeping only (entity ids, owner) for the rest."""
    refuse_waiting_knobs(mesh is not None)
    dense = isinstance(features, DenseFeatures)
    src = (features.X if dense else features.values).device
    prepared = []
    owners = None
    if mesh is not None and re_shard_enabled():
        pm = as_process_mesh(mesh)
        # placement before any staging: device residency is O(owned buckets)
        owners = _plan_bucket_owners(buckets, pm.process_count, pm.process_index)
    for b, (ent_ids, rows) in enumerate(zip(buckets.entity_ids, buckets.row_indices)):
        if owners is not None:
            owner = int(owners[b])
            if owner != pm.process_index:
                prepared.append(PreparedBucket(entity_ids=np.asarray(ent_ids), ids=None, static=None, row_idx=None,
                                               mask=None, bucket=b, owner=owner))
            else:
                prepared.append(_prepare_one(features, labels, weights, ent_ids, rows, features_to_samples_ratio,
                                             intercept_index, pm.head, bucket=b, owner=owner))
            continue
        if mesh is None:
            prepared.append(_prepare_one(features, labels, weights, ent_ids, rows, features_to_samples_ratio,
                                         intercept_index, src))
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
                                         bucket=b, shard=shard))
    return prepared


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

    prepared = prepare_buckets(features, col(labels), col(weights), buckets, mesh=mesh)
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
    ``iter_accounting_enabled``."""
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
    if any(pb.owner is not None for pb in prepared):
        # owned mode: this process's whole buckets, each as without a mesh
        pm = as_process_mesh(mesh)
        diag = [None] * len(prepared)
        for i, pb in enumerate(prepared):
            if pb.owner != pm.process_index:
                continue  # another process's: its rows arrive in the combine
            step = _bucket_step(W, V, offsets, pb, l2, norm, prior_mu, prior_var, **kw)
            acct.add(step[1], pb.static.labels.shape[0])
            diag[i] = (pb.entity_ids, *step)
        if pm.spans_processes:
            diag = _combine_owned(pm, W, V, prepared, diag)
    elif mesh is None:
        diag = []
        for pb in prepared:
            step = _bucket_step(W, V, offsets, pb, l2, norm, prior_mu, prior_var, **kw)
            acct.add(step[1], pb.static.labels.shape[0])
            diag.append((pb.entity_ids, *step))
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
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """One bucket: gather its rows' residual offsets, extract the warm-start
    and prior lanes, solve the k lanes together, and scatter the solutions
    (and variances) into W (and V) in place. Returns the lanes' (k,) final
    objective, iterations, reason and objective passes."""
    batch = dataclasses.replace(pb.static, offsets=offsets[pb.row_idx] * pb.mask)
    if pb.columns is not None and intercept_index is not None:
        intercept_index = pb.columns.shape[1] - 1  # the intercept is each subspace's last slot
    w, var, *diag = _solve_lanes(
        batch, _extract_lanes(W, pb.ids, pb.columns), l2_weight, norm,
        _extract_lanes(prior_mu, pb.ids, pb.columns), _extract_lanes(prior_var, pb.ids, pb.columns),
        loss=loss, config=config, intercept_index=intercept_index,
        variance_computation=variance_computation, minimize_fn=minimize_fn,
        minimize_kwargs=minimize_kwargs,
    )
    _scatter_lanes(W, V, pb.ids, pb.columns, w, var)
    return tuple(diag)


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
    intercept_index = kw.pop("intercept_index")
    if pb.columns is not None and intercept_index is not None:
        intercept_index = pb.columns.shape[1] - 1  # the intercept is each subspace's last slot
    with _on(dev):
        ids = pb.ids
        batch = dataclasses.replace(pb.static, offsets=offsets.to(dev)[pb.row_idx] * pb.mask)

        def lanes_of(M, fill=0.0):
            return None if M is None else _pad_lanes(_extract_lanes(M.to(dev), ids, cols), lanes, fill)

        out = _solve_lanes(
            batch, lanes_of(W), l2_weight.to(dev), None if norm is None else norm.to(dev), lanes_of(prior_mu),
            lanes_of(prior_var, 1.0), intercept_index=intercept_index, **kw,
        )
    return tuple(None if t is None else t[:k] for t in out)


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
    if own:
        ids = torch.as_tensor(np.concatenate([prepared[i].entity_ids for i in own]), dtype=torch.int64,
                              device=W.device)
        W_own = W[ids].cpu().numpy()
        V_own = None if V is None else V[ids].cpu().numpy()
        D_own = torch.cat([torch.stack([t.double() for t in diag[i][1:]]) for i in own], dim=1).cpu().numpy()
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
        ids = torch.as_tensor(pb.entity_ids, dtype=torch.int64, device=W.device)
        W[ids] = torch.from_numpy(got[0][a:b].copy()).to(W.device)
        if V is not None:
            V[ids] = torch.from_numpy(got[2][a:b].copy()).to(V.device)
        Dg = got[1][:, a:b]
        out[i] = (pb.entity_ids, torch.from_numpy(Dg[0].astype(np.float32)).to(W.device),
                  *(torch.from_numpy(Dg[j].astype(np.int64)).to(W.device) for j in (1, 2, 3)))
    seconds = time.perf_counter() - t0
    combine_stats["seconds"] += seconds
    combine_stats["calls"] += 1
    combine_stats["bytes"] += nbytes
    REGISTRY.counter_inc("re_combine.exchanges")
    REGISTRY.counter_inc("re_combine.bytes_sent", float(nbytes))
    emit_event("re_combine", mode="allgather", bytes_sent=int(nbytes), buckets_owned=len(own),
               buckets=len(prepared), seconds=seconds)
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


def _plan_bucket_owners(buckets: EntityBuckets, num_processes: int, process_index: int) -> np.ndarray:
    """Whole-bucket owners over ``num_processes``, decided before any
    staging: LPT over Σ active rows (Zipf traffic puts most rows behind a
    few head entities, so counting buckets or entities would not balance),
    the fusion groups (keyed by capacity, which fixes a bucket's geometry
    before staging) placed whole. The same host arithmetic on the same
    buckets on every process gives every process the same plan; its
    gauges go to the registry (``record_placement_metrics``)."""
    lanes = [len(e) for e in buckets.entity_ids]
    rows = [int(np.sum(np.asarray(r) >= 0)) for r in buckets.row_indices]
    keys = [int(np.asarray(r).shape[1]) for r in buckets.row_indices]
    groups = [idxs for idxs, _ in plan_fusion_groups(keys, lanes)]
    plan = plan_shard_placement(rows, num_processes, groups=groups)
    record_placement_metrics(plan, shard=process_index, atoms=len(groups))
    return plan.owner


def refuse_waiting_knobs(placed: bool) -> None:
    """Raise, naming the ROADMAP item, on a random-effect knob the port
    does not have yet: ``PHOTON_RE_PROJECT`` (12d-ii) whenever it is set;
    with ``placed`` (a mesh, or the out-of-core trainer) also
    ``PHOTON_RE_SPLIT``, ``PHOTON_RE_DEVICE_SPLIT``,
    ``PHOTON_RE_SPLIT_WEIGHT`` and ``PHOTON_RE_COMBINE`` at any value but
    their defaults (12d-iii). Without this a set knob would be dropped
    without a word and train another model than the reference's."""
    waiting = {"PHOTON_RE_PROJECT": "12d-ii (capacity-class projection)"}
    if placed:
        waiting.update(dict.fromkeys(("PHOTON_RE_SPLIT", "PHOTON_RE_DEVICE_SPLIT", "PHOTON_RE_SPLIT_WEIGHT",
                                      "PHOTON_RE_COMBINE"), "12d-iii (split, combine, device split)"))
    defaults = {"PHOTON_RE_SPLIT_WEIGHT": "rows", "PHOTON_RE_COMBINE": "allreduce"}
    for name, item in waiting.items():
        value = os.environ.get(name)
        if value not in (None, "", "0", defaults.get(name)):
            raise NotImplementedError(
                f"{name}={value} waits for ROADMAP queue 1 item {item}: the port does not read it yet, "
                "and training without it would not be the reference's model (unset it)"
            )


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


def _knob_waits_for_item_15(name: str) -> None:
    env = os.environ.get(name)
    if env not in (None, "", "0"):
        raise NotImplementedError(
            f"{name}={env} changes the random-effect launch schedule; it waits for "
            "ROADMAP queue 1 item 15 (set it to 0 or unset it)"
        )


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
        launch_counts["launches"] += 1
        REGISTRY.counter_inc("re_solve.launches")
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
            launch_counts["executed_entity_iterations"] += executed
            launch_counts["useful_entity_iterations"] += useful
            REGISTRY.counter_inc("re_solve.executed_entity_iterations", float(executed))
            REGISTRY.counter_inc("re_solve.useful_entity_iterations", float(useful))
            if executed:
                REGISTRY.gauge_set("re_solve.active_lane_fraction", useful / executed)
        self._pending.clear()


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
    once. The compacted and fused launch schedules
    (``PHOTON_RE_COMPACT_EVERY``, ``PHOTON_RE_FUSE_BUCKETS``) are ROADMAP
    queue 1 item 15 and raise when set."""
    _knob_waits_for_item_15("PHOTON_RE_COMPACT_EVERY")
    _knob_waits_for_item_15("PHOTON_RE_FUSE_BUCKETS")
    w, var, value, iterations, reason, _passes = _solve_lanes(
        bucket_batch, w0, l2_weight, norm, prior_mu, prior_var, loss=loss, config=config,
        intercept_index=intercept_index, variance_computation=variance_computation,
        minimize_fn=minimize_fn, minimize_kwargs=minimize_kwargs,
    )
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
