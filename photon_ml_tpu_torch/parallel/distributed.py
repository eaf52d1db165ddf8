"""Data-parallel GLM training over row shards (port of
``photon_ml_tpu/parallel/distributed.py``).

Photon ML's ``DistributedGLMLossFunction`` sums per-partition partials
and folds them into one driver-side optimizer loop. The reference runs
its whole optimizer inside ``shard_map`` with one ``psum`` per objective
evaluation. Here the optimizer loop runs on the host as everywhere in the
port, over ``ShardedGLMObjective``: shard i's rows live on ``mesh[i]``
(``parallel/mesh.py``), each evaluation runs every shard's contract there
(K1 / K2 on dense shards, K3 on tiled sparse ones), and the shards' raw
partial sums meet once, in float64, in shard order, on shard 0's device.
The normalization and the regularizer are applied after that sum, once.
The order is fixed, so a solve repeats bit for bit run to run; the
reference's ``psum`` order is unspecified, so the two packages agree to
rounding, not bitwise.

The optimizers are the ones every single-device solve uses
(``optim/lbfgs.py``, ``optim/tron.py``): the sharded objective meets the
same contracts (``value``, ``value_and_grad``, ``hvp``, ``hessian_diag``,
``hessian``, the margin API and ``ray_values*``). Its margins are a tuple
of per-shard tensors; only scalars and d-vectors are summed.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.batch import (
    Batch,
    DenseBatch,
    SparseBatch,
    densify,
    maybe_densify,
    pad_batch,
)
from photon_ml_tpu_torch.ops.glm import (
    GaussianPrior,
    GLMObjective,
    _constant_hints,
    auto_fused,
    make_objective,
)
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.sparse_tiled import supports_tiling, tile_sparse_batch_sharded
from photon_ml_tpu_torch.optim.common import OptimizationResult, select_minimize_fn
from photon_ml_tpu_torch.parallel.mesh import Mesh

Tensor = torch.Tensor


def _on(device: torch.device):
    """The CUDA device context a shard's launches need (a no-op on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _slice_rows(batch: Batch, lo: int, hi: int, device: torch.device) -> Batch:
    part = slice(lo, hi)
    if isinstance(batch, DenseBatch):
        return DenseBatch(X=batch.X[part].to(device), labels=batch.labels[part].to(device),
                          offsets=batch.offsets[part].to(device), weights=batch.weights[part].to(device))
    if isinstance(batch, SparseBatch):
        return SparseBatch(indices=batch.indices[part].to(device), values=batch.values[part].to(device),
                           labels=batch.labels[part].to(device), offsets=batch.offsets[part].to(device),
                           weights=batch.weights[part].to(device), num_features=batch.num_features)
    raise TypeError(f"row shards are cut from a DenseBatch or a SparseBatch, not {type(batch).__name__}")


def shard_batch(batch: DenseBatch | SparseBatch, mesh: Mesh) -> list[DenseBatch | SparseBatch]:
    """The batch's rows padded with zero-weight rows to a multiple of
    ``len(mesh)`` and split into that many contiguous shards of equal
    count, shard i on ``mesh[i]`` (a row slice on the batch's own device
    is a view, not a copy)."""
    p = len(mesh)
    rows = -(-batch.num_rows // p)
    padded = pad_batch(batch, rows * p)
    return [_slice_rows(padded, i * rows, (i + 1) * rows, mesh[i]) for i in range(p)]


def _densify_sharded(batch: SparseBatch, mesh: Mesh) -> list[DenseBatch]:
    """A sparse batch whose dense form fits the mesh's cards but not one:
    the sparse rows are sharded first and each shard densifies on its own
    device, so the whole (n, d) matrix never exists on one card."""
    out = []
    for shard, dev in zip(shard_batch(batch, mesh), mesh):
        with _on(dev):
            out.append(densify(shard))
    return out


def _mesh_budget_bytes(mesh: Mesh) -> float:
    """The memory a dataset may hold on the mesh: one card's budget times
    the distinct devices it spans (shards that share a card share its
    memory)."""
    from photon_ml_tpu_torch.ops.streaming import device_hbm_budget_bytes

    return device_hbm_budget_bytes(device=mesh[0]) * len(set(mesh))


@dataclass(frozen=True)
class ShardedGLMObjective:
    """One ``GLMObjective`` per row shard, each on its shard's device, with
    the contracts of a single objective. Every shard objective carries the
    same regularization, normalization and prior, but only shard 0's
    finishes a contract: the raw data partials (``value_and_grad``'s
    (value, Xᵀr, Σr), ``hvp``'s (Xᵀq, Σq), ...) of all shards are summed
    first, in float64 and shard order on shard 0's device, then rounded
    to float32 and finished once, so L2 (or the prior) is added once.
    Inputs and outputs lie on shard 0's device; each shard receives the
    coefficients on its own device."""

    shards: tuple[GLMObjective, ...]

    @property
    def head(self) -> GLMObjective:
        return self.shards[0]

    @property
    def device(self) -> torch.device:
        return self.head.batch.device

    # what the optimizers read besides the contracts
    @property
    def reg_mask(self) -> Tensor:
        return self.head.reg_mask

    @property
    def fused(self) -> bool:
        return self.head.fused

    @property
    def one_pass_value_grad(self) -> bool:
        return self.head.one_pass_value_grad

    # -- the reduction ---------------------------------------------------------
    def _each(self, fn: Callable, *per_shard: Sequence) -> list:
        """``fn(shard objective, *its arguments)`` on every shard, in order,
        under the shard's device."""
        out = []
        for i, obj in enumerate(self.shards):
            with _on(obj.batch.device):
                out.append(fn(obj, *(a[i] for a in per_shard)))
        return out

    def _bcast(self, v: Tensor) -> list[Tensor]:
        """``v`` on every shard's device (no copy where it already lies)."""
        return [v.to(o.batch.device) for o in self.shards]

    def _sum(self, parts: list) -> tuple:
        """The shards' partials, each summed in float64 in shard order on
        shard 0's device and rounded once to its own dtype."""
        dev = self.device
        out = []
        for k in range(len(parts[0])):
            acc = parts[0][k].to(dev, torch.float64)
            for p in parts[1:]:
                acc = acc + p[k].to(dev, torch.float64)
            out.append(acc.to(parts[0][k].dtype))
        return tuple(out)

    # -- contracts ---------------------------------------------------------------
    def value(self, w: Tensor) -> Tensor:
        (val,) = self._sum(self._each(lambda o, wi: (o.value_partial(wi),), self._bcast(w)))
        return val + self.head._l2_term(w)

    def value_and_grad(self, w: Tensor) -> tuple[Tensor, Tensor]:
        parts = self._each(lambda o, wi: o.value_and_grad_partials(wi), self._bcast(w))
        return self.head._finish_grad(*self._sum(parts), w)

    def grad(self, w: Tensor) -> Tensor:
        return self.value_and_grad(w)[1]

    def hvp(self, w: Tensor, v: Tensor) -> Tensor:
        parts = self._each(lambda o, wi, vi: o.hvp_partials(wi, vi), self._bcast(w), self._bcast(v))
        return self.head._finish_hvp(*self._sum(parts), v)

    def hessian_diag(self, w: Tensor) -> Tensor:
        parts = self._each(lambda o, wi: o.hessian_diag_partials(wi), self._bcast(w))
        return self.head._finish_hessian_diag(*self._sum(parts))

    def hessian(self, w: Tensor) -> Tensor:
        return self.hessian_from_margins(self.margins(w), w)

    # -- margin API: one margin tensor per shard, never concatenated -----------
    def margins(self, w: Tensor) -> tuple[Tensor, ...]:
        return tuple(self._each(lambda o, wi: o.margins(wi), self._bcast(w)))

    def direction_margins(self, p: Tensor) -> tuple[Tensor, ...]:
        return tuple(self._each(lambda o, pi: o.direction_margins(pi), self._bcast(p)))

    def value_and_grad_from_margins(self, m: Sequence[Tensor], w: Tensor) -> tuple[Tensor, Tensor]:
        parts = self._each(lambda o, mi: o.value_and_grad_partials_from_margins(mi), m)
        return self.head._finish_grad(*self._sum(parts), w)

    def hessian_from_margins(self, m: Sequence[Tensor], w: Tensor) -> Tensor:
        (h,) = self._sum(self._each(lambda o, mi: (o.hessian_partial_from_margins(mi),), m))
        return self.head._finish_hessian(h)

    def ray_values_from_margins(self, m: Sequence[Tensor], dm: Sequence[Tensor], w: Tensor, p: Tensor,
                                ts: Tensor) -> Tensor:
        ts_i = self._bcast(ts)
        (data,) = self._sum(self._each(lambda o, mi, dmi, t: (o.ray_partials_from_margins(mi, dmi, t),),
                                       m, dm, ts_i))
        return data + self.head._reg_ray(w, p, ts)

    def ray_values(self, w: Tensor, p: Tensor, ts: Tensor) -> Tensor:
        return self.ray_values_from_margins(self.margins(w), self.direction_margins(p), w, p, ts)


def sharded_objective(
    batch: Batch,
    mesh: Mesh,
    loss: PointwiseLoss,
    l2_weight: float | Tensor = 0.0,
    norm: NormalizationContext | None = None,
    intercept_index: int | None = None,
    fused: bool | None = None,
    prior: GaussianPrior | None = None,
) -> ShardedGLMObjective:
    """The batch split over ``mesh`` as one objective.

    The ingest layout decision is the reference's: a sparse batch
    densifies when its dense matrix fits one card's budget
    (``device_hbm_budget_bytes``), densifies shard by shard when it fits
    the mesh's cards together, and is otherwise re-blocked into one K3
    layout per shard when ``supports_tiling`` takes it. ``fused=None``
    decides K1 / K2 on the global batch (``auto_fused``), as the reference
    decides outside its ``shard_map``. Rows padded in to divide the shard
    count turn the all-ones weights hint off, so each shard's kernel reads
    its weights and the padding stays inert (a kernel given no weights
    counts every row once)."""
    from photon_ml_tpu_torch.ops.streaming import device_hbm_budget_bytes

    shards = None
    hints = (False, False)  # shards built here read their offsets and weights
    if isinstance(batch, SparseBatch):
        one_card = device_hbm_budget_bytes(device=mesh[0])
        dense_bytes = batch.num_rows * batch.num_features * 4
        if dense_bytes <= one_card:
            batch = maybe_densify(batch, one_card)
        elif dense_bytes <= _mesh_budget_bytes(mesh):
            shards = _densify_sharded(batch, mesh)
        elif supports_tiling(batch):
            shards = tile_sparse_batch_sharded(batch, len(mesh), devices=mesh)[0]
    if shards is None:
        if fused is None:
            fused = auto_fused(batch)
        if fused:
            hints = _constant_hints(batch)
            if batch.num_rows % len(mesh):
                hints = (hints[0], False)
        shards = shard_batch(batch, mesh)
    elif fused is None:
        fused = all(auto_fused(s) for s in shards)
    objs = []
    for shard, dev in zip(shards, mesh):
        with _on(dev):
            objs.append(make_objective(
                shard, loss, l2_weight=l2_weight, norm=norm, intercept_index=intercept_index,
                fused=bool(fused) and isinstance(shard, DenseBatch), data_hints=hints, prior=prior,
                device=dev,
            ))
    return ShardedGLMObjective(shards=tuple(objs))


def sharded_minimize(
    minimize_fn: Callable[..., OptimizationResult],
    batch: Batch,
    w0: Tensor,
    config: OptimizerConfig,
    mesh: Mesh,
    loss: PointwiseLoss,
    l2_weight: float | Tensor = 0.0,
    norm: NormalizationContext | None = None,
    intercept_index: int | None = None,
    l1_weight: float | Tensor | None = None,
    fused: bool | None = None,
    prior: GaussianPrior | None = None,
) -> OptimizationResult:
    """Run ``minimize_fn`` (``lbfgs_minimize``, ``owlqn_minimize`` or
    ``tron_minimize``: the single-device solvers, unchanged) over the batch
    row-sharded on ``mesh``. The solver's state lives on ``mesh[0]``;
    ``l1_weight`` is passed on when given (OWL-QN). The port's Newton
    solves a single GLM as one lane of its lane solver, which needs the
    whole dense batch on one device, so it is refused here."""
    from photon_ml_tpu_torch.optim.newton import newton_minimize

    if minimize_fn is newton_minimize:
        raise NotImplementedError(
            "NEWTON_CHOLESKY runs a single GLM as one lane of the lane solver, on one device; "
            "the sharded solve takes LBFGS (OWL-QN with L1) or TRON"
        )
    obj = sharded_objective(batch, mesh, loss, l2_weight=l2_weight, norm=norm,
                            intercept_index=intercept_index, fused=fused, prior=prior)
    w0 = torch.as_tensor(w0, dtype=torch.float32).to(obj.device)
    kwargs = {} if l1_weight is None else {"l1_weight": l1_weight}
    return minimize_fn(obj, w0, config, **kwargs)


@dataclass(frozen=True)
class DistributedTrainer:
    """A mesh and an optimizer choice bound into ``train(batch, w0)``: the
    reference's ``DistributedOptimizationProblem`` (objective, optimizer,
    regularization and normalization together). The optimizer follows
    ``select_minimize_fn``: TRON if configured, OWL-QN when L1 is active,
    else L-BFGS."""

    mesh: Mesh
    config: OptimizerConfig
    loss: PointwiseLoss
    l2_weight: float = 0.0
    l1_weight: float = 0.0
    norm: NormalizationContext | None = None
    intercept_index: int | None = None

    def train(self, batch: Batch, w0: Tensor) -> OptimizationResult:
        fn, kwargs = select_minimize_fn(self.config, self.l1_weight)
        return sharded_minimize(
            fn, batch, w0, self.config, self.mesh, self.loss, l2_weight=self.l2_weight,
            norm=self.norm, intercept_index=self.intercept_index, **kwargs,
        )
