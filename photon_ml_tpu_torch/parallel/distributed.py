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

Across processes (a ``ProcessMesh``, ``parallel/mesh.py``) each process
builds and runs only its own global shards, gathers the raw float64
partials of every global shard over gloo and sums them in global shard
order, so P processes × L shards reproduce the bits of one process × P·L
shards, and every process holds the same iterate.

The optimizers are the ones every single-device solve uses
(``optim/lbfgs.py``, ``optim/tron.py``): the sharded objective meets the
same contracts (``value``, ``value_and_grad``, ``hvp``, ``hessian_diag``,
``hessian``, the margin API and ``ray_values*``). Its margins are a tuple
of per-shard tensors; only scalars and d-vectors are summed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.batch import (
    Batch,
    DenseBatch,
    SparseBatch,
    densify,
    maybe_densify,
)
from photon_ml_tpu_torch.ops.glm import (
    GaussianPrior,
    GLMObjective,
    _constant_hints,
    auto_fused,
    make_objective,
)
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.sparse_tiled import supports_tiling, tile_sparse_batch
from photon_ml_tpu_torch.optim.common import OptimizationResult, select_minimize_fn
from photon_ml_tpu_torch.parallel.mesh import Mesh, ProcessMesh, as_process_mesh, shard_extent
from photon_ml_tpu_torch.parallel.multihost import _gather_arrays

Tensor = torch.Tensor

# host seconds and calls of the shard reductions since the last reset
# (across processes the gather included; on one process the card's
# additions run asynchronously, so the seconds are their enqueueing)
reduction_stats: dict = {"seconds": 0.0, "calls": 0}


def reset_reduction_stats() -> None:
    reduction_stats.update(seconds=0.0, calls=0)


def _on(device: torch.device):
    """The CUDA device context a shard's launches need (a no-op on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_rows(t: Tensor, shard: int, rows: int, device: torch.device) -> Tensor:
    """Global shard ``shard``'s rows of ``t`` (rows [shard × rows,
    (shard + 1) × rows), zero rows past the end) on ``device``: a view
    where no padding is needed and ``t`` already lies there."""
    n = t.shape[0]
    lo, hi = min(shard * rows, n), min((shard + 1) * rows, n)
    part = t[lo:hi]
    if hi - lo < rows:
        part = torch.cat([part, part.new_zeros((rows - (hi - lo),) + tuple(t.shape[1:]))])
    return part.to(device)


def _slice_rows(batch: Batch, shard: int, rows: int, device: torch.device) -> Batch:
    if not isinstance(batch, (DenseBatch, SparseBatch)):
        raise TypeError(f"row shards are cut from a DenseBatch or a SparseBatch, not {type(batch).__name__}")
    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
    return type(batch)(**{k: shard_rows(v, shard, rows, device) if isinstance(v, Tensor) else v
                          for k, v in fields.items()})


def shard_batch(batch: DenseBatch | SparseBatch, mesh: Mesh | ProcessMesh) -> list[DenseBatch | SparseBatch]:
    """This process's row shards: the rows split into the mesh's global
    shards of ceil(n / shards) rows each (the tail padded with zero-weight
    rows), shard i of ``as_process_mesh(mesh).local`` on its device (a row
    slice on the batch's own device is a view, not a copy)."""
    pm = as_process_mesh(mesh)
    rows = shard_extent(batch.num_rows, pm.num_shards)
    return [_slice_rows(batch, s, rows, dev) for s, dev in zip(pm.global_shards(), pm.local)]


def _densify_sharded(batch: SparseBatch, mesh: Mesh | ProcessMesh) -> list[DenseBatch]:
    """A sparse batch whose dense form fits the mesh's cards but not one:
    the sparse rows are sharded first and each shard densifies on its own
    device, so the whole (n, d) matrix never exists on one card."""
    out = []
    for shard, dev in zip(shard_batch(batch, mesh), as_process_mesh(mesh).local):
        with _on(dev):
            out.append(densify(shard))
    return out


def _mesh_budget_bytes(mesh: Mesh | ProcessMesh) -> float:
    """The memory a dataset may hold on the mesh: one card's budget times
    the distinct devices it spans (shards that share a card share its
    memory; each process counts its own)."""
    from photon_ml_tpu_torch.ops.streaming import device_hbm_budget_bytes

    mesh = as_process_mesh(mesh)
    return device_hbm_budget_bytes(device=mesh.head) * len(set(mesh.local)) * mesh.process_count


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
    # set when the shards are this process's part of a mesh across processes
    mesh: ProcessMesh | None = None

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
        shard 0's device and rounded once to its own dtype. Across processes
        the float64 partials of every global shard are gathered (one gloo
        gather) and summed on the host in global shard order: the same
        additions in the same order, so the same bits."""
        t0 = time.perf_counter()
        if self.mesh is not None and self.mesh.spans_processes:
            out = self._sum_across_processes(parts)
        else:
            dev = self.device
            out = []
            for k in range(len(parts[0])):
                acc = parts[0][k].to(dev, torch.float64)
                for p in parts[1:]:
                    acc = acc + p[k].to(dev, torch.float64)
                out.append(acc.to(parts[0][k].dtype))
            out = tuple(out)
        reduction_stats["seconds"] += time.perf_counter() - t0
        reduction_stats["calls"] += 1
        return out

    def _sum_across_processes(self, parts: list) -> tuple:
        local = [np.stack([p[k].detach().to(torch.float64).cpu().numpy() for p in parts])
                 for k in range(len(parts[0]))]
        ranks = _gather_arrays(local)
        out = []
        for k, ref in enumerate(parts[0]):
            shards = [s for rank in ranks for s in rank[k]]  # global shard order
            acc = shards[0]
            for part in shards[1:]:
                acc = acc + part
            out.append(torch.from_numpy(np.array(acc, np.float64)).to(self.device).to(ref.dtype))
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


def shard_layout(
    batch: Batch, mesh: Mesh | ProcessMesh, fused: bool | None = None
) -> tuple[list[Batch], bool, tuple[bool, bool]]:
    """This process's shards of ``batch`` in their training layout, and the
    objective's ``fused`` flag and data hints: the ingest layout decision
    of ``sharded_objective``, made once (the GAME fixed effect re-binds
    each visit's offsets onto the shards)."""
    from photon_ml_tpu_torch.ops.streaming import device_hbm_budget_bytes

    pm = as_process_mesh(mesh)
    shards = None
    hints = (False, False)  # shards built here read their offsets and weights
    if isinstance(batch, SparseBatch):
        one_card = device_hbm_budget_bytes(device=pm.head)
        dense_bytes = batch.num_rows * batch.num_features * 4
        if dense_bytes <= one_card:
            batch = maybe_densify(batch, one_card)
        elif dense_bytes <= _mesh_budget_bytes(mesh):
            shards = _densify_sharded(batch, mesh)
        elif supports_tiling(batch):
            shards = [tile_sparse_batch(s) for s in shard_batch(batch, pm)]
    if shards is None:
        shards = shard_batch(batch, pm)
        if fused is None:
            fused = all(auto_fused(s) for s in shards)
        if fused:
            hints = _constant_hints(batch)
            if batch.num_rows % pm.num_shards:
                hints = (hints[0], False)
    elif fused is None:
        fused = all(auto_fused(s) for s in shards)
    return shards, bool(fused), hints


def objective_over_shards(
    shards: Sequence[Batch],
    mesh: Mesh | ProcessMesh,
    loss: PointwiseLoss,
    l2_weight: float | Tensor = 0.0,
    norm: NormalizationContext | None = None,
    intercept_index: int | None = None,
    fused: bool = False,
    hints: tuple[bool, bool] = (False, False),
    prior: GaussianPrior | None = None,
) -> ShardedGLMObjective:
    """One objective per shard of ``shard_layout``, each on its device."""
    pm = as_process_mesh(mesh)
    objs = []
    for shard, dev in zip(shards, pm.local):
        with _on(dev):
            objs.append(make_objective(
                shard, loss, l2_weight=l2_weight, norm=norm, intercept_index=intercept_index,
                fused=fused and isinstance(shard, DenseBatch), data_hints=hints, prior=prior,
                device=dev,
            ))
    return ShardedGLMObjective(shards=tuple(objs), mesh=pm)


def sharded_objective(
    batch: Batch,
    mesh: Mesh | ProcessMesh,
    loss: PointwiseLoss,
    l2_weight: float | Tensor = 0.0,
    norm: NormalizationContext | None = None,
    intercept_index: int | None = None,
    fused: bool | None = None,
    prior: GaussianPrior | None = None,
) -> ShardedGLMObjective:
    """The batch split over ``mesh`` as one objective (this process's
    shards of a ``ProcessMesh``).

    The ingest layout decision is the reference's: a sparse batch
    densifies when its dense matrix fits one card's budget
    (``device_hbm_budget_bytes``), densifies shard by shard when it fits
    the mesh's cards together, and is otherwise re-blocked into one K3
    layout per shard when ``supports_tiling`` takes it. ``fused=None``
    enables K1 / K2 when every shard takes them (``auto_fused``). Rows
    padded in to divide the shard count turn the all-ones weights hint
    off, so each shard's kernel reads its weights and the padding stays
    inert (a kernel given no weights counts every row once). Across
    processes ``batch`` is every process's same replicated batch, so every
    process takes the same decisions."""
    shards, fused, hints = shard_layout(batch, mesh, fused)
    return objective_over_shards(shards, mesh, loss, l2_weight=l2_weight, norm=norm,
                                 intercept_index=intercept_index, fused=fused, hints=hints, prior=prior)


def refuse_newton(minimize_fn) -> None:
    """The port's Newton solves a single GLM as one lane of its lane solver,
    which needs the whole dense batch on one device: a sharded solve
    refuses it."""
    from photon_ml_tpu_torch.optim.newton import newton_minimize

    if minimize_fn is newton_minimize:
        raise NotImplementedError(
            "NEWTON_CHOLESKY runs a single GLM as one lane of the lane solver, on one device; "
            "the sharded solve takes LBFGS (OWL-QN with L1) or TRON"
        )


def sharded_minimize(
    minimize_fn: Callable[..., OptimizationResult],
    batch: Batch,
    w0: Tensor,
    config: OptimizerConfig,
    mesh: Mesh | ProcessMesh,
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
    refuse_newton(minimize_fn)
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
