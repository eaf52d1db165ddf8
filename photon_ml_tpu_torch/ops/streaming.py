"""Out-of-core GLM training: chunked host-to-device objective evaluation
(port of ``photon_ml_tpu/ops/streaming.py``).

When a dataset exceeds the card's memory, the batch lives in host memory
as a list of uniform chunk dicts (``chunk_batch``, ``dense_chunks``,
``sparse_chunks`` or ``AvroDataReader.iter_batch_chunks``), and every
objective evaluation streams the chunks through the card, summing partial
values and gradients there in chunk order. The copies run ahead of the
compute (``ops/prefetch.py``: worker threads, none at depth 0, and a
device-resident chunk cache at every depth), and every kernel call and
sum stays on the calling thread in chunk order, so all depths give bitwise
equal results.

Each chunk goes through ``GLMObjective`` with no regularization: a dense
chunk takes the one-pass kernels K1 (``value_and_grad``) and K2 (``hvp``),
and a sparse chunk of a width that ``auto_tile_streaming`` accepts runs K3
on its packed layouts, which are built once (``ops/tile_cache.py``) and
stay on the card, so only its labels, offsets and weights stream. On a CPU the
same calls run the kernels' plain versions. L2, or the Gaussian prior, is
added once after the stream; normalization applies inside each chunk's
contract, and the chunk gradients add up because ``grad_to_model_space``
is linear.

The optimizers over these objectives are the host loops of
``optim/host_lbfgs.py`` and ``optim/host_tron.py``: one streamed pass per
value-and-gradient evaluation, plus one per CG step for TRON.
``fits_in_memory`` is the rule between them and the in-memory solvers.

With ``cross_process`` every process streams its own chunks (none is
allowed) and each pass's sums, read back in float64, meet in
``allreduce_sum_host`` (``parallel/multihost.py``) before the regularizer
is added, so every process holds the same value and gradient.

Feature-range sharding (``PHOTON_FE_SHARD=1``, sparse chunks) is the
other axis: every process streams all the rows, and holds only its range
[lo, hi) of ``data/index_map.py``'s ``plan_feature_ranges`` over the
global nonzero histogram. Its chunks are restricted to the range
(``_fe_restrict_chunks``), its K3 layouts are packed at width hi − lo, and
its coefficients, gradients and curvature vectors are the (hi − lo,)
segment. Each evaluation is two passes: phase A streams the range's
partial margins (one K3 ``matvec`` a chunk and vector) and sums them over
the processes in one ascending-rank reduction (float32 on the wire, summed
in float64, rounded once), the local L2 scalar riding along; phase B
derives value, gradient, H·v or diag(H) from the combined margins with
K3's ``rmatvec`` / ``rmatvec_sq``. The ranges are disjoint, so each
process's segment is its exact share and ``fe_gather`` assembles the full
vector by concatenation. ``fe_dot`` gives the host solvers the global
inner products they branch on.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.data.index_map import FeatureRangePlan, fe_shard_enabled, plan_feature_ranges
from photon_ml_tpu_torch.obs import devcost
from photon_ml_tpu_torch.normalization import NormalizationContext, no_normalization
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.ops import prefetch, stream_executor, tile_cache
from photon_ml_tpu_torch.ops.batch import Batch, DenseBatch, SparseBatch, densify
from photon_ml_tpu_torch.ops.fused import supports_fused
from photon_ml_tpu_torch.ops.glm import GLMObjective, fused_disabled, reg_curvature, reg_delta, reg_term
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.sparse_tiled import TiledSparseBatch, auto_tile_streaming, tiled_apply_cost

Tensor = torch.Tensor

_TILED_STREAM_KEYS = ("labels", "offsets", "weights")


def chunk_batch(batch_arrays: dict, chunk_rows: int) -> list[dict]:
    """Split host arrays of one leading length into uniform
    ``chunk_rows``-row chunks; the last is padded with zero-weight rows."""
    n = len(batch_arrays["labels"])
    chunks = []
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        chunk = {k: v[lo:hi] for k, v in batch_arrays.items()}
        pad = chunk_rows - (hi - lo)
        if pad:
            for k, v in chunk.items():
                chunk[k] = np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
            chunk["weights"][hi - lo:] = 0.0  # padded rows are inert
        chunks.append(chunk)
    return chunks


def dense_chunks(X: np.ndarray, labels: np.ndarray, chunk_rows: int,
                 offsets: np.ndarray | None = None, weights: np.ndarray | None = None) -> list[dict]:
    n = X.shape[0]
    return chunk_batch(
        {
            "X": X,
            "labels": labels,
            "offsets": np.zeros(n, X.dtype) if offsets is None else offsets,
            "weights": np.ones(n, X.dtype) if weights is None else weights,
        },
        chunk_rows,
    )


def sparse_chunks(indices: np.ndarray, values: np.ndarray, labels: np.ndarray, chunk_rows: int,
                  offsets: np.ndarray | None = None, weights: np.ndarray | None = None) -> list[dict]:
    n = indices.shape[0]
    return chunk_batch(
        {
            "indices": indices,
            "values": values,
            "labels": labels,
            "offsets": np.zeros(n, values.dtype) if offsets is None else offsets,
            "weights": np.ones(n, values.dtype) if weights is None else weights,
        },
        chunk_rows,
    )


def device_hbm_budget_bytes(default: float = 8e9, fraction: float = 0.75, device=None) -> float:
    """The memory a dataset may hold on the card: ``fraction`` of its total
    memory (room for the coefficients, the optimizer's state and scratch).
    ``device=None`` asks the current card; without CUDA, or on a CPU
    device, ``default``."""
    dev = torch.device(device if device is not None else "cuda" if torch.cuda.is_available() else "cpu")
    queried = dev.type == "cuda"
    budget = fraction * float(torch.cuda.get_device_properties(dev).total_memory) if queried else default
    from photon_ml_tpu_torch.obs import devcost

    devcost.record_hbm_budget(budget, queried)
    return budget


def fits_in_memory(num_rows: int, num_features: int, itemsize: int = 4,
                   hbm_budget_bytes: float | None = None, device=None) -> bool:
    """The rule between the device-resident solvers and streaming;
    ``hbm_budget_bytes=None`` asks the device."""
    if hbm_budget_bytes is None:
        hbm_budget_bytes = device_hbm_budget_bytes(device=device)
    return num_rows * num_features * itemsize <= hbm_budget_bytes


def _to_batch(chunk: dict, num_features: int | None) -> Batch:
    """A device chunk as a batch (sparse indices as int64)."""
    if "X" in chunk:
        return DenseBatch(X=chunk["X"], labels=chunk["labels"], offsets=chunk["offsets"],
                          weights=chunk["weights"])
    return SparseBatch(
        indices=chunk["indices"].long(), values=chunk["values"], labels=chunk["labels"],
        offsets=chunk["offsets"], weights=chunk["weights"], num_features=num_features,
    )


def _host_sparse_batch(chunk: dict, num_features: int | None) -> SparseBatch:
    """A host chunk's nonzeros as a CPU ``SparseBatch`` for the layout
    cache (which copies them to the device on a miss only); the per-row
    arrays are left empty, the layout takes none of them."""
    empty = torch.zeros(0)
    return SparseBatch(
        indices=torch.from_numpy(np.ascontiguousarray(chunk["indices"])).long(),
        values=torch.from_numpy(np.ascontiguousarray(chunk["values"], np.float32)),
        labels=empty, offsets=empty, weights=empty, num_features=num_features,
    )


def _fe_nnz_histogram(chunks: Sequence[dict], num_features: int) -> np.ndarray:
    """Per-feature nonzero counts over sparse host chunks (zero-valued
    slots left out: they pack to nothing). Rows are replicated under
    feature-range sharding, so this local histogram is the global one."""
    nnz = np.zeros(num_features, np.int64)
    for c in chunks:
        idx = np.asarray(c["indices"]).ravel()
        live = idx[np.asarray(c["values"]).ravel() != 0.0]
        if live.size:
            nnz += np.bincount(live, minlength=num_features)
    return nnz


def _fe_restrict_chunks(chunks: Sequence[dict], lo: int, hi: int) -> tuple[list[dict], int]:
    """Sparse host chunks restricted to the feature range [lo, hi): entries
    outside it become (0, 0.0), inert in every direction, entries inside
    shift by −lo, and every chunk keeps its live entries first (stable) in
    one common row width, the most any row keeps, so the restricted chunks
    are uniform and their raw stream shrinks with the range. Labels,
    offsets and weights are the input chunks' own arrays (the chunk cache
    keeps hitting). Returns (chunks, width)."""
    keeps, k_max = [], 1
    for c in chunks:
        idx, val = np.asarray(c["indices"]), np.asarray(c["values"])
        keep = (idx >= lo) & (idx < hi) & (val != 0.0)
        if keep.size:
            k_max = max(k_max, int(keep.sum(axis=1).max()))
        keeps.append(keep)
    out = []
    for c, keep in zip(chunks, keeps):
        idx, val = np.asarray(c["indices"]), np.asarray(c["values"])
        order = np.argsort(~keep, axis=1, kind="stable")
        idx_loc = np.take_along_axis(np.where(keep, idx - lo, 0).astype(idx.dtype), order, axis=1)[:, :k_max]
        val_loc = np.take_along_axis(np.where(keep, val, 0.0).astype(val.dtype), order, axis=1)[:, :k_max]
        out.append(dict(c, indices=np.ascontiguousarray(idx_loc), values=np.ascontiguousarray(val_loc)))
    return out, k_max


def _fe_plan(chunks: Sequence[dict], num_features: int) -> tuple[FeatureRangePlan, tuple]:
    """This process's plan and range identity (pid, lo, hi, P) over the
    process group (one range on a lone process)."""
    from photon_ml_tpu_torch.parallel.multihost import process_count, process_index

    p, pid = process_count(), process_index()
    plan = plan_feature_ranges(_fe_nnz_histogram(chunks, num_features), p)
    lo, hi = plan.range_of(pid)
    return plan, (pid, lo, hi, p)


def _fe_allreduce(*arrays: np.ndarray):
    """The phase-A reduction: float32 host arrays summed over the processes
    in rank order (float32 on the wire, float64 sums); unchanged on one."""
    from photon_ml_tpu_torch.parallel.multihost import allreduce_sum_lockstep

    return allreduce_sum_lockstep(*arrays, wire_dtype=np.float32)


def _weighted(b: Batch, x: Tensor) -> Tensor:
    """weights·x with zero-weight rows exactly 0 (``GLMObjective._weighted``)."""
    return torch.where(b.weights != 0.0, b.weights * x, torch.zeros_like(x))


def _fe_cost(b: Batch, directions: dict) -> Callable[[], dict]:
    """One chunk's analytic work in a sharded phase: K3's on each named
    (direction: times) of a tiled chunk (a gather's 2 operations a nonzero
    otherwise), and the chunk's per-row arrays read once."""
    def cost() -> dict:
        rows = 4.0 * 3 * b.num_rows
        if isinstance(b, TiledSparseBatch):
            parts = [(tiled_apply_cost(b.g if name != "matvec" else b.m, name == "rmatvec_sq"), k)
                     for name, k in directions.items()]
            flops = sum(c["flops"] * k for c, k in parts)
            nbytes = sum(c["bytes_accessed"] * k for c, k in parts) + rows
        else:
            nnz = float(b.indices.numel())
            flops = sum(2.0 * nnz * k for k in directions.values())
            nbytes = sum(12.0 * nnz * k for k in directions.values()) + rows
        return {"flops": flops, "bytes_accessed": nbytes}
    return cost


def _same_storage(a, b) -> bool:
    """True when ``a`` and ``b`` are numpy arrays over the same memory (the
    same object, or views with one data pointer, shape and strides)."""
    if a is b:
        return True
    if not (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)):
        return False
    ai, bi = a.__array_interface__, b.__array_interface__
    return (ai["data"] == bi["data"] and ai["shape"] == bi["shape"]
            and ai["strides"] == bi["strides"] and a.dtype == b.dtype)


@dataclass
class StreamingGLMObjective:
    """GLM objective over host-resident chunks of uniform shape, on
    ``device`` (CUDA unless the caller passes another; raises without it).

    The ``value`` / ``value_and_grad`` / ``hvp`` / ``hessian_diag`` /
    ``hessian`` contracts of ``GLMObjective``, each one streamed pass, so
    the host solvers take it directly. ``prior_mean`` / ``prior_precision``
    (the solver's space) make the regularizer 0.5·λ₂·Σ maskⱼ·precⱼ·(wⱼ−μⱼ)².
    ``cross_process`` sums every pass over all processes (each holding its
    own chunks, possibly none); every process must then evaluate the same
    contracts in the same order.
    ``tile_sparse=None`` tiles sparse chunks by ``auto_tile_streaming``
    (on the global width, sharded or not);
    the layouts are built once from the first chunks, and a later
    ``chunks`` swap may change labels, offsets or weights but nothing else
    (the fingerprints refuse it).
    ``fe_shard=None`` follows ``PHOTON_FE_SHARD`` on sparse chunks; True
    or False forces it. Sharded, the objective's vectors are this
    process's range segment (``fe_slice``, ``fe_gather``, ``fe_dot``), its
    values are global, and every process must evaluate the same contracts
    in the same order. It refuses dense chunks, ``cross_process``,
    ``norm``, a chunk swap and the FULL Hessian."""

    chunks: Sequence[dict]
    loss: PointwiseLoss
    num_features: int
    l2_weight: float = 0.0
    intercept_index: int | None = None
    norm: NormalizationContext | None = None
    cross_process: bool = False
    prior_mean: Tensor | None = None
    prior_precision: Tensor | None = None
    tile_sparse: bool | None = None
    fe_shard: bool | None = None
    device: torch.device | str | None = None
    # seconds each chunk's layout took to build or to find in the cache
    layout_build_s: list = field(default_factory=list)

    # d-bound on the streamed FULL Hessian: the (d, d) float32 sum stays on
    # the card for the whole pass (8192 → 256 MB)
    FULL_HESSIAN_MAX_D = 8192

    def __post_init__(self):
        sparse = bool(self.chunks) and "indices" in self.chunks[0]
        if not self.chunks and not self.cross_process:
            raise ValueError("streaming objective needs at least one chunk")
        dev = resolve_device(self.device)
        self.device = dev
        d = self.num_features
        mask = torch.ones(d, dtype=torch.float32, device=dev)
        if self.intercept_index is not None:
            mask[self.intercept_index] = 0.0
        self.reg_mask = mask  # the host OWL-QN applies its L1 over this mask (the range's, sharded)
        if self.prior_mean is not None:
            self.prior_mean = torch.as_tensor(self.prior_mean, dtype=torch.float32, device=dev)
        if self.prior_precision is not None:
            self.prior_precision = torch.as_tensor(self.prior_precision, dtype=torch.float32, device=dev)
        self._zero = torch.zeros((), dtype=torch.float32, device=dev)
        self._tile_layouts = None
        self._tile_fingerprints = None
        self._fe_plan = None
        self._fe_range = None  # (pid, lo, hi, P) when sharded
        self._fe_chunks = None
        self._fe_dim = d
        if self.fe_shard if self.fe_shard is not None else (sparse and fe_shard_enabled()):
            self._init_fe_shard(sparse)
        self._norm = (no_normalization(self._fe_dim, self.intercept_index, device=dev) if self.norm is None
                      else self.norm.to(dev))
        want_tiling = (self.tile_sparse if self.tile_sparse is not None
                       else auto_tile_streaming(sparse, d, dev))
        if want_tiling and sparse:
            self._build_tile_layouts()

    def _init_fe_shard(self, sparse: bool) -> None:
        """Restrict this process to its feature range: the plan from the
        global nonzero histogram and the process count (the same on every
        process), the restricted chunks, and the regularizer's mask and
        prior sliced to the range (disjoint ranges: the local quadratic
        terms sum to the global one)."""
        if not sparse:
            raise ValueError("PHOTON_FE_SHARD requires sparse chunks (dense chunks fit one card by construction)")
        if self.cross_process:
            raise ValueError("PHOTON_FE_SHARD shards the feature axis over replicated rows; cross_process "
                             "shards the rows: the two are exclusive on one objective")
        if self.norm is not None:
            raise NotImplementedError("PHOTON_FE_SHARD supports identity normalization only (norm=None): "
                                      "normalization shifts couple all ranges through the margin correction")
        plan, fe_range = _fe_plan(self.chunks, self.num_features)
        pid, lo, hi, p = fe_range
        self._fe_plan, self._fe_range, self._fe_dim = plan, fe_range, hi - lo
        self._fe_chunks, _ = _fe_restrict_chunks(self.chunks, lo, hi)
        self.reg_mask = self.reg_mask[lo:hi]
        if self.prior_mean is not None:
            self.prior_mean = self.prior_mean[lo:hi]
        if self.prior_precision is not None:
            self.prior_precision = self.prior_precision[lo:hi]
        for name, value in (("ranges", p), ("width", hi - lo), ("nnz_local", plan.weights[pid]),
                            ("nnz_balance", plan.balance)):
            REGISTRY.gauge_set(f"fe_shard.{name}", float(value))

    def _build_tile_layouts(self) -> None:
        """Each sparse chunk's K3 layouts, built once through the
        process-wide cache (a rebuilt objective over the same data packs
        nothing) and kept on the card."""
        layouts, fps = [], []
        for c in self._source():
            t0 = time.perf_counter()
            fp = tile_cache.structure_fingerprint(c["indices"], c["values"])
            tb = tile_cache.tiled_layout_for(_host_sparse_batch(c, self._fe_dim),
                                             fingerprint=(fp[0], self._fe_dim, fp[1], fp[2]),
                                             device=self.device, fe_range=self._fe_range)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.layout_build_s.append(time.perf_counter() - t0)
            layouts.append((tb.m, tb.g))
            fps.append(fp)
        self._tile_layouts = layouts
        self._tile_fingerprints = fps

    @property
    def tiled(self) -> bool:
        return self._tile_layouts is not None

    def _source(self) -> Sequence[dict]:
        """The chunks the passes stream: the restricted ones when sharded."""
        return self._fe_chunks if self._fe_chunks is not None else self.chunks

    def __setattr__(self, name, value):
        if name == "chunks" and getattr(self, "_fe_chunks", None) is not None:
            # the restricted chunks and their plan came from the previous
            # chunks; re-deriving a plan mid-solve would not be lock step
            raise ValueError("chunk swap under feature-range sharding (PHOTON_FE_SHARD); "
                             "rebuild the StreamingGLMObjective")
        if name == "chunks" and getattr(self, "_tile_layouts", None) is not None:
            # the layouts were built from the previous chunks' indices and
            # values: a swap may change labels, offsets and weights only
            old = getattr(self, "chunks", None)
            for i, c in enumerate(value):
                prev = old[i] if old is not None and i < len(old) else None
                if (prev is not None and _same_storage(c.get("indices"), prev.get("indices"))
                        and _same_storage(c.get("values"), prev.get("values"))):
                    continue
                if (i >= len(self._tile_fingerprints)
                        or tile_cache.structure_fingerprint(c["indices"], c["values"])
                        != self._tile_fingerprints[i]):
                    raise ValueError("chunk swap changed indices/values under cached K3 layouts; "
                                     "rebuild the StreamingGLMObjective")
            if len(value) != len(self._tile_fingerprints):
                raise ValueError("chunk swap changed the chunk count under cached K3 layouts; "
                                 "rebuild the StreamingGLMObjective")
        object.__setattr__(self, name, value)

    # -- the stream ---------------------------------------------------------------
    def _chunk_batch(self, cur: dict, i: int) -> Batch:
        if self._tile_layouts is not None:
            m, g = self._tile_layouts[i]
            return TiledSparseBatch(m=m, g=g, labels=cur["labels"], offsets=cur["offsets"],
                                    weights=cur["weights"], num_features=self._fe_dim, fe_range=self._fe_range)
        return _to_batch(cur, self._fe_dim)

    def _chunk_objective(self, b: Batch) -> GLMObjective:
        """One chunk's contracts with no regularization: the one-pass
        kernels on a dense chunk of a shape they take (their plain versions
        on a CPU chunk), offsets and weights always read."""
        fused = (isinstance(b, DenseBatch) and not fused_disabled()
                 and supports_fused(b.num_rows, b.num_features, b.X.dtype))
        return GLMObjective(batch=b, norm=self._norm, l2_weight=self._zero, reg_mask=self.reg_mask,
                            loss=self.loss, fused=fused)

    def _slim(self, c: dict) -> dict:
        return {k: c[k] for k in _TILED_STREAM_KEYS} if self._tile_layouts is not None else c

    def _batches(self, consumer_name: str = "objective"):
        """Each chunk's batch on the card, in order, with its copies waited
        for on the calling thread's stream. The chunks come through the
        chunk cache at every prefetch depth; depth 0 prepares each one on
        this thread. With ``PHOTON_STREAM_EXECUTOR=1`` they come through
        the executor's stream ``consumer_name`` and its arbiter, keyed by
        content and the feature range, so another stream's resident copy
        of the same content serves them."""
        src, dev = self._source(), self.device
        consumer = prefetch.consumer_stream(dev)
        if stream_executor.stream_executor_enabled():
            def prepare(i):
                return stream_executor.cached_device_put(consumer_name, self._slim(src[i]), dev, consumer,
                                                         context=self._fe_range)

            items = stream_executor.stream(consumer_name, len(src), prepare)
        else:
            def prepare(i):
                return prefetch.cached_device_put(self._slim(src[i]), dev, consumer)

            items = prefetch.prefetch_iter(len(src), prepare)
        for i, cur in enumerate(items):
            prefetch.wait(cur, consumer)
            yield self._chunk_batch(cur, i)

    def _stream(self, kernel: Callable[[Batch, int], object], accumulate: Callable, init,
                cost_label: str | None = None, cost: Callable[[Batch], Callable] | None = None):
        """One pass: ``kernel(batch, chunk index)`` on every chunk in order,
        folded by ``accumulate``. ``cost_label`` records the first chunk's
        analytic work (``cost(batch)``) under device-cost capture."""
        acc = init
        if not self.chunks:  # a process without rows streams nothing
            return acc
        # one registry update a pass, none a chunk
        REGISTRY.counter_inc("stream.passes")
        REGISTRY.counter_inc("stream.chunks", len(self.chunks))
        for i, b in enumerate(self._batches()):
            if i == 0 and cost_label is not None and devcost.capture_enabled():
                devcost.capture(cost_label, (b.labels, self._fe_range), cost(b))
            acc = accumulate(acc, kernel(b, i))
        return acc

    def _each_chunk(self, contract: Callable[[GLMObjective], object]) -> Callable[[Batch, int], object]:
        return lambda b, _: contract(self._chunk_objective(b))

    def _across_processes(self, *sums: Tensor) -> tuple[Tensor, ...]:
        """This process's pass sums summed over all processes when
        ``cross_process`` (read back in float64, summed in rank order,
        rounded once to float32 on the device); unchanged otherwise."""
        if not self.cross_process:
            return sums
        from photon_ml_tpu_torch.parallel.multihost import allreduce_sum_host

        host = [t.detach().to(torch.float64).cpu().numpy() for t in sums]
        total = allreduce_sum_host(*host)
        total = total if len(sums) > 1 else (total,)
        return tuple(torch.as_tensor(np.asarray(t), dtype=torch.float32, device=self.device) for t in total)

    # -- the regularizer, once after the stream -----------------------------------
    def _l2_term(self, w: Tensor) -> Tensor:
        return reg_term(w, float(self.l2_weight), self.reg_mask, self.prior_mean, self.prior_precision)

    def _w(self, w) -> Tensor:
        return torch.as_tensor(w, dtype=torch.float32, device=self.device)

    # -- contracts ----------------------------------------------------------------
    def value(self, w) -> Tensor:
        if self._fe_range is not None:
            return self._fe_value(self._w(w))
        w = self._w(w)
        total = self._stream(self._each_chunk(lambda o: o.value(w)), lambda acc, v: acc + v, self._zero)
        (total,) = self._across_processes(total)
        return total + self._l2_term(w)

    def value_and_grad(self, w) -> tuple[Tensor, Tensor]:
        if self._fe_range is not None:
            return self._fe_value_and_grad(self._w(w))
        w = self._w(w)
        init = (self._zero, torch.zeros(self.num_features, dtype=torch.float32, device=self.device))
        v, g = self._stream(self._each_chunk(lambda o: o.value_and_grad(w)),
                            lambda acc, out: (acc[0] + out[0], acc[1] + out[1]), init)
        v, g = self._across_processes(v, g)
        g = g + float(self.l2_weight) * self.reg_mask * reg_delta(w, self.prior_mean, self.prior_precision)
        return v + self._l2_term(w), g

    def hvp(self, w, v) -> Tensor:
        """Gauss-Newton H·v, streamed: TRON's CG step costs one pass (two
        sharded: the margins of w and v, then the contraction)."""
        w, v = self._w(w), self._w(v)
        if self._fe_range is not None:
            return self._fe_hvp(w, v)
        init = torch.zeros(self.num_features, dtype=torch.float32, device=self.device)
        hv = self._stream(self._each_chunk(lambda o: o.hvp(w, v)), lambda acc, out: acc + out, init)
        (hv,) = self._across_processes(hv)
        return hv + float(self.l2_weight) * self.reg_mask * reg_curvature(
            v, self.prior_mean, self.prior_precision) * v

    def hessian_diag(self, w) -> Tensor:
        """diag(H), streamed: SIMPLE variances cost one pass (two sharded)."""
        w = self._w(w)
        if self._fe_range is not None:
            return self._fe_hessian_diag(w)
        init = torch.zeros(self.num_features, dtype=torch.float32, device=self.device)
        diag = self._stream(self._each_chunk(lambda o: o.hessian_diag(w)), lambda acc, out: acc + out, init)
        (diag,) = self._across_processes(diag)
        return diag + float(self.l2_weight) * self.reg_mask * reg_curvature(
            diag, self.prior_mean, self.prior_precision)

    def hessian(self, w) -> Tensor:
        """The full (d, d) Hessian, streamed: FULL variances cost one pass
        that sums each chunk's Zᵀ(d2·Z) (sparse chunks densified), bounded
        by ``FULL_HESSIAN_MAX_D``."""
        if self._fe_range is not None:
            raise NotImplementedError(
                "FULL variance is not supported under feature-range sharding (PHOTON_FE_SHARD): the d×d "
                "Hessian couples all ranges; use SIMPLE variances"
            )
        if self._tile_layouts is not None:
            raise NotImplementedError(
                "FULL variance is not supported with K3 streamed chunks (the raw per-chunk "
                "indices are not kept); build the objective with tile_sparse=False or use SIMPLE"
            )
        if self.num_features > self.FULL_HESSIAN_MAX_D:
            raise NotImplementedError(
                f"streamed FULL variance supports d <= {self.FULL_HESSIAN_MAX_D} (the dense d×d "
                f"Hessian sum would be {self.num_features}² floats); use SIMPLE variances at this width"
            )
        w = self._w(w)
        d = self.num_features
        init = torch.zeros((d, d), dtype=torch.float32, device=self.device)

        def chunk_hessian(o: GLMObjective) -> Tensor:
            if isinstance(o.batch, SparseBatch):
                o = GLMObjective(batch=densify(o.batch), norm=o.norm, l2_weight=o.l2_weight,
                                 reg_mask=o.reg_mask, loss=o.loss)
            return o.hessian(w)

        h = self._stream(self._each_chunk(chunk_hessian), lambda acc, out: acc + out, init)
        (h,) = self._across_processes(h)
        return h + torch.diag(float(self.l2_weight) * self.reg_mask * reg_curvature(
            self.reg_mask, self.prior_mean, self.prior_precision))

    def stream_scores(self, w, num_rows: int) -> np.ndarray:
        """Margins X·w (no offsets) over this objective's chunks, trimmed to
        ``num_rows``, through the layouts the solve used when it has them.
        Under ``cross_process`` the rows are this process's own, as in the
        reference: scoring rows needs no collective. Sharded, ``w`` is the
        range segment and the scores are the combined margins, the same on
        every process (a collective)."""
        w = self._w(w)
        if self._fe_range is not None:
            if not self.chunks:
                return np.zeros(num_rows, np.float32)
            return self._fe_combine_margins((w,))[0].cpu().numpy()[:num_rows]
        outs = [b.matvec(w) for b in self._batches("scores")]
        if not outs:
            return np.zeros(num_rows, np.float32)
        return torch.cat(outs).cpu().numpy()[:num_rows]

    # -- feature-range sharding (PHOTON_FE_SHARD) ---------------------------------
    # Phase A: the range's partial margins, one reduction a pass (the L2
    # value piggybacks); phase B: each chunk reads its rows of the combined
    # margins. The data value is a full-data sum every process forms alike;
    # gradients and curvature are this range's disjoint segment, exact by
    # construction; the regularizer is elementwise over the local slices.
    @property
    def fe_active(self) -> bool:
        """True when the objective's vectors are a feature-range segment."""
        return self._fe_range is not None

    def fe_slice(self, w_full) -> np.ndarray:
        """This process's segment of a full-space vector (a warm start)."""
        _, lo, hi, _ = self._fe_range
        full = w_full.cpu().numpy() if isinstance(w_full, torch.Tensor) else np.asarray(w_full)
        return full[lo:hi]

    def fe_gather(self, w_local) -> np.ndarray:
        """The full vector from every process's segment, in range order: a
        concatenation, bitwise the segments (a collective over the framed
        mesh, tag ``fe_gather``; the segment itself on one range)."""
        from photon_ml_tpu_torch.parallel.multihost import allgather_concat

        local = w_local.cpu().numpy() if isinstance(w_local, torch.Tensor) else np.asarray(w_local)
        return local if self._fe_range[3] <= 1 else allgather_concat(local)

    def fe_dot(self, a, b) -> float:
        """The global inner product of two segments: a local float64 dot
        summed over the processes in rank order, the same on every
        process (the host solvers' line searches branch on it)."""
        from photon_ml_tpu_torch.parallel.multihost import allreduce_sum_lockstep

        return float(allreduce_sum_lockstep(np.asarray(np.dot(np.asarray(a, np.float64), np.asarray(b, np.float64)))))

    def _fe_combine_margins(self, ws: tuple, l2_w: Tensor | None = None):
        """Phase A: (len(ws), rows) combined margins on the device (and the
        global L2 value when ``l2_w`` is given), the same bits on every
        process."""
        parts = self._stream(lambda b, _: torch.stack([b.matvec(w) for w in ws]),
                             lambda acc, out: acc + [out], [], cost_label="streaming.fe_margins",
                             cost=lambda b: _fe_cost(b, {"matvec": len(ws)}))
        partial = torch.cat(parts, dim=1).cpu().numpy()
        if l2_w is None:
            return torch.as_tensor(np.asarray(_fe_allreduce(partial)), dtype=torch.float32, device=self.device)
        m, l2 = _fe_allreduce(partial, self._l2_term(l2_w).cpu().numpy())
        as_dev = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)  # noqa: E731
        return as_dev(m), as_dev(l2)

    def _fe_rows(self, m: Tensor, b: Batch, i: int) -> Tensor:
        """Chunk i's rows of combined margins ``m`` (chunks are uniform)."""
        n = b.num_rows
        return m[..., i * n:(i + 1) * n]

    def _fe_value(self, w: Tensor) -> Tensor:
        m, l2 = self._fe_combine_margins((w,), l2_w=w)

        def chunk(b, i):
            mi = self._fe_rows(m[0], b, i) + b.offsets
            return torch.sum(_weighted(b, self.loss.value(mi, b.labels)))

        total = self._stream(chunk, lambda acc, v: acc + v, self._zero,
                             cost_label="streaming.fe_chunk_value", cost=lambda b: _fe_cost(b, {}))
        return total + l2

    def _fe_value_and_grad(self, w: Tensor) -> tuple[Tensor, Tensor]:
        m, l2 = self._fe_combine_margins((w,), l2_w=w)

        def chunk(b, i):
            mi = self._fe_rows(m[0], b, i) + b.offsets
            r = _weighted(b, self.loss.d1(mi, b.labels))
            return torch.sum(_weighted(b, self.loss.value(mi, b.labels))), b.rmatvec(r)

        init = (self._zero, torch.zeros(self._fe_dim, dtype=torch.float32, device=self.device))
        v, g = self._stream(chunk, lambda acc, out: (acc[0] + out[0], acc[1] + out[1]), init,
                            cost_label="streaming.fe_chunk_value_grad", cost=lambda b: _fe_cost(b, {"rmatvec": 1}))
        g = g + float(self.l2_weight) * self.reg_mask * reg_delta(w, self.prior_mean, self.prior_precision)
        return v + l2, g

    def _fe_hvp(self, w: Tensor, v: Tensor) -> Tensor:
        m2 = self._fe_combine_margins((w, v))  # both matvecs in one pass and one reduction

        def chunk(b, i):
            rows = self._fe_rows(m2, b, i)
            return b.rmatvec(_weighted(b, self.loss.d2(rows[0] + b.offsets, b.labels)) * rows[1])

        hv = self._stream(chunk, lambda acc, out: acc + out,
                          torch.zeros(self._fe_dim, dtype=torch.float32, device=self.device),
                          cost_label="streaming.fe_chunk_hvp", cost=lambda b: _fe_cost(b, {"rmatvec": 1}))
        return hv + float(self.l2_weight) * self.reg_mask * reg_curvature(
            v, self.prior_mean, self.prior_precision) * v

    def _fe_hessian_diag(self, w: Tensor) -> Tensor:
        m = self._fe_combine_margins((w,))

        def chunk(b, i):
            return b.rmatvec_sq(_weighted(b, self.loss.d2(self._fe_rows(m[0], b, i) + b.offsets, b.labels)))

        diag = self._stream(chunk, lambda acc, out: acc + out,
                            torch.zeros(self._fe_dim, dtype=torch.float32, device=self.device),
                            cost_label="streaming.fe_chunk_hessian_diag",
                            cost=lambda b: _fe_cost(b, {"rmatvec_sq": 1}))
        return diag + float(self.l2_weight) * self.reg_mask * reg_curvature(
            diag, self.prior_mean, self.prior_precision)


# Fingerprints of recently scored chunks, by storage identity: the module
# scorer is called with fresh dicts over unchanged arrays, and a cache hit
# must not cost a hash of every index and value. The entries hold the
# arrays, so a data pointer cannot be reused while it is remembered.
_FP_MEMO: list = []
_FP_MEMO_CAP = 16
_FP_MEMO_LOCK = threading.Lock()


def _chunk_structure_fingerprint(indices, values) -> tuple:
    with _FP_MEMO_LOCK:
        for i, (pi, pv, fp) in enumerate(_FP_MEMO):
            if _same_storage(indices, pi) and _same_storage(values, pv):
                _FP_MEMO.append(_FP_MEMO.pop(i))
                return fp
    fp = tile_cache.structure_fingerprint(indices, values)  # outside the lock
    with _FP_MEMO_LOCK:
        if not any(_same_storage(indices, pi) and _same_storage(values, pv) for pi, pv, _ in _FP_MEMO):
            _FP_MEMO.append((indices, values, fp))
            del _FP_MEMO[:-_FP_MEMO_CAP]
    return fp


def stream_scores(chunks: Sequence[dict], w, num_rows: int, num_features: int | None = None,
                  tile_sparse: bool | None = None, device=None) -> np.ndarray:
    """Margins X·w over all chunks (scoring an out-of-core dataset) on
    ``device`` (CUDA unless the caller passes another), trimmed to
    ``num_rows``. ``tile_sparse=None`` applies ``auto_tile_streaming``:
    sparse chunks of that width score through K3 layouts from the
    process-wide cache. Under ``PHOTON_FE_SHARD`` (sparse chunks with
    ``num_features``) ``w`` is the full vector, each process scores its
    range, and the margins are summed over the processes: a collective,
    the same scores on every process. With ``PHOTON_STREAM_EXECUTOR=1``
    raw chunks come through the executor's arbiter (stream "scores"),
    where another stream's resident copy of the same content serves them;
    tiled chunks keep the layout cache."""
    dev = resolve_device(device)
    if not chunks:
        return np.zeros(num_rows, np.float32)
    sparse = "indices" in chunks[0]
    tiled = sparse and (tile_sparse if tile_sparse is not None
                        else auto_tile_streaming(sparse, num_features, dev))
    fe_range = None
    if sparse and num_features is not None and fe_shard_enabled():
        # sharded: this range's partial margins over the restricted chunks,
        # summed over the processes as the objective sums them (the same
        # plan, so the layouts the solve packed are found again)
        _, fe_range = _fe_plan(chunks, num_features)
        _, lo, hi, _ = fe_range
        chunks, _ = _fe_restrict_chunks(chunks, lo, hi)
        num_features = hi - lo
        w = (w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w))[lo:hi]
    w = torch.as_tensor(w, dtype=torch.float32, device=dev)
    consumer = prefetch.consumer_stream(dev)
    executor = stream_executor.stream_executor_enabled()

    def prepare(i):
        c = chunks[i]
        if not tiled:
            if executor:
                put = stream_executor.cached_device_put("scores", c, dev, consumer, context=fe_range)
            else:
                put = prefetch.device_put(prefetch.pack_host_chunk(c), dev, consumer)
            return _to_batch(put, num_features), put
        shape, h_idx, h_val = _chunk_structure_fingerprint(c["indices"], c["values"])
        tb = tile_cache.tiled_layout_for(_host_sparse_batch(c, num_features),
                                         fingerprint=(shape, num_features, h_idx, h_val), device=dev,
                                         fe_range=fe_range)
        return tb, None

    outs = []
    items = (stream_executor.stream("scores", len(chunks), prepare) if executor
             else prefetch.prefetch_iter(len(chunks), prepare))
    for b, put in items:
        prefetch.wait(put, consumer)  # scoring stays on this thread, in chunk order
        outs.append(b.matvec(w))
    scores = torch.cat(outs).cpu().numpy()
    if fe_range is not None:
        scores = np.asarray(_fe_allreduce(scores)).astype(np.float32, copy=False)
    return scores[:num_rows]
