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
Feature-range sharding (``PHOTON_FE_SHARD``) is ROADMAP queue 1 item 12d.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.normalization import NormalizationContext, no_normalization
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.ops import prefetch, tile_cache
from photon_ml_tpu_torch.ops.batch import Batch, DenseBatch, SparseBatch, densify
from photon_ml_tpu_torch.ops.fused import supports_fused
from photon_ml_tpu_torch.ops.glm import GLMObjective, fused_disabled, reg_curvature, reg_delta, reg_term
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.sparse_tiled import TiledSparseBatch, auto_tile_streaming

Tensor = torch.Tensor

_TILED_STREAM_KEYS = ("labels", "offsets", "weights")


def _fe_shard_waits() -> NotImplementedError:
    return NotImplementedError(
        "feature-range sharding (PHOTON_FE_SHARD) waits for ROADMAP queue 1 item 12d (multi-GPU)"
    )


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
    ``tile_sparse=None`` tiles sparse chunks by ``auto_tile_streaming``;
    the layouts are built once from the first chunks, and a later
    ``chunks`` swap may change labels, offsets or weights but nothing else
    (the fingerprints refuse it)."""

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
        env = os.environ.get("PHOTON_FE_SHARD")
        if self.fe_shard or (self.fe_shard is None and sparse and env not in (None, "", "0")):
            raise _fe_shard_waits()
        if not self.chunks and not self.cross_process:
            raise ValueError("streaming objective needs at least one chunk")
        dev = resolve_device(self.device)
        self.device = dev
        d = self.num_features
        mask = torch.ones(d, dtype=torch.float32, device=dev)
        if self.intercept_index is not None:
            mask[self.intercept_index] = 0.0
        self.reg_mask = mask  # the host OWL-QN applies its L1 over this mask
        if self.prior_mean is not None:
            self.prior_mean = torch.as_tensor(self.prior_mean, dtype=torch.float32, device=dev)
        if self.prior_precision is not None:
            self.prior_precision = torch.as_tensor(self.prior_precision, dtype=torch.float32, device=dev)
        self._norm = (no_normalization(d, self.intercept_index, device=dev) if self.norm is None
                      else self.norm.to(dev))
        self._zero = torch.zeros((), dtype=torch.float32, device=dev)
        self._tile_layouts = None
        self._tile_fingerprints = None
        want_tiling = (self.tile_sparse if self.tile_sparse is not None
                       else auto_tile_streaming(sparse, d, dev))
        if want_tiling and sparse:
            self._build_tile_layouts()

    def _build_tile_layouts(self) -> None:
        """Each sparse chunk's K3 layouts, built once through the
        process-wide cache (a rebuilt objective over the same data packs
        nothing) and kept on the card."""
        layouts, fps = [], []
        for c in self.chunks:
            t0 = time.perf_counter()
            fp = tile_cache.structure_fingerprint(c["indices"], c["values"])
            tb = tile_cache.tiled_layout_for(_host_sparse_batch(c, self.num_features),
                                             fingerprint=(fp[0], self.num_features, fp[1], fp[2]),
                                             device=self.device)
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

    def __setattr__(self, name, value):
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
                                    weights=cur["weights"], num_features=self.num_features)
        return _to_batch(cur, self.num_features)

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

    def _batches(self):
        """Each chunk's batch on the card, in order, with its copies waited
        for on the calling thread's stream. The chunks come through the
        chunk cache at every prefetch depth; depth 0 prepares each one on
        this thread."""
        src, dev = self.chunks, self.device
        consumer = prefetch.consumer_stream(dev)

        def prepare(i):
            return prefetch.cached_device_put(self._slim(src[i]), dev, consumer)

        for i, cur in enumerate(prefetch.prefetch_iter(len(src), prepare)):
            prefetch.wait(cur, consumer)
            yield self._chunk_batch(cur, i)

    def _stream(self, kernel: Callable[[GLMObjective], object], accumulate: Callable, init):
        acc = init
        if not self.chunks:  # a process without rows streams nothing
            return acc
        # one registry update a pass, none a chunk
        REGISTRY.counter_inc("stream.passes")
        REGISTRY.counter_inc("stream.chunks", len(self.chunks))
        for b in self._batches():
            acc = accumulate(acc, kernel(self._chunk_objective(b)))
        return acc

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
        w = self._w(w)
        total = self._stream(lambda o: o.value(w), lambda acc, v: acc + v, self._zero)
        (total,) = self._across_processes(total)
        return total + self._l2_term(w)

    def value_and_grad(self, w) -> tuple[Tensor, Tensor]:
        w = self._w(w)
        init = (self._zero, torch.zeros(self.num_features, dtype=torch.float32, device=self.device))
        v, g = self._stream(lambda o: o.value_and_grad(w),
                            lambda acc, out: (acc[0] + out[0], acc[1] + out[1]), init)
        v, g = self._across_processes(v, g)
        g = g + float(self.l2_weight) * self.reg_mask * reg_delta(w, self.prior_mean, self.prior_precision)
        return v + self._l2_term(w), g

    def hvp(self, w, v) -> Tensor:
        """Gauss-Newton H·v, streamed: TRON's CG step costs one pass."""
        w, v = self._w(w), self._w(v)
        init = torch.zeros(self.num_features, dtype=torch.float32, device=self.device)
        hv = self._stream(lambda o: o.hvp(w, v), lambda acc, out: acc + out, init)
        (hv,) = self._across_processes(hv)
        return hv + float(self.l2_weight) * self.reg_mask * reg_curvature(
            v, self.prior_mean, self.prior_precision) * v

    def hessian_diag(self, w) -> Tensor:
        """diag(H), streamed: SIMPLE variances cost one pass."""
        w = self._w(w)
        init = torch.zeros(self.num_features, dtype=torch.float32, device=self.device)
        diag = self._stream(lambda o: o.hessian_diag(w), lambda acc, out: acc + out, init)
        (diag,) = self._across_processes(diag)
        return diag + float(self.l2_weight) * self.reg_mask * reg_curvature(
            diag, self.prior_mean, self.prior_precision)

    def hessian(self, w) -> Tensor:
        """The full (d, d) Hessian, streamed: FULL variances cost one pass
        that sums each chunk's Zᵀ(d2·Z) (sparse chunks densified), bounded
        by ``FULL_HESSIAN_MAX_D``."""
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

        h = self._stream(chunk_hessian, lambda acc, out: acc + out, init)
        (h,) = self._across_processes(h)
        return h + torch.diag(float(self.l2_weight) * self.reg_mask * reg_curvature(
            self.reg_mask, self.prior_mean, self.prior_precision))

    def stream_scores(self, w, num_rows: int) -> np.ndarray:
        """Margins X·w (no offsets) over this objective's chunks, trimmed to
        ``num_rows``, through the layouts the solve used when it has them.
        Under ``cross_process`` the rows are this process's own, as in the
        reference: scoring rows needs no collective."""
        w = self._w(w)
        outs = [b.matvec(w) for b in self._batches()]
        if not outs:
            return np.zeros(num_rows, np.float32)
        return torch.cat(outs).cpu().numpy()[:num_rows]


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
    process-wide cache."""
    dev = resolve_device(device)
    if not chunks:
        return np.zeros(num_rows, np.float32)
    sparse = "indices" in chunks[0]
    env = os.environ.get("PHOTON_FE_SHARD")
    if sparse and num_features is not None and env not in (None, "", "0"):
        raise _fe_shard_waits()
    tiled = sparse and (tile_sparse if tile_sparse is not None
                        else auto_tile_streaming(sparse, num_features, dev))
    w = torch.as_tensor(w, dtype=torch.float32, device=dev)
    consumer = prefetch.consumer_stream(dev)

    def prepare(i):
        c = chunks[i]
        if not tiled:
            put = prefetch.device_put(prefetch.pack_host_chunk(c), dev, consumer)
            return _to_batch(put, num_features), put
        shape, h_idx, h_val = _chunk_structure_fingerprint(c["indices"], c["values"])
        tb = tile_cache.tiled_layout_for(_host_sparse_batch(c, num_features),
                                         fingerprint=(shape, num_features, h_idx, h_val), device=dev)
        return tb, None

    outs = []
    for b, put in prefetch.prefetch_iter(len(chunks), prepare):
        prefetch.wait(put, consumer)  # scoring stays on this thread, in chunk order
        outs.append(b.matvec(w))
    return torch.cat(outs).cpu().numpy()[:num_rows]
