"""High-dimensional sparse GLM batches: K3 on Hopper (port of
``photon_ml_tpu/ops/sparse_tiled.py``'s semantics, not of its TPU schedule).

``TiledSparseBatch`` is a drop-in batch whose ``matvec`` (margins X@w),
``rmatvec`` (gradient Xᵀr) and ``rmatvec_sq`` (Hessian diagonal (X⊙X)ᵀr)
all run one kernel, ``sparse_apply`` (K3): out[write] = Σ val·src[read]
over the nonzeros of each write index. It replaces the Pallas kernel
``_tile_kernel_seg`` (launched by ``_tiled_apply_jit``) and its per-group
twin ``_tile_kernel`` (K4), which compute the same function.

Layout. One CSR per direction, built once at ingest by ``tile_sparse_batch``
(on the batch's device): the margins layout has write = row and read =
column, the gradient layout write = column and read = row. Each holds
int64 offsets per write index (a count of nonzeros may pass 2^31 within the
gate), int32 read indices and the values at the rung's storage width,
sorted by write index and then by read index (a stable sort, so duplicate
(row, column) pairs keep their input order and accumulate). Zero-valued
slots are dropped, as the reference drops its padding. Outputs have
exactly (n,) and (d,) entries: nothing is padded to a slab.

The kernel cuts each direction's nonzeros into tiles of ``TILE_NNZ``; the
layout carries, per tile, the first write index whose nonzeros begin at or
after the tile's first position (``tile_write``, one ``torch.searchsorted``
over the offsets), and pads the streams' storage so the kernel's bulk
copies stay in bounds: read indices and values to whole tiles (zeros),
offsets to two entries past ``write_len`` rounded to an even count, and
each int8 scale row to a multiple of four floats. The layout's tensors are
views of the stream's logical length.

Rungs (``PHOTON_KERNEL_DTYPE``, read when the layout is built; the
reference's storage ladder): they change storage only, and every rung
accumulates in float32.

- ``f32``: float32 values (8 B per nonzero with the int32 index).
- ``bf16``: bfloat16 values (6 B); the source vector is rounded to
  bfloat16 before the product, and products are taken in float32.
- ``int8``: symmetric int8 values (5 B) with one float32 scale per cell, a
  cell being a (row // 1024, column // 1024) tile: scale = amax/127 over
  the cell's nonzeros (0 maps to 1), q = clip(rint(v/scale), ±127), as the
  reference quantizes. The source is rounded to bfloat16 as on ``bf16``.
  ``rmatvec_sq`` squares after dequantization; the other rungs square the
  stored value.

On a CPU tensor each direction runs the kernel's plain version
(``tiled_apply_reference``: the same decode and products, sums in float64
rounded once); on a CUDA tensor it launches the kernel or raises.
``launch_counts`` counts kernel launches per direction. While device-cost
capture is on (``obs/devcost``), ``sparse_apply`` records each layout
signature's analytic work once (``tiled_apply_cost``).
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import torch

from photon_ml_tpu_torch.obs import devcost

Tensor = torch.Tensor

SLAB = 1024  # a cell side of the int8 rung's scale table (the reference's slab)
_SLAB_SHIFT = 10
TILE_NNZ = 512  # nonzeros a kernel tile takes: ``kTileNnz`` in csrc/sparse_tiled.cu

KERNEL_DTYPE = "f32"  # storage rung: "f32" | "bf16" | "int8"
KERNEL_DTYPES = ("f32", "bf16", "int8")
_STORAGE_ID = {"f32": 0, "bf16": 1, "int8": 2}  # `Storage` in csrc/sparse_tiled.cu
_VALUE_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}

# The reference's tiling gate: genuinely high-dimensional and within its
# chunk-count economy (``_MAX_TOTAL_ROWS`` / ``_MAX_TOTAL_COLS``).
_MIN_FEATURES = 4096
_MAX_TOTAL_ROWS = 1 << 25
_MAX_TOTAL_COLS = 1 << 23

DIRECTIONS = ("matvec", "rmatvec", "rmatvec_sq")
launch_counts: dict[str, int] = {k: 0 for k in DIRECTIONS}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def validate_kernel_dtype(value) -> str:
    """Strict parse of a storage rung: case and surrounding whitespace are
    ignored, anything else unknown raises, naming the valid rungs."""
    v = str(value).strip().lower()
    if v not in KERNEL_DTYPES:
        raise ValueError(
            f"PHOTON_KERNEL_DTYPE={value!r} is not a known precision rung; "
            f"valid rungs: {', '.join(KERNEL_DTYPES)}"
        )
    return v


def kernel_dtype() -> str:
    """The active storage rung, read at call time: a non-empty
    ``PHOTON_KERNEL_DTYPE`` wins over the module's ``KERNEL_DTYPE``."""
    env = os.environ.get("PHOTON_KERNEL_DTYPE")
    if env is not None and env != "":
        return validate_kernel_dtype(env)
    return validate_kernel_dtype(KERNEL_DTYPE)


def tiling_economical_features(num_features: int) -> bool:
    """The feature-dimension half of the tiling gate."""
    return _MIN_FEATURES <= num_features <= _MAX_TOTAL_COLS


def auto_tile_streaming(sparse: bool, num_features: int | None, device) -> bool:
    """The streamed paths' one rule for K3 chunk layouts (the chunk
    objective and the module scorer both call it): sparse chunks, a
    feature width ``tiling_economical_features`` takes, and a CUDA device.
    On the CPU the plain version is opted into with ``tile_sparse=True``."""
    return (
        bool(sparse)
        and num_features is not None
        and tiling_economical_features(num_features)
        and torch.device(device).type == "cuda"
    )


def supports_tiling(batch) -> bool:
    """Shapes the sparse kernel serves better than the gather/scatter
    ``SparseBatch``: a padded-sparse batch with 4096 <= d <= 2^23,
    1024 <= n <= 2^25 and some nonzero value (the reference's gate)."""
    from photon_ml_tpu_torch.ops.batch import SparseBatch

    return (
        isinstance(batch, SparseBatch)
        and tiling_economical_features(batch.num_features)
        and SLAB <= batch.num_rows <= _MAX_TOTAL_ROWS
        and bool(torch.any(batch.values != 0))
    )


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SparseLayout:
    """One direction's CSR by write index, cut into kernel tiles.

    ``scale`` is the int8 rung's float32 table of this direction,
    write-major: a nonzero at (write, read) takes ``scale[write >> 10,
    read >> 10]``. None on the other rungs. ``tile_write[t]`` is the first
    write index whose nonzeros begin at or after position ``t·TILE_NNZ``,
    and ``tile_write[num_tiles]`` the first past the last nonzero."""

    offsets: Tensor  # (write_len + 1,) int64
    read: Tensor  # (nnz,) int32
    values: Tensor  # (nnz,) float32 | bfloat16 | int8
    tile_write: Tensor  # (num_tiles + 1,) int64
    write_len: int
    read_len: int
    storage: str
    scale: Tensor | None = None

    @property
    def nnz(self) -> int:
        return self.read.shape[0]

    @property
    def num_tiles(self) -> int:
        return -(-self.nnz // TILE_NNZ)

    def stream_bytes(self) -> int:
        """Bytes the kernel streams besides the source and output vectors:
        offsets, read indices, values and (int8) the scale table."""
        scale = 0 if self.scale is None else self.scale.numel() * 4
        return (
            self.offsets.numel() * 8 + self.read.numel() * 4
            + self.values.numel() * self.values.element_size() + scale
        )

    def tile_bytes(self) -> tuple[int, int]:
        """(per-tile metadata the kernel reads, carry traffic it writes and
        reads back): bytes beyond ``stream_bytes``."""
        return self.tile_write.numel() * 8, 2 * 2 * self.num_tiles * 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _padded(t: Tensor, length: int, fill=0) -> Tensor:
    """``t`` at the front of fresh storage of ``length`` elements (the rest
    ``fill``), returned as a view of ``t``'s own length."""
    buf = torch.full((length,), fill, dtype=t.dtype, device=t.device)
    buf[: t.numel()] = t
    return buf[: t.numel()]


def _scale_rows(table: Tensor) -> Tensor:
    """A (write slabs, read slabs) table whose rows start 16 bytes apart:
    a view of the logical width over rows padded to four floats."""
    rows, cols = table.shape
    buf = torch.ones((rows, _round_up(cols, 4)), dtype=table.dtype, device=table.device)
    buf[:, :cols] = table
    return buf[:, :cols]


def _csr(write: Tensor, read: Tensor, values: Tensor, write_len: int, read_len: int,
         storage: str, scale) -> SparseLayout:
    order = torch.argsort(write * read_len + read, stable=True)
    nnz = write.numel()
    stream_len = _round_up(nnz, TILE_NNZ)
    offsets = torch.zeros(_round_up(write_len + 3, 2), dtype=torch.int64, device=write.device)
    offsets[1 : write_len + 1] = torch.cumsum(torch.bincount(write, minlength=write_len), 0)
    offsets = offsets[: write_len + 1]
    starts = torch.arange(0, stream_len + 1, TILE_NNZ, dtype=torch.int64, device=write.device)
    return SparseLayout(
        offsets=offsets,
        read=_padded(read[order].to(torch.int32), stream_len),
        values=_padded(values[order], stream_len),
        tile_write=torch.searchsorted(offsets, starts.clamp_max(nnz)),
        write_len=write_len,
        read_len=read_len,
        storage=storage,
        scale=scale,
    )


def _quantize_int8(rows: Tensor, cols: Tensor, vals: Tensor, n: int, d: int):
    """Symmetric per-cell int8: (q, scale table (row-slabs, column-slabs)).
    A cell with no nonzero keeps scale 1 and is never read. The table has
    one float per cell, (n/1024)·(d/1024) of them: 256 KB at config A2,
    1 GB at the gate's largest n and d."""
    n_cs = -(-d // SLAB)
    table = torch.zeros((-(-n // SLAB)) * n_cs, dtype=torch.float32, device=vals.device)
    cell = (rows >> _SLAB_SHIFT) * n_cs + (cols >> _SLAB_SHIFT)
    table.scatter_reduce_(0, cell, vals.abs(), reduce="amax")
    table = table / 127.0
    table[table == 0.0] = 1.0
    q = torch.clamp(torch.round(vals / table[cell]), -127, 127).to(torch.int8)
    return q, table.view(-1, n_cs)


@dataclass(frozen=True)
class TiledSparseBatch:
    """Drop-in batch whose three contractions run K3. ``labels``,
    ``offsets`` and ``weights`` are the caller's (n,) tensors. Build with
    ``tile_sparse_batch``."""

    m: SparseLayout  # margins: write = row, read = column
    g: SparseLayout  # gradient: write = column, read = row
    labels: Tensor
    offsets: Tensor
    weights: Tensor
    num_features: int
    # (pid, lo, hi, P) when the columns are the feature range [lo, hi) of
    # ``PHOTON_FE_SHARD``'s plan (``num_features`` is then hi − lo), else None
    fe_range: tuple | None = None

    @property
    def num_rows(self) -> int:
        return self.labels.shape[0]

    @property
    def device(self) -> torch.device:
        return self.labels.device

    @property
    def storage(self) -> str:
        return self.m.storage

    def matvec(self, w: Tensor) -> Tensor:
        """Margins X @ w, (n,)."""
        return sparse_apply(self.m, w, direction="matvec")

    def rmatvec(self, r: Tensor) -> Tensor:
        """Gradient contraction Xᵀ @ r, (d,)."""
        return sparse_apply(self.g, r, direction="rmatvec")

    def rmatvec_sq(self, r: Tensor) -> Tensor:
        """(X ⊙ X)ᵀ @ r, (d,): the Hessian diagonal's contraction."""
        return sparse_apply(self.g, r, square=True, direction="rmatvec_sq")


def tile_sparse_batch(batch, fe_range: tuple | None = None) -> TiledSparseBatch:
    """Both directions' layouts of a padded-sparse batch, built on its
    device, on the storage rung ``kernel_dtype()`` gives (read once for
    both). Raises on a feature index outside [0, d). ``fe_range`` names a
    batch whose columns are one feature range (already shifted to start
    at 0) and rides the result."""
    storage = kernel_dtype()
    n, k = batch.indices.shape
    d = batch.num_features
    dev = batch.values.device
    rows = torch.arange(n, device=dev).repeat_interleave(k)
    cols = batch.indices.reshape(-1).to(torch.int64)
    vals = batch.values.reshape(-1).to(torch.float32)
    keep = vals != 0.0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if cols.numel() and (int(cols.min()) < 0 or int(cols.max()) >= d):
        raise ValueError(f"feature index out of range [0, {d})")

    m_scale = g_scale = None
    if storage == "int8":
        stored, table = _quantize_int8(rows, cols, vals, n, d)
        m_scale, g_scale = _scale_rows(table), _scale_rows(table.T)
    else:
        stored = vals.to(_VALUE_DTYPE[storage])
    return TiledSparseBatch(
        m=_csr(rows, cols, stored, n, d, storage, m_scale),
        g=_csr(cols, rows, stored, d, n, storage, g_scale),
        labels=batch.labels,
        offsets=batch.offsets,
        weights=batch.weights,
        num_features=d,
        fe_range=fe_range,
    )


def tile_sparse_batch_sharded(batch, num_shards: int, devices=None) -> tuple[list[TiledSparseBatch], int]:
    """One ``TiledSparseBatch`` per row shard (the reference's
    ``tile_sparse_batch_sharded``): the rows pad with zero-weight rows to a
    multiple of ``num_shards`` and split into contiguous shards of equal
    count, and shard i is moved to ``devices[i]`` (the batch's own device
    when None) and tiled there, so each shard runs K3 on its own layouts.
    The reference stacks its shards' tiles on a leading device axis for
    ``shard_map``; here each shard's layouts are a batch of their own.
    Returns (shards, rows per shard)."""
    from photon_ml_tpu_torch.ops.batch import SparseBatch, pad_batch

    rows = -(-batch.num_rows // num_shards)
    padded = pad_batch(batch, rows * num_shards)
    devs = [batch.device] * num_shards if devices is None else [torch.device(d) for d in devices]
    shards = []
    for i, dev in enumerate(devs):
        part = slice(i * rows, (i + 1) * rows)
        shard = SparseBatch(
            indices=padded.indices[part].to(dev), values=padded.values[part].to(dev),
            labels=padded.labels[part].to(dev), offsets=padded.offsets[part].to(dev),
            weights=padded.weights[part].to(dev), num_features=padded.num_features,
        )
        shards.append(tile_sparse_batch(shard))
    return shards, rows


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def _write_ids(layout: SparseLayout) -> Tensor:
    counts = layout.offsets[1:] - layout.offsets[:-1]
    return torch.arange(layout.write_len, device=counts.device).repeat_interleave(counts)


def decoded_values(layout: SparseLayout, square: bool = False) -> Tensor:
    """Each nonzero's value in float32 as the kernel decodes it (int8
    dequantized by its cell's scale), squared when ``square``."""
    v = layout.values.to(torch.float32)
    if layout.storage == "int8":
        v = v * layout.scale[_write_ids(layout) >> _SLAB_SHIFT, layout.read.long() >> _SLAB_SHIFT]
    return v * v if square else v


def source_operand(layout: SparseLayout, src: Tensor) -> Tensor:
    """The source vector as the kernel reads it: rounded to bfloat16 on
    the reduced rungs."""
    src = src.to(torch.float32)
    return src if layout.storage == "f32" else src.to(torch.bfloat16).to(torch.float32)


def tiled_apply_reference(layout: SparseLayout, src: Tensor, square: bool = False) -> Tensor:
    """Plain version of K3: out[i] = Σ over write index i's nonzeros of
    float32 products val·src[read] (val² with ``square``), summed in
    float64 and rounded once to float32 (standing for the exact sums the
    kernel's compensated sums approach)."""
    p = decoded_values(layout, square) * source_operand(layout, src)[layout.read.long()]
    out = torch.zeros(layout.write_len, dtype=torch.float64, device=p.device)
    return out.index_add_(0, _write_ids(layout), p.to(torch.float64)).to(torch.float32)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------
def _ptr(t: Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _room(t: Tensor) -> int:
    """Elements of ``t``'s storage from its first element on."""
    return t.untyped_storage().nbytes() // t.element_size() - t.storage_offset()


def _check_kernel_layout(layout: SparseLayout) -> None:
    """Raise unless the layout carries the tiles and storage padding the
    kernel's bulk copies read (``tile_sparse_batch`` builds both)."""
    stream_len = layout.num_tiles * TILE_NNZ
    ok = (
        layout.tile_write.shape == (layout.num_tiles + 1,)
        and _room(layout.read) >= stream_len and _room(layout.values) >= stream_len
        and _room(layout.offsets) >= _round_up(layout.write_len + 3, 2)
        and all(t.is_contiguous() for t in (layout.offsets, layout.read, layout.values,
                                            layout.tile_write))
    )
    if layout.scale is not None:
        ok = ok and layout.scale.stride(1) == 1 and layout.scale.stride(0) % 4 == 0
    if not ok:
        raise ValueError("the layout lacks the kernel's tiles or padding; build it "
                         "with tile_sparse_batch")


def tiled_apply_cost(layout: SparseLayout, square: bool = False) -> dict:
    """K3's work on one layout: its streams (offsets, read indices, values,
    the int8 scale table) and the (read_len,) float32 source read once, the
    (write_len,) output written once; 2 operations a nonzero (4 squared)."""
    args = layout.stream_bytes() + 4 * layout.read_len
    return {"flops": 2.0 * layout.nnz * (2 if square else 1), "bytes_accessed": args + 4 * layout.write_len,
            "memory": {"argument_size_in_bytes": args, "output_size_in_bytes": 4 * layout.write_len}}


def sparse_apply(layout: SparseLayout, src: Tensor, square: bool = False,
                 direction: str = "matvec") -> Tensor:
    """K3 over one layout: (write_len,) float32 from a (read_len,) source.
    A CPU source runs the plain version; a CUDA source launches the kernel
    (counted under ``direction``) or raises."""
    if devcost.capture_enabled():
        devcost.capture("sparse_tiled.tiled_apply",
                        (layout.values, layout.read, layout.offsets, layout.scale, src, direction),
                        lambda: tiled_apply_cost(layout, square))
    if src.device.type == "cpu":
        return tiled_apply_reference(layout, src, square)
    if src.device.type != "cuda":
        raise ValueError(f"sparse_apply runs on CPU or CUDA tensors, not {src.device}")
    src = src.to(torch.float32).contiguous()
    if src.shape != (layout.read_len,) or layout.read.device != src.device:
        raise ValueError(
            f"source must be a ({layout.read_len},) tensor on {layout.read.device}; "
            f"got {tuple(src.shape)} on {src.device}"
        )
    _check_kernel_layout(layout)
    if layout.storage != "f32":  # the operand the reduced rungs multiply, half the gathers' bytes
        src = src.to(torch.bfloat16)
    from photon_ml_tpu_torch.ops import _cuda

    lib = _cuda.load()
    out = torch.empty(layout.write_len, dtype=torch.float32, device=src.device)
    carry = torch.empty(2 * layout.num_tiles, dtype=torch.float64, device=src.device)
    scale_ld = 0 if layout.scale is None else layout.scale.stride(0)
    rc = lib.photon_sparse_apply(
        _ptr(layout.offsets), _ptr(layout.read), _ptr(layout.values),
        _STORAGE_ID[layout.storage], _ptr(layout.scale), scale_ld, _ptr(src), layout.read_len,
        layout.write_len, layout.nnz, _ptr(layout.tile_write), _ptr(carry), int(square),
        _ptr(out), ctypes.c_void_p(torch.cuda.current_stream(src.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"sparse_apply kernel launch failed: cudaError {rc}")
    launch_counts[direction] += 1
    return out
