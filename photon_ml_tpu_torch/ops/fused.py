"""One-pass fused GLM evaluation: K1 and K2 on Hopper.

``fused_value_grad`` (K1) replaces the Pallas kernel ``_vg_kernel`` of
``photon_ml_tpu/ops/fused.py`` (launched there by ``fused_value_grad``);
``fused_hvp`` (K2) replaces ``_hvp_kernel`` (launched by ``fused_hvp``).
The CUDA C++ kernels live in ``csrc/fused_glm.cu``; that file's header
says how they work.

Bound on an H100 SXM: each reads X once and everything else is O(n + d),
so each is bound by the bytes of X over 3.35 TB/s: 0.32 ms for the
headline X (n = 2^20, d = 512, bfloat16: 1 GiB) and 0.32 ms for config B's
X (n = 2^20, d = 256, float32: 1 GiB), 0.041 ms for config B's streamed
chunk (2^17 rows), 1.6 ms for GAME's fixed effect at MovieLens-20M depth
(20,000,263 x 65, float32). The design reads X exactly once per
evaluation and keeps margins and r / q on the chip, never in device
memory.

K1 has two layouts, picked by shape and alignment alone (``vg_plan``
mirrors the kernel's rule): "rows", a warp per row with the row in
registers, which runs the headline and config B near their bound and K2
everywhere; and "tiles", for rows of at most ``TILES_MAX_FEATURES``
columns (GAME's 65), where a warp per row would spend its issue slots on
empty lanes and a 32-lane butterfly per row. The tiles layout stages row
tiles in shared memory by bulk asynchronous copies on a ring, gives each
row one thread for its margin and loss and each column a fixed set of
threads for Xᵀr; ``tile_plan`` gives its geometry.

Each wrapper takes a CPU tensor to its plain PyTorch version
(``fused_value_grad_reference`` / ``fused_hvp_reference``: the same row
masking, loss and casts, with float64 sums) and a CUDA tensor to its
kernel; any other device raises, and a kernel that fails to build or
launch raises. The plain versions are what the CPU tests run and what
``chip_smoke.py`` holds the kernels against on the card.

A call on the card does little on the host: it checks its inputs, takes
c and cv where the caller holds them (a float32 scalar tensor on the card
is read there, a Python number passes by value), allocates its output,
and reuses the blocks' float64 partials, kept per device and stream.

``launch_counts`` counts the calls that launched each kernel (plain
integers; ``reset_launch_counts`` zeroes them). A call made while a CUDA
graph is captured (``ops/graphs.py``) counts on the device instead, once
for each launch a replay makes, and the owner of the replays adds those
counts here after its one read. While device-cost capture
is on (``obs/devcost``: a telemetry sink, or ``PHOTON_DEVCOST=1``), each
wrapper records its call signature's analytic work once
(``value_grad_cost`` / ``hvp_cost``: the bytes and operations the bound
divides), on the card and on the CPU alike.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from photon_ml_tpu_torch.obs import devcost
from photon_ml_tpu_torch.ops import _cuda, graphs
from photon_ml_tpu_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor

# Columns a kernel handles: 32 lanes x up to 32 register-held columns each
# (``kMaxFeatures`` in csrc/fused_glm.cu).
MAX_FEATURES = 1024
# Upper bound on resident 256-thread blocks per SM (2048 threads); sizes
# the per-block partial buffer.
_MAX_BLOCKS_PER_SM = 8

launch_counts: dict[str, int] = {"fused_value_grad": 0, "fused_hvp": 0}

# K1's two layouts (``VgLayout`` in csrc/fused_glm.cu): "rows", a warp per
# row (``vg_kernel``), and "tiles", row tiles staged in shared memory with
# one thread per row (``vg_tiles_kernel``). The rule takes "tiles" where
# ``tile_plan`` gives a ring of two stages or more, X, labels, offsets and
# weights are 16-byte aligned, and d is at most TILES_MAX_FEATURES for the
# storage type (``kTilesMaxFeatures*``); "rows" everywhere else.
LAYOUTS = {"rows": 0, "tiles": 1}
TILES_MAX_FEATURES = {torch.float32: 124, torch.bfloat16: 128}
# The tiles layout's geometry, as csrc/fused_glm.cu's constants of the same
# names: a block of _THREADS threads; a stage (a tile's X rows and each
# row's label, offset and weight) holds at most _STAGE_BYTES and
# _TILE_MAX_ROWS rows; the ring at most _MAX_STAGES stages in _RING_BYTES.
_THREADS = 256
_STAGE_BYTES = 65536
_TILE_MAX_ROWS = 1024
_RING_BYTES = 204800
_MAX_STAGES = 4
_AUX_BYTES_PER_ROW = 12


class VgPlan(NamedTuple):
    """K1's layout for one shape, and for "tiles" the geometry the kernel
    uses (``tile_plan`` in csrc/fused_glm.cu): rows per tile, ring stages,
    column partitions (each of the partitions x d owning threads sums one
    column over every partitions-th row of a tile), the dot's column
    rotation per thread, bytes per stage and the block's shared memory."""

    layout: str
    rows: int = 0
    stages: int = 0
    partitions: int = 0
    rotation: int = 0
    stage_bytes: int = 0
    smem_bytes: int = 0


def tile_plan(d: int, dtype) -> VgPlan | None:
    """The tiles layout's geometry at width d, or None where it has none
    (d > 256, or fewer than two stages fit)."""
    if not 1 <= d <= _THREADS:
        return None
    itemsize = torch.empty((), dtype=dtype).element_size()
    row_bytes = d * itemsize
    rows = min(_STAGE_BYTES // (row_bytes + _AUX_BYTES_PER_ROW) // 32 * 32, _TILE_MAX_ROWS)
    if rows > _THREADS:
        rows = rows // _THREADS * _THREADS
    if rows < 32:
        return None
    stage = rows * (row_bytes + _AUX_BYTES_PER_ROW)
    stages = min(_RING_BYTES // stage, _MAX_STAGES)
    if stages < 2:
        return None
    rotation = (1 if d % 2 == 0 else 0) if itemsize == 4 else (2 - d) % 4
    smem = (stages * stage + 8 * stages + 8 * _THREADS + 8 * (d + 2) + 4 * rows
            + math.ceil(row_bytes / 16) * 16)
    return VgPlan("tiles", rows, stages, _THREADS // d, rotation, stage, smem)


def vg_plan(d: int, dtype, aligned: bool = True) -> VgPlan:
    """The layout K1 takes at width d for this storage type, by the rule
    above; ``aligned``: X, labels, offsets and weights 16-byte aligned."""
    plan = tile_plan(d, dtype)
    if plan is not None and aligned and d <= TILES_MAX_FEATURES[dtype]:
        return plan
    return VgPlan("rows")


def inputs_aligned(*tensors: Tensor | None) -> bool:
    """Every tensor given starts on a 16-byte boundary (None is skipped)."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _count(name: str, n: int) -> None:
    launch_counts[name] += n


def _cost(n: int, d: int, x_itemsize: int, row_vectors: int, in_vectors: int, outputs: int,
          flops_per_entry: float) -> dict:
    """A one-pass kernel's analytic work: X and the (n,) row vectors read
    once, the (d,) input vectors read once, the outputs written once."""
    args = n * d * x_itemsize + 4 * n * row_vectors + 4 * d * in_vectors
    return {"flops": flops_per_entry * n * d, "bytes_accessed": args + 4 * outputs,
            "memory": {"argument_size_in_bytes": args, "output_size_in_bytes": 4 * outputs}}


def value_grad_cost(n: int, d: int, x_itemsize: int, offsets: bool, weights: bool) -> dict:
    """K1's work: X, labels (offsets, weights where read) and u read once;
    the value, Xᵀr and Σr written once; 4·n·d operations (Xu and Xᵀr)."""
    return _cost(n, d, x_itemsize, 1 + offsets + weights, 1, d + 2, 4.0)


def hvp_cost(n: int, d: int, x_itemsize: int, offsets: bool, weights: bool) -> dict:
    """K2's work: X, labels (offsets, weights where read), u and v read
    once; Xᵀq and Σq written once; 6·n·d operations (Xu, Xv and Xᵀq)."""
    return _cost(n, d, x_itemsize, 1 + offsets + weights, 2, d + 1, 6.0)


def _capture(label: str, cost, X: Tensor, offsets: Tensor | None, weights: Tensor | None) -> None:
    n, d = X.shape
    devcost.capture(label, (X, offsets, weights),
                    lambda: cost(n, d, X.element_size(), offsets is not None, weights is not None))


def supports_fused(n: int, d: int, dtype) -> bool:
    """Shapes and storage types the kernels take: float32 or bfloat16 X
    with 1 <= d <= MAX_FEATURES (the per-lane register accumulators).
    Wider problems take the objective's unfused branch."""
    return dtype in (torch.float32, torch.bfloat16) and n >= 1 and 1 <= d <= MAX_FEATURES


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _margin_operand(X: Tensor, u: Tensor) -> Tensor:
    """u in the precision the kernel uses against X (rounded to bfloat16
    for bfloat16 storage), as float64."""
    return u.to(X.dtype).double()


def _select_weighted(weights: Tensor | None, x: Tensor) -> Tensor:
    if weights is None:
        return x
    return torch.where(weights != 0.0, weights * x, torch.zeros_like(x))


def _sum(x: Tensor) -> Tensor:
    return torch.sum(x, dtype=torch.float64).float()


def fused_value_grad_reference(X, labels, offsets, weights, u, c, *, loss: PointwiseLoss):
    """Plain version of K1: (Σ w·l(m, y), Xᵀr, Σr), r = w·l'(m, y),
    m = X@u + offsets − c; offsets None means 0, weights None means 1.
    The row masking, the loss and the bfloat16 casts are the kernel's, in
    float32; every sum is taken in float64 and rounded once, standing for
    the exact sums the kernel's compensated sums approach."""
    xd = X.double()
    m = (xd @ _margin_operand(X, u)).float() - c
    if offsets is not None:
        m = m + offsets
    lv = _select_weighted(weights, loss.value(m, labels))
    r = _select_weighted(weights, loss.d1(m, labels))
    g = (xd.T @ r.to(X.dtype).double()).float()
    return _sum(lv), g, _sum(r)


def fused_hvp_reference(X, labels, offsets, weights, u, v, c, cv, *, loss: PointwiseLoss):
    """Plain version of K2: (Xᵀq, Σq), q = w·l''(m, y)·(X@v − cv), with the
    sums taken as in ``fused_value_grad_reference``."""
    xd = X.double()
    m = (xd @ _margin_operand(X, u)).float() - c
    if offsets is not None:
        m = m + offsets
    mv = (xd @ _margin_operand(X, v)).float() - cv
    q = _select_weighted(weights, loss.d2(m, labels)) * mv
    return (xd.T @ q.to(X.dtype).double()).float(), _sum(q)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _ptr(t: Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check(X, labels, offsets, weights, vectors) -> None:
    """Raise unless X is a contiguous (n, d) float32 / bfloat16 tensor the
    kernels take and every other input a contiguous float32 vector of its
    length on X's device."""
    if X.dim() != 2 or not X.is_contiguous():
        raise ValueError("X must be a contiguous (n, d) tensor")
    n, d = X.shape
    if not supports_fused(n, d, X.dtype):
        raise ValueError(
            f"fused kernels take float32/bfloat16 X with 1 <= d <= {MAX_FEATURES}; "
            f"got {tuple(X.shape)} {X.dtype}"
        )
    device = X.get_device()
    for k, (t, size) in enumerate(((labels, n), (offsets, n), (weights, n), *((t, d) for t in vectors))):
        if t is not None and (t.dtype is not torch.float32 or t.dim() != 1 or t.shape[0] != size
                              or t.get_device() != device or not t.is_contiguous()):
            name = ("labels", "offsets", "weights")[k] if k < 3 else f"vector {k - 3}"
            raise ValueError(f"{name} must be a contiguous float32 ({size},) tensor on {X.device}")


_workspaces: dict[tuple[int, int], tuple[int, int, Tensor]] = {}
_raw_stream = None


def _current_stream(index: int) -> int:
    """The handle of the current CUDA stream on device ``index``."""
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(index)


def _workspace(device: torch.device, stream: int) -> tuple[int, int, Tensor]:
    """(partials pointer, max_grid, partials) for a device and stream, made
    on first use and kept: room for every block's float64 row at any
    width. Calls on one stream run in order, so they share it; another
    stream gets its own."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        max_grid = torch.cuda.get_device_properties(device).multi_processor_count * _MAX_BLOCKS_PER_SM
        part = torch.empty((max_grid, MAX_FEATURES + 2), dtype=torch.float64, device=device)
        ws = _workspaces[key] = (part.data_ptr(), max_grid, part)
    return ws


def _scalar(s, X: Tensor):
    """(pointer, value, tensor kept for the launch) for c or cv: a tensor is
    read by the kernel where it lies (moved to X's device as float32 if it
    is not already there), a number passes by value."""
    if isinstance(s, Tensor):
        if s.numel() != 1:
            raise ValueError(f"a scalar argument must have one element, not {tuple(s.shape)}")
        if s.dtype is not torch.float32 or s.device != X.device:
            s = s.to(device=X.device, dtype=torch.float32)
        return s.data_ptr(), 0.0, s
    return None, float(s), None


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def _as_f32(t: Tensor) -> Tensor:
    if t.dtype is torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def fused_value_grad(X, labels, offsets, weights, u, c, *, loss: PointwiseLoss):
    """One X-read (Σᵢ wᵢ·l(mᵢ, yᵢ), Xᵀr, Σᵢ rᵢ) with r = w·l'(m, y) and
    m = X@u + offsets − c. ``offsets=None`` means 0 and ``weights=None``
    means 1 (the kernel then reads neither array). K1 takes the layout
    ``vg_plan`` names. Returns float32 (value, grad, r_sum)."""
    return _value_grad(X, labels, offsets, weights, u, c, loss, None)


def fused_value_grad_in_layout(X, labels, offsets, weights, u, c, *, loss: PointwiseLoss,
                               layout: str):
    """``fused_value_grad`` with K1 in the layout named ("rows" or
    "tiles"), whatever the rule would pick: for comparing the two layouts.
    A layout that cannot run on these inputs raises."""
    return _value_grad(X, labels, offsets, weights, u, c, loss, LAYOUTS[layout])


def _value_grad(X, labels, offsets, weights, u, c, loss, layout: int | None):
    if devcost.capture_enabled():
        _capture("fused.value_grad", value_grad_cost, X, offsets, weights)
    device = X.device
    if device.type == "cpu":
        return fused_value_grad_reference(X, labels, offsets, weights, u, c, loss=loss)
    if device.type != "cuda":
        raise ValueError(f"fused_value_grad runs on CPU or CUDA tensors, not {device}")
    u = _as_f32(u)
    _check(X, labels, offsets, weights, (u,))
    lib = _cuda.load()
    n, d = X.shape
    stream = _current_stream(device.index)
    part, max_grid, _ = _workspace(device, stream)
    cp, cval, _c = _scalar(c, X)
    out = torch.empty(d + 2, dtype=torch.float32, device=device)
    args = (
        X.data_ptr(), X.dtype is torch.bfloat16, labels.data_ptr(), _ptr(offsets), _ptr(weights),
        u.data_ptr(), cp, cval, n, d, loss.kernel_id, device.index, max_grid, part,
        out.data_ptr(), stream,
    )
    if layout is None:  # the layout the rule picks
        rc = lib.photon_fused_vg(*args)
    else:
        rc = lib.photon_fused_vg_layout(*args, layout)
    _raise_on(rc, "fused_value_grad")
    graphs.count_launch("fused_value_grad", device, functools.partial(_count, "fused_value_grad"))
    return out[d], out[:d], out[d + 1]


def fused_hvp(X, labels, offsets, weights, u, v, c, cv, *, loss: PointwiseLoss):
    """One X-read Gauss-Newton Hv: (Xᵀq, Σq) with q = w·l''(m, y)·(X@v − cv)
    and m = X@u + offsets − c; ``offsets``/``weights`` may be None as in
    ``fused_value_grad``. Returns float32 (hv, q_sum)."""
    if devcost.capture_enabled():
        _capture("fused.hvp", hvp_cost, X, offsets, weights)
    device = X.device
    if device.type == "cpu":
        return fused_hvp_reference(X, labels, offsets, weights, u, v, c, cv, loss=loss)
    if device.type != "cuda":
        raise ValueError(f"fused_hvp runs on CPU or CUDA tensors, not {device}")
    u, v = _as_f32(u), _as_f32(v)
    _check(X, labels, offsets, weights, (u, v))
    lib = _cuda.load()
    n, d = X.shape
    stream = _current_stream(device.index)
    part, max_grid, _ = _workspace(device, stream)
    cp, cval, _c = _scalar(c, X)
    cvp, cvval, _cv = _scalar(cv, X)
    out = torch.empty(d + 1, dtype=torch.float32, device=device)
    rc = lib.photon_fused_hvp(
        X.data_ptr(), X.dtype is torch.bfloat16, labels.data_ptr(), _ptr(offsets), _ptr(weights),
        u.data_ptr(), v.data_ptr(), cp, cvp, cval, cvval, n, d, loss.kernel_id, device.index,
        max_grid, part, out.data_ptr(), stream,
    )
    _raise_on(rc, "fused_hvp")
    graphs.count_launch("fused_hvp", device, functools.partial(_count, "fused_hvp"))
    return out[:d], out[d]
