"""One-pass fused GLM evaluation: K1 and K2 on Hopper.

``fused_value_grad`` (K1) replaces the Pallas kernel ``_vg_kernel`` of
``photon_ml_tpu/ops/fused.py`` (launched there by ``fused_value_grad``);
``fused_hvp`` (K2) replaces ``_hvp_kernel`` (launched by ``fused_hvp``).
The CUDA C++ kernels live in ``csrc/fused_glm.cu``; that file's header
says how they work.

Bound on an H100 SXM: each reads X once and everything else is O(n + d),
so each is bound by the bytes of X over 3.35 TB/s: 0.32 ms for the
headline X (n = 2^20, d = 512, bfloat16: 1 GiB) and 0.32 ms for config B's
X (n = 2^20, d = 256, float32: 1 GiB). The design reads X exactly once per
evaluation and keeps margins and r / q in registers, never in device
memory.

Each wrapper takes a CPU tensor to its plain PyTorch version
(``fused_value_grad_reference`` / ``fused_hvp_reference``: the same row
masking, loss and casts, with float64 sums) and a CUDA tensor to its
kernel; any other device raises, and a kernel that fails to launch raises.
The plain versions are what the CPU tests run and what ``chip_smoke.py``
holds the kernels against on the card.

``launch_counts`` counts the kernel launches of each wrapper (plain
integers; ``reset_launch_counts`` zeroes them).
"""

from __future__ import annotations

import ctypes

import torch

from photon_ml_tpu_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor

# Columns a kernel handles: 32 lanes x up to 32 register-held columns each
# (``kMaxFeatures`` in csrc/fused_glm.cu).
MAX_FEATURES = 1024
# Upper bound on resident 256-thread blocks per SM (2048 threads); sizes
# the per-block partial buffer.
_MAX_BLOCKS_PER_SM = 8

launch_counts: dict[str, int] = {"fused_value_grad": 0, "fused_hvp": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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
def _ptr(t: Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(X, labels, offsets, weights, vectors) -> None:
    if X.dim() != 2 or not X.is_contiguous():
        raise ValueError("X must be a contiguous (n, d) tensor")
    n, d = X.shape
    if not supports_fused(n, d, X.dtype):
        raise ValueError(
            f"fused kernels take float32/bfloat16 X with 1 <= d <= {MAX_FEATURES}; "
            f"got {tuple(X.shape)} {X.dtype}"
        )
    for name, t, size in (
        [("labels", labels, n), ("offsets", offsets, n), ("weights", weights, n)]
        + [(f"vector {k}", t, d) for k, t in enumerate(vectors)]
    ):
        if t is None:
            continue
        if t.device != X.device or t.dtype != torch.float32 or t.shape != (size,) or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous float32 ({size},) tensor on {X.device}"
            )


def _scalars(X: Tensor, *values) -> Tensor:
    return torch.stack(
        [torch.as_tensor(s, dtype=torch.float32, device=X.device).reshape(()) for s in values]
    )


def _max_grid(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count * _MAX_BLOCKS_PER_SM


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def _as_f32(t: Tensor | None) -> Tensor | None:
    return None if t is None else t.to(torch.float32).contiguous()


def fused_value_grad(X, labels, offsets, weights, u, c, *, loss: PointwiseLoss):
    """One X-read (Σᵢ wᵢ·l(mᵢ, yᵢ), Xᵀr, Σᵢ rᵢ) with r = w·l'(m, y) and
    m = X@u + offsets − c. ``offsets=None`` means 0 and ``weights=None``
    means 1 (the kernel then reads neither array). Returns float32
    (value, grad, r_sum)."""
    if X.device.type == "cpu":
        return fused_value_grad_reference(X, labels, offsets, weights, u, c, loss=loss)
    if X.device.type != "cuda":
        raise ValueError(f"fused_value_grad runs on CPU or CUDA tensors, not {X.device}")
    u = _as_f32(u)
    _check(X, labels, offsets, weights, (u,))
    from photon_ml_tpu_torch.ops import _cuda

    lib = _cuda.load()
    n, d = X.shape
    sc = _scalars(X, c)
    max_grid = _max_grid(X.device)
    part = torch.empty((max_grid, d + 2), dtype=torch.float64, device=X.device)
    out = torch.empty(d + 2, dtype=torch.float32, device=X.device)
    rc = lib.photon_fused_vg(
        _ptr(X), int(X.dtype == torch.bfloat16), _ptr(labels), _ptr(offsets),
        _ptr(weights), _ptr(u), _ptr(sc), n, d, loss.kernel_id, max_grid,
        _ptr(part), _ptr(out), ctypes.c_void_p(torch.cuda.current_stream(X.device).cuda_stream),
    )
    _raise_on(rc, "fused_value_grad")
    launch_counts["fused_value_grad"] += 1
    return out[d], out[:d], out[d + 1]


def fused_hvp(X, labels, offsets, weights, u, v, c, cv, *, loss: PointwiseLoss):
    """One X-read Gauss-Newton Hv: (Xᵀq, Σq) with q = w·l''(m, y)·(X@v − cv)
    and m = X@u + offsets − c; ``offsets``/``weights`` may be None as in
    ``fused_value_grad``. Returns float32 (hv, q_sum)."""
    if X.device.type == "cpu":
        return fused_hvp_reference(X, labels, offsets, weights, u, v, c, cv, loss=loss)
    if X.device.type != "cuda":
        raise ValueError(f"fused_hvp runs on CPU or CUDA tensors, not {X.device}")
    u, v = _as_f32(u), _as_f32(v)
    _check(X, labels, offsets, weights, (u, v))
    from photon_ml_tpu_torch.ops import _cuda

    lib = _cuda.load()
    n, d = X.shape
    sc = _scalars(X, c, cv)
    max_grid = _max_grid(X.device)
    part = torch.empty((max_grid, d + 1), dtype=torch.float64, device=X.device)
    out = torch.empty(d + 1, dtype=torch.float32, device=X.device)
    rc = lib.photon_fused_hvp(
        _ptr(X), int(X.dtype == torch.bfloat16), _ptr(labels), _ptr(offsets),
        _ptr(weights), _ptr(u), _ptr(v), _ptr(sc), n, d, loss.kernel_id, max_grid,
        _ptr(part), _ptr(out), ctypes.c_void_p(torch.cuda.current_stream(X.device).cuda_stream),
    )
    _raise_on(rc, "fused_hvp")
    launch_counts["fused_hvp"] += 1
    return out[:d], out[d]
