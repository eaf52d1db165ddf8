#!/usr/bin/env python3
"""Drive the PyTorch port's dense GLM training path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the CUDA kernels from
``photon_ml_tpu_torch/csrc`` and prints one JSON line per phase:

1. device: the card's name and power limit;
2. build: the kernels compiled with nvcc for sm_90a;
3. parity: K1 (fused value+gradient) and K2 (fused Hessian-vector) against
   their plain PyTorch versions on the card, at the headline shape
   (n = 2^20, d = 512, bfloat16 X), config B's (n = 2^20, d = 256, float32)
   and a ragged one (n = 2^20 - 37, d = 124, both storage types), over all
   four losses, with and without offsets and weights (zero-weight rows
   included); then each kernel's time at the shape the main path gives it,
   beside its plain version, one PyTorch-library computation of the same
   function, and the least time the card could take;
4. main_a: ``train_glm`` on the headline logistic problem (L-BFGS, 30
   iterations, lambda = 1), then a warm-started 3-lambda sweep with
   validation at the same width;
5. main_b: ``train_glm`` with TRON on config B's linear problem (15
   iterations);
6. agreement: A and B again with the kernels vetoed
   (``PHOTON_DISABLE_FUSED=1``), held to |dAUC| <= 0.005, relative
   d(objective) <= 1e-3 and, for B, relative dRMSE <= 1e-4.

Every check that fails raises, and the script exits non-zero with no
result. Its last lines are the kernel table as one JSON object, the line
``nvidia-smi --query-gpu=name,power.limit`` prints, and
``{"ok": true, "device": {...}}``. It needs one card, and refuses to run
without CUDA or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.data.synthetic import synthetic_glm_data
from photon_ml_tpu_torch.evaluation import auc_roc, rmse
from photon_ml_tpu_torch.ops import _cuda, fused
from photon_ml_tpu_torch.ops.batch import DenseBatch
from photon_ml_tpu_torch.ops.losses import LOSSES
from photon_ml_tpu_torch.supervised.training import train_glm
from photon_ml_tpu_torch.types import OptimizerType, TaskType

N = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-3, 2e-2)}  # (value rtol, vector rtol = atol)
KERNEL_ROWS = {
    "fused_value_grad": dict(
        source="photon_ml_tpu_torch/csrc/fused_glm.cu",
        replaces="photon_ml_tpu/ops/fused.py:120 (_vg_kernel, launched at :230)",
    ),
    "fused_hvp": dict(
        source="photon_ml_tpu_torch/csrc/fused_glm.cu",
        replaces="photon_ml_tpu/ops/fused.py:246 (_hvp_kernel, launched at :299)",
    ),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def close(got, ref, rtol: float, atol: float) -> tuple[bool, float]:
    """(every element within atol + rtol·|ref|, max |got − ref|)."""
    err = (got.double() - ref.double()).abs()
    ok = bool((err <= atol + rtol * ref.double().abs()).all()) and bool(torch.isfinite(got).all())
    return ok, float(err.max())


# ---------------------------------------------------------------------------
# phase 3: kernel parity and timing
# ---------------------------------------------------------------------------
def _labels(gen, loss: str, n: int, dev):
    if loss == "poisson":
        return torch.poisson(torch.ones(n, device=dev), generator=gen)
    if loss == "squared":
        return torch.randn(n, generator=gen, device=dev)
    return (torch.rand(n, generator=gen, device=dev) < 0.5).float()


def _aux(gen, n: int, dev):
    """Offsets and weights; every 7th row has weight 0 and offset 100, which
    overflows the Poisson loss there: the select must keep it at 0."""
    off = 0.1 * torch.randn(n, generator=gen, device=dev)
    wt = 0.5 + torch.rand(n, generator=gen, device=dev)
    wt[::7] = 0.0
    off[::7] = 100.0
    return off, wt


def parity(dev) -> None:
    shapes = [
        ("headline", N, 512, torch.bfloat16),
        ("config_b", N, 256, torch.float32),
        ("ragged_f32", N - 37, 124, torch.float32),
        ("ragged_bf16", N - 37, 124, torch.bfloat16),
    ]
    for name, n, d, dtype in shapes:
        gen = torch.Generator(device=dev).manual_seed(n + d)
        X = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        # margins and X·v of standard deviation 0.5 and 1
        u = 0.5 * torch.randn(d, generator=gen, device=dev) / d**0.5
        v = torch.randn(d, generator=gen, device=dev) / d**0.5
        c, cv = torch.tensor(0.1, device=dev), torch.tensor(-0.05, device=dev)
        off, wt = _aux(gen, n, dev)
        rtol_v, tol = TOL[str(dtype).removeprefix("torch.")]
        for loss_name, loss in LOSSES.items():
            y = _labels(gen, loss_name, n, dev)
            for aux in (False, True):
                o, w = (off, wt) if aux else (None, None)
                kv = fused.fused_value_grad(X, y, o, w, u, c, loss=loss)
                pv = fused.fused_value_grad_reference(X, y, o, w, u, c, loss=loss)
                kh = fused.fused_hvp(X, y, o, w, u, v, c, cv, loss=loss)
                ph = fused.fused_hvp_reference(X, y, o, w, u, v, c, cv, loss=loss)
                torch.cuda.synchronize()
                checks = {
                    "value": close(kv[0], pv[0], rtol_v, 0.0),
                    "grad": close(kv[1], pv[1], tol, tol),
                    "r_sum": close(kv[2], pv[2], tol, tol),
                    "hv": close(kh[0], ph[0], tol, tol),
                    "q_sum": close(kh[1], ph[1], tol, tol),
                }
                emit("parity", shape=name, n=n, d=d, dtype=str(dtype), loss=loss_name, aux=aux,
                     max_abs_err={k: e for k, (_, e) in checks.items()},
                     ok=all(ok for ok, _ in checks.values()))
                bad = [k for k, (ok, _) in checks.items() if not ok]
                if bad:
                    raise AssertionError(f"kernel disagrees with its plain version: {name} "
                                         f"{loss_name} aux={aux}: {bad}")
        if name == "headline":
            a = fused.fused_value_grad(X, y, off, wt, u, c, loss=loss)
            b = fused.fused_value_grad(X, y, off, wt, u, c, loss=loss)
            if not all(torch.equal(p, q) for p, q in zip(a, b)):
                raise AssertionError("K1 is not bitwise repeatable")
        del X
        torch.cuda.empty_cache()


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing(dev) -> dict:
    """Each kernel at the shape and inputs the main path gives it: K1 at the
    headline (logistic, bfloat16, offsets and weights constant and not
    read), K2 at config B (squared, float32); K1 at config B besides."""
    rows = {}
    cases = [
        ("fused_value_grad", "headline", 512, torch.bfloat16, "logistic"),
        ("fused_value_grad", "config_b", 256, torch.float32, "squared"),
        ("fused_hvp", "config_b", 256, torch.float32, "squared"),
    ]
    for kernel, shape, d, dtype, loss_name in cases:
        loss = LOSSES[loss_name]
        gen = torch.Generator(device=dev).manual_seed(d)
        X = torch.randn((N, d), generator=gen, device=dev).to(dtype)
        y = _labels(gen, loss_name, N, dev)
        u = 0.5 * torch.randn(d, generator=gen, device=dev) / d**0.5
        v = torch.randn(d, generator=gen, device=dev) / d**0.5
        c, cv = torch.tensor(0.1, device=dev), torch.tensor(-0.05, device=dev)
        itemsize = X.element_size()
        if kernel == "fused_value_grad":
            run = lambda: fused.fused_value_grad(X, y, None, None, u, c, loss=loss)  # noqa: E731
            plain = lambda: fused.fused_value_grad_reference(X, y, None, None, u, c, loss=loss)  # noqa: E731

            def library():
                m = (X @ u.to(dtype)).float() - c
                r = loss.d1(m, y)
                return loss.value(m, y).sum(), X.T @ r.to(dtype), r.sum()

            # X, labels and u read once; gradient, value and r-sum written once
            nbytes = N * d * itemsize + 4 * N + 4 * d + 4 * (d + 2)
            flops = 4.0 * N * d
            got, ref = run(), plain()
            err = float((got[1].double() - ref[1].double()).abs().max())
        else:
            run = lambda: fused.fused_hvp(X, y, None, None, u, v, c, cv, loss=loss)  # noqa: E731
            plain = lambda: fused.fused_hvp_reference(X, y, None, None, u, v, c, cv, loss=loss)  # noqa: E731
            uv = torch.stack([u, v], dim=1).to(dtype)

            def library():
                muv = (X @ uv).float()
                q = loss.d2(muv[:, 0] - c, y) * (muv[:, 1] - cv)
                return X.T @ q.to(dtype), q.sum()

            nbytes = N * d * itemsize + 4 * N + 8 * d + 4 * (d + 1)
            flops = 6.0 * N * d
            got, ref = run(), plain()
            err = float((got[0].double() - ref[0].double()).abs().max())
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(plain, 3)
        library_ms = cuda_ms(library, 20)
        ms_again = cuda_ms(run, 20)
        bound_ms, bound_by = _bound(nbytes, flops)
        rec = dict(kernel=kernel, shape=shape, n=N, d=d, dtype=str(dtype), loss=loss_name,
                   ms=ms, ms_again=ms_again, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
                   max_abs_err=err, hbm_share=bound_ms / ms)
        emit("timing", **rec)
        if (kernel, shape) in (("fused_value_grad", "headline"), ("fused_hvp", "config_b")):
            rows[kernel] = rec
        del X
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------
def headline_problem(dev):
    """bench.py's headline shape: logistic, n = 2^20, d = 512 with the
    intercept at 511, bfloat16 X, offsets 0 and weights 1; a 2^16-row
    validation set from the same true weights."""
    batch, intercept, w_true = synthetic_glm_data(
        0, N, 511, TaskType.LOGISTIC_REGRESSION, dtype=torch.bfloat16, device=dev
    )
    gen = torch.Generator(device=dev).manual_seed(1)
    nv = 1 << 16
    Xv = torch.randn((nv, 512), generator=gen, device=dev)
    Xv[:, intercept] = 1.0
    yv = (torch.rand(nv, generator=gen, device=dev) < torch.sigmoid(Xv @ w_true)).float()
    val = DenseBatch(X=Xv.to(torch.bfloat16), labels=yv, offsets=torch.zeros(nv, device=dev),
                     weights=torch.ones(nv, device=dev))
    return batch, intercept, val


def solve(batch, task, config, weights, dev, **kw):
    """``train_glm`` with the launch counts zeroed just before it and read
    just after; returns (result, wall seconds, launches)."""
    fused.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = train_glm(batch, task, optimizer_config=config, regularization_weights=weights,
                       device=dev, **kw)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, dict(fused.launch_counts)


def _record(t, wall, launches, **metrics) -> dict:
    return dict(iterations=t.iterations, reason=t.reason, objective_passes=t.objective_passes,
                objective=float(t.value), **metrics, wall_s=wall,
                wall_ms_per_pass=1e3 * wall / t.objective_passes, launches=launches)


def run_a(batch, intercept, dev) -> dict:
    task = TaskType.LOGISTIC_REGRESSION
    # the warm-up solve keeps first-call costs out of the timed one
    solve(batch, task, OptimizerConfig(max_iterations=2), [1.0], dev, intercept_index=intercept)
    result, wall, launches = solve(batch, task, OptimizerConfig(max_iterations=30, tolerance=0.0),
                                   [1.0], dev, intercept_index=intercept)
    auc = float(auc_roc(result.models[1.0].score(batch), batch.labels))
    return _record(result.trackers[1.0], wall, launches, train_auc=auc)


def run_sweep(batch, intercept, val, dev) -> dict:
    result, wall, launches = solve(
        batch, TaskType.LOGISTIC_REGRESSION, OptimizerConfig(max_iterations=30, tolerance=0.0),
        [0.1, 1.0, 10.0], dev, intercept_index=intercept, validation_batch=val,
    )
    per = {
        str(lam): dict(iterations=t.iterations, objective_passes=t.objective_passes,
                       objective=float(t.value), validation_auc=result.validation[lam].metrics["AUC"])
        for lam, t in result.trackers.items()
    }
    passes = sum(t.objective_passes for t in result.trackers.values())
    return dict(best_weight=result.best_weight, per_weight=per, wall_s=wall,
                wall_ms_per_pass=1e3 * wall / passes, launches=launches)


def run_b(dev) -> dict:
    task = TaskType.LINEAR_REGRESSION
    batch, _, _ = synthetic_glm_data(
        2, N, 256, task, noise=0.1, add_intercept=False, dtype=torch.float32, device=dev
    )
    tron = OptimizerType.TRON
    solve(batch, task, OptimizerConfig(optimizer_type=tron, max_iterations=2), [1.0], dev)
    result, wall, launches = solve(
        batch, task, OptimizerConfig(optimizer_type=tron, max_iterations=15, tolerance=0.0),
        [1.0], dev,
    )
    train_rmse = float(rmse(result.models[1.0].score(batch), batch.labels))
    return _record(result.trackers[1.0], wall, launches, train_rmse=train_rmse)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    name, power_limit = [s.strip() for s in smi.split(",", 1)]
    emit("device", name=name, power_limit=power_limit, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    t0 = time.perf_counter()
    lib = _cuda.build()
    log = lib.with_suffix(".log").read_text()
    spills = sum(1 for line in log.splitlines() if "spill" in line and " 0 bytes spill" not in line)
    emit("build", seconds=time.perf_counter() - t0, library=lib.name, spill_lines=spills)

    parity(dev)
    rows = timing(dev)

    # main path A: the headline solve, then the sweep
    batch, intercept, val = headline_problem(dev)
    a = run_a(batch, intercept, dev)
    emit("main_a", **a)
    if a["launches"]["fused_value_grad"] != a["objective_passes"] or a["launches"]["fused_hvp"]:
        raise AssertionError(f"main path A did not run on K1 alone: {a['launches']}")
    sweep = run_sweep(batch, intercept, val, dev)
    emit("main_a_sweep", **sweep)
    if sweep["launches"]["fused_value_grad"] == 0:
        raise AssertionError("the sweep launched no K1")

    # main path B: TRON on config B
    b = run_b(dev)
    emit("main_b", **b)
    k1, k2 = b["launches"]["fused_value_grad"], b["launches"]["fused_hvp"]
    if k1 != b["iterations"] + 1 or k2 == 0 or k1 + k2 != b["objective_passes"]:
        raise AssertionError(f"main path B did not run on K1 and K2: {b['launches']}")

    # agreement: the same solves with the kernels vetoed
    os.environ["PHOTON_DISABLE_FUSED"] = "1"
    try:
        a0 = run_a(batch, intercept, dev)
        del batch, val
        torch.cuda.empty_cache()
        b0 = run_b(dev)
    finally:
        del os.environ["PHOTON_DISABLE_FUSED"]
    if any(a0["launches"].values()) or any(b0["launches"].values()):
        raise AssertionError("the unfused runs launched a kernel")
    agree = dict(
        a_unfused=a0, b_unfused=b0,
        d_auc=abs(a["train_auc"] - a0["train_auc"]),
        a_rel_d_objective=abs(a["objective"] - a0["objective"]) / abs(a0["objective"]),
        b_rel_d_objective=abs(b["objective"] - b0["objective"]) / abs(b0["objective"]),
        b_rel_d_rmse=abs(b["train_rmse"] - b0["train_rmse"]) / b0["train_rmse"],
    )
    emit("agreement", **agree)
    if not (agree["d_auc"] <= 0.005 and agree["a_rel_d_objective"] <= 1e-3
            and agree["b_rel_d_objective"] <= 1e-3 and agree["b_rel_d_rmse"] <= 1e-4):
        raise AssertionError("fused and unfused solves disagree")

    launches = {  # over the main path's three solves: A, the sweep and B
        k: a["launches"][k] + sweep["launches"][k] + b["launches"][k] for k in KERNEL_ROWS
    }
    kernels = [
        dict(name=kernel, route="cuda", **KERNEL_ROWS[kernel], launches=launches[kernel],
             max_abs_err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
             bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=rec["library_ms"])
        for kernel, rec in rows.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
