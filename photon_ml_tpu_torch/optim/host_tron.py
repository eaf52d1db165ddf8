"""Host-driven TRON for streamed objectives (port of
``photon_ml_tpu/optim/host_tron.py``).

``optim/tron.py``'s algorithm (LIBLINEAR's trust-region truncated Newton:
the same η / σ constants, convergence and stagnation tests) as a host
loop over an objective whose every ``value_and_grad`` and ``hvp`` streams
the data through the card (``StreamingGLMObjective``): one pass per outer
evaluation plus one per CG step, the reference's cost model. The
recursion runs in float64 numpy on the host; each evaluation is read back
once. Its telemetry is ``host_lbfgs``'s (``optim_iter`` records, then
``optim_result``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from photon_ml_tpu_torch.config import OptimizerConfig
from photon_ml_tpu_torch.obs import emit_event
from photon_ml_tpu_torch.optim.common import ConvergenceReason, OptimizationResult
from photon_ml_tpu_torch.optim.host_lbfgs import (
    objective_device,
    read_value_and_grad,
    result_record,
    to_device,
)

# LIBLINEAR tron.cpp's constants (as optim/tron.py)
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0
_CG_XI = 0.1


def _trcg_host(hvp, g: np.ndarray, delta: float, max_cg: int):
    """Truncated CG for H·s = -g within ‖s‖ <= delta (each ``hvp`` one
    streamed pass)."""
    s = np.zeros_like(g)
    r = -g
    d = r.copy()
    rtr = float(r @ r)
    cg_tol = _CG_XI * float(np.linalg.norm(g))
    for _ in range(max_cg):
        if np.sqrt(rtr) <= cg_tol:
            break
        hd = np.asarray(hvp(d), np.float64)
        dhd = float(d @ hd)
        alpha = rtr / max(dhd, 1e-30)
        s1 = s + alpha * d
        if float(np.linalg.norm(s1)) > delta:
            # the boundary: τ >= 0 with ‖s + τ·d‖ = delta
            std = float(s @ d)
            dd = float(d @ d)
            ss = float(s @ s)
            rad = np.sqrt(max(std * std + dd * (delta * delta - ss), 0.0))
            if std >= 0.0:
                tau = (delta * delta - ss) / max(std + rad, 1e-30)
            else:
                tau = (rad - std) / max(dd, 1e-30)
            s = s + tau * d
            r = r - tau * hd
            break
        s = s1
        r = r - alpha * hd
        rtr_new = float(r @ r)
        beta = rtr_new / max(rtr, 1e-30)
        d = r + beta * d
        rtr = rtr_new
    return s, r


def host_tron_minimize(
    objective: Any,
    w0,
    config: OptimizerConfig,
    iteration_callback: Any = None,
) -> OptimizationResult:
    """Minimize with TRON driven from the host; ``objective`` exposes
    ``value_and_grad(w)`` and ``hvp(w, v)``. ``iteration_callback(it, w,
    value)`` fires after every outer iteration (the checkpoint hook)."""
    dev = objective_device(objective)
    T = config.max_iterations
    tol = config.tolerance
    passes = 0

    def vg(w_):
        nonlocal passes
        passes += 1
        return read_value_and_grad(objective, w_, dev)

    def hvp(w_, v):
        nonlocal passes
        passes += 1
        return objective.hvp(to_device(w_, dev), to_device(v, dev)).double().cpu().numpy()

    w = np.asarray(torch.as_tensor(w0).cpu().numpy() if isinstance(w0, torch.Tensor) else w0, np.float64)
    f, g = vg(w)
    g0_norm = float(np.linalg.norm(g))
    loss_hist = np.full(T + 1, np.nan)
    gnorm_hist = np.full(T + 1, np.nan)
    loss_hist[0], gnorm_hist[0] = f, g0_norm

    def converged_grad(gn):
        return gn <= tol * max(1.0, g0_norm)

    delta = g0_norm
    reason = ConvergenceReason.MAX_ITERATIONS
    it = 0
    if converged_grad(g0_norm):
        reason = ConvergenceReason.GRADIENT_CONVERGED
        T = 0

    while it < T:
        s, r = _trcg_host(lambda v: hvp(w, v), g, delta, config.max_cg_iterations)
        gs = float(np.dot(g, s))
        prered = -0.5 * (gs - float(np.dot(s, r)))
        f_new, g_new = vg(w + s)
        actred = f - f_new
        snorm = float(np.linalg.norm(s))

        if it == 0:
            delta = min(delta, snorm)
        denom = f_new - f - gs
        alpha = _SIGMA3 if denom <= 0.0 else max(_SIGMA1, -0.5 * gs / denom)
        if actred < _ETA0 * prered:
            delta = min(max(alpha, _SIGMA1) * snorm, _SIGMA2 * delta)
        elif actred < _ETA1 * prered:
            delta = max(_SIGMA1 * delta, min(alpha * snorm, _SIGMA2 * delta))
        elif actred < _ETA2 * prered:
            delta = max(_SIGMA1 * delta, min(alpha * snorm, _SIGMA3 * delta))
        else:
            delta = max(delta, min(alpha * snorm, _SIGMA3 * delta))

        accept = actred > _ETA0 * prered
        if accept:
            w, f, g = w + s, f_new, g_new
        gn = float(np.linalg.norm(g))
        it += 1
        loss_hist[it], gnorm_hist[it] = f, gn
        # one record an iteration (a no-op with no sink)
        emit_event("optim_iter", algorithm="tron", it=it, loss=f, grad_norm=gn, accepted=bool(accept))
        if iteration_callback is not None:
            iteration_callback(it, w, f)

        if accept and converged_grad(gn):
            reason = ConvergenceReason.GRADIENT_CONVERGED
            break
        tiny = 1e-12 * abs(f)
        stalled = (abs(actred) <= 0.0 and prered <= 0.0) or (abs(actred) <= tiny and abs(prered) <= tiny)
        if stalled or f < -1e32:
            reason = ConvergenceReason.OBJECTIVE_CONVERGED
            break

    return result_record(w, f, np.linalg.norm(g), it, reason, loss_hist, gnorm_hist, passes, dev, "tron")
