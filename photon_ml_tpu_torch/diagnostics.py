"""Model diagnostics reports, JSON and one self-contained HTML file (port
of ``photon_ml_tpu/diagnostics.py``), built from what the trainers already
return:

- each solve's trace (``OptimizationResult``: iterations, reason, loss and
  gradient-norm histories, objective passes),
- the validation metrics of each λ or grid entry and each descent step,
- coefficient summaries with the top features by |weight| named through
  the feature ``IndexMap``.

``*_diagnostics`` builds a plain JSON-able dict from the port's result types
and tensors, moving each tensor to the host once; ``write_html`` renders it
as one dependency-free HTML file with inline SVG sparklines.
"""

from __future__ import annotations

import html
import json
import math
import os
from typing import Any, Mapping

import numpy as np
import torch

from photon_ml_tpu_torch.game.models import FixedEffectModel, RandomEffectModel
from photon_ml_tpu_torch.optim.common import ConvergenceReason, OptimizationResult

__all__ = [
    "coefficient_summary",
    "optimizer_summary",
    "glm_sweep_diagnostics",
    "game_diagnostics",
    "write_html",
    "write_report",
]


def _clean(x: float) -> float | None:
    """JSON-safe float (NaN and ±Inf → None)."""
    x = float(x)
    return x if math.isfinite(x) else None


def _host(x) -> np.ndarray | None:
    """A tensor (or array) as a float64 numpy array, in one transfer."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def optimizer_summary(tracker: OptimizationResult) -> dict:
    """One solve's trace: counts, terminal state, loss and gradient-norm
    curves."""
    n = int(tracker.iterations)
    # the histories and the final value and gradient norm in one transfer
    dev = tracker.loss_history.device
    flat = _host(torch.cat([
        torch.as_tensor(t, dtype=torch.float64, device=dev).reshape(-1)
        for t in (tracker.loss_history, tracker.grad_norm_history, tracker.value, tracker.grad_norm)
    ]))
    m = (len(flat) - 2) // 2
    losses, gnorms, value, grad_norm = flat[:m], flat[m:2 * m], flat[-2], flat[-1]
    out = {
        "iterations": n,
        "converged": bool(tracker.converged),
        "reason": ConvergenceReason(int(tracker.reason)).name,
        "final_loss": _clean(value),
        "final_grad_norm": _clean(grad_norm),
        "loss_history": [_clean(v) for v in losses[: n + 1]],
        "grad_norm_history": [_clean(v) for v in gnorms[: n + 1]],
    }
    if tracker.objective_passes is not None:
        out["objective_passes"] = int(tracker.objective_passes)
    return out


def coefficient_summary(means, variances=None, index_map=None, top_k: int = 25) -> dict:
    """Shape and sparsity statistics and the top-|weight| features, named by
    ``index_map`` when given (feature importance in the reference's report
    sense: the magnitude of the weight)."""
    w = _host(means).ravel()
    d = w.shape[0]
    nz = int(np.count_nonzero(w))
    finite = np.isfinite(w)
    order = np.argsort(-np.abs(np.where(finite, w, 0.0)))[: min(top_k, d)]
    # names for the selected indices only (a reverse lookup, not a d-sized inversion)
    names = index_map.keys_for(order) if index_map is not None else [str(int(j)) for j in order]
    var = None if variances is None else _host(variances).ravel()
    top = []
    for rank, j in enumerate(order):
        if not finite[j]:
            continue  # a diverged solve can leave NaN or Inf weights
        if w[j] == 0.0:
            break
        entry = {"index": int(j), "feature": names[rank], "weight": _clean(w[j])}
        if var is not None:
            entry["variance"] = _clean(var[j])
        top.append(entry)
    return {
        "num_features": d,
        "num_nonzero": nz,
        "num_nonfinite": int(np.sum(~finite)),
        "sparsity": _clean(1.0 - nz / max(d, 1)),
        "weight_norm": _clean(np.linalg.norm(w)),
        "weight_max_abs": _clean(np.max(np.abs(w)) if d else 0.0),
        "has_variances": var is not None,
        "top_features": top,
    }


def glm_sweep_diagnostics(result, index_map=None, task=None, top_k: int = 25) -> dict:
    """Report for a ``GLMTrainingResult`` (the GLM driver's λ sweep)."""
    entries = []
    for lam, model in result.models.items():
        tracker = result.trackers.get(lam)
        ev = result.validation.get(lam)
        entries.append({
            "regularization_weight": float(lam),
            "optimizer": None if tracker is None else optimizer_summary(tracker),
            "validation": None if ev is None else dict(ev.metrics),
            "coefficients": coefficient_summary(model.coefficients.means, model.coefficients.variances,
                                                index_map, top_k=top_k),
        })
    return {
        "kind": "glm_sweep",
        "task": None if task is None else str(getattr(task, "value", task)),
        "best_regularization_weight": result.best_weight,
        "entries": entries,
    }


def game_diagnostics(results, config=None, index_maps=None, top_k: int = 25) -> dict:
    """Report for a list of ``GameResult`` grid entries; ``index_maps``
    (feature shard id → ``IndexMap``) names the fixed effects' features."""
    index_maps = index_maps or {}
    grid = []
    for i, res in enumerate(results):
        coords = {}
        for cid, sub in res.model.models.items():
            info: dict[str, Any] = {}
            if isinstance(sub, FixedEffectModel):
                info["type"] = "fixed_effect"
                info["feature_shard"] = sub.feature_shard_id
                info["coefficients"] = coefficient_summary(
                    sub.model.coefficients.means, sub.model.coefficients.variances,
                    index_maps.get(sub.feature_shard_id), top_k=top_k,
                )
            elif isinstance(sub, RandomEffectModel):
                W = _host(sub.coefficients)
                norms = np.linalg.norm(W, axis=1)
                info["type"] = "random_effect"
                info["feature_shard"] = sub.feature_shard_id
                info["random_effect_type"] = sub.random_effect_type
                info["num_entities"] = int(W.shape[0])
                info["num_features"] = int(W.shape[1])
                info["entities_nonzero"] = int(np.count_nonzero(norms))
                info["entity_norm_mean"] = _clean(norms.mean() if norms.size else 0.0)
                info["entity_norm_max"] = _clean(norms.max() if norms.size else 0.0)
            info["per_iteration"] = [
                optimizer_summary(t) for t in res.descent.trackers.get(cid, [])
                if isinstance(t, OptimizationResult)
            ]
            coords[cid] = info
        grid.append({
            "grid_index": i,
            "configuration": {cid: cfg.to_dict() for cid, cfg in res.configuration.items()},
            "evaluation": None if res.evaluation is None else dict(res.evaluation.metrics),
            "coordinates": coords,
            "validation_history": [
                {cid: dict(ev.metrics) for cid, ev in step.items()} for step in res.descent.validation_history
            ],
        })
    report = {"kind": "game", "grid": grid}
    if config is not None:
        report["config"] = config.to_dict()
    return report


# ---------------------------------------------------------------- HTML


def _sparkline(values, width=240, height=40) -> str:
    """Inline SVG polyline of a numeric series (log-ish robust scaling)."""
    vals = [v for v in values if v is not None]
    if len(vals) < 2:
        return ""
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    pts = []
    n = len(vals)
    for i, v in enumerate(vals):
        x = i * (width - 4) / (n - 1) + 2
        y = height - 2 - (v - lo) * (height - 4) / span
        pts.append(f"{x:.1f},{y:.1f}")
    return (
        f'<svg width="{width}" height="{height}" class="spark">'
        f'<polyline fill="none" stroke="#2563eb" stroke-width="1.5" '
        f'points="{" ".join(pts)}"/></svg>'
    )


def _metric_table(metrics: Mapping[str, Any]) -> str:
    rows = "".join(
        f"<tr><td>{html.escape(str(k))}</td><td>{'' if v is None else f'{v:.6g}' if isinstance(v, float) else html.escape(str(v))}</td></tr>"
        for k, v in metrics.items()
    )
    return f"<table>{rows}</table>"


def _coeff_block(c: dict) -> str:
    head = _metric_table(
        {
            "features": c["num_features"],
            "nonzero": c["num_nonzero"],
            "sparsity": c["sparsity"],
            "‖w‖₂": c["weight_norm"],
            "max |w|": c["weight_max_abs"],
        }
    )
    fmt = lambda v, p: "—" if v is None else f"{v:{p}}"
    rows = "".join(
        "<tr><td>{}</td><td>{}</td>{}</tr>".format(
            html.escape(str(t["feature"])),
            fmt(t["weight"], ".6g"),
            f"<td>{fmt(t['variance'], '.3g')}</td>" if "variance" in t else "",
        )
        for t in c["top_features"]
    )
    var_h = "<th>variance</th>" if c.get("has_variances") else ""
    table = (
        f"<table><tr><th>feature</th><th>weight</th>{var_h}</tr>{rows}</table>"
        if rows
        else "<p class='dim'>all-zero coefficients</p>"
    )
    return head + "<h4>top features by |weight|</h4>" + table


def _opt_block(o: dict) -> str:
    head = _metric_table(
        {
            "iterations": o["iterations"],
            "objective passes": o.get("objective_passes"),
            "converged": o["converged"],
            "reason": o["reason"],
            "final loss": o["final_loss"],
            "final ‖g‖": o["final_grad_norm"],
        }
    )
    spark = _sparkline(o["loss_history"])
    return head + (f"<div>loss {spark}</div>" if spark else "")


_STYLE = """
body{font-family:system-ui,sans-serif;margin:2rem;color:#111}
h1,h2,h3{margin:1.2em 0 .4em} .dim{color:#777}
table{border-collapse:collapse;margin:.4em 0}
td,th{border:1px solid #ddd;padding:.25em .6em;text-align:left;font-size:.92em}
th{background:#f3f4f6} .spark{vertical-align:middle}
section{margin-bottom:2rem;border-bottom:1px solid #eee;padding-bottom:1rem}
"""


def write_html(report: dict, path: str) -> None:
    """Render a diagnostics report dict as one self-contained HTML file."""
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>photon-ml-tpu diagnostics</title><style>{_STYLE}</style></head><body>",
        "<h1>photon-ml-tpu — model diagnostics</h1>",
    ]
    if report.get("kind") == "glm_sweep":
        parts.append(
            f"<p>task: <b>{html.escape(str(report.get('task')))}</b> — best λ: "
            f"<b>{report.get('best_regularization_weight')}</b></p>"
        )
        for e in report["entries"]:
            parts.append(
                f"<section><h2>λ = {e['regularization_weight']}</h2>"
            )
            if e.get("optimizer"):
                parts.append("<h3>optimizer</h3>" + _opt_block(e["optimizer"]))
            if e.get("validation"):
                parts.append("<h3>validation</h3>" + _metric_table(e["validation"]))
            parts.append("<h3>coefficients</h3>" + _coeff_block(e["coefficients"]))
            parts.append("</section>")
    elif report.get("kind") == "game":
        for g in report["grid"]:
            parts.append(f"<section><h2>grid entry {g['grid_index']}</h2>")
            if g.get("evaluation"):
                parts.append("<h3>final evaluation</h3>" + _metric_table(g["evaluation"]))
            for cid, info in g["coordinates"].items():
                parts.append(f"<h3>coordinate “{html.escape(cid)}” ({info.get('type')})</h3>")
                if info.get("type") == "fixed_effect":
                    parts.append(_coeff_block(info["coefficients"]))
                elif info.get("type") == "random_effect":
                    parts.append(
                        _metric_table(
                            {
                                "entities": info["num_entities"],
                                "features / entity": info["num_features"],
                                "entities with nonzero model": info["entities_nonzero"],
                                "mean ‖w_e‖": info["entity_norm_mean"],
                                "max ‖w_e‖": info["entity_norm_max"],
                            }
                        )
                    )
                if info.get("per_iteration"):
                    last = info["per_iteration"][-1]
                    parts.append("<h4>last solve</h4>" + _opt_block(last))
            if g.get("validation_history"):
                parts.append("<h3>validation history (primary metric)</h3>")
                series: dict[str, list] = {}
                for step in g["validation_history"]:
                    for cid, metrics in step.items():
                        first = next(iter(metrics.values()), None)
                        series.setdefault(cid, []).append(first)
                for cid, vals in series.items():
                    parts.append(
                        f"<div>{html.escape(cid)} {_sparkline(vals)}</div>"
                    )
            parts.append("</section>")
    else:  # unknown kind: raw dump
        parts.append(f"<pre>{html.escape(json.dumps(report, indent=2))}</pre>")
    parts.append("</body></html>")
    with open(path, "w") as f:
        f.write("".join(parts))


def write_report(report: dict, directory: str, basename: str = "diagnostics") -> None:
    """Write both the JSON and the HTML rendering into ``directory``."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, f"{basename}.json"), "w") as f:
        json.dump(report, f, indent=2)
    write_html(report, os.path.join(directory, f"{basename}.html"))
