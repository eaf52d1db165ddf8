"""Checkpoints of coordinate descent after every outer iteration (port of
``photon_ml_tpu/checkpoint.py``).

A checkpoint is one ``ckpt.npz``: every coordinate's coefficient arrays,
the residual-exchange scores and total, and the progress metadata (JSON
bytes under ``__meta__``), committed by one atomic rename so a job cut
while writing keeps its previous checkpoint. ``ckpt.json`` beside it is a
readable copy of the metadata and is never read back. The format is the
reference's: a checkpoint that either package writes, the other resumes.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.game.models import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.parallel.multihost import broadcast_from_host0, is_output_process, process_count
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils.atomic_io import atomic_savez


@dataclass(frozen=True)
class DescentCheckpoint:
    """A resumable descent state: the model and the NEXT outer iteration.

    ``scores`` / ``total`` (when present) restore the residual exchange
    exactly: scores recomputed from the model differ by float
    re-association, which the entity solvers amplify into visible drift.
    ``fingerprint`` is the one the checkpoint was written under."""

    model: GameModel
    next_iteration: int
    scores: dict[str, np.ndarray] | None = None
    total: np.ndarray | None = None
    fingerprint: str | None = None
    # the coordinate to restart at within next_iteration (the out-of-core
    # trainer checkpoints every coordinate visit; in-memory descent, 0)
    next_coordinate: int = 0


_SCORE_PREFIX = "__score__"
_TOTAL_KEY = "__total__"
_META_KEY = "__meta__"

_log = logging.getLogger(__name__)


def batch_digest(labels: torch.Tensor, weights: torch.Tensor) -> str:
    """A cheap digest of a batch that ties a checkpoint's scores to the data
    they were computed on: the float32 bytes of the first and last 256
    labels, and the sums of the labels and of the weights as float64 bytes.
    Reads back 512 labels and two sums, never the columns.

    Each sum is taken in float64 and rounded to float32, so the digest is
    the same on every device. The reference sums in float32; the two agree
    whenever the float32 sum is exact (integer labels such as 0/1 or counts,
    and unit weights, under 2^24 rows) — ROADMAP queue 3."""

    def f32_sum(t: torch.Tensor) -> bytes:
        return np.float64(np.float32(torch.sum(t, dtype=torch.float64).item())).tobytes()

    head = labels[:256].detach().cpu().numpy()
    tail = labels[-256:].detach().cpu().numpy()
    return hashlib.sha256(
        head.tobytes() + tail.tobytes() + f32_sum(labels) + f32_sum(weights)
    ).hexdigest()


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_checkpoint(
    directory: str,
    model: GameModel,
    next_iteration: int,
    fingerprint: str | None = None,
    scores: dict[str, np.ndarray | torch.Tensor] | None = None,
    total: np.ndarray | torch.Tensor | None = None,
    data_digest: str | None = None,
    next_coordinate: int = 0,
) -> None:
    """``fingerprint`` identifies the training setup (configuration and data
    signature): ``load_checkpoint`` refuses a checkpoint written under
    another, so a rerun after a change to the grid, the settings or the data
    retrains instead of resuming a stale state. ``next_coordinate`` is the
    coordinate within ``next_iteration`` to restart at (0 for the in-memory
    descent, which checkpoints whole outer iterations)."""
    os.makedirs(directory, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {
        "task_type": model.task_type.value,
        "next_iteration": next_iteration,
        "next_coordinate": next_coordinate,
        "fingerprint": fingerprint,
        "data_digest": data_digest,
        "coordinates": {},
    }
    for cid, sub in model.models.items():
        if isinstance(sub, FixedEffectModel):
            means, variances = sub.model.coefficients.means, sub.model.coefficients.variances
            meta["coordinates"][cid] = {"type": "fixed", "feature_shard_id": sub.feature_shard_id}
        elif isinstance(sub, RandomEffectModel):
            means, variances = sub.coefficients, sub.variances
            meta["coordinates"][cid] = {
                "type": "random",
                "feature_shard_id": sub.feature_shard_id,
                "random_effect_type": sub.random_effect_type,
            }
        else:  # pragma: no cover
            raise TypeError(f"unknown sub-model {type(sub)}")
        arrays[f"{cid}__means"] = _numpy(means)
        if variances is not None:
            arrays[f"{cid}__variances"] = _numpy(variances)

    if scores is not None and total is not None:
        for cid, s in scores.items():
            arrays[f"{_SCORE_PREFIX}{cid}"] = _numpy(s)
        arrays[_TOTAL_KEY] = _numpy(total)
        meta["has_scores"] = True

    # the metadata lives INSIDE the npz: one file, one atomic rename
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    atomic_savez(directory, os.path.join(directory, "ckpt.npz"), arrays)
    with open(os.path.join(directory, "ckpt.json"), "w") as f:
        json.dump(meta, f)


def peek_fingerprint(directory: str) -> str | None:
    """The fingerprint the stored checkpoint was written under, from the
    npz's metadata alone (``np.load`` reads entries lazily); None without a
    checkpoint or its metadata."""
    npz_path = os.path.join(directory, "ckpt.npz")
    if not os.path.exists(npz_path):
        return None
    try:
        with np.load(npz_path) as z:
            if _META_KEY not in z.files:
                return None
            meta = json.loads(bytes(z[_META_KEY]).decode())
    except (OSError, ValueError):  # a truncated or foreign file
        return None
    return meta.get("fingerprint")


def _checkpoint_source(npz_path: str, across_processes: bool):
    """Where ``load_checkpoint`` reads: the file, or across processes the
    bytes process 0 read from it and broadcast (None: no checkpoint)."""
    if across_processes and process_count() > 1:
        blob = b""
        if is_output_process() and os.path.exists(npz_path):
            with open(npz_path, "rb") as f:
                blob = f.read()
        blob = broadcast_from_host0(np.frombuffer(blob, np.uint8)).tobytes()
        return io.BytesIO(blob) if blob else None
    return npz_path if os.path.exists(npz_path) else None


def load_checkpoint(
    directory: str,
    fingerprint: str | Sequence[str] | None = None,
    data_digest: str | None = None,
    device=None,
    across_processes: bool = False,
) -> DescentCheckpoint | None:
    """The checkpoint in ``directory``, its model on ``device`` (CUDA unless
    the caller asks for another; raises without it), or None without one.
    ``across_processes``: process 0 alone reads the file and every process
    parses the bytes it broadcasts, so all make the same resume decision
    (a collective: every process calls it).

    A checkpoint whose fingerprint is not ``fingerprint`` (when given) is
    ignored with a warning: it belongs to another configuration or dataset.
    A collection of fingerprints accepts any of them: a recovery resumes a
    degraded run from a checkpoint written under the process layout before
    the loss, whose fingerprint differs from the survivors' (the row layout
    is part of it). A ``data_digest`` other than the stored one
    drops only the scores and total (they hold the old data's per-row
    values); the model still resumes."""
    dev = resolve_device(device)
    npz_path = os.path.join(directory, "ckpt.npz")
    source = _checkpoint_source(npz_path, across_processes)
    if source is None:
        return None
    with np.load(source) as z:
        arrays = {k: z[k] for k in z.files}
    if _META_KEY not in arrays:
        _log.warning(
            "ignoring %s: no embedded metadata (truncated or foreign npz); "
            "training restarts from iteration 0", npz_path,
        )
        return None
    meta = json.loads(bytes(arrays[_META_KEY]).decode())
    accepted = (fingerprint,) if isinstance(fingerprint, str) else None if fingerprint is None else tuple(fingerprint)
    if accepted is not None and meta.get("fingerprint") not in accepted:
        _log.warning(
            "ignoring %s: fingerprint mismatch (written under a different "
            "configuration/data); training restarts from iteration 0", npz_path,
        )
        return None
    task = TaskType(meta["task_type"])

    def on_device(key: str) -> torch.Tensor | None:
        return torch.from_numpy(arrays[key]).to(dev) if key in arrays else None

    models: dict = {}
    for cid, info in meta["coordinates"].items():
        means, variances = on_device(f"{cid}__means"), on_device(f"{cid}__variances")
        if info["type"] == "fixed":
            models[cid] = FixedEffectModel(
                model=GeneralizedLinearModel(Coefficients(means, variances), task),
                feature_shard_id=info["feature_shard_id"],
            )
        else:
            models[cid] = RandomEffectModel(
                coefficients=means,
                variances=variances,
                random_effect_type=info["random_effect_type"],
                feature_shard_id=info["feature_shard_id"],
                task_type=task,
            )
    scores = total = None
    if meta.get("has_scores"):
        if data_digest is not None and meta.get("data_digest") != data_digest:
            _log.warning(
                "checkpoint %s was written against different data; dropping "
                "its residual scores (model still resumes, scores recompute)",
                npz_path,
            )
        else:
            scores = {
                k[len(_SCORE_PREFIX):]: v for k, v in arrays.items() if k.startswith(_SCORE_PREFIX)
            }
            total = arrays[_TOTAL_KEY]
    return DescentCheckpoint(
        model=GameModel(models=models, task_type=task),
        next_iteration=int(meta["next_iteration"]),
        scores=scores,
        total=total,
        fingerprint=meta.get("fingerprint"),
        next_coordinate=int(meta.get("next_coordinate", 0)),
    )
