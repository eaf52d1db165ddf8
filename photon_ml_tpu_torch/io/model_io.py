"""GLM and GAME model files in Avro (port of ``photon_ml_tpu/io/model_io.py``;
the reference's ``ModelProcessingUtils``).

A fixed effect is one ``BayesianLinearModelAvro`` record, a list of (name,
term, mean) coefficients with optional variances; a random effect is
partitioned Avro of per-entity records whose ``modelId`` is the entity id.
Coefficients at or below the sparsity threshold in magnitude are left out.
The directory layout is the reference's:

    <dir>/metadata.json
    <dir>/fixed-effect/<cid>/coefficients/part-00000.avro
    <dir>/random-effect/<cid>/coefficients/part-00000.avro

With an ``IndexMap`` the real (name, term) keys are written; without one,
synthetic names ``f<index>``, parsed back on load. A model that either
package saves, the other loads with equal coefficients.

Each model tensor is read back from the device once and each loaded matrix
copied to it once; the per-entity work is host numpy.

A published model (the serving side's snapshot pointer) is a root holding
``snapshots/snap-NNNNNN/`` (each a ``save_game_model`` directory) and
``MANIFEST.json``, which names the current snapshot, its sequence number
and its ``model_fingerprint``. ``publish_game_model`` writes the snapshot
whole before it moves the pointer, through an atomic replace, so a reader
sees the previous snapshot or the new one and never a part of either. A
root either package publishes, the other loads with the same fingerprint.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Mapping, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.data.index_map import DELIMITER, INTERCEPT_KEY, IndexMap
from photon_ml_tpu_torch.game.models import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.io.avro import iter_avro_directory, read_avro_file, write_avro_file
from photon_ml_tpu_torch.io.schemas import BAYESIAN_LINEAR_MODEL_SCHEMA
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.types import TaskType

_SYNTHETIC = re.compile(r"^f(\d+)$")


def _host(t: torch.Tensor | None) -> np.ndarray | None:
    """One read-back of a model tensor, as float64 for the Avro doubles."""
    return None if t is None else t.detach().cpu().numpy().astype(np.float64)


def _split_key(key: str) -> tuple[str, str]:
    if DELIMITER in key:
        name, term = key.split(DELIMITER, 1)
        return name, term
    return key, ""


def _index_to_key(index_map: IndexMap | None, d: int) -> list[tuple[str, str]]:
    if index_map is None:
        return [(f"f{i}", "") for i in range(d)]
    keys: list[tuple[str, str]] = [("", "")] * d
    for key, i in index_map.items():
        keys[i] = _split_key(key)
    return keys


def _coefficients_to_record(
    model_id: str,
    means: np.ndarray,
    variances: np.ndarray | None,
    keys: Sequence[tuple[str, str]],
    task: TaskType,
    sparsity_threshold: float,
) -> dict:
    """One model record from host float64 coefficients."""
    keep = np.flatnonzero(np.abs(means) > sparsity_threshold)

    def ntv(values: np.ndarray) -> list[dict]:
        return [
            {"name": keys[i][0], "term": keys[i][1], "value": v}
            for i, v in zip(keep.tolist(), values[keep].tolist())
        ]

    return {
        "modelId": model_id,
        "modelClass": "GeneralizedLinearModel",
        "lossFunction": task.value,
        "means": ntv(means),
        "variances": None if variances is None else ntv(variances),
    }


def _record_to_coefficients(
    record: dict, index_map: IndexMap | None, num_features: int | None,
    lookup: Mapping[str, int] | None = None,
) -> tuple[np.ndarray, np.ndarray | None]:
    """A record's (means, variances) as host float32 arrays. ``lookup`` is
    ``dict(index_map.items())``, passed by callers that resolve many
    records against one map."""
    if index_map is not None and lookup is None:
        lookup = dict(index_map.items())

    def base_index(name: str, term: str) -> int:
        if lookup is not None:
            return lookup.get(f"{name}{DELIMITER}{term}" if term else name, -1)
        m = _SYNTHETIC.match(name)
        if m is None:
            raise ValueError(f"feature {name!r} needs an IndexMap to resolve (not synthetic)")
        return int(m.group(1))

    def resolve(recs: list[dict]) -> tuple[list[tuple[int, float]], list[float]]:
        """(resolved (index, value) pairs, intercept values that need a slot).
        Without an IndexMap the intercept key has no stored index: it takes
        ``intercept_slot``, set below once the synthetic indices are known."""
        pairs: list[tuple[int, float]] = []
        intercept_values: list[float] = []
        for r in recs:
            if index_map is None and r["name"] == INTERCEPT_KEY:
                intercept_values.append(r["value"])
            else:
                pairs.append((base_index(r["name"], r["term"]), r["value"]))
        return [(i, v) for i, v in pairs if i >= 0], intercept_values  # unknown features dropped

    mean_pairs, mean_icept = resolve(record["means"])
    # one intercept slot for the record (means AND variances): the last
    # column when the width is known, else one past the largest mean index
    if num_features is not None:
        intercept_slot = num_features - 1
    else:
        intercept_slot = max((i for i, _ in mean_pairs), default=-1) + 1
    mean_pairs += [(intercept_slot, v) for v in mean_icept]
    d = num_features
    if d is None:
        d = (max(i for i, _ in mean_pairs) + 1) if mean_pairs else 0
        if index_map is not None:
            d = index_map.size
    means = np.zeros((d,), np.float32)
    for i, v in mean_pairs:
        means[i] = v
    variances = None
    if record.get("variances"):
        var_pairs, var_icept = resolve(record["variances"])
        var_pairs += [(intercept_slot, v) for v in var_icept]
        variances = np.zeros((d,), np.float32)
        for i, v in var_pairs:
            if i < d:
                variances[i] = v
    return means, variances


# ---------------------------------------------------------------------------
# one GLM
# ---------------------------------------------------------------------------
def save_glm(
    model: GeneralizedLinearModel,
    path: str,
    index_map: IndexMap | None = None,
    model_id: str = "global",
    sparsity_threshold: float = 0.0,
) -> None:
    c = model.coefficients
    rec = _coefficients_to_record(
        model_id, _host(c.means), _host(c.variances), _index_to_key(index_map, c.dim),
        model.task_type, sparsity_threshold,
    )
    write_avro_file(path, BAYESIAN_LINEAR_MODEL_SCHEMA, [rec])


def load_glm(
    path: str,
    index_map: IndexMap | None = None,
    num_features: int | None = None,
    task: TaskType | None = None,
    device=None,
) -> GeneralizedLinearModel:
    """The model of ``path`` on ``device`` (CUDA unless the caller asks for
    another; raises without it)."""
    dev = resolve_device(device)
    _, records = read_avro_file(path)
    if len(records) != 1:
        raise ValueError(f"{path}: expected one model record, found {len(records)}")
    rec = records[0]
    means, variances = _record_to_coefficients(rec, index_map, num_features)
    task = task or TaskType(rec.get("lossFunction") or "LOGISTIC_REGRESSION")
    return GeneralizedLinearModel(_coefficients_on(means, variances, dev), task)


def _coefficients_on(means: np.ndarray, variances: np.ndarray | None, dev) -> Coefficients:
    return Coefficients(
        torch.from_numpy(means).to(dev),
        None if variances is None else torch.from_numpy(variances).to(dev),
    )


# ---------------------------------------------------------------------------
# GAME models
# ---------------------------------------------------------------------------
def save_game_model(
    model: GameModel,
    directory: str,
    index_maps: Mapping[str, IndexMap] | None = None,
    entity_names: Mapping[str, Sequence[str]] | None = None,
    sparsity_threshold: float = 0.0,
    records_per_part: int = 100_000,
) -> None:
    """Write a GameModel to ``directory``.

    ``index_maps``: feature-shard id → IndexMap (real feature names).
    ``entity_names``: coordinate id → dense entity id → original entity
    string (default: the dense id's decimal string)."""
    index_maps = index_maps or {}
    entity_names = entity_names or {}
    meta: dict = {"task_type": model.task_type.value, "coordinates": {}}
    for cid, sub in model.models.items():
        if isinstance(sub, FixedEffectModel):
            c = sub.model.coefficients
            keys = _index_to_key(index_maps.get(sub.feature_shard_id), c.dim)
            rec = _coefficients_to_record(
                cid, _host(c.means), _host(c.variances), keys, model.task_type, sparsity_threshold
            )
            out = os.path.join(directory, "fixed-effect", cid, "coefficients", "part-00000.avro")
            write_avro_file(out, BAYESIAN_LINEAR_MODEL_SCHEMA, [rec])
            meta["coordinates"][cid] = {
                "type": "fixed",
                "feature_shard_id": sub.feature_shard_id,
                "dim": int(c.dim),
            }
        elif isinstance(sub, RandomEffectModel):
            W, V = _host(sub.coefficients), _host(sub.variances)
            keys = _index_to_key(index_maps.get(sub.feature_shard_id), W.shape[1])
            names = entity_names.get(cid)
            out_dir = os.path.join(directory, "random-effect", cid, "coefficients")
            os.makedirs(out_dir, exist_ok=True)
            starts = range(0, W.shape[0], records_per_part)
            for part, lo in enumerate(starts or [0]):
                write_avro_file(
                    os.path.join(out_dir, f"part-{part:05d}.avro"),
                    BAYESIAN_LINEAR_MODEL_SCHEMA,
                    (
                        _coefficients_to_record(
                            names[e] if names is not None else str(e), W[e],
                            None if V is None else V[e], keys, model.task_type,
                            sparsity_threshold,
                        )
                        for e in range(lo, min(lo + records_per_part, W.shape[0]))
                    ),
                )
            if W.shape[0] and W.shape[0] % records_per_part == 0:
                # the reference closes with an empty part after a full one
                write_avro_file(
                    os.path.join(out_dir, f"part-{len(starts):05d}.avro"),
                    BAYESIAN_LINEAR_MODEL_SCHEMA, [],
                )
            meta["coordinates"][cid] = {
                "type": "random",
                "feature_shard_id": sub.feature_shard_id,
                "random_effect_type": sub.random_effect_type,
                "num_entities": int(W.shape[0]),
                "dim": int(W.shape[1]),
                "has_variances": V is not None,
            }
        else:  # pragma: no cover
            raise TypeError(f"unknown sub-model type {type(sub)}")
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)


def model_fingerprint(model: GameModel) -> str:
    """sha256 over the model's structure and coefficient bytes (means and
    variances, coordinates in sorted order): equal iff a scorer computes
    identical scores from the two models. The same string as the
    reference's for the same float32 coefficients."""
    h = hashlib.sha256()
    h.update(model.task_type.value.encode())

    def add(t: torch.Tensor | None) -> None:
        if t is not None:
            h.update(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes())

    for cid in sorted(model.models):
        sub = model.models[cid]
        if isinstance(sub, FixedEffectModel):
            h.update(f"|fixed:{cid}:{sub.feature_shard_id}".encode())
            add(sub.model.coefficients.means)
            add(sub.model.coefficients.variances)
        elif isinstance(sub, RandomEffectModel):
            h.update(f"|random:{cid}:{sub.feature_shard_id}:{sub.random_effect_type}".encode())
            add(sub.coefficients)
            add(sub.variances)
    return h.hexdigest()


MODEL_MANIFEST = "MANIFEST.json"
MANIFEST_SCHEMA_VERSION = 1


def publish_game_model(
    model: GameModel,
    root: str,
    index_maps: Mapping[str, IndexMap] | None = None,
    entity_names: Mapping[str, Sequence[str]] | None = None,
    sparsity_threshold: float = 0.0,
) -> str:
    """Write ``model`` as the next snapshot under ``root``, then commit the
    manifest pointer atomically. Returns the snapshot directory. A crash at
    any point leaves the manifest on a complete snapshot; a snapshot
    directory left by a crash before the commit is inert, and the next
    publish writes over it."""
    from photon_ml_tpu_torch.utils.atomic_io import atomic_replace_bytes

    manifest = read_model_manifest(root)
    seq = int(manifest["seq"]) + 1 if manifest else 1
    rel = os.path.join("snapshots", f"snap-{seq:06d}")
    snap_dir = os.path.join(root, rel)
    save_game_model(model, snap_dir, index_maps=index_maps, entity_names=entity_names,
                    sparsity_threshold=sparsity_threshold)
    doc = {
        "schema_version": MANIFEST_SCHEMA_VERSION,
        "seq": seq,
        "snapshot": rel,
        "fingerprint": model_fingerprint(model),
        "task_type": model.task_type.value,
    }
    atomic_replace_bytes(root, os.path.join(root, MODEL_MANIFEST), (json.dumps(doc, indent=2) + "\n").encode())
    return snap_dir


def read_model_manifest(root: str) -> dict | None:
    """The manifest under ``root``, or None when nothing is published. A
    manifest of a later schema than this reader's raises ``ValueError``."""
    path = os.path.join(root, MODEL_MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        doc = json.load(f)
    version = int(doc.get("schema_version", 0))
    if version > MANIFEST_SCHEMA_VERSION:
        raise ValueError(
            f"{path}: manifest schema v{version} is newer than this reader (v{MANIFEST_SCHEMA_VERSION})"
        )
    return doc


def peek_published_fingerprint(root: str) -> str | None:
    """The published snapshot's fingerprint, read from the manifest alone
    (no model array is loaded): the server's hot-swap poll."""
    manifest = read_model_manifest(root)
    return manifest.get("fingerprint") if manifest else None


def load_published_model(
    root: str,
    index_maps: Mapping[str, IndexMap] | None = None,
    entity_ids: Mapping[str, Mapping[str, int]] | None = None,
    device=None,
) -> tuple[GameModel, dict]:
    """``(model, manifest)`` of the snapshot the manifest names, on
    ``device`` (CUDA unless the caller asks for another). Raises
    ``FileNotFoundError`` when nothing is published."""
    manifest = read_model_manifest(root)
    if manifest is None:
        raise FileNotFoundError(f"{os.path.join(root, MODEL_MANIFEST)}: no published model")
    model = load_game_model(os.path.join(root, manifest["snapshot"]), index_maps=index_maps,
                            entity_ids=entity_ids, device=device)
    return model, manifest


def load_game_model(
    directory: str,
    index_maps: Mapping[str, IndexMap] | None = None,
    entity_ids: Mapping[str, Mapping[str, int]] | None = None,
    device=None,
) -> GameModel:
    """A GameModel written by ``save_game_model`` (either package's), on
    ``device`` (CUDA unless the caller asks for another; raises without it).
    ``entity_ids`` maps coordinate id → original entity string → dense id;
    without it ``modelId`` is parsed as the dense id. A coordinate's width
    comes from the current index map when given (a warm start onto data
    whose feature space grew), else from the saved dim."""
    dev = resolve_device(device)
    index_maps = index_maps or {}
    entity_ids = entity_ids or {}
    with open(os.path.join(directory, "metadata.json")) as f:
        meta = json.load(f)
    task = TaskType(meta["task_type"])
    models: dict = {}
    for cid, info in meta["coordinates"].items():
        imap = index_maps.get(info["feature_shard_id"])
        dim = imap.size if imap is not None else info["dim"]
        lookup = None if imap is None else dict(imap.items())
        if info["type"] == "fixed":
            path = os.path.join(directory, "fixed-effect", cid, "coefficients", "part-00000.avro")
            _, records = read_avro_file(path)
            means, variances = _record_to_coefficients(records[0], imap, dim, lookup)
            models[cid] = FixedEffectModel(
                model=GeneralizedLinearModel(_coefficients_on(means, variances, dev), task),
                feature_shard_id=info["feature_shard_id"],
            )
            continue
        W = np.zeros((info["num_entities"], dim), np.float32)
        V = np.zeros_like(W) if info.get("has_variances") else None
        id_map = entity_ids.get(cid)
        for rec in iter_avro_directory(os.path.join(directory, "random-effect", cid, "coefficients")):
            e = id_map[rec["modelId"]] if id_map is not None else int(rec["modelId"])
            W[e], var = _record_to_coefficients(rec, imap, dim, lookup)
            if V is not None and var is not None:
                V[e] = var
        models[cid] = RandomEffectModel(
            coefficients=torch.from_numpy(W).to(dev),
            variances=None if V is None else torch.from_numpy(V).to(dev),
            random_effect_type=info["random_effect_type"],
            feature_shard_id=info["feature_shard_id"],
            task_type=task,
        )
    return GameModel(models=models, task_type=task)
