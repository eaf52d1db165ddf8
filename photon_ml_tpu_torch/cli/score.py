"""GAME scoring driver (port of ``photon_ml_tpu/cli/score.py``; the
reference's ``GameScoringDriver``).

Loads a trained model (``best/`` of a training output directory, with its
``index-maps/`` and ``entity-maps.json``), reads the data against those
frozen maps, scores it through ``GameTransformer``, and writes
``scores/part-00000.avro`` (``ScoringResultAvro``) and, given evaluators,
``metrics.json``. It scores either package's training output.

``--multihost``: scoring is independent per row, so each process scores
its round-robin slice of the part files (``host_shard_of_paths``) and
writes ``scores/part-{rank:05d}.avro``. Scalar metrics come from one
gather of every process's (score, label, weight) rows, evaluated the
same on every process; a grouped metric sends each row to its entity's
owner (dense id mod P, through ``exchange_rows``), which sums its
complete groups' partials, and one (sum, count) allreduce finishes it.
Process 0 writes ``metrics.json``; a barrier closes the run.

Usage:
    python -m photon_ml_tpu_torch.cli.score \\
        --model-dir out/ --data data/test --output-dir scores/ \\
        [--evaluators AUC "MULTI_AUC(userId)"] [--config config.json] [--device cpu] \\
        [--multihost]

``--telemetry-dir DIR`` writes the run's telemetry JSONL into ``DIR``
(``obs``; the span ``score/pass``); ``--profile-dir DIR`` traces the
scoring pass with ``torch.profiler`` into ``DIR/score/``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.cli.common import load_training_config
from photon_ml_tpu_torch.config import FeatureShardConfig
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.evaluation import (
    evaluate_all,
    grouped_auc_parts,
    grouped_precision_at_k_parts,
    make_evaluator,
)
from photon_ml_tpu_torch.game.models import RandomEffectModel
from photon_ml_tpu_torch.io.avro import list_avro_files
from photon_ml_tpu_torch.io.data_reader import AvroDataReader
from photon_ml_tpu_torch.io.model_io import load_game_model
from photon_ml_tpu_torch.io.results import write_scoring_results
from photon_ml_tpu_torch.parallel.multihost import (
    allgather_rows,
    allreduce_sum_host,
    exchange_rows,
    host_shard_of_paths,
    initialize_multihost,
    is_output_process,
    process_count,
    process_index,
    require_process_group,
    shutdown_multihost,
    sync_processes,
)
from photon_ml_tpu_torch.transformers import GameTransformer
from photon_ml_tpu_torch.utils import PhotonLogger, profile_trace, timed


def run(
    model_dir: str,
    data: list[str],
    output_dir: str,
    evaluators: list[str] | None = None,
    feature_shards: dict[str, FeatureShardConfig] | None = None,
    logger: PhotonLogger | None = None,
    profile_dir: str | None = None,
    multihost: bool = False,
    device=None,
):
    """Score ``data`` with the model of ``model_dir`` (a training output
    directory holding ``best/``, or a bare model directory with the maps one
    level above it) on ``device`` (CUDA unless the caller asks for another;
    raises without it). Returns (scores, metrics or None); under
    ``multihost`` the scores are this process's rows and the metrics the
    global ones (module docstring). ``profile_dir`` traces the scoring
    pass (``utils/profiling.profile_trace``)."""
    dev = resolve_device(device)
    part_index = 0
    if multihost:
        require_process_group()
        # one process owns the shared log file; the rest log to stderr
        logger = logger or PhotonLogger(output_dir if is_output_process() else None)
        files = [f for p_ in data for f in list_avro_files(p_)]
        data = host_shard_of_paths(files)
        part_index = process_index()
        logger.info(f"multihost scoring: this process scores {len(data)}/{len(files)} files")
    logger = logger or PhotonLogger(output_dir)

    best_dir = os.path.join(model_dir, "best")
    if os.path.isdir(best_dir):
        game_dir, maps_root = best_dir, model_dir
    else:
        game_dir, maps_root = model_dir, os.path.dirname(model_dir.rstrip("/"))

    with timed(logger, "load model + maps"):
        index_maps = {}
        imap_dir = os.path.join(maps_root, "index-maps")
        if os.path.isdir(imap_dir):
            for fn in os.listdir(imap_dir):
                if fn.endswith(".npz"):
                    index_maps[fn[:-4]] = IndexMap.load(os.path.join(imap_dir, fn))
        entity_maps = {}
        em_path = os.path.join(maps_root, "entity-maps.json")
        if os.path.exists(em_path):
            with open(em_path) as f:
                entity_maps = json.load(f)
        entity_ids = None
        if entity_maps:
            entity_ids = {
                cid: entity_maps[retype]
                for cid, retype in _random_effects(game_dir).items()
                if retype in entity_maps
            }
        model = load_game_model(game_dir, index_maps=index_maps, entity_ids=entity_ids, device=dev)

    id_tags = tuple(
        sub.random_effect_type for sub in model.models.values() if isinstance(sub, RandomEffectModel)
    )
    if evaluators:
        # a grouped evaluator groups on any id tag of the records, not only
        # the model's random-effect types: the reader extracts those too
        eval_tags = [make_evaluator(s).group_by for s in evaluators if make_evaluator(s).group_by]
        id_tags = tuple(dict.fromkeys([*id_tags, *eval_tags]))
        missing = [t for t in eval_tags if t not in entity_maps]
        if missing and (multihost or entity_maps):
            # across processes each reader's own dictionary would disagree;
            # with other frozen maps present the reader would freeze the
            # missing tag to an empty map (every id -1) and evaluate nothing
            raise ValueError(
                f"grouped evaluators need the id tags in the training-saved "
                f"entity-maps.json; missing: {missing} (declare the evaluator at "
                f"training time so its tag's entity map is extracted and saved)"
            )
    ds = None
    # only a process of a group may hold no part file
    if data or not multihost:
        with timed(logger, "read scoring data"):
            ds = AvroDataReader(feature_shards).read(
                data,
                id_tags=id_tags,
                index_maps=index_maps or None,
                entity_maps={t: entity_maps[t] for t in id_tags} if entity_maps else None,
                device=dev,
            )

    transformer = GameTransformer(model, logger=logger, device=dev)
    metrics = None
    with timed(logger, "score"), profile_trace(profile_dir, "score"), obs.span("score/pass"):
        if evaluators and not multihost:
            scores, results = transformer.transform_with_evaluation(ds.batch, evaluators)
            metrics = dict(results.metrics)
        elif ds is not None:
            scores = transformer.transform(ds.batch)
        else:
            scores = torch.zeros(0, device=dev)
        if evaluators and multihost:
            metrics = _metrics_multihost(evaluators, scores, ds, dev)
            logger.info(f"scoring evaluation (global): {metrics}")

    with timed(logger, "write scores"):
        if ds is not None:
            write_scoring_results(
                os.path.join(output_dir, "scores", f"part-{part_index:05d}.avro"), scores, uids=ds.uids,
                labels=ds.labels,
            )
        if metrics is not None and is_output_process():
            with open(os.path.join(output_dir, "metrics.json"), "w") as f:
                json.dump(metrics, f, indent=2)
    if multihost:
        sync_processes("score-outputs-written")
    return scores, metrics


def _metrics_multihost(specs: list[str], scores, ds, dev) -> dict:
    """Every evaluator over every process's rows (a collective: every
    process calls it with the same specs; one with no rows takes part)."""
    def host(t) -> np.ndarray:
        return t.detach().cpu().numpy().astype(np.float32)

    s = host(scores)
    if ds is None:
        y = w = np.zeros(0, np.float32)
        tags = {}
    else:
        y, w = host(ds.batch.labels), host(ds.batch.weights)
        tags = {t: v.detach().cpu().numpy() for t, v in ds.batch.id_tags.items()}
    scalar = [e for e in specs if make_evaluator(e).group_by is None]
    grouped = [e for e in specs if make_evaluator(e).group_by is not None]
    out: dict = {}
    if scalar:
        out.update(_global_metrics_multihost(scalar, s, y, w, dev))
    if grouped:
        out.update(_grouped_metrics_multihost(grouped, s, y, tags))
    names = [make_evaluator(e).name for e in specs]
    return {name: out[name] for name in names}


def _global_metrics_multihost(specs: list[str], scores: np.ndarray, labels: np.ndarray,
                              weights: np.ndarray, dev) -> dict:
    """Scalar metrics over every process's rows: one gather of (score,
    label, weight) in rank order, evaluated the same on every process."""
    s, y, w = allgather_rows(scores, labels, weights)
    results = evaluate_all(specs, *(torch.from_numpy(a).to(dev) for a in (s, y, w)))
    return dict(results.metrics)


def _grouped_metrics_multihost(specs: list[str], scores: np.ndarray, labels: np.ndarray,
                               id_tags: dict[str, np.ndarray]) -> dict:
    """Grouped metrics over every process's rows: one exchange per id tag
    sends each row's (score, label, entity id) to the entity's owner
    (dense id mod P; unseen entities, id -1, stay out), each owner sums the
    partials of its complete groups, and one (sum, count) allreduce per
    metric finishes it. No process gathers the whole score column."""
    p = max(process_count(), 1)
    routed: dict[str, tuple] = {}
    out: dict = {}
    for spec in specs:
        ev = make_evaluator(spec)
        tag = ev.group_by
        if tag not in routed:
            gids = np.asarray(id_tags.get(tag, np.zeros(0, np.int64)), np.int64)
            keep = np.flatnonzero(gids >= 0)
            recv = exchange_rows({"gid": gids[keep], "score": scores[keep], "label": labels[keep]},
                                 gids[keep] % p, tag=f"grouped-metrics:{tag}")
            routed[tag] = (recv["score"], recv["label"], recv["gid"])
        s, y, g = routed[tag]
        part = grouped_precision_at_k_parts(s, y, g, ev.k) if ev.k is not None else grouped_auc_parts(s, y, g)
        total = allreduce_sum_host(np.asarray(part, np.float64))
        out[ev.name] = float(total[0] / total[1]) if total[1] > 0 else float("nan")
    return out


def _random_effects(game_dir: str) -> dict:
    """cid → random_effect_type, from the model's metadata."""
    with open(os.path.join(game_dir, "metadata.json")) as f:
        meta = json.load(f)
    return {
        cid: info["random_effect_type"]
        for cid, info in meta["coordinates"].items()
        if info["type"] == "random"
    }


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="GAME scoring driver (PyTorch/CUDA port)")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--data", required=True, nargs="+")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--evaluators", nargs="*", default=None)
    p.add_argument("--config", default=None, help="training config JSON (for feature shards)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (CPU and CUDA) of the scoring pass into this directory")
    p.add_argument("--telemetry-dir", default=None,
                   help="write the run's telemetry JSONL into this directory; read it with the "
                        "reference's photon-ml-tpu report")
    p.add_argument("--multihost", action="store_true",
                   help="score across processes: run the same command in each with "
                        "JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID set; each "
                        "scores its slice of the part files and writes its own scores part")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    shards = dict(load_training_config(args.config).feature_shards) if args.config else None
    if args.multihost:
        initialize_multihost()
    try:
        # after the process group is up: process 0 writes (every process
        # its shard under PHOTON_TELEMETRY_FLEET=1)
        obs.configure(args.telemetry_dir)
        try:
            run(
                args.model_dir, args.data, args.output_dir, evaluators=args.evaluators,
                feature_shards=shards, profile_dir=args.profile_dir,
                multihost=args.multihost, device=args.device,
            )
        finally:
            obs.shutdown()
    finally:
        shutdown_multihost()


if __name__ == "__main__":
    main()
