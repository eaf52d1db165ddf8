"""GAME scoring driver (port of ``photon_ml_tpu/cli/score.py`` on one host;
the reference's ``GameScoringDriver``).

Loads a trained model (``best/`` of a training output directory, with its
``index-maps/`` and ``entity-maps.json``), reads the data against those
frozen maps, scores it through ``GameTransformer``, and writes
``scores/part-00000.avro`` (``ScoringResultAvro``) and, given evaluators,
``metrics.json``. It scores either package's training output.

Usage:
    python -m photon_ml_tpu_torch.cli.score \\
        --model-dir out/ --data data/test --output-dir scores/ \\
        [--evaluators AUC "MULTI_AUC(userId)"] [--config config.json] [--device cpu]

``--multihost`` (ROADMAP queue 1 item 12b) and ``--profile-dir`` /
``--telemetry-dir`` (item 13) raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import os

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.cli.common import load_training_config, not_ported
from photon_ml_tpu_torch.config import FeatureShardConfig
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.evaluation import make_evaluator
from photon_ml_tpu_torch.game.models import RandomEffectModel
from photon_ml_tpu_torch.io.data_reader import AvroDataReader
from photon_ml_tpu_torch.io.model_io import load_game_model
from photon_ml_tpu_torch.io.results import write_scoring_results
from photon_ml_tpu_torch.transformers import GameTransformer
from photon_ml_tpu_torch.utils import PhotonLogger, timed


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
    raises without it). Returns (scores, metrics or None)."""
    if multihost:
        raise not_ported("multi-host scoring (--multihost)", "12b")
    if profile_dir is not None:
        raise not_ported("device traces (--profile-dir)", "13")
    dev = resolve_device(device)
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
        if missing and entity_maps:
            # with other frozen maps present the reader would freeze the
            # missing tag to an empty map (every id -1) and evaluate nothing
            raise ValueError(
                f"grouped evaluators need the id tags in the training-saved "
                f"entity-maps.json; missing: {missing} (declare the evaluator at "
                f"training time so its tag's entity map is extracted and saved)"
            )
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
    with timed(logger, "score"):
        if evaluators:
            scores, results = transformer.transform_with_evaluation(ds.batch, evaluators)
            metrics = dict(results.metrics)
        else:
            scores = transformer.transform(ds.batch)

    with timed(logger, "write scores"):
        write_scoring_results(
            os.path.join(output_dir, "scores", "part-00000.avro"), scores, uids=ds.uids,
            labels=ds.labels,
        )
        if metrics is not None:
            with open(os.path.join(output_dir, "metrics.json"), "w") as f:
                json.dump(metrics, f, indent=2)
    return scores, metrics


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
                   help="a device trace of the scoring pass (ROADMAP queue 1 item 13; raises)")
    p.add_argument("--telemetry-dir", default=None,
                   help="the run's telemetry JSONL (ROADMAP queue 1 item 13; raises)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-host scoring (ROADMAP queue 1 item 12b; raises)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.telemetry_dir is not None:
        raise not_ported("run telemetry (--telemetry-dir)", "13")
    shards = dict(load_training_config(args.config).feature_shards) if args.config else None
    run(
        args.model_dir, args.data, args.output_dir, evaluators=args.evaluators,
        feature_shards=shards, profile_dir=args.profile_dir,
        multihost=args.multihost, device=args.device,
    )


if __name__ == "__main__":
    main()
