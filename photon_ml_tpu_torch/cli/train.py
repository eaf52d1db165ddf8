"""GAME training driver (port of ``photon_ml_tpu/cli/train.py`` on its
in-memory path; the reference's ``GameTrainingDriver``).

Stages: read the training data (with the native columnar decoder, as the
reference does by default) and build the feature and entity maps (or load
prebuilt index maps), read the validation data against the frozen maps,
load the warm-start model, fit the estimator's grid with a checkpoint per
grid entry under ``<output>/checkpoints`` (a rerun resumes), run the
Bayesian hyperparameter search when ``hyperparameter_tuning_iters`` > 0,
select the best entry, and write ``best/``, ``models/NNNN`` (output mode
ALL), ``index-maps/``, ``entity-maps.json``, ``metrics.json`` and, with
``--diagnostics``, ``diagnostics.json`` and ``diagnostics.html``: the
reference's files, which its scoring driver reads as well as the port's.

Usage:
    python -m photon_ml_tpu_torch.cli.train \\
        --config config.json --train-data data/train \\
        [--validation-data data/val] --output-dir out/ [--device cpu]

Branches not ported yet raise ``NotImplementedError`` naming their ROADMAP
queue 1 item: the out-of-core GAME trainer (``--streaming-chunk-rows`` and
its selection by input size, item 11b), ``--multihost`` (12), ``--telemetry-dir``
and ``--profile-dir`` (13).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.cli.common import load_training_config, not_ported
from photon_ml_tpu_torch.config import GameTrainingConfig
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.diagnostics import game_diagnostics, write_report
from photon_ml_tpu_torch.estimators import GameEstimator, GameResult
from photon_ml_tpu_torch.evaluation import make_evaluator
from photon_ml_tpu_torch.game.models import GameModel, RandomEffectModel
from photon_ml_tpu_torch.hyperparameter.tuning import tune_game_hyperparameters
from photon_ml_tpu_torch.io.avro import list_avro_files
from photon_ml_tpu_torch.io.data_reader import AvroDataReader, GameDataset, expand_date_range
from photon_ml_tpu_torch.io.model_io import load_game_model, save_game_model
from photon_ml_tpu_torch.ops.batch import hbm_budget_bytes
from photon_ml_tpu_torch.types import ModelOutputMode
from photon_ml_tpu_torch.utils import PhotonLogger, timed


def run(
    config: GameTrainingConfig,
    train_data: list[str],
    output_dir: str,
    validation_data: list[str] | None = None,
    index_map_dir: str | None = None,
    logger: PhotonLogger | None = None,
    profile_dir: str | None = None,
    diagnostics: bool = False,
    streaming_chunk_rows: int | None = None,
    multihost: bool = False,
    device=None,
) -> GameResult:
    """Train, select and write; returns the grid's best ``GameResult``.
    Runs on ``device`` (CUDA unless the caller asks for another; raises
    without it)."""
    if streaming_chunk_rows is not None:
        raise not_ported("the out-of-core GAME trainer (--streaming-chunk-rows)", "11b")
    if multihost:
        raise not_ported("multi-host GAME training (--multihost)", "12")
    if profile_dir is not None:
        raise not_ported("device traces (--profile-dir)", "13")
    dev = resolve_device(device)
    logger = logger or PhotonLogger(output_dir)
    id_tags = _game_id_tags(config)
    reader = AvroDataReader(config.feature_shards or None)

    # prebuilt index maps (the indexing driver's output), else built from the data
    prebuilt = None
    if index_map_dir:
        prebuilt = {
            fn[:-4]: IndexMap.load(os.path.join(index_map_dir, fn))
            for fn in os.listdir(index_map_dir)
            if fn.endswith(".npz")
        }
        logger.info(f"loaded index maps: { {s: m.size for s, m in prebuilt.items()} }")

    # warm start: the saved run's entity maps keep the saved model's dense
    # entity rows valid; new entities get ids after them
    warm_tag_maps = _load_entity_maps(config.model_input_dir) if config.model_input_dir else None
    with timed(logger, "read training data"):
        train = reader.read(
            train_data, id_tags=id_tags, index_maps=prebuilt, entity_maps=warm_tag_maps,
            extend_entities=warm_tag_maps is not None, device=dev,
        )
        logger.info(
            f"train: {train.batch.num_rows} rows, shards "
            f"{ {s: m.size for s, m in train.index_maps.items()} }"
        )

    val: GameDataset | None = None
    if validation_data:
        with timed(logger, "read validation data"):
            val = reader.read(
                validation_data, id_tags=id_tags, index_maps=train.index_maps,
                entity_maps=train.entity_maps, device=dev,
            )

    initial_model = None
    if config.model_input_dir:
        with timed(logger, "load warm-start model"):
            entity_ids = None
            if warm_tag_maps:
                # entity-maps.json is keyed by id tag; the loader takes
                # coordinate id → (entity string → dense id)
                entity_ids = {
                    cid: warm_tag_maps[c.random_effect_type]
                    for cid, c in config.random_effect_coordinates.items()
                    if c.random_effect_type in warm_tag_maps
                }
            initial_model = load_game_model(
                config.model_input_dir, index_maps=train.index_maps, entity_ids=entity_ids,
                device=dev,
            )
            initial_model = _pad_random_effects(initial_model, train, config)

    estimator = GameEstimator(
        config, intercept_indices=train.intercept_indices, logger=logger, device=dev
    )
    with timed(logger, "estimator grid fit"):
        results = estimator.fit(
            train.batch,
            None if val is None else val.batch,
            initial_model=initial_model,
            checkpoint_dir=os.path.join(output_dir, "checkpoints"),
        )

    if config.hyperparameter_tuning_iters > 0:
        if val is None:
            raise ValueError("hyperparameter tuning requires validation data")
        with timed(logger, "hyperparameter tuning"):
            results = list(results) + tune_game_hyperparameters(
                estimator, train.batch, val.batch, results, config.hyperparameter_tuning_iters,
            )

    best = estimator.select_best(results)
    logger.info(
        "selected configuration: "
        f"{ {c: o.regularization_weight for c, o in best.configuration.items()} }"
    )
    with timed(logger, "write models"):
        entity_names = train.entity_names()
        by_cid = {
            cid: entity_names[cfg.random_effect_type]
            for cid, cfg in config.random_effect_coordinates.items()
        }
        save_game_model(
            best.model, os.path.join(output_dir, "best"), index_maps=train.index_maps,
            entity_names=by_cid,
        )
        if config.output_mode is ModelOutputMode.ALL:
            for i, r in enumerate(results):
                save_game_model(
                    r.model, os.path.join(output_dir, "models", f"{i:04d}"),
                    index_maps=train.index_maps, entity_names=by_cid,
                )
        _save_maps(output_dir, train)

    metrics = {
        "results": [
            {
                "configuration": {cid: opt.to_dict() for cid, opt in r.configuration.items()},
                "metrics": dict(r.evaluation.metrics) if r.evaluation else None,
            }
            for r in results
        ],
        # identity, not ==: a GameResult holds tensors
        "best_index": next(i for i, r in enumerate(results) if r is best),
    }
    with open(os.path.join(output_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    if diagnostics:
        with timed(logger, "write diagnostics"):
            write_report(game_diagnostics(results, config=config, index_maps=train.index_maps), output_dir)
    return best


def _game_id_tags(config: GameTrainingConfig) -> tuple[str, ...]:
    """The id-tag columns the records must carry: every random-effect type
    and every grouped evaluator's group-by tag (a grouped evaluator may
    group on a tag no coordinate uses; its entity map is saved too)."""
    tags = [c.random_effect_type for c in config.random_effect_coordinates.values()]
    for spec in config.evaluators:
        gb = make_evaluator(spec).group_by
        if gb is not None:
            tags.append(gb)
    return tuple(dict.fromkeys(tags))


def _expand_part_files(paths: list[str]) -> list[str]:
    """Directories become their sorted ``*.avro`` part files (the readers'
    ``list_avro_files`` policy)."""
    return [f for p in paths for f in list_avro_files(p)]


def _input_exceeds_device(train_data: list[str], dev: torch.device) -> bool:
    """The reference's rule for selecting its out-of-core trainer: the raw
    input bytes exceed the device's memory budget (Avro is more compact than
    the decoded float32 columns, so such an input cannot fit)."""
    try:
        total = sum(os.path.getsize(f) for f in _expand_part_files(train_data))
    except OSError:
        return False  # the reader reports a missing input
    return total > hbm_budget_bytes(dev)


def _pad_random_effects(model: GameModel, train: GameDataset, config: GameTrainingConfig) -> GameModel:
    """Grow each warm-start random-effect matrix to the current entity count;
    new entities start from zero rows, as in the reference."""
    for cid, c in config.random_effect_coordinates.items():
        sub = model.models.get(cid)
        if not isinstance(sub, RandomEffectModel):
            continue
        pad = len(train.entity_maps[c.random_effect_type]) - sub.num_entities
        if pad > 0:
            def grown(t):
                return None if t is None else torch.cat([t, t.new_zeros((pad, t.shape[1]))])

            model = model.updated(
                cid, dataclasses.replace(sub, coefficients=grown(sub.coefficients),
                                         variances=grown(sub.variances)),
            )
    return model


def _save_maps(output_dir: str, ds: GameDataset) -> None:
    """The ingest dictionaries beside the model, so scoring and warm starts
    line columns and entities up."""
    for sid, imap in ds.index_maps.items():
        imap.save(os.path.join(output_dir, "index-maps", sid))
    with open(os.path.join(output_dir, "entity-maps.json"), "w") as f:
        json.dump(ds.entity_maps, f)


def _load_entity_maps(model_dir: str) -> dict | None:
    """``entity-maps.json`` in the model directory or one level above it
    (where ``run`` writes it, beside ``best/``)."""
    for candidate in (
        os.path.join(model_dir, "entity-maps.json"),
        os.path.join(os.path.dirname(model_dir.rstrip("/")), "entity-maps.json"),
    ):
        if os.path.exists(candidate):
            with open(candidate) as f:
                return json.load(f)
    return None


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GAME training driver (PyTorch/CUDA port)")
    p.add_argument("--config", required=True, help="GameTrainingConfig JSON file")
    p.add_argument("--train-data", required=True, nargs="+")
    p.add_argument(
        "--train-date-range", nargs=2, metavar=("START", "END"), default=None,
        help="expand each --train-data base path into its daily subdirectories for the "
             "inclusive YYYY-MM-DD range (base/daily/YYYY/MM/DD or base/YYYY-MM-DD layouts)",
    )
    p.add_argument("--validation-data", nargs="*", default=None)
    p.add_argument(
        "--validation-date-range", nargs=2, metavar=("START", "END"), default=None,
        help="like --train-date-range, for --validation-data",
    )
    p.add_argument("--index-maps", default=None, help="prebuilt index maps (directory of .npz)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-host training (ROADMAP queue 1 item 12; raises)")
    p.add_argument("--streaming-chunk-rows", type=int, default=None,
                   help="the out-of-core GAME trainer (ROADMAP queue 1 item 11b; raises)")
    p.add_argument(
        "--no-auto-streaming", action="store_true",
        help="train in memory even when the input exceeds the device's memory budget "
             "(without it such an input selects the out-of-core trainer, which raises)",
    )
    p.add_argument("--profile-dir", default=None,
                   help="device traces (ROADMAP queue 1 item 13; raises)")
    p.add_argument("--telemetry-dir", default=None,
                   help="the run's telemetry JSONL (ROADMAP queue 1 item 13; raises)")
    p.add_argument("--diagnostics", action="store_true",
                   help="write diagnostics.json and diagnostics.html beside the models")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--output-dir", required=True)
    return p


def main(argv: list[str] | None = None) -> None:
    args = _parser().parse_args(argv)
    if args.telemetry_dir is not None:
        raise not_ported("run telemetry (--telemetry-dir)", "13")
    config = load_training_config(args.config)
    train_data, validation_data = args.train_data, args.validation_data
    if args.train_date_range:
        train_data = [d for base in train_data for d in expand_date_range(base, *args.train_date_range)]
    if args.validation_date_range:
        if not validation_data:
            raise SystemExit("--validation-date-range requires --validation-data base paths")
        validation_data = [
            d for base in validation_data for d in expand_date_range(base, *args.validation_date_range)
        ]
    dev = resolve_device(args.device)
    if (
        args.streaming_chunk_rows is None
        and not args.no_auto_streaming
        and _input_exceeds_device(train_data, dev)
    ):
        raise not_ported(
            "the input exceeds the device's memory budget; the out-of-core trainer it "
            "selects (pass --no-auto-streaming to train in memory)", "11b",
        )
    run(
        config, train_data, args.output_dir, validation_data=validation_data,
        index_map_dir=args.index_maps, profile_dir=args.profile_dir,
        diagnostics=args.diagnostics, streaming_chunk_rows=args.streaming_chunk_rows,
        multihost=args.multihost, device=dev,
    )


if __name__ == "__main__":
    main()
