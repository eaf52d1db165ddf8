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

``--streaming-chunk-rows N`` (chosen by itself, at 2^20 rows, when the
input's bytes exceed the card's memory budget) trains out of core
(``game/streaming.py``): a statistics pass over every file builds the
index and entity maps, the rows are read into host memory, and each grid
or tuning entry is one streamed descent with its checkpoints under
``checkpoints/<entry>`` (only the best entry's model is kept). It writes
``best/``, ``index-maps/``, ``entity-maps.json`` and a ``metrics.json``
that a resumed run merges with the interrupted one's, as the reference's
streamed branch does.

``--multihost`` trains across processes, as the reference does. In
memory, every process reads every file (replicated ingest: the feature
and entity dictionaries need the global view) into host memory and the
estimator runs over the process-spanning data mesh (one shard per local
card, or one on ``--device cpu``). Out of core, the statistics pass reads
every file on every process (so the dictionaries agree), each process
fills only its round-robin slice of the part files (none, when there are
fewer files than processes) and the streamed trainer partitions the rows
over the processes, with per-process score files in the checkpoints.
Process 0 alone writes the log file and every output; the others log to
stderr. Run the same command in each process with
``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID`` set (the reference's variables).

Usage:
    python -m photon_ml_tpu_torch.cli.train \\
        --config config.json --train-data data/train \\
        [--validation-data data/val] --output-dir out/ [--device cpu] \\
        [--streaming-chunk-rows 1048576] [--multihost]

``--telemetry-dir DIR`` writes the run's telemetry JSONL into ``DIR``
(``obs``: spans, optimizer records, the metrics registry; process 0 writes,
or every process its own shard under ``PHOTON_TELEMETRY_FLEET=1``);
``--profile-dir DIR`` traces the fit with ``torch.profiler`` into
``DIR/grid-fit/`` (``DIR/streamed-game/`` out of core).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.cli.common import load_training_config
from photon_ml_tpu_torch.config import GameTrainingConfig
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.diagnostics import game_diagnostics, write_report
from photon_ml_tpu_torch.estimators import GameEstimator, GameResult, build_configuration_grid
from photon_ml_tpu_torch.evaluation import DEFAULT_EVALUATOR_BY_TASK, make_evaluator
from photon_ml_tpu_torch.game.models import GameModel, RandomEffectModel
from photon_ml_tpu_torch.game.streaming import StreamedGameTrainer
from photon_ml_tpu_torch.hyperparameter.tuning import gp_tune_weights, tune_game_hyperparameters
from photon_ml_tpu_torch.io.avro import list_avro_files
from photon_ml_tpu_torch.io.data_reader import AvroDataReader, GameDataset, expand_date_range
from photon_ml_tpu_torch.io.model_io import load_game_model, save_game_model
from photon_ml_tpu_torch.obs import span
from photon_ml_tpu_torch.ops.batch import hbm_budget_bytes
from photon_ml_tpu_torch.parallel.mesh import process_mesh
from photon_ml_tpu_torch.parallel.multihost import (
    host_shard_of_paths,
    initialize_multihost,
    is_output_process,
    require_process_group,
    runtime_summary,
    shutdown_multihost,
    sync_processes,
)
from photon_ml_tpu_torch.types import ModelOutputMode
from photon_ml_tpu_torch.utils import PhotonLogger, profile_trace, timed


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
) -> GameResult | GameModel:
    """Train, select and write; returns the grid's best ``GameResult``, or,
    when ``streaming_chunk_rows`` selects the out-of-core branch, the best
    entry's ``GameModel``. Runs on ``device`` (CUDA unless the caller asks
    for another; raises without it). ``multihost`` trains across the
    process group (module docstring): in memory over ``process_mesh`` (one
    shard on ``device``'s card, or one on every local card for plain
    ``cuda``), out of core over each process's part files. ``profile_dir``
    traces the fit (``utils/profiling.profile_trace``)."""
    dev = resolve_device(device)
    if multihost:
        require_process_group()
    logger = logger or PhotonLogger(output_dir if is_output_process() else None)
    if streaming_chunk_rows is not None:
        return _run_streamed_game(config, train_data, output_dir, validation_data, streaming_chunk_rows,
                                  logger, dev, multihost, profile_dir)
    mesh = process_mesh(devices=None if dev == torch.device("cuda") else [dev]) if multihost else None
    # across processes the replicated batches stay on the host; each
    # process stages its shards on its cards
    read_dev = torch.device("cpu") if multihost else dev
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
    with timed(logger, "read training data"), span("ingest/train-data"):
        train = reader.read(
            train_data, id_tags=id_tags, index_maps=prebuilt, entity_maps=warm_tag_maps,
            extend_entities=warm_tag_maps is not None, device=read_dev,
        )
        logger.info(
            f"train: {train.batch.num_rows} rows, shards "
            f"{ {s: m.size for s, m in train.index_maps.items()} }"
        )

    val: GameDataset | None = None
    if validation_data:
        with timed(logger, "read validation data"), span("ingest/validation-data"):
            val = reader.read(
                validation_data, id_tags=id_tags, index_maps=train.index_maps,
                entity_maps=train.entity_maps, device=read_dev,
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
        config, intercept_indices=train.intercept_indices, logger=logger, device=dev, mesh=mesh
    )
    with timed(logger, "estimator grid fit"), profile_trace(profile_dir, "grid-fit"), span("train/grid-fit"):
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
    # every process computes; process 0 alone writes the shared outputs
    if is_output_process():
        _write_outputs(output_dir, config, train, results, best, diagnostics, logger)
    if multihost:
        sync_processes("train-outputs-written")
    return best


def _write_outputs(output_dir: str, config: GameTrainingConfig, train: GameDataset, results, best,
                   diagnostics: bool, logger: PhotonLogger) -> None:
    """The in-memory branch's files: ``best/``, ``models/NNNN`` (output mode
    ALL), the maps, ``metrics.json`` and the diagnostics."""
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


def _streamed_unsupported(config: GameTrainingConfig) -> list[str]:
    """Configuration features the out-of-core branch rejects (an explicit
    ``--streaming-chunk-rows`` raises on them, and the selection by input
    size keeps such a job in memory); none today, as in the reference."""
    return []


def _config_with_optimizations(config: GameTrainingConfig, configuration: dict) -> GameTrainingConfig:
    """The training configuration with each coordinate's optimization
    replaced by a grid or tuning entry's."""
    def entry(coords):
        return {cid: dataclasses.replace(c, optimization=configuration.get(cid, c.optimization))
                for cid, c in coords.items()}

    return dataclasses.replace(
        config, fixed_effect_coordinates=entry(config.fixed_effect_coordinates),
        random_effect_coordinates=entry(config.random_effect_coordinates),
    )


def _should_auto_stream(train_data: list[str], config: GameTrainingConfig, logger, dev: torch.device,
                        has_validation: bool = True) -> bool:
    """The reference's rule for selecting the out-of-core trainer: the raw
    input bytes of the files the reader will read exceed the card's memory
    budget (Avro is more compact than the decoded float32 columns, so such
    an input cannot fit), unless the configuration is one the streamed
    branch rejects (then it logs why and stays in memory)."""
    try:
        total = sum(os.path.getsize(f) for f in _expand_part_files(train_data))
    except OSError:
        return False  # the reader reports a missing input
    budget = hbm_budget_bytes(dev)
    if total <= budget:
        return False
    unsupported = _streamed_unsupported(config)
    if not has_validation and (config.hyperparameter_tuning_iters > 0 or config.regularization_weight_grid):
        # the streamed grid selects by validation metric
        unsupported = unsupported + ["regularization grids / hyperparameter tuning without --validation-data"]
    if unsupported:
        logger.info(
            f"input bytes {total:.3g} exceed the device memory budget {budget:.3g} but the configuration "
            f"uses {', '.join(unsupported)}, which the streamed path does not support; keeping the "
            "in-memory path"
        )
        return False
    logger.info(
        f"input bytes {total:.3g} exceed the device memory budget {budget:.3g}: selecting the "
        "out-of-core streamed path (pass --streaming-chunk-rows to set the chunk size, or "
        "--no-auto-streaming to train in memory)"
    )
    return True


def _run_streamed_game(config: GameTrainingConfig, train_data: list[str], output_dir: str,
                       validation_data: list[str] | None, chunk_rows: int, logger: PhotonLogger,
                       dev: torch.device, multihost: bool = False, profile_dir: str | None = None) -> GameModel:
    """The out-of-core branch: the statistics pass over every file, the
    host fill of the training and validation rows (across processes, each
    process's slice of the files), one streamed descent per grid (and
    tuning) entry with per-entry checkpoints, and the best entry's files,
    written by process 0."""
    unsupported = _streamed_unsupported(config)
    if unsupported:
        raise ValueError("--streaming-chunk-rows does not support: " + ", ".join(unsupported))
    id_tags = _game_id_tags(config)
    reader = AvroDataReader(config.feature_shards or None)
    train_paths = _expand_part_files(train_data)
    warm_tag_maps = _load_entity_maps(config.model_input_dir) if config.model_input_dir else None
    with timed(logger, "streaming stats pass (all files)"), span("ingest/stats-pass", files=len(train_paths)):
        index_maps, max_nnz, entity_maps, n_rows = reader.streaming_game_stats(
            train_paths, id_tags, entity_maps=warm_tag_maps
        )
    logger.info(
        f"streamed GAME: {n_rows} rows, shards { {s: m.size for s, m in index_maps.items()} }, "
        f"entities { {t: len(m) for t, m in entity_maps.items()} }"
    )

    def own(paths: list[str]) -> list[str]:
        return host_shard_of_paths(paths) if multihost else paths

    local_paths = own(train_paths)
    if multihost:
        logger.info(f"this process fills {len(local_paths)}/{len(train_paths)} files")
    # a process without a file still builds its 0-row dataset: it takes
    # part in every collective of the trainer
    with timed(logger, "fill pass"), span("ingest/fill-pass", files=len(local_paths)):
        data = reader.read_streamed_game(local_paths, id_tags, index_maps, entity_maps, max_nnz=max_nnz,
                                         allow_empty=multihost)
    vdata = None
    if validation_data:
        local_val = own(_expand_part_files(validation_data))
        with timed(logger, "fill validation"), span("ingest/fill-validation", files=len(local_val)):
            vdata = reader.read_streamed_game(local_val, id_tags, index_maps, entity_maps, max_nnz=max_nnz,
                                              unseen_entity_ok=True, allow_empty=multihost)

    initial_model = None
    if config.model_input_dir:
        with timed(logger, "load warm-start model"):
            entity_ids = None
            if warm_tag_maps:
                entity_ids = {cid: warm_tag_maps[c.random_effect_type]
                              for cid, c in config.random_effect_coordinates.items()
                              if c.random_effect_type in warm_tag_maps}
            initial_model = load_game_model(config.model_input_dir, index_maps=index_maps,
                                            entity_ids=entity_ids, device=dev)
            # entities absent from the saved run cold-start from zero rows
            for cid, c in config.random_effect_coordinates.items():
                sub = initial_model.models.get(cid)
                if not isinstance(sub, RandomEffectModel):
                    continue
                pad = len(entity_maps[c.random_effect_type]) - sub.num_entities
                if pad > 0:
                    W = torch.cat([sub.coefficients, sub.coefficients.new_zeros((pad, sub.coefficients.shape[1]))])
                    initial_model = initial_model.updated(
                        cid, dataclasses.replace(sub, coefficients=W, variances=None)
                    )

    intercepts = {sid: m.intercept_index for sid, m in index_maps.items()}
    num_entities = {t: len(m) for t, m in entity_maps.items()}
    grid = build_configuration_grid(config)
    multi_entry = len(grid) > 1 or config.hyperparameter_tuning_iters > 0
    if multi_entry and vdata is None:
        raise ValueError("regularization grids / hyperparameter tuning on the streamed path select by "
                         "validation metric; pass --validation-data")
    # an empty evaluators tuple means the task's default metric
    specs = tuple(config.evaluators) or (DEFAULT_EVALUATOR_BY_TASK[config.task_type],)
    primary_ev = make_evaluator(specs[0])
    # only the current best entry's model and trainer stay alive: the host
    # memory is the dataset's
    best: dict | None = None
    summaries: list[dict] = []

    def fit_entry(configuration, tag):
        nonlocal best
        ck_dir = os.path.join(output_dir, "checkpoints", tag) if multi_entry else os.path.join(
            output_dir, "checkpoints")
        if any(c.random_projection_dim is not None for c in config.random_effect_coordinates.values()):
            logger.info("random-projected coordinates: checkpoint/resume disabled for the streamed descent")
            ck_dir = None
        trainer = StreamedGameTrainer(
            _config_with_optimizations(config, configuration), chunk_rows=chunk_rows,
            intercept_indices=intercepts, logger=logger.info, multihost=multihost, checkpoint_dir=ck_dir,
            evaluators=specs if vdata is not None else (), num_entities=num_entities, device=dev,
        )
        weights = {cid: float(o.regularization_weight) for cid, o in configuration.items()}
        with span("train/grid-entry", tag=tag, weights=weights):
            model, info = trainer.fit(data, validation=vdata, initial_model=initial_model)
        primary = None
        if trainer.validation_history:
            (_, last), = trainer.validation_history[-1].items()
            primary = last.primary
        summaries.append({"configuration": configuration, "primary": primary})
        entry = {"model": model, "info": info, "trainer": trainer, "configuration": configuration,
                 "primary": primary, "index": len(summaries) - 1}
        if best is None or (primary is not None and (best["primary"] is None
                                                     or primary_ev.better(primary, best["primary"]))):
            best = entry  # the previous best's model and trainer go here
        return primary

    with timed(logger, "streamed coordinate descent"), profile_trace(profile_dir, "streamed-game"), \
            span("train/streamed-descent", grid_entries=len(grid)):
        for i, configuration in enumerate(grid):
            fit_entry(configuration, f"grid-{i:04d}")
        if config.hyperparameter_tuning_iters > 0:
            cids = list(config.coordinate_update_sequence)
            prior = [({cid: s["configuration"][cid].regularization_weight for cid in cids}, s["primary"])
                     for s in summaries if s["primary"] is not None]

            def evaluate(weights, it):
                configuration = {
                    cid: dataclasses.replace(config.coordinate_config(cid).optimization,
                                             regularization_weight=weights[cid])
                    for cid in cids
                }
                return fit_entry(configuration, f"tune-{it:04d}")

            with timed(logger, "streamed hyperparameter tuning"):
                gp_tune_weights(cids, prior, config.hyperparameter_tuning_iters, evaluate,
                                primary_ev.larger_is_better)
    if multi_entry:
        logger.info(
            "selected streamed configuration: "
            f"{ {c: o.regularization_weight for c, o in best['configuration'].items()} } "
            f"(primary {best['primary']})"
        )
    model, info, trainer = best["model"], best["info"], best["trainer"]
    # every process computes; process 0 alone writes the shared outputs
    if is_output_process():
        _write_streamed_outputs(output_dir, config, index_maps, entity_maps, model, info, trainer, chunk_rows,
                                summaries if multi_entry else None, best["index"], logger)
    if multihost:
        sync_processes("streamed-game-outputs-written")
    return model


def _write_streamed_outputs(output_dir: str, config: GameTrainingConfig, index_maps, entity_maps, model,
                            info, trainer, chunk_rows: int, summaries: list | None, best_index: int,
                            logger: PhotonLogger) -> None:
    """The out-of-core branch's files: ``best/``, the maps and a
    ``metrics.json`` merged with an interrupted run's; ``summaries``, the
    grid's entries (None for one entry)."""
    with timed(logger, "write models"):
        entity_names = {}
        for tag, m in entity_maps.items():
            names = [""] * len(m)
            for s, i in m.items():
                names[i] = s
            entity_names[tag] = names
        by_cid = {cid: entity_names[c.random_effect_type] for cid, c in config.random_effect_coordinates.items()}
        save_game_model(model, os.path.join(output_dir, "best"), index_maps=index_maps, entity_names=by_cid)
        for sid, imap in index_maps.items():
            imap.save(os.path.join(output_dir, "index-maps", sid))
        with open(os.path.join(output_dir, "entity-maps.json"), "w") as f:
            json.dump(entity_maps, f)
    metrics_path = os.path.join(output_dir, "metrics.json")
    # a resumed run revisits only the remaining coordinates: merge with the
    # interrupted run's file; a run from scratch replaces it
    old: dict = {}
    if trainer.resumed_from is not None and os.path.exists(metrics_path):
        try:
            with open(metrics_path) as f:
                old = json.load(f)
        except (OSError, json.JSONDecodeError):
            old = {}
    if info or not old:
        coordinates = dict(old.get("coordinates", {}))
        coordinates.update({cid: {"final_loss": ci.final_loss, "iterations": ci.iterations,
                                  "converged": ci.converged} for cid, ci in info.items()})
        metrics = {
            "streaming_chunk_rows": chunk_rows,
            "coordinates": coordinates,
            "validation_history": list(old.get("validation_history", [])) + [
                {cid: dict(res.metrics) for cid, res in entry.items()} for entry in trainer.validation_history
            ],
        }
        if summaries is not None:
            metrics["results"] = [
                {"configuration": {cid: opt.to_dict() for cid, opt in s["configuration"].items()},
                 "primary": s["primary"]}
                for s in summaries
            ]
            metrics["best_index"] = best_index
        with open(metrics_path, "w") as f:
            json.dump(metrics, f, indent=2)
    else:
        # the checkpoint showed the run complete: no visit ran, and the
        # existing metrics.json holds the run's diagnostics
        logger.info("checkpoint shows training already complete; keeping the existing metrics.json")


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
                   help="train across processes: run the same command in each with "
                        "JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID set; in memory "
                        "every process reads every file, out of core (--streaming-chunk-rows or "
                        "auto-streaming) each fills its slice of the part files; process 0 writes")
    p.add_argument("--streaming-chunk-rows", type=int, default=None,
                   help="out-of-core training: the dataset stays in host memory and streams through "
                        "the card in chunks of this many rows; selected by itself (2^20 rows) when "
                        "the input exceeds the device's memory budget")
    p.add_argument(
        "--no-auto-streaming", action="store_true",
        help="train in memory even when the input exceeds the device's memory budget",
    )
    p.add_argument("--profile-dir", default=None,
                   help="write torch.profiler traces (CPU and CUDA) of the fit into this directory")
    p.add_argument("--telemetry-dir", default=None,
                   help="write the run's telemetry JSONL (spans, per-iteration optimizer records, the "
                        "metrics registry) into this directory; read it with the reference's "
                        "photon-ml-tpu report")
    p.add_argument("--diagnostics", action="store_true",
                   help="write diagnostics.json and diagnostics.html beside the models")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--output-dir", required=True)
    return p


def main(argv: list[str] | None = None) -> None:
    args = _parser().parse_args(argv)
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
    if args.multihost:
        initialize_multihost()
    try:
        # one process owns the shared log file; the rest log to stderr
        logger = PhotonLogger(args.output_dir if is_output_process() else None)
        if args.multihost:
            logger.info(f"multihost runtime: {runtime_summary()}")
        if (
            args.streaming_chunk_rows is None
            and not args.no_auto_streaming
            and _should_auto_stream(train_data, config, logger, dev, has_validation=bool(validation_data))
        ):
            args.streaming_chunk_rows = 1 << 20
        # after the process group is up: process 0 writes (every process
        # its shard under PHOTON_TELEMETRY_FLEET=1)
        obs.configure(args.telemetry_dir)
        try:
            run(
                config, train_data, args.output_dir, validation_data=validation_data,
                index_map_dir=args.index_maps, logger=logger, profile_dir=args.profile_dir,
                diagnostics=args.diagnostics, streaming_chunk_rows=args.streaming_chunk_rows,
                multihost=args.multihost, device=dev,
            )
        finally:
            obs.shutdown()
    finally:
        shutdown_multihost()


if __name__ == "__main__":
    main()
