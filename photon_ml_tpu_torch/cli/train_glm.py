"""Single-GLM training command (port of ``photon_ml_tpu/cli/train_glm.py``
``run`` on its in-memory path, LIBSVM or Avro input).

Trains one GLM per regularization weight (ascending, warm-started),
validates each, selects the best, and writes the reference's files:
``models/lambda-<λ>/model.avro`` per weight, ``best/model.avro`` and
``report.json``, advancing ``_stage`` through INIT, PROCESSED, TRAINED and
VALIDATED. Avro input trains on the ``global`` shard of ``AvroDataReader``
(the ``features`` bag with an intercept), and its model files name the real
features; LIBSVM models name them ``f<index>``. ``--validate`` checks the
training columns first, ``--summarize-features`` writes
``summary/part-00000.avro``, ``--prior-model`` trains incrementally with a
saved model as the Gaussian prior, and ``--diagnostics`` writes
``diagnostics.json`` and ``diagnostics.html``.

``--streaming-chunk-rows N`` (Avro only) trains out of core: one
statistics pass over every file gives the index maps and the widest row,
the data are then read into uniform host chunks of N rows, and every
objective evaluation streams them through the device (``ops/streaming.py``,
host L-BFGS or TRON); the sweep checkpoints to ``checkpoints/`` and a rerun
into the same output directory resumes it.

``--multihost`` (with ``--streaming-chunk-rows`` only, as in the
reference) trains one model over several processes: every process runs
the same command with ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``
and ``JAX_PROCESS_ID`` set, joins one gloo process group
(``parallel/multihost.py``), builds the index maps from a statistics pass
over all files, then chunks only its round-robin share of the part files
(``host_shard_of_paths``). Each objective pass sums over the processes;
validation files are read whole by every process, so the metrics agree.
Only process 0 writes (models, report, summary, checkpoints, ``_stage``),
and all processes meet at a closing barrier.

``--telemetry-dir DIR`` writes the run's telemetry JSONL into ``DIR``
(``obs``: the solvers' per-iteration records, the streamed passes, the
kernels' analytic cost, the metrics registry; process 0 writes, or every
process its own shard under ``PHOTON_TELEMETRY_FLEET=1``);
``--profile-dir DIR`` traces the λ sweep with ``torch.profiler`` into
``DIR/glm-sweep/`` (``DIR/glm-sweep-streamed/`` out of core).

Usage:
    python -m photon_ml_tpu_torch.cli.train_glm \\
        --task LOGISTIC_REGRESSION --train-data a9a.libsvm \\
        --regularization L2 --weights 0.1 1 10 --output-dir out/
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.config import OptimizerConfig, RegularizationContext
from photon_ml_tpu_torch.data.libsvm import read_libsvm
from photon_ml_tpu_torch.data.summary import summarize, summarize_chunks
from photon_ml_tpu_torch.data.validation import DataValidationError, validate_arrays
from photon_ml_tpu_torch.io.avro import list_avro_files
from photon_ml_tpu_torch.diagnostics import glm_sweep_diagnostics, write_report
from photon_ml_tpu_torch.io.data_reader import AvroDataReader
from photon_ml_tpu_torch.io.model_io import load_glm, save_glm
from photon_ml_tpu_torch.io.results import write_feature_summary
from photon_ml_tpu_torch.ops.batch import hbm_budget_bytes as _hbm_budget_bytes
from photon_ml_tpu_torch.ops.batch import optimize_batch_layout
from photon_ml_tpu_torch.parallel.multihost import (
    allreduce_max_host,
    host_shard_of_paths,
    initialize_multihost,
    is_output_process,
    shutdown_multihost,
    sync_processes,
)
from photon_ml_tpu_torch.supervised.training import train_glm, train_glm_streamed
from photon_ml_tpu_torch.utils import PhotonLogger, profile_trace, timed
from photon_ml_tpu_torch.types import (
    DataValidationType,
    NormalizationType,
    OptimizerType,
    RegularizationType,
    TaskType,
    VarianceComputationType,
)


def run(
    task: TaskType,
    train_data: list[str],
    output_dir: str,
    data_format: str = "libsvm",
    validation_data: list[str] | None = None,
    regularization: RegularizationType = RegularizationType.L2,
    weights: list[float] = (1.0,),
    optimizer: OptimizerType = OptimizerType.LBFGS,
    max_iterations: int = 100,
    tolerance: float = 1e-7,
    normalization: NormalizationType = NormalizationType.NONE,
    variance_computation: VarianceComputationType = VarianceComputationType.NONE,
    device=None,
    logger: PhotonLogger | None = None,
    summarize_features: bool = False,
    validate: DataValidationType = DataValidationType.VALIDATE_DISABLED,
    prior_model_path: str | None = None,
    diagnostics: bool = False,
    streaming_chunk_rows: int | None = None,
    multihost: bool = False,
    profile_dir: str | None = None,
):
    _check_multihost(multihost, streaming_chunk_rows)
    if data_format not in ("libsvm", "avro"):
        raise ValueError(f"unknown --format {data_format!r}")
    if data_format == "libsvm" and (
        len(train_data) != 1 or (validation_data and len(validation_data) != 1)
    ):
        raise ValueError("libsvm input takes exactly one file")
    dev = resolve_device(device)
    logger = logger or PhotonLogger(output_dir)
    stage_file = os.path.join(output_dir, "_stage")

    def advance(stage: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        with open(stage_file, "w") as f:
            f.write(stage)
        logger.info(f"stage → {stage}")

    if streaming_chunk_rows is not None:
        # refuse, never silently drop, what the streamed branch cannot honour
        unsupported = []
        if optimizer not in (OptimizerType.LBFGS, OptimizerType.TRON):
            unsupported.append(f"--optimizer {optimizer.value} (streaming offers LBFGS/TRON)")
        if optimizer is OptimizerType.TRON and regularization in (
            RegularizationType.L1, RegularizationType.ELASTIC_NET
        ):
            unsupported.append(
                f"--optimizer TRON with --regularization {regularization.value} "
                "(L1 routes through OWL-QN; use LBFGS)"
            )
        if unsupported:
            raise ValueError("--streaming-chunk-rows does not support: " + ", ".join(unsupported))
        return _run_streamed(
            task, train_data, output_dir, data_format, validation_data, regularization, weights,
            max_iterations, tolerance, streaming_chunk_rows, advance, logger, dev,
            optimizer=optimizer, normalization=normalization,
            variance_computation=variance_computation, summarize_features=summarize_features,
            validate=validate, prior_model_path=prior_model_path, diagnostics=diagnostics,
            multihost=multihost, profile_dir=profile_dir,
        )

    advance("INIT")
    imap = None
    with timed(logger, "read training data"):
        if data_format == "avro":
            train_ds = AvroDataReader().read(train_data, device=dev)
            sid = next(iter(train_ds.index_maps))
            batch, intercept_index = train_ds.batch.batch_for(sid), train_ds.intercept_indices[sid]
            imap = train_ds.index_maps[sid]
        else:
            batch, intercept_index = read_libsvm(train_data[0], device=dev)
    if validate is not DataValidationType.VALIDATE_DISABLED:
        with timed(logger, "validate data"):
            validate_arrays(task, batch.labels, batch.X if hasattr(batch, "X") else batch.values,
                            offsets=batch.offsets, weights=batch.weights, mode=validate)
    norm_context = None
    if summarize_features or normalization is not NormalizationType.NONE:
        with timed(logger, "summarize features"):
            summary = summarize(batch)
            if summarize_features:
                write_feature_summary(os.path.join(output_dir, "summary", "part-00000.avro"), summary, imap)
            if normalization is not NormalizationType.NONE:
                norm_context = summary.normalization(normalization, intercept_index, device=dev)
    advance("PROCESSED")

    val_batch = None
    if validation_data:
        with timed(logger, "read validation data"):
            if data_format == "avro":
                val_ds = AvroDataReader().read(validation_data, index_maps=train_ds.index_maps,
                                               device=dev)
                val_batch = val_ds.batch.batch_for(sid)
            else:
                # pin the validation feature space to the training one
                d_raw = batch.num_features - (1 if intercept_index is not None else 0)
                val_batch, _ = read_libsvm(validation_data[0], num_features=d_raw, device=dev)

    prior_model = None
    if prior_model_path:
        with timed(logger, "load prior model"):
            prior_model = load_glm(prior_model_path, index_map=imap, num_features=batch.num_features,
                                   task=task, device=dev)

    # layout decision after the validation and the summary (which read the raw rows)
    with timed(logger, "optimize batch layout"):
        batch = optimize_batch_layout(batch, hbm_budget_bytes=_hbm_budget_bytes(dev))
    with timed(logger, "train"), profile_trace(profile_dir, "glm-sweep"):
        result = train_glm(
            batch,
            task,
            optimizer_config=OptimizerConfig(
                optimizer_type=optimizer, max_iterations=max_iterations, tolerance=tolerance
            ),
            regularization=RegularizationContext(regularization),
            regularization_weights=list(weights),
            normalization=norm_context,
            intercept_index=intercept_index,
            validation_batch=val_batch,
            variance_computation=variance_computation,
            initial_model=prior_model,
            incremental=prior_model is not None,
            device=dev,
        )
    advance("TRAINED")

    with timed(logger, "write models"):
        for lam, model in result.models.items():
            save_glm(
                model, os.path.join(output_dir, "models", f"lambda-{lam:g}", "model.avro"),
                index_map=imap, model_id=f"lambda-{lam:g}",
            )
        save_glm(result.best_model, os.path.join(output_dir, "best", "model.avro"), index_map=imap,
                 model_id="best")

    report = {
        "task": task.value,
        "weights": sorted(float(w) for w in weights),
        "best_weight": result.best_weight,
        "validation": {str(lam): dict(ev.metrics) for lam, ev in result.validation.items()},
        "trackers": {
            str(lam): {"iterations": int(t.iterations), "converged": bool(t.converged)}
            for lam, t in result.trackers.items()
        },
    }
    with open(os.path.join(output_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    if diagnostics:
        with timed(logger, "write diagnostics"):
            write_report(glm_sweep_diagnostics(result, index_map=imap, task=task), output_dir)
    advance("VALIDATED")
    return result


def _check_multihost(multihost: bool, streaming_chunk_rows: int | None) -> None:
    if multihost and streaming_chunk_rows is None:
        raise ValueError(
            "--multihost requires --streaming-chunk-rows (per-host sharded "
            "ingest exists on the streaming path; in-memory multihost GLM "
            "training goes through the GAME driver's --multihost)"
        )


def _expand_avro_paths(paths: list[str]) -> list[str]:
    """Directories as their sorted ``*.avro`` part files."""
    return [f for p in paths for f in list_avro_files(p)]


def _run_streamed(
    task, train_data, output_dir, data_format, validation_data, regularization, weights,
    max_iterations, tolerance, chunk_rows, advance, logger, dev,
    optimizer: OptimizerType = OptimizerType.LBFGS,
    normalization: NormalizationType = NormalizationType.NONE,
    variance_computation: VarianceComputationType = VarianceComputationType.NONE,
    summarize_features: bool = False,
    validate: DataValidationType = DataValidationType.VALIDATE_DISABLED,
    prior_model_path: str | None = None,
    diagnostics: bool = False,
    multihost: bool = False,
    profile_dir: str | None = None,
):
    """The out-of-core branch: the data are read into uniform chunks that
    live in host memory and stream through the device on every optimizer
    evaluation. Avro only (a LIBSVM file fits in memory whenever its text
    does). The data are read twice: the statistics pass over all files,
    then the chunk fill (of this process's files under ``multihost``)."""
    if data_format != "avro":
        raise ValueError("--streaming-chunk-rows requires --format avro")
    reader = AvroDataReader()
    sid = next(iter(reader.feature_shards))
    train_paths = _expand_avro_paths(train_data)
    local_paths = train_paths
    if multihost:
        local_paths = host_shard_of_paths(train_paths)
        logger.info(f"this process reads {len(local_paths)}/{len(train_paths)} files")
    writer = is_output_process()

    def advance_once(stage: str) -> None:
        if writer:
            advance(stage)

    advance_once("INIT")
    with timed(logger, "index maps (streaming pass, all files)"):
        index_maps, max_nnz = reader.streaming_ingest_stats(train_paths)
    imap = index_maps[sid]
    with timed(logger, "chunk training data"):
        chunks = list(reader.iter_batch_chunks(local_paths, sid, chunk_rows, index_maps,
                                               max_nnz=max_nnz[sid])) if local_paths else []
    logger.info(f"{len(chunks)} training chunks of {chunk_rows} rows")

    if validate is not DataValidationType.VALIDATE_DISABLED:
        with timed(logger, "validate data (streamed, per chunk)"):
            # FULL checks every chunk; SAMPLE thins the rows inside each
            # chunk (seeded by the chunk's number)
            failure = None
            for ci, chunk in enumerate(chunks):
                try:
                    validate_arrays(task, chunk["labels"], chunk.get("X", chunk.get("values")),
                                    offsets=chunk.get("offsets"), weights=chunk.get("weights"),
                                    mode=validate, seed=ci)
                except DataValidationError as e:
                    failure = (f"chunk {ci} (rows {ci * chunk_rows}..{ci * chunk_rows + len(chunk['labels'])}"
                               f" of this process's stream): {e}")
                    break
            if multihost:
                # every process learns of a failure before any raises: one
                # raising alone would leave the others waiting in a collective
                failed_anywhere = allreduce_max_host(np.asarray([float(failure is not None)]))
                if float(failed_anywhere[0]) > 0 and failure is None:
                    failure = "validation failed on another process"
            if failure is not None:
                raise DataValidationError(failure)

    norm_context = None
    if summarize_features or normalization is not NormalizationType.NONE:
        with timed(logger, "summarize features (streamed)"):
            # cross-process: every process gets the global statistics
            summary = summarize_chunks(chunks, num_features=imap.size, cross_process=multihost)
        if summarize_features and writer:
            write_feature_summary(os.path.join(output_dir, "summary", "part-00000.avro"), summary, imap)
        if normalization is not NormalizationType.NONE:
            norm_context = summary.normalization(normalization, imap.intercept_index, device=dev)
    advance_once("PROCESSED")

    val_chunks = None
    if validation_data:
        with timed(logger, "chunk validation data"):
            val_chunks = list(reader.iter_batch_chunks(_expand_avro_paths(validation_data), sid,
                                                       chunk_rows, index_maps))

    prior_model = None
    if prior_model_path:
        with timed(logger, "load prior model"):
            prior_model = load_glm(prior_model_path, index_map=imap, num_features=imap.size, task=task,
                                   device=dev)

    with timed(logger, "train (streamed)"), profile_trace(profile_dir, "glm-sweep-streamed"):
        result = train_glm_streamed(
            chunks,
            task,
            num_features=imap.size,
            optimizer_config=OptimizerConfig(
                optimizer_type=optimizer, max_iterations=max_iterations, tolerance=tolerance
            ),
            regularization=RegularizationContext(regularization),
            regularization_weights=list(weights),
            intercept_index=imap.intercept_index,
            validation_chunks=val_chunks,
            initial_model=prior_model,
            incremental=prior_model is not None,
            checkpoint_dir=os.path.join(output_dir, "checkpoints"),
            normalization=norm_context,
            variance_computation=variance_computation,
            cross_process=multihost,
            device=dev,
        )
    advance_once("TRAINED")

    if writer:
        with timed(logger, "write models"):
            for lam, model in result.models.items():
                save_glm(
                    model, os.path.join(output_dir, "models", f"lambda-{lam:g}", "model.avro"),
                    index_map=imap, model_id=f"lambda-{lam:g}",
                )
            save_glm(result.best_model, os.path.join(output_dir, "best", "model.avro"), index_map=imap,
                     model_id="best")
        report = {
            "task": task.value,
            "streaming_chunk_rows": chunk_rows,
            "weights": sorted(float(w) for w in weights),
            "best_weight": result.best_weight,
            "validation": {str(lam): dict(ev.metrics) for lam, ev in result.validation.items()},
        }
        with open(os.path.join(output_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=2)
        if diagnostics:
            with timed(logger, "write diagnostics"):
                write_report(glm_sweep_diagnostics(result, index_map=imap, task=task), output_dir)
        advance("VALIDATED")
    sync_processes("train-glm-outputs-written")
    return result


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Single-GLM training (PyTorch/CUDA port)")
    p.add_argument("--task", required=True, choices=[t.value for t in TaskType])
    p.add_argument("--train-data", required=True, nargs="+")
    p.add_argument("--validation-data", nargs="*", default=None)
    p.add_argument(
        "--format", default="libsvm", choices=["libsvm", "avro"],
        help="input format: a LIBSVM file, or Avro files or directories of part files",
    )
    p.add_argument(
        "--regularization", default="L2", choices=[r.value for r in RegularizationType]
    )
    p.add_argument("--weights", nargs="+", type=float, default=[1.0])
    p.add_argument(
        "--optimizer", default="LBFGS", choices=[o.value for o in OptimizerType],
        help="LBFGS (OWL-QN when the regularization has an L1 part) or TRON",
    )
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument("--tolerance", type=float, default=1e-7)
    p.add_argument(
        "--normalization", default="NONE", choices=[n.value for n in NormalizationType]
    )
    p.add_argument(
        "--variance", "--variance-computation", dest="variance", default="NONE",
        choices=[v.value for v in VarianceComputationType],
        help="the reference's spelling; --variance-computation is kept as an alias",
    )
    p.add_argument("--summarize-features", action="store_true",
                   help="write the training features' summary to summary/part-00000.avro")
    p.add_argument("--validate", default="VALIDATE_DISABLED", choices=[v.value for v in DataValidationType],
                   help="check labels, features, offsets and weights before training")
    p.add_argument("--prior-model", default=None,
                   help="incremental training: a saved model.avro whose means and variances become "
                        "the Gaussian prior of every λ's solve")
    p.add_argument("--diagnostics", action="store_true",
                   help="write diagnostics.json and a self-contained diagnostics.html (optimizer "
                        "traces, validation metrics, top features)")
    p.add_argument("--streaming-chunk-rows", type=int, default=None,
                   help="out of core (Avro): stream the data through the device in uniform chunks "
                        "of this many rows, held in host memory")
    p.add_argument("--multihost", action="store_true",
                   help="train over several processes (with --streaming-chunk-rows): run the same "
                        "command in each with JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and "
                        "JAX_PROCESS_ID set; each reads its share of the part files")
    p.add_argument("--profile-dir", default=None,
                   help="write torch.profiler traces (CPU and CUDA) of the λ sweep into this directory")
    p.add_argument("--telemetry-dir", default=None,
                   help="write the run's telemetry JSONL (spans, per-iteration optimizer records, the "
                        "metrics registry) into this directory; read it with "
                        "photon-ml-tpu-torch report")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--output-dir", required=True)
    args = p.parse_args(argv)
    if args.multihost:
        _check_multihost(True, args.streaming_chunk_rows)
        initialize_multihost()
    try:
        # after the process group is up: process 0 writes (every process
        # its shard under PHOTON_TELEMETRY_FLEET=1)
        obs.configure(args.telemetry_dir)
        try:
            _run_main(args)
        finally:
            obs.shutdown()
    finally:
        shutdown_multihost()


def _run_main(args) -> None:
    run(
        TaskType(args.task),
        args.train_data,
        args.output_dir,
        data_format=args.format,
        validation_data=args.validation_data,
        regularization=RegularizationType(args.regularization),
        weights=args.weights,
        optimizer=OptimizerType(args.optimizer),
        max_iterations=args.max_iterations,
        tolerance=args.tolerance,
        normalization=NormalizationType(args.normalization),
        variance_computation=VarianceComputationType(args.variance),
        device=args.device,
        summarize_features=args.summarize_features,
        validate=DataValidationType(args.validate),
        prior_model_path=args.prior_model,
        diagnostics=args.diagnostics,
        streaming_chunk_rows=args.streaming_chunk_rows,
        multihost=args.multihost,
        profile_dir=args.profile_dir,
    )


if __name__ == "__main__":
    main()
