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

Usage:
    python -m photon_ml_tpu_torch.cli.train_glm \\
        --task LOGISTIC_REGRESSION --train-data a9a.libsvm \\
        --regularization L2 --weights 0.1 1 10 --output-dir out/
"""

from __future__ import annotations

import argparse
import json
import os

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.config import OptimizerConfig, RegularizationContext
from photon_ml_tpu_torch.data.libsvm import read_libsvm
from photon_ml_tpu_torch.data.summary import summarize
from photon_ml_tpu_torch.data.validation import validate_arrays
from photon_ml_tpu_torch.diagnostics import glm_sweep_diagnostics, write_report
from photon_ml_tpu_torch.io.data_reader import AvroDataReader
from photon_ml_tpu_torch.io.model_io import load_glm, save_glm
from photon_ml_tpu_torch.io.results import write_feature_summary
from photon_ml_tpu_torch.ops.batch import hbm_budget_bytes as _hbm_budget_bytes
from photon_ml_tpu_torch.ops.batch import optimize_batch_layout
from photon_ml_tpu_torch.supervised.training import train_glm
from photon_ml_tpu_torch.utils import PhotonLogger, timed
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
):
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
    with timed(logger, "train"):
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
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--output-dir", required=True)
    args = p.parse_args(argv)
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
    )


if __name__ == "__main__":
    main()
