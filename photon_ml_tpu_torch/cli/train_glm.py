"""Single-GLM training command (port of ``photon_ml_tpu/cli/train_glm.py``
``run`` on its in-memory LIBSVM path).

Trains one GLM per regularization weight (ascending, warm-started),
validates each, selects the best, and writes ``report.json`` with the
reference's keys, advancing ``_stage`` through INIT, PROCESSED, TRAINED
and VALIDATED. Avro input (``--format avro``) and the Avro model files the
reference writes wait for a later slice: the command rejects Avro input,
and the trained models stay in the returned result.

Usage:
    python -m photon_ml_tpu_torch.cli.train_glm \\
        --task LOGISTIC_REGRESSION --train-data a9a.libsvm \\
        --regularization L2 --weights 0.1 1 10 --output-dir out/
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from photon_ml_tpu_torch._device import resolve_device
from photon_ml_tpu_torch.config import OptimizerConfig, RegularizationContext
from photon_ml_tpu_torch.data.libsvm import read_libsvm
from photon_ml_tpu_torch.data.summary import summarize
from photon_ml_tpu_torch.ops.batch import optimize_batch_layout
from photon_ml_tpu_torch.supervised.training import train_glm
from photon_ml_tpu_torch.types import (
    NormalizationType,
    OptimizerType,
    RegularizationType,
    TaskType,
    VarianceComputationType,
)

def _hbm_budget_bytes(dev: torch.device) -> float:
    """Bytes the dense training matrix may take: three quarters of the
    card's memory (room for the optimizer's state and scratch), or 8 GB on
    the CPU; the reference's ``device_hbm_budget_bytes`` policy."""
    if dev.type == "cuda":
        return 0.75 * torch.cuda.get_device_properties(dev).total_memory
    return 8e9


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
):
    if data_format != "libsvm":
        raise ValueError(
            f"--format {data_format}: the port reads LIBSVM only; Avro input "
            "and Avro model output come with a later slice"
        )
    if len(train_data) != 1 or (validation_data and len(validation_data) != 1):
        raise ValueError("libsvm input takes exactly one file")
    dev = resolve_device(device)
    stage_file = os.path.join(output_dir, "_stage")

    def advance(stage: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        with open(stage_file, "w") as f:
            f.write(stage)

    advance("INIT")
    batch, intercept_index = read_libsvm(train_data[0], device=dev)
    norm_context = None
    if normalization is not NormalizationType.NONE:
        norm_context = summarize(batch).normalization(normalization, intercept_index, device=dev)
    advance("PROCESSED")

    val_batch = None
    if validation_data:
        # pin the validation feature space to the training one
        d_raw = batch.num_features - (1 if intercept_index is not None else 0)
        val_batch, _ = read_libsvm(validation_data[0], num_features=d_raw, device=dev)

    # layout decision after the summary (which reads the raw rows)
    batch = optimize_batch_layout(batch, hbm_budget_bytes=_hbm_budget_bytes(dev))
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
        device=dev,
    )
    advance("TRAINED")

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
    advance("VALIDATED")
    return result


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Single-GLM training (PyTorch/CUDA port)")
    p.add_argument("--task", required=True, choices=[t.value for t in TaskType])
    p.add_argument("--train-data", required=True, nargs="+")
    p.add_argument("--validation-data", nargs="*", default=None)
    p.add_argument(
        "--format", default="libsvm", choices=["libsvm", "avro"],
        help="input format; avro is rejected until a later slice ports it",
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
        "--variance-computation", default="NONE",
        choices=[v.value for v in VarianceComputationType],
    )
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
        variance_computation=VarianceComputationType(args.variance_computation),
        device=args.device,
    )


if __name__ == "__main__":
    main()
