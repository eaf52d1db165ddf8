"""Single-GLM training: regularization sweep with warm start, validation,
model selection and coefficient variances (port of ``train_glm``,
``train_glm_streamed`` and ``_StreamedSweepCheckpoint`` in
``photon_ml_tpu/supervised/training.py``)."""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch._device import check_device, resolve_device
from photon_ml_tpu_torch.config import OptimizerConfig, RegularizationContext
from photon_ml_tpu_torch.evaluation import (
    DEFAULT_EVALUATOR_BY_TASK,
    EvaluationResults,
    evaluate_all,
    make_evaluator,
)
from photon_ml_tpu_torch.models import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.normalization import NormalizationContext, require_intercept_for_shifts
from photon_ml_tpu_torch.obs import emit_event, span
from photon_ml_tpu_torch.obs import enabled as obs_enabled
from photon_ml_tpu_torch.ops.batch import Batch
from photon_ml_tpu_torch.ops.glm import GaussianPrior, compute_variances, make_objective
from photon_ml_tpu_torch.ops.losses import loss_for_task
from photon_ml_tpu_torch.optim.common import OptimizationResult, select_minimize_fn
from photon_ml_tpu_torch.parallel.multihost import broadcast_from_host0, is_output_process, process_count
from photon_ml_tpu_torch.types import RegularizationType, TaskType, VarianceComputationType


@dataclass(frozen=True)
class GLMTrainingResult:
    """Per-λ models + diagnostics, and the selected best model."""

    models: Mapping[float, GeneralizedLinearModel]
    trackers: Mapping[float, OptimizationResult]
    validation: Mapping[float, EvaluationResults]
    best_weight: float | None

    @property
    def best_model(self) -> GeneralizedLinearModel:
        if self.best_weight is None:
            # no validation data: the sweep's last (most regularized) model
            return self.models[list(self.models)[-1]]
        return self.models[self.best_weight]


def train_glm(
    batch: Batch,
    task: TaskType,
    optimizer_config: OptimizerConfig | None = None,
    regularization: RegularizationContext | None = None,
    regularization_weights: Sequence[float] = (0.0,),
    normalization: NormalizationContext | None = None,
    intercept_index: int | None = None,
    validation_batch: Batch | None = None,
    evaluators: Sequence[str] = (),
    variance_computation: VarianceComputationType = VarianceComputationType.NONE,
    initial_model: GeneralizedLinearModel | None = None,
    incremental: bool = False,
    device=None,
) -> GLMTrainingResult:
    """Train one GLM per regularization weight (ascending, warm-started),
    validate each, and select the best by the first evaluator.

    ``incremental=True`` turns ``initial_model`` from a plain warm start
    into an informative Gaussian prior (MAP update) pulling toward its
    means with strength 1/variance per coordinate.

    Runs on ``device`` (CUDA unless the caller passes another), which must
    hold ``batch`` and ``validation_batch``."""
    dev = check_device(batch.device, device)
    if validation_batch is not None:
        check_device(validation_batch.device, dev)
    optimizer_config = optimizer_config or OptimizerConfig()
    if regularization is None:
        # nonzero weights imply plain L2 (λ>0 with type NONE would silently
        # train unregularized)
        has_weights = any(w > 0 for w in regularization_weights)
        regularization = RegularizationContext(
            RegularizationType.L2 if has_weights else RegularizationType.NONE
        )
    elif regularization.regularization_type is RegularizationType.NONE and any(
        w > 0 for w in regularization_weights
    ):
        raise ValueError(
            "regularization_weights > 0 with RegularizationType.NONE would be "
            "silently ignored; pass an L1/L2/ELASTIC_NET context or drop the weights"
        )
    loss = loss_for_task(task)
    d = batch.num_features
    require_intercept_for_shifts(normalization)
    if normalization is not None:
        normalization = normalization.to(dev)

    # The optimizer works in NORMALIZED coefficient space; models are kept
    # in ORIGINAL space.
    prior = None
    if initial_model is not None:
        means = torch.as_tensor(initial_model.coefficients.means, dtype=torch.float32, device=dev)
        w = means
        if normalization is not None:
            w = normalization.model_from_original_space(w)
        if incremental:
            if not any(regularization.l2_weight(lam) > 0 for lam in regularization_weights):
                raise ValueError(
                    "incremental=True needs at least one sweep weight with a "
                    "positive L2 component: the prior's pull is "
                    "l2_weight * (1/prior_variance)"
                )
            variances = initial_model.coefficients.variances
            prior = GaussianPrior.from_coefficients(
                means,
                None if variances is None
                else torch.as_tensor(variances, dtype=torch.float32, device=dev),
                normalization,
            )
    else:
        if incremental:
            raise ValueError("incremental=True requires initial_model (the prior)")
        w = torch.zeros((d,), dtype=torch.float32, device=dev)

    specs = list(evaluators)
    if validation_batch is not None and not specs:
        specs = [DEFAULT_EVALUATOR_BY_TASK[task]]
    primary = make_evaluator(specs[0]) if specs else None

    models: dict[float, GeneralizedLinearModel] = {}
    trackers: dict[float, OptimizationResult] = {}
    validation: dict[float, EvaluationResults] = {}
    best_weight: float | None = None
    best_value = float("nan")

    for lam in sorted(regularization_weights):  # ascending, warm-started
        with span("glm/lambda", weight=float(lam)):
            obj = make_objective(
                batch,
                loss,
                l2_weight=regularization.l2_weight(lam),
                norm=normalization,
                intercept_index=intercept_index,
                prior=prior,
                device=dev,
            )
            minimize_fn, extra = select_minimize_fn(optimizer_config, regularization.l1_weight(lam))
            result = minimize_fn(obj, w, optimizer_config, **extra)
        w = result.w  # warm start for the next λ (normalized space)
        if obs_enabled():
            # the device solvers' record reads the result back: only while a sink is active
            emit_event("optim_result", weight=float(lam), **result.telemetry_record())

        variances = compute_variances(obj, result.w, variance_computation)
        w_model = result.w
        if normalization is not None:
            w_model, _ = normalization.model_to_original_space(result.w)
            if variances is not None:
                # linear map u = f⊙w ⇒ var scales by f² (diagonal approx.)
                variances = normalization.factors**2 * variances
        model = GeneralizedLinearModel(Coefficients(w_model, variances), task)
        models[lam] = model
        trackers[lam] = result

        if validation_batch is not None and specs:
            # evaluators consume RAW scores (margins + offsets)
            res = evaluate_all(
                specs, model.score(validation_batch), validation_batch.labels,
                validation_batch.weights,
            )
            validation[lam] = res
            if primary is not None and (
                best_weight is None or primary.better(res.primary, best_value)
            ):
                best_weight, best_value = lam, res.primary

    return GLMTrainingResult(
        models=models, trackers=trackers, validation=validation, best_weight=best_weight
    )


def _f32_bytes(t) -> bytes:
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return np.ascontiguousarray(np.asarray(a, np.float32)).tobytes()


class _StreamedSweepCheckpoint:
    """Resumable state of the streamed λ sweep: an npz of the completed
    λs' coefficient vectors (rewritten when a λ finishes) and a small npz
    of the running λ's latest iterate (rewritten every iteration), both
    written atomically with the reference's layout and fingerprint string
    (task, geometry, optimizer, regularization, normalization, prior and a
    digest of the data), so either package resumes the other's sweep where
    the digest agrees. A changed setup retrains; a corrupt or foreign file
    is ignored, never fatal.

    Across processes only the output process reads and writes the files;
    ``sync_across_processes`` then gives every process its view, so all
    take the same branch of the λ loop and their collectives stay
    matched (each process's own chunks would give it another
    fingerprint)."""

    def __init__(self, directory, task, chunks, num_features, opt_config, reg,
                 normalization=None, prior=None):
        self.directory = directory
        self.done_path = os.path.join(directory, "sweep-done.npz")
        self.partial_path = os.path.join(directory, "sweep-partial.npz")
        first_labels = np.ascontiguousarray(chunks[0]["labels"]) if chunks else np.zeros(0)
        total_rows = sum(len(c["labels"]) for c in chunks)
        norm_token = None if normalization is None else hashlib.sha256(
            _f32_bytes(normalization.factors) + _f32_bytes(normalization.shifts)
            + repr(normalization.intercept_index).encode()
        ).hexdigest()
        prior_token = None if prior is None else hashlib.sha256(
            _f32_bytes(prior.means) + (b"" if prior.variances is None else _f32_bytes(prior.variances))
        ).hexdigest()
        # the λ list is left out: completed models are keyed by λ, so an
        # extended sweep reuses what finished; the optimizer's budget is in
        self.fingerprint = hashlib.sha256(
            repr((
                task.value, num_features, total_rows, len(chunks),
                opt_config.optimizer_type.value, opt_config.max_iterations,
                opt_config.max_cg_iterations, opt_config.history_length,
                opt_config.max_line_search_steps, opt_config.tolerance,
                reg.regularization_type.value if reg is not None else None,
                reg.alpha if reg is not None else None,
                norm_token, prior_token,
            )).encode()
            + first_labels.tobytes()
        ).hexdigest()
        self._completed: dict[str, np.ndarray] = {}
        self._partial: tuple[float, np.ndarray] | None = None
        if not is_output_process():
            return
        done = self._load(self.done_path)
        if done is not None:
            z, _ = done
            self._completed = {k[len("done__"):]: z[k] for k in z.files if k.startswith("done__")}
        partial = self._load(self.partial_path)
        if partial is not None:
            z, meta = partial
            if "w" in z.files and meta.get("lam") is not None:
                self._partial = (float(meta["lam"]), z["w"])

    def sync_across_processes(self) -> None:
        """Every process adopts process 0's view of the checkpoint, in two
        broadcasts: the counts and width first, then the arrays, all in
        float64 (the stored dtype varies: float32 from the solver, float64
        from a resume). A no-op on one process."""
        if process_count() <= 1:
            return
        width = next((len(v) for v in self._completed.values()), None)
        if width is None and self._partial is not None:
            width = len(self._partial[1])
        counts = broadcast_from_host0(np.asarray(
            [len(self._completed), int(self._partial is not None), width or 0], np.int64))
        k, has_partial, width = (int(c) for c in counts)
        if k == 0 and not has_partial:
            self._completed, self._partial = {}, None
            return
        if is_output_process():
            lams = np.asarray([float(key) for key in self._completed], np.float64)
            W = (np.stack([np.asarray(v, np.float64) for v in self._completed.values()]) if k
                 else np.zeros((0, width)))
            plam = np.asarray([self._partial[0] if has_partial else 0.0], np.float64)
            pw = np.asarray(self._partial[1], np.float64) if has_partial else np.zeros(width)
        else:
            lams, W, plam, pw = np.zeros(k), np.zeros((k, width)), np.zeros(1), np.zeros(width)
        lams, W, plam, pw = broadcast_from_host0((lams, W, plam, pw))
        self._completed = {repr(float(lams[i])): np.asarray(W[i]) for i in range(k)}
        self._partial = (float(plam[0]), np.asarray(pw)) if has_partial else None

    def _load(self, path):
        """(npz, meta) when ``path`` is a checkpoint of this sweep, else None."""
        if not os.path.exists(path):
            return None
        try:
            z = np.load(path, allow_pickle=False)
            meta = json.loads(bytes(z["__meta__"]).decode())
        except Exception:
            return None  # truncated or foreign: retrain
        if meta.get("fingerprint") != self.fingerprint:
            return None
        return z, meta

    def completed_model(self, lam: float) -> np.ndarray | None:
        got = self._completed.get(repr(float(lam)))
        return None if got is None else np.asarray(got, np.float64)

    def partial_iterate(self, lam: float) -> np.ndarray | None:
        if self._partial is not None and self._partial[0] == float(lam):
            return np.asarray(self._partial[1], np.float64)
        return None

    def save_partial(self, lam: float, w: np.ndarray) -> None:
        self._partial = (float(lam), np.asarray(w))
        self._write(self.partial_path, {"w": self._partial[1]}, {"lam": self._partial[0]})

    def save_completed(self, lam: float, w: np.ndarray) -> None:
        self._completed[repr(float(lam))] = np.asarray(w)
        self._partial = None
        self._write(self.done_path, {f"done__{k}": v for k, v in self._completed.items()}, {})
        if is_output_process():
            try:
                os.remove(self.partial_path)
            except OSError:
                pass

    def _write(self, path: str, arrays: dict, extra_meta: dict) -> None:
        if not is_output_process():
            return  # one writer across processes
        os.makedirs(self.directory, exist_ok=True)
        arrays = dict(arrays)
        arrays["__meta__"] = np.frombuffer(
            json.dumps({"fingerprint": self.fingerprint, **extra_meta}).encode(), dtype=np.uint8
        )
        tmp = path + f".tmp-{os.getpid()}.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)


def train_glm_streamed(
    chunks: Sequence[dict],
    task: TaskType,
    num_features: int,
    optimizer_config: OptimizerConfig | None = None,
    regularization: RegularizationContext | None = None,
    regularization_weights: Sequence[float] = (0.0,),
    intercept_index: int | None = None,
    validation_chunks: Sequence[dict] | None = None,
    evaluators: Sequence[str] = (),
    initial_model: GeneralizedLinearModel | None = None,
    incremental: bool = False,
    cross_process: bool = False,
    checkpoint_dir: str | None = None,
    normalization: NormalizationContext | None = None,
    variance_computation: VarianceComputationType = VarianceComputationType.NONE,
    device=None,
) -> GLMTrainingResult:
    """Out-of-core twin of ``train_glm``: the same ascending, warm-started
    λ sweep by the host L-BFGS (OWL-QN when L1 is active) or host TRON over
    one ``StreamingGLMObjective`` (one streamed pass per value-and-gradient
    evaluation), on ``device`` (CUDA unless the caller passes another).

    ``chunks`` are uniform host chunk dicts (``ops/streaming.py`` builders
    or ``AvroDataReader.iter_batch_chunks``); validation scores stream
    chunk by chunk, and padded rows (weight 0) count as absent.
    ``normalization`` (build it with ``summarize_chunks`` over the same
    chunks) applies inside every evaluation, and models are saved in the
    original space. SIMPLE variances cost one streamed Hessian-diagonal
    pass per λ, FULL one pass summing the d×d Hessian (d <=
    ``FULL_HESSIAN_MAX_D``). ``incremental=True`` makes ``initial_model``
    a Gaussian MAP prior. ``checkpoint_dir`` makes the sweep resumable:
    completed λs load, and an interrupted λ restarts from its last saved
    iterate with a fresh history. ``cross_process`` trains over every
    process's chunks (this process's may be none): each pass's sums meet
    in ``allreduce_sum_host``, only process 0 reads and writes the
    checkpoint, and every process adopts its view before the λ loop."""
    from photon_ml_tpu_torch.ops.streaming import StreamingGLMObjective, stream_scores

    dev = resolve_device(device)
    optimizer_config = optimizer_config or OptimizerConfig()
    has_weights = any(w > 0 for w in regularization_weights)
    if regularization is None:
        regularization = RegularizationContext(
            RegularizationType.L2 if has_weights else RegularizationType.NONE
        )
    # unsupported combinations fail before any data work (the rule is shared)
    select_minimize_fn(optimizer_config, regularization.l1_weight(1.0), host=True)
    if regularization.regularization_type is RegularizationType.NONE and has_weights:
        raise ValueError(
            "regularization_weights > 0 with RegularizationType.NONE would be "
            "silently ignored; pass an L2 context or drop the weights"
        )
    if (variance_computation is VarianceComputationType.FULL
            and num_features > StreamingGLMObjective.FULL_HESSIAN_MAX_D):
        raise ValueError(
            f"streamed FULL variance supports d <= {StreamingGLMObjective.FULL_HESSIAN_MAX_D} "
            f"(got {num_features}); use SIMPLE at this width"
        )
    require_intercept_for_shifts(normalization)
    if normalization is not None:
        normalization = normalization.to(dev)
    loss = loss_for_task(task)
    prior = None
    if initial_model is not None:
        means = torch.as_tensor(initial_model.coefficients.means, dtype=torch.float32, device=dev)
        w0 = means if normalization is None else normalization.model_from_original_space(means)
        w = w0.cpu().numpy().astype(np.float32)
        if incremental:
            if not any(regularization.l2_weight(lam) > 0 for lam in regularization_weights):
                raise ValueError(
                    "incremental=True needs at least one sweep weight with a "
                    "positive L2 component: the prior's pull is "
                    "l2_weight * (1/prior_variance)"
                )
            variances = initial_model.coefficients.variances
            prior = GaussianPrior.from_coefficients(
                means,
                None if variances is None
                else torch.as_tensor(variances, dtype=torch.float32, device=dev),
                normalization,
            )
    else:
        if incremental:
            raise ValueError("incremental=True requires initial_model (the prior)")
        w = np.zeros((num_features,), np.float32)

    specs = list(evaluators)
    if validation_chunks is not None and not specs:
        specs = [DEFAULT_EVALUATOR_BY_TASK[task]]
    primary = make_evaluator(specs[0]) if specs else None
    if validation_chunks is not None:
        val_labels, val_weights, val_offsets = (
            np.concatenate([c[k] for c in validation_chunks]) for k in ("labels", "weights", "offsets")
        )

    models: dict[float, GeneralizedLinearModel] = {}
    trackers: dict[float, OptimizationResult] = {}
    validation: dict[float, EvaluationResults] = {}
    best_weight: float | None = None
    best_value = float("nan")

    ckpt = (
        _StreamedSweepCheckpoint(checkpoint_dir, task, chunks, num_features, optimizer_config,
                                 regularization, normalization=normalization, prior=prior)
        if checkpoint_dir is not None else None
    )
    if ckpt is not None and cross_process:
        ckpt.sync_across_processes()
    # one objective for the sweep (λ is applied outside the stream); FULL
    # keeps the raw chunks, which its densified Hessian pass needs
    sobj = StreamingGLMObjective(
        chunks, loss, num_features=num_features, l2_weight=0.0, intercept_index=intercept_index,
        cross_process=cross_process, norm=normalization,
        prior_mean=None if prior is None else prior.means,
        prior_precision=None if prior is None else prior.precisions,
        tile_sparse=False if variance_computation is VarianceComputationType.FULL else None,
        device=dev,
    )
    for lam in sorted(regularization_weights):
        sobj.l2_weight = float(regularization.l2_weight(lam))
        done_w = ckpt.completed_model(lam) if ckpt is not None else None
        if done_w is not None:
            w, result = done_w, None
        else:
            resume_w = ckpt.partial_iterate(lam) if ckpt is not None else None
            minimize, extra = select_minimize_fn(optimizer_config, regularization.l1_weight(lam), host=True)
            result = minimize(
                sobj, resume_w if resume_w is not None else w, optimizer_config,
                iteration_callback=(
                    None if ckpt is None else lambda it, wi, f: ckpt.save_partial(lam, wi)
                ),
                **extra,
            )
            w = result.w.cpu().numpy()  # warm start for the next λ (normalized space)
            if ckpt is not None:
                ckpt.save_completed(lam, w)

        # variances are not checkpointed: one more streamed pass at the solution
        w_solver = torch.as_tensor(np.asarray(w, np.float32), device=dev)
        variances = compute_variances(sobj, w_solver, variance_computation)
        w_model = w_solver
        if normalization is not None:
            w_model, _ = normalization.model_to_original_space(w_solver)
            if variances is not None:
                variances = normalization.factors**2 * variances
        model = GeneralizedLinearModel(Coefficients(w_model, variances), task)
        models[lam] = model
        if result is not None:
            trackers[lam] = result

        if validation_chunks is not None and specs:
            # validation chunks hold raw features: original-space coefficients
            margins = stream_scores(validation_chunks, w_model, num_rows=len(val_labels),
                                    num_features=num_features, device=dev)
            res = evaluate_all(
                specs,
                torch.as_tensor(margins + val_offsets, device=dev),
                torch.as_tensor(val_labels, device=dev),
                torch.as_tensor(val_weights, device=dev),
            )
            validation[lam] = res
            if primary is not None and (best_weight is None or primary.better(res.primary, best_value)):
                best_weight, best_value = lam, res.primary

    return GLMTrainingResult(
        models=models, trackers=trackers, validation=validation, best_weight=best_weight
    )
