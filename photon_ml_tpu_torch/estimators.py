"""GAME estimator: a grid of coordinate-descent fits and model selection
(port of ``GameEstimator`` in ``photon_ml_tpu/estimators.py``).

Everything that does not depend on the optimization configuration (data
validation, per-shard normalization statistics, entity grouping and
bucketing) is done once per ``fit`` and shared by every grid entry; the
random-effect coordinates' bucket tensors are gathered on the device once
and shared too. With ``checkpoint_dir`` each grid entry checkpoints its
descent under ``config-NNNN/``, fingerprinted by the reference's recipe
(the same string for the same configuration and data), so either package
resumes the other's checkpoints.

With a data ``mesh`` (``parallel/mesh.py``: row shards of one process, or
of every process of a group, each holding the same replicated batch) the
mesh reaches every coordinate and the descent, as in the reference; the
batches may then lie on the host, and only each process's shards go to
its devices (the validation batch to the mesh's head device).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch._device import check_device
from photon_ml_tpu_torch.checkpoint import batch_digest
from photon_ml_tpu_torch.config import (
    GameTrainingConfig,
    OptimizationConfig,
    RandomEffectCoordinateConfig,
)
from photon_ml_tpu_torch.data.summary import shard_normalization_context, summarize
from photon_ml_tpu_torch.data.validation import validate_game_batch
from photon_ml_tpu_torch.evaluation import (
    DEFAULT_EVALUATOR_BY_TASK,
    EvaluationResults,
    evaluate_all,
    make_evaluator,
)
from photon_ml_tpu_torch.game.coordinate import (
    Coordinate,
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.data import (
    EntityBuckets,
    EntityGrouping,
    GameBatch,
    bucket_entities,
    group_by_entity,
)
from photon_ml_tpu_torch.game.descent import CoordinateDescent, CoordinateDescentResult
from photon_ml_tpu_torch.game.models import GameModel
from photon_ml_tpu_torch.game.projector import RandomProjector
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.parallel.mesh import Mesh, ProcessMesh, as_process_mesh
from photon_ml_tpu_torch.sampling import down_sample
from photon_ml_tpu_torch.types import NormalizationType

# One grid entry: per-coordinate optimization configurations.
GameOptimizationConfiguration = Mapping[str, OptimizationConfig]


@dataclass(frozen=True)
class GameResult:
    """One grid entry's outcome: the model, its validation evaluation (None
    without a validation batch), its configuration and the descent record."""

    model: GameModel
    evaluation: EvaluationResults | None
    configuration: dict[str, OptimizationConfig]
    descent: CoordinateDescentResult


def build_configuration_grid(config: GameTrainingConfig) -> list[dict[str, OptimizationConfig]]:
    """The cross-product of the per-coordinate regularization-weight lists
    (``regularization_weight_grid``); a coordinate without a list keeps its
    one configured weight."""
    cids = list(config.coordinate_update_sequence)
    unknown = set(config.regularization_weight_grid) - set(cids)
    if unknown:
        raise ValueError(
            f"regularization_weight_grid names unknown coordinate(s) {sorted(unknown)}; "
            f"update sequence is {cids}"
        )
    axes: list[list[OptimizationConfig]] = []
    for cid in cids:
        base = config.coordinate_config(cid).optimization
        weights = config.regularization_weight_grid.get(cid)
        if weights:
            axes.append([dataclasses.replace(base, regularization_weight=float(w)) for w in weights])
        else:
            axes.append([base])
    return [dict(zip(cids, combo)) for combo in itertools.product(*axes)]


# GameTrainingConfig fields that do not change the optimization trajectory:
# left out of the checkpoint fingerprint, so a rerun that only extends the
# iterations (resume and extend), or changes the evaluators or the output
# mode, still resumes
_NON_TRAJECTORY_CONFIG_FIELDS = (
    "coordinate_descent_iterations",
    "evaluators",
    "output_mode",
    "hyperparameter_tuning_iters",
    "model_input_dir",  # the warm-start model itself is hashed by value
)


def _fingerprint_base(
    config: GameTrainingConfig,
    batch: GameBatch,
    seed: int,
    initial_model: GameModel | None,
) -> dict:
    """The part of the checkpoint fingerprint that every grid entry shares:
    the trajectory-affecting config fields, the seed, a hash of the
    warm-start coefficients and a cheap signature of the data."""
    warm = None
    if initial_model is not None:
        warm = {
            cid: hashlib.sha256(
                np.ascontiguousarray(sub.coefficient_means.detach().cpu().numpy()).tobytes()
            ).hexdigest()
            for cid, sub in sorted(initial_model.models.items())
        }
    cfg_dict = config.to_dict()
    for key in _NON_TRAJECTORY_CONFIG_FIELDS:
        cfg_dict.pop(key, None)
    return {
        "training_config": cfg_dict,
        "seed": seed,
        "initial_model": warm,
        "data": {
            "num_rows": batch.num_rows,
            "digest": batch_digest(batch.labels, batch.weights),
            "shards": {sid: feats.num_features for sid, feats in sorted(batch.features.items())},
        },
    }


def _fit_fingerprint(base: dict, configuration: GameOptimizationConfiguration) -> str:
    """One grid entry's fingerprint: the shared base and its own
    per-coordinate optimization configs."""
    payload = dict(base, configuration={cid: oc.to_dict() for cid, oc in configuration.items()})
    return hashlib.sha256(json.dumps(payload, sort_keys=True, default=str).encode()).hexdigest()


class GameEstimator:
    """Fits GAME models over a grid of optimization configurations.

    ``intercept_indices`` maps feature-shard id → intercept column (None or
    absent: no intercept). ``device`` is where the batches must lie (CUDA
    unless the caller asks for another; raises without it). With ``mesh``
    the fit runs over its shards and the batches may lie anywhere."""

    def __init__(
        self,
        config: GameTrainingConfig,
        intercept_indices: Mapping[str, int | None] | None = None,
        logger: Callable[[str], None] | None = None,
        seed: int = 0,
        device=None,
        mesh: Mesh | ProcessMesh | None = None,
    ):
        self.config = config
        self.intercept_indices = dict(intercept_indices or {})
        self._log = logger or (lambda msg: None)
        self.seed = seed
        self.device = device
        self.mesh = None if mesh is None else as_process_mesh(mesh)

    # -- ingest-time preparation (the same for every grid entry) ---------------
    def _normalization_contexts(self, batch: GameBatch) -> dict[str, NormalizationContext]:
        """A context for every shard the coordinates read, random-effect
        shards included (their entity solves apply it inside the objective)."""
        if self.config.normalization is NormalizationType.NONE:
            return {}
        shard_ids = {c.feature_shard_id for c in self.config.fixed_effect_coordinates.values()} | {
            c.feature_shard_id for c in self.config.random_effect_coordinates.values()
        }
        return {
            sid: shard_normalization_context(
                summarize(batch.batch_for(sid)), self.config.normalization, sid,
                self.intercept_indices.get(sid), log=self._log, device=batch.device,
            )
            for sid in sorted(shard_ids)
        }

    def _entity_layouts(self, batch: GameBatch) -> dict[str, tuple[EntityGrouping, EntityBuckets, int]]:
        """Group and bucket each random effect's entities (host numpy, once)."""
        layouts = {}
        for cid, cfg in self.config.random_effect_coordinates.items():
            ids = batch.id_tags[cfg.random_effect_type].cpu().numpy()
            num_entities = int(ids.max()) + 1 if len(ids) else 0
            grouping = group_by_entity(
                ids, num_entities=num_entities, active_upper_bound=cfg.active_data_upper_bound,
                seed=self.seed,
            )
            buckets = bucket_entities(
                grouping, cfg.sample_bucket_sizes, target_buckets=cfg.bucket_target_count,
                max_padded_ratio=cfg.bucket_max_padded_ratio,
            )
            layouts[cid] = (grouping, buckets, num_entities)
        return layouts

    def _build_coordinates(
        self,
        batch: GameBatch,
        configuration: GameOptimizationConfiguration,
        norm_contexts: Mapping[str, NormalizationContext],
        entity_layouts: Mapping[str, tuple[EntityGrouping, EntityBuckets, int]],
        re_coordinate_cache: dict[str, RandomEffectCoordinate] | None = None,
        prior_model: GameModel | None = None,
    ) -> dict[str, Coordinate]:
        """The coordinates of one grid entry. ``re_coordinate_cache`` shares
        each random effect's prepared bucket tensors across entries (only the
        optimization config changes)."""
        coordinates: dict[str, Coordinate] = {}
        task = self.config.task_type
        for cid in self.config.coordinate_update_sequence:
            opt = configuration[cid]
            cc = self.config.coordinate_config(cid)
            prior = None if prior_model is None else prior_model.models.get(cid)
            intercept = self.intercept_indices.get(cc.feature_shard_id)
            common = dict(
                coordinate_id=cid, batch=batch, feature_shard_id=cc.feature_shard_id, config=opt,
                task_type=task, intercept_index=intercept,
                normalization=norm_contexts.get(cc.feature_shard_id),
                variance_computation=self.config.variance_computation, prior_model=prior,
            )
            if isinstance(cc, RandomEffectCoordinateConfig):
                if re_coordinate_cache is not None and cid in re_coordinate_cache:
                    coordinates[cid] = re_coordinate_cache[cid].with_config(opt)
                    continue
                grouping, buckets, num_entities = entity_layouts[cid]
                projector = None
                if cc.random_projection_dim is not None:
                    projector = RandomProjector.build(
                        batch.features[cc.feature_shard_id].num_features, cc.random_projection_dim,
                        seed=self.seed, device=batch.device if self.mesh is None else self.mesh.head,
                    )
                coord = RandomEffectCoordinate(
                    random_effect_type=cc.random_effect_type, grouping=grouping, buckets=buckets,
                    num_entities=num_entities,
                    features_to_samples_ratio=cc.features_to_samples_ratio_upper_bound,
                    projector=projector, mesh=self.mesh, **common,
                )
                if re_coordinate_cache is not None:
                    re_coordinate_cache[cid] = coord
                coordinates[cid] = coord
            else:
                train_rows = weight_scale = None
                if opt.down_sampling_rate < 1.0:
                    rows, scale = down_sample(
                        task, batch.labels.cpu().numpy(), opt.down_sampling_rate, seed=self.seed
                    )
                    train_rows = torch.as_tensor(rows, dtype=torch.int64, device=batch.device)
                    weight_scale = None if scale is None else torch.as_tensor(scale, device=batch.device)
                coordinates[cid] = FixedEffectCoordinate(
                    train_rows=train_rows, train_weight_scale=weight_scale, mesh=self.mesh, **common
                )
        return coordinates

    # -- fit -------------------------------------------------------------------
    def _evaluator_specs(self) -> tuple[str, ...]:
        return tuple(self.config.evaluators) or (DEFAULT_EVALUATOR_BY_TASK[self.config.task_type],)

    def fit(
        self,
        batch: GameBatch,
        validation_batch: GameBatch | None = None,
        configurations: Sequence[GameOptimizationConfiguration] | None = None,
        initial_model: GameModel | None = None,
        checkpoint_dir: str | None = None,
    ) -> list[GameResult]:
        """One GAME model per grid configuration (default: the
        ``regularization_weight_grid`` cross-product). ``initial_model``
        warm-starts every entry and, with ``incremental``, is each
        coordinate's Gaussian MAP prior. ``checkpoint_dir`` checkpoints entry
        i's descent after every outer iteration under
        ``checkpoint_dir/config-{i:04d}`` and resumes from what is there."""
        if self.mesh is None:
            check_device(batch.device, self.device)
            if validation_batch is not None:
                check_device(validation_batch.device, self.device)
        elif validation_batch is not None:
            validation_batch = validation_batch.to(self.mesh.head)
        cfg = self.config
        validate_game_batch(batch, cfg.task_type, cfg.data_validation, self.seed)
        if validation_batch is not None:
            validate_game_batch(validation_batch, cfg.task_type, cfg.data_validation, self.seed)
        if configurations is None:
            configurations = build_configuration_grid(cfg)

        norm_contexts = self._normalization_contexts(batch)
        entity_layouts = self._entity_layouts(batch)
        specs = self._evaluator_specs()
        fingerprint_base = (
            None if checkpoint_dir is None
            else _fingerprint_base(cfg, batch, self.seed, initial_model)
        )
        results: list[GameResult] = []
        re_cache: dict[str, RandomEffectCoordinate] = {}
        for i, configuration in enumerate(configurations):
            self._log(f"grid entry {i + 1}/{len(configurations)}: {configuration}")
            coordinates = self._build_coordinates(
                batch, configuration, norm_contexts, entity_layouts, re_coordinate_cache=re_cache,
                prior_model=initial_model if cfg.incremental else None,
            )
            descent = CoordinateDescent(
                coordinates, batch, cfg.task_type, validation_batch=validation_batch,
                evaluators=specs if validation_batch is not None else (), logger=self._log,
                mesh=self.mesh,
            )
            cd_result = descent.run(
                cfg.coordinate_update_sequence, cfg.coordinate_descent_iterations,
                initial_model=initial_model,
                checkpoint_dir=None if checkpoint_dir is None else f"{checkpoint_dir}/config-{i:04d}",
                checkpoint_fingerprint=(
                    None if fingerprint_base is None
                    else _fit_fingerprint(fingerprint_base, configuration)
                ),
            )
            evaluation = None
            if validation_batch is not None:
                evaluation = evaluate_all(
                    specs, cd_result.model.score(validation_batch), validation_batch.labels,
                    validation_batch.weights, group_ids=validation_batch.id_tags, mesh=self.mesh,
                )
                self._log(f"grid entry {i + 1}: validation {evaluation}")
            results.append(
                GameResult(
                    model=cd_result.model, evaluation=evaluation,
                    configuration=dict(configuration), descent=cd_result,
                )
            )
        return results

    def select_best(self, results: Sequence[GameResult]) -> GameResult:
        """The entry with the best primary validation metric; the first one
        when nothing was evaluated."""
        primary = make_evaluator(self._evaluator_specs()[0])
        best = None
        for r in results:
            if r.evaluation is None:
                continue
            if best is None or primary.better(r.evaluation.primary, best.evaluation.primary):
                best = r
        return best if best is not None else results[0]
