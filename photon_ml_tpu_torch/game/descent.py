"""Coordinate descent over GAME coordinates (port of the eager visit loop
of ``photon_ml_tpu/game/descent.py``).

The loop keeps ``total = offsets + Σ coordinate scores`` and trains each
coordinate on ``total − its own score`` (its residual), then swaps its new
score into the total. A coordinate that is in ``initial_model`` but not in
the update sequence is locked: it keeps contributing its score. With a
validation batch and evaluators, the evolving model is evaluated after
every visit. With a checkpoint directory the model, the scores and the
total are saved after every outer iteration (``checkpoint.py``), and a
rerun resumes at the next one.

Telemetry (``obs``; no-ops with no sink): spans ``descent/iter`` →
``descent/visit``, ``descent/validation`` and ``descent/checkpoint``, and
a ``descent_iteration`` record after every outer iteration.

With a data mesh (``parallel/mesh.py``) the coordinates solve and score
over it, the (n,) vectors live on the mesh's head device, and validation
takes the evaluators' sharded forms (``evaluate_all(mesh=)``). Across
processes process 0 alone writes checkpoints and reads them for a
resume; every process adopts the bytes it broadcasts, so all make the same
decision. The reference's one-program fused outer iteration and
degrade-in-place wait (ROADMAP queue 1 item 10a.6); its peer-loss
handling and degraded-restart fingerprints are item 12d.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

import torch

from photon_ml_tpu_torch.evaluation import EvaluationResults, evaluate_all
from photon_ml_tpu_torch.game.coordinate import Coordinate
from photon_ml_tpu_torch.game.data import GameBatch
from photon_ml_tpu_torch.game.models import GameModel
from photon_ml_tpu_torch.obs import emit_event, span
from photon_ml_tpu_torch.parallel.mesh import Mesh, ProcessMesh, as_process_mesh
from photon_ml_tpu_torch.parallel.multihost import is_output_process
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


@dataclass(frozen=True)
class CoordinateDescentResult:
    model: GameModel
    # validation_history[i][cid]: metrics after training cid in outer iteration i
    validation_history: list[dict[str, EvaluationResults]]
    trackers: dict[str, list[Any]]  # cid → per-visit optimizer trackers
    training_scores: dict[str, Tensor]  # final per-coordinate scores

    @property
    def final_validation(self) -> EvaluationResults | None:
        if not self.validation_history or not self.validation_history[-1]:
            return None
        last = self.validation_history[-1]
        return last[list(last)[-1]]


class CoordinateDescent:
    """Drives coordinates, which share one training ``GameBatch``, through
    residual-offset retraining. With ``mesh`` the coordinates are the
    mesh's (the batch may lie on the host) and the validation batch lies on
    the mesh's head device."""

    def __init__(
        self,
        coordinates: Mapping[str, Coordinate],
        batch: GameBatch,
        task_type: TaskType,
        validation_batch: GameBatch | None = None,
        evaluators: Sequence[str] = (),
        logger: Callable[[str], None] | None = None,
        mesh: Mesh | ProcessMesh | None = None,
    ):
        self.coordinates = dict(coordinates)
        self.batch = batch
        self.task_type = task_type
        self.validation_batch = validation_batch
        self.evaluators = list(evaluators)
        self._log = logger or (lambda msg: None)
        self.mesh = None if mesh is None else as_process_mesh(mesh)

    def run(
        self,
        update_sequence: Sequence[str],
        num_iterations: int,
        initial_model: GameModel | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_fingerprint: str | None = None,
    ) -> CoordinateDescentResult:
        """``checkpoint_dir`` makes the descent resumable: a checkpoint is
        saved after every outer iteration, and one already in the directory
        restarts the descent at its next iteration. A stored checkpoint
        whose fingerprint is not ``checkpoint_fingerprint`` (which names the
        training setup) is ignored. When the stored data digest differs from
        this batch's, the model resumes and the scores are recomputed."""
        for cid in update_sequence:
            if cid not in self.coordinates:
                raise KeyError(f"update sequence names unknown coordinate {cid!r}")
        dev = self.batch.device if self.mesh is None else self.mesh.head
        model = initial_model or GameModel(models={}, task_type=self.task_type)
        start_iteration = 0
        ckpt = digest = None
        if checkpoint_dir is not None:
            # imported here: checkpoint.py imports game.models, so game/ itself
            from photon_ml_tpu_torch.checkpoint import batch_digest, load_checkpoint

            digest = batch_digest(self.batch.labels, self.batch.weights)
            ckpt = load_checkpoint(
                checkpoint_dir, fingerprint=checkpoint_fingerprint, data_digest=digest, device=dev,
                across_processes=self.mesh is not None,
            )
            if ckpt is not None:
                model = ckpt.model
                start_iteration = ckpt.next_iteration
                self._log(
                    f"resuming coordinate descent from checkpoint at outer iteration {start_iteration}"
                )
        trackers: dict[str, list[Any]] = {cid: [] for cid in update_sequence}
        validation_history: list[dict[str, EvaluationResults]] = []
        scores: dict[str, Tensor] = {}
        if ckpt is not None and ckpt.scores is not None and ckpt.total is not None:
            # the stored residual exchange, exactly (recomputed scores differ
            # by float re-association, which the entity solvers amplify)
            scores = {cid: torch.from_numpy(s).to(dev) for cid, s in ckpt.scores.items()}
            total = torch.from_numpy(ckpt.total).to(dev)
        else:
            # warm-start scores of every coordinate already in the model,
            # locked ones (not in the update sequence) included
            for cid, sub in model.models.items():
                coord = self.coordinates.get(cid)
                if coord is not None:
                    scores[cid] = coord.score(sub)
                else:  # a locked coordinate scores where the batch lies
                    scores[cid] = sub.to(self.batch.device).score(self.batch).to(dev)
            total = self.batch.offsets.to(dev)
            for s in scores.values():
                total = total + s

        validate = self.validation_batch is not None and bool(self.evaluators)
        for it in range(start_iteration, num_iterations):
            iter_validation: dict[str, EvaluationResults] = {}
            with span("descent/iter", iteration=it):
                for cid in update_sequence:
                    coord = self.coordinates[cid]
                    with span("descent/visit", iteration=it, coordinate=cid):
                        offsets = total - scores[cid] if cid in scores else total
                        sub_model, tracker = coord.train(offsets, model.models.get(cid))
                        new_score = coord.score(sub_model)
                        total = offsets + new_score
                        scores[cid] = new_score
                        model = model.updated(cid, sub_model)
                        if trackers[cid]:
                            # keep per-entity diagnostics of the latest visit only
                            release = getattr(trackers[cid][-1], "release_device_diagnostics", None)
                            if release is not None:
                                release()
                        trackers[cid].append(tracker)
                    if validate:
                        vb = self.validation_batch
                        with span("descent/validation", iteration=it, coordinate=cid):
                            res = evaluate_all(
                                self.evaluators, model.score(vb), vb.labels, vb.weights,
                                group_ids=vb.id_tags, mesh=self.mesh,
                            )
                        iter_validation[cid] = res
                        self._log(f"iter {it} coordinate {cid}: {res}")
                    else:
                        self._log(f"iter {it} coordinate {cid}: trained")
                validation_history.append(iter_validation)
                emit_event("descent_iteration", iteration=it)
                if checkpoint_dir is not None and is_output_process():
                    from photon_ml_tpu_torch.checkpoint import save_checkpoint

                    with span("descent/checkpoint", iteration=it):
                        save_checkpoint(
                            checkpoint_dir, model, next_iteration=it + 1,
                            fingerprint=checkpoint_fingerprint,
                            scores=scores, total=total, data_digest=digest,
                        )
        return CoordinateDescentResult(
            model=model, validation_history=validation_history, trackers=trackers,
            training_scores=scores,
        )
