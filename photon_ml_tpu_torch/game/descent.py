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
decision. The reference's one-program fused outer iteration waits
(ROADMAP queue 1 item 10a.6).

Peer loss (ROADMAP 12d-v-a). Each outer iteration is a transaction: a
``multihost.PeerLost`` inside it either aborts ``run`` with the
restart-from-checkpoint message (``PHOTON_DESCENT_DEGRADE`` unset, the
default) or, with the knob on, degrades in place: a roll call confirms
the loss, the group shrinks to the survivors, every coordinate drops its
prepared state (owned random-effect buckets re-plan over the survivors at
the next visit) and the iteration runs again from its start, so ``run``
returns normally and the model is bitwise a clean run over the survivors
resumed from the same state. A roll call that finds every peer alive (a
link flap) re-runs the iteration, at most ``_MAX_FLAP_RETRIES`` times in a
row. A coordinate spanning the device mesh (a mesh fixed effect, lanes
sharded over a mesh) and validation over the mesh cannot shrink and keep
the abort. ``resume_fingerprints`` lets a degraded restart resume from a
checkpoint of the layout before the loss.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

import torch

from photon_ml_tpu_torch.evaluation import EvaluationResults, evaluate_all
from photon_ml_tpu_torch.game.coordinate import Coordinate
from photon_ml_tpu_torch.game.data import GameBatch
from photon_ml_tpu_torch.game.models import GameModel
from photon_ml_tpu_torch.obs import emit_event, span
from photon_ml_tpu_torch.obs.metrics import REGISTRY
from photon_ml_tpu_torch.parallel import multihost as mh
from photon_ml_tpu_torch.parallel.mesh import Mesh, ProcessMesh, as_process_mesh, effective_mesh
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor

# in-place degrade of the descent on a peer loss (``PHOTON_DESCENT_DEGRADE``;
# the environment wins over this module value, read at call time)
DESCENT_DEGRADE = 0

# iteration re-runs in a row for roll calls that find every peer alive (a
# link flap): the ring collectives have no retry of their own, so the re-run
# absorbs the transient, bounded so a flapping link still surfaces
_MAX_FLAP_RETRIES = 3


def descent_degrade_enabled() -> bool:
    """``PHOTON_DESCENT_DEGRADE`` (strict int parse: a typo raises rather
    than silently keeping the abort on a loss)."""
    env = os.environ.get("PHOTON_DESCENT_DEGRADE")
    if env is not None and env != "":
        return int(env) != 0
    return int(DESCENT_DEGRADE) != 0


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
        resume_fingerprints: Sequence[str] = (),
    ) -> CoordinateDescentResult:
        """``checkpoint_dir`` makes the descent resumable: a checkpoint is
        saved after every outer iteration, and one already in the directory
        restarts the descent at its next iteration. A stored checkpoint
        whose fingerprint is not ``checkpoint_fingerprint`` (which names the
        training setup) is ignored, unless it is one of
        ``resume_fingerprints`` (a degraded restart from a checkpoint of the
        layout before a loss). When the stored data digest differs from
        this batch's, the model resumes and the scores are recomputed."""
        for cid in update_sequence:
            if cid not in self.coordinates:
                raise KeyError(f"update sequence names unknown coordinate {cid!r}")
        try:
            return self._run(update_sequence, num_iterations, initial_model, checkpoint_dir,
                             checkpoint_fingerprint, resume_fingerprints)
        except mh.PeerLost as e:
            raise self._peer_lost_error(e, checkpoint_dir) from e

    @staticmethod
    def _peer_lost_error(e: "mh.PeerLost", checkpoint_dir) -> RuntimeError:
        """The abort on a loss the descent does not degrade around (after
        its ``peer_lost`` event): an instruction to restart on the survivors
        from the per-iteration checkpoint, in place of a timeout."""
        emit_event("peer_lost", peer=int(e.peer), error=str(e))
        hint = (f"resume from the last per-iteration checkpoint in {checkpoint_dir!r} by restarting on the "
                "surviving hosts" if checkpoint_dir is not None else
                "re-run with checkpoint_dir set to make the restart resume instead of retrain")
        return RuntimeError(
            f"in-memory coordinate descent lost process {e.peer}: the mesh-spanning executables cannot degrade "
            f"in place — {hint} (set PHOTON_DESCENT_DEGRADE=1 with owned random-effect buckets to degrade in "
            "place; the streamed trainer recovers from its checkpoint)")

    def _run(self, update_sequence, num_iterations, initial_model, checkpoint_dir, checkpoint_fingerprint,
             resume_fingerprints) -> CoordinateDescentResult:
        dev = self.batch.device if self.mesh is None else self.mesh.head
        model = initial_model or GameModel(models={}, task_type=self.task_type)
        start_iteration = 0
        ckpt = digest = None
        if checkpoint_dir is not None:
            # imported here: checkpoint.py imports game.models, so game/ itself
            from photon_ml_tpu_torch.checkpoint import batch_digest, load_checkpoint

            digest = batch_digest(self.batch.labels, self.batch.weights)
            # None keeps its accept-anything meaning; else the primary and the collection
            accepted: Any = checkpoint_fingerprint
            if checkpoint_fingerprint is not None and resume_fingerprints:
                accepted = (checkpoint_fingerprint, *resume_fingerprints)
            ckpt = load_checkpoint(
                checkpoint_dir, fingerprint=accepted, data_digest=digest, device=dev,
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

        it = start_iteration
        flap_retries = 0
        while it < num_iterations:
            # the start-of-iteration state: nothing below writes a tensor of it
            # in place, so holding the references is the snapshot
            snap_model, snap_scores, snap_total = model, dict(scores), total
            snap_trackers = {cid: len(trackers[cid]) for cid in update_sequence}
            snap_history = len(validation_history)
            try:
                model, scores, total = self._run_one_iteration(
                    it, update_sequence, model, scores, total, trackers, validation_history, checkpoint_dir,
                    checkpoint_fingerprint, digest)
            except mh.PeerLost as e:
                if not descent_degrade_enabled():
                    raise
                if not self._degrade_in_place(e, it):
                    flap_retries += 1
                    if flap_retries > _MAX_FLAP_RETRIES:
                        raise RuntimeError(
                            f"in-memory descent iteration {it}: links flapped {flap_retries} times with every "
                            "peer alive — raise PHOTON_P2P_RETRIES/BACKOFF_S rather than retrying the "
                            "iteration forever") from e
                # back to the start of the iteration, over the (maybe shrunk) group
                model, scores, total = snap_model, dict(snap_scores), snap_total
                for cid in update_sequence:
                    del trackers[cid][snap_trackers[cid]:]
                del validation_history[snap_history:]
                continue
            flap_retries = 0
            it += 1
        return CoordinateDescentResult(
            model=model, validation_history=validation_history, trackers=trackers,
            training_scores=scores,
        )

    def _run_one_iteration(self, it, update_sequence, model, scores, total, trackers, validation_history,
                           checkpoint_dir, checkpoint_fingerprint, digest):
        """One outer iteration, the unit the degrade in place rolls back:
        returns the advanced (model, scores, total)."""
        validate = self.validation_batch is not None and bool(self.evaluators)
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
            if checkpoint_dir is not None and mh.is_output_process():
                from photon_ml_tpu_torch.checkpoint import save_checkpoint

                with span("descent/checkpoint", iteration=it):
                    save_checkpoint(
                        checkpoint_dir, model, next_iteration=it + 1,
                        fingerprint=checkpoint_fingerprint,
                        scores=scores, total=total, data_digest=digest,
                    )
        return model, scores, total

    def _degrade_in_place(self, err, iteration: int) -> bool:
        """The ``PHOTON_DESCENT_DEGRADE`` handler: confirm the loss with a
        roll call, shrink the group to the survivors and drop every
        coordinate's prepared state, without leaving ``run``. True when
        the group shrank, False when every peer answered (a link flap: the
        roll call rebuilt the mesh, the caller re-runs the iteration). A
        coordinate or a validation that spans the device mesh cannot shrink:
        the loss then goes on to the abort."""
        self._log(f"iteration {iteration}: peer loss (process {getattr(err, 'peer', -1)}) — starting roll call")
        group, survivors, lost = mh.confirm_peer_loss(err)
        if not lost:
            emit_event("descent_retry", iteration=iteration, group=list(group))
            self._log(f"iteration {iteration}: roll call found every process alive (links flapped) — re-running "
                      "the iteration over the rebuilt mesh")
            return False
        # judged only once a loss is confirmed: a flap needs no shrinking
        blockers = [getattr(coord, "_degrade_blocker", lambda: None)() for coord in self.coordinates.values()]
        if self.mesh is not None and self.validation_batch is not None and self.evaluators:
            blockers.append("validation evaluates over the full device mesh")
        for blocker in blockers:
            if blocker is not None:
                self._log(f"iteration {iteration}: lost processes {lost} with PHOTON_DESCENT_DEGRADE=1, but "
                          f"{blocker} — falling back to the abort path")
                raise err
        mh.set_degraded_group(survivors)
        if self.mesh is not None:
            self.mesh = effective_mesh(self.mesh)
        for coord in self.coordinates.values():
            reset = getattr(coord, "_reset_compiled_state", None)
            if reset is not None:
                reset()
        REGISTRY.counter_inc("fleet.degraded_descents")
        emit_event("degraded_descent", iteration=iteration, survivors=[int(s) for s in survivors],
                   lost=[int(p) for p in lost])
        self._log(f"iteration {iteration}: lost processes {lost}, surviving group {survivors} — degraded in "
                  "place, re-running the iteration over the survivor set")
        return True
