#!/usr/bin/env python3
"""Drive the PyTorch port's dense and high-dimensional sparse GLM training
paths, its GAME mixed-effect training path (random effects on damped
Newton, on the default lane solvers and in per-entity subspaces and random
projections), its GAME train and score drivers on Avro files, read by
the native columnar decoder, its out-of-core GLM and GAME paths (host
data streamed through the card), and its data-parallel GLM and GAME
paths (shards of the card, and two processes over gloo, in memory and
out of core) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the CUDA kernels from
``photon_ml_tpu_torch/csrc`` and prints one JSON line per phase:

1. device: the card's name and power limit;
2. build: the kernels compiled with nvcc for sm_90a (one nvcc per source,
   started together), with the spill lines of each source's report, and
   beside them the native Avro decoder with g++;
3. parity: K1 (fused value+gradient) and K2 (fused Hessian-vector)
   against their plain PyTorch versions on the card, at the headline shape
   (n = 2^20, d = 512, bfloat16 X), config B's (n = 2^20, d = 256,
   float32), a ragged one (n = 2^20 - 37, d = 124, both storage types) and
   GAME's width (n = 2^20, d = 65, float32; n = 2^20 - 37, d = 65,
   bfloat16), over all four losses, with and without offsets and weights
   (zero-weight rows included), with each line naming K1's layout; K1
   repeats bitwise at the headline and at d = 65, K2 at config B and the
   ragged d = 124; then each kernel's time at the shape the main path gives
   it (card, device and enqueue ms), beside its plain version, one
   PyTorch-library computation of the same function, and the least time
   the card could take; then ``timing_k1_layouts``: K1 in both of its
   layouts at d = 65, 124, 128 and 256 (n = 2^20, both storage types),
   each with its device time from ``torch.profiler``;
4. main_a: ``train_glm`` on the headline logistic problem (L-BFGS, 30
   iterations, lambda = 1), then a warm-started 3-lambda sweep with
   validation at the same width; then main_a_sharded: the same solve
   through ``DistributedTrainer`` over ``data_mesh(num_shards=4)`` (4 row
   shards of the card, which it prints), K1 = 4 x the objective passes,
   against main_a |dAUC| <= 0.005 and relative d(objective) <= 1e-3, a
   second run bitwise equal, the wall per pass beside main_a's;
5. main_b: ``train_glm`` with TRON on config B's linear problem (15
   iterations);
6. agreement: A and B again with the kernels vetoed
   (``PHOTON_DISABLE_FUSED=1``), held to |dAUC| <= 0.005, relative
   d(objective) <= 1e-3 and, for B, relative dRMSE <= 1e-4;
7. parity_k3: K3 (the sparse kernel) against its plain version in all
   three directions (margins, gradient, squared gradient) on every storage
   rung, at config A2's shape (n = 2^19, d = 2^17, 32 nonzeros a row), a
   ragged one, one with duplicate (row, column) pairs and one whose
   columns follow a power law (a few columns hold tens of thousands of
   nonzeros); f32 within rtol = atol = 1e-5, bf16 / int8 within
   1e-5 x max|plain|; and K3 repeats bitwise at A2;
8. timing_k3: each direction at A2 on each rung, beside its plain version,
   cuSPARSE (``torch.sparse_csr_tensor @ src``) on the same matrix, the
   bytes per nonzero, the kernel's tile metadata and carry bytes and the
   least time the card could take; then on f32 the power-law shape (with
   its heaviest column's count) and A2 with every read index set to 0
   (``timing_k3_streams_only``: the streams without the gathers' spread),
   after ``gather_floor``: 2^24 random gathers alone from a source of A2's
   sizes, from a probe built here, each K3 row's least time on this
   layout beside its bytes bound;
9. main_a2: config A2 (logistic, L-BFGS 30 iterations, lambda = 1, SIMPLE
   variances), generated on the card as bench.py generates it, through
   ``optimize_batch_layout`` (which must pick the sparse kernel's layout)
   and ``train_glm``; train AUC >= 0.98 x the AUC of the true weights;
   then main_a2_sharded: the same data over 4 row shards of the card, one
   K3 layout each (``sharded_objective``), L-BFGS 30 iterations and SIMPLE
   variances: K3 = 4 x (passes + 1) margins and gradients and 4 squared
   gradients, against main_a2 |dAUC| <= 1e-3 and relative d(objective)
   <= 1e-4;
10. agreement_a2: the same solve on the gather/scatter ``SparseBatch``
   (|dAUC| <= 1e-3, relative d(objective) <= 1e-4), and on the bf16 and
   int8 rungs against f32 (|dAUC| <= 0.005 / 0.01, relative d(loss) <=
   1e-3 / 5e-3), each timed after a warm-up solve;
11. main_d: config D (bench.py ``bench_d_game_fixed``: logistic, n = 2^18,
   64 features and an intercept, the fixed coordinate alone, L-BFGS 20
   iterations at tolerance 1e-7) through ``GameEstimator.fit`` for one
   outer iteration; its coefficients equal ``train_glm``'s on the same
   batch within atol 1e-4, and K1's launches equal the objective passes;
   then K1 alone at D's shape (2^18 x 65, float32, offsets not read), in
   both layouts, beside its plain version, the library yardstick and its
   bound;
12. main_e: config E's widths at MovieLens-20M depth (20,000,263 rows,
   138,493 users and 27,278 items with 8 features each, Zipf skew 1.5,
   generated on the card): fixed (L-BFGS 20 iterations, no
   regularization), per-user and per-item random effects (damped Newton
   20 iterations, L2 1, capacity ladder merged toward 8 buckets at 0.5
   padding) through ``GameEstimator.fit``, 2 warm-up outer iterations and
   4 timed ones; wall per outer iteration and per coordinate visit, the
   buckets and their Newton iterations, K1's launches against the fixed
   effect's objective passes, train AUC >= 0.95 x the generating model's;
   then K1 alone at that shape (20,000,263 x 65, float32, offsets read) as
   at D's; K1 must take its tiles layout at both shapes;
12b. main_e_sharded: main_e's batch and schedule over a data mesh of 4
   shards of the card (the fixed effect row-sharded, K1 once per shard a
   pass; each bucket's entity lanes split over the shards), then the same
   fit again: K1 = 4 x the fixed effect's passes, the repeat bitwise
   equal, against main_e |dAUC| <= 0.005, relative d(fixed objective)
   <= 1e-3 and the random effects within atol 2e-3 / rtol 1e-2; the wall
   per outer iteration beside main_e's and each visit's seconds in the
   shard reductions; then main_e_multihost: two processes of this script
   on the card, 2 local shards each of a 4-shard mesh across them, each
   drawing main_e's rows on the card and keeping the replicated copy on
   the host: both processes' models bitwise equal and bitwise equal to
   main_e_sharded, K1 = 2 x passes in each, each process's peak device
   memory below main_e's; the wall per outer iteration and each visit's
   seconds in gloo collectives and in the score row gather (and its
   bytes);
13. agreement_e: config E at bench.py's own shape (n = 2^18, 20,000 users
   and 4,000 items), 4 outer iterations on K1 and again with the kernels
   vetoed (which must launch none): |dAUC| <= 0.005 and relative d(training
   log-loss) <= 1e-3;
14. main_e_lbfgs: main_e's batch and schedule with the random effects on
   lane-batched L-BFGS (the default solver type, at the fixed effect's
   20 iterations and tolerance 1e-7, L2 1): wall per outer iteration and
   per visit, each visit's read-backs (host reads of a CUDA tensor's
   value), per bucket the lanes, capacity, lane iterations and line-search
   steps, the peak memory, the profile of its second outer iteration (as
   main_e's); train AUC >= 0.95 x the generating model's,
   and against main_e's Newton fit |dAUC| <= 0.005 and relative d(training
   log-loss) <= 1e-3;
15. agreement_e_solvers: config E at bench.py's shape, 4 outer iterations
   with the random effects on (a) L-BFGS, (b) TRON, (c) OWL-QN through
   ELASTIC_NET (alpha 0.5, weight 1) and (d) L-BFGS over the per-user
   shard handed over as SparseFeatures (8 nonzeros a row, the same
   values). (a) and (b) against agreement_e's Newton fit: |dAUC| <= 0.005,
   relative d log-loss <= 1e-3; (c) train AUC >= 0.95 x the generating
   model's, its exact zeros reported; (d) against (a): |dAUC| and relative
   d log-loss <= 1e-4 and coefficients within atol 2e-3 / rtol 1e-2 (a
   lane near a float32 stopping threshold meets it one iteration apart
   under another summation order: about 5e-4); for 16 entities per effect
   in each variant, the last visit's lane solution against the port's
   single-GLM solver on that entity's rows with the visit's residual
   offsets and warm start, atol 2e-3 / rtol 1e-2; in (a) the validation
   metrics MULTI_AUC(userId), PRECISION_AT_K(5,userId) and BUCKETED_AUC,
   computed on the card, against the numpy host versions (|d| <= 1e-6)
   and the exact AUC (|d| <= 1e-4);
15b. main_e_projected: main_e_lbfgs's batch and schedule with each user in
   the subspace of its ceil(capacity / 4) most frequent columns and the
   items over a shared random projection to 4 of their 8 columns: wall per
   outer iteration and per visit, each bucket's solve width, the peak
   memory; train AUC >= 0.95 x the generating model's (its difference from
   main_e_lbfgs reported, not gated); the stored original-space item
   coefficients score as (XP)·w_p of the lane solutions on the card, within
   1e-5 x the largest score;
15c. main_e_streamed: main_e's rows copied to host numpy and trained out
   of core by ``StreamedGameTrainer`` (2 outer iterations, chunks of 2^20
   rows: 20, the last 77,319 rows and padding; the fixed effect streamed
   through K1, the random effects' buckets gathered on the host into pinned
   memory every visit), against an in-memory ``GameEstimator`` fit of the
   same configuration on the same rows: |dAUC| <= 0.005 and relative
   d(training log-loss) <= 1e-3, train AUC >= 0.95 x the generating
   model's, K1's launches = 20 x the fixed effect's value-and-gradient
   passes on its tiles layout and nothing else launched, the second fixed
   visit missing the chunk cache once a chunk (its offsets; X stays
   resident); wall per outer iteration and per visit, each visit's cache
   hits and misses and bytes copied, each random-effect visit's host gather
   seconds, copy bytes and read-backs, peak device memory and host RSS, the
   card's busy share over a profiled second iteration, and K1 alone at the
   chunk's shape (2^20 x 65, float32, offsets read) against its plain
   version;
15d. main_e_streamed_multihost: main_e_streamed's problem at the same
   width and depth in two processes of this script on the card (gloo over
   loopback), each drawing main_e's rows from the seed on the card and
   keeping one contiguous half (10,000,131 and 10,000,132 rows) on its
   host: ``StreamedGameTrainer(multihost=True)``, each process streaming
   its own 10 chunks through K1 with every pass summed over the
   processes, each entity's rows exchanged to its owner (entity % 2) once
   and the offsets and scores every visit. The ranks' models bitwise
   equal; against main_e_streamed |dAUC| <= 0.005, relative d(fixed
   objective) <= 1e-3 and the random effects within atol 2e-3 / rtol
   1e-2; K1 = the process's chunks x the fixed effect's passes in each.
   It records the wall per outer iteration beside main_e_streamed's, per
   coordinate the ingest exchange's seconds and bytes, per visit the
   offset and score exchanges' seconds and bytes and the host gather
   seconds, and each process's peak device bytes and host RSS;
16. main_game_cli: config E at its bench depth (64 global features, 8 per
   user and 8 per item, 20,000 users and 4,000 items, Zipf 1.5; 2^18
   training and 2^16 validation rows), generated on the card and written as
   Avro part files (two each) with the port's codec; one training part read
   on the host by the native decoder and by the Python codec (its plain
   version), equal bit for bit, each with its ms a record; then the drivers
   driven as a user drives them, every read on the native decoder:
   ``cli.train.main`` (the fixed effect on L-BFGS over the grid lambda in
   {0.1, 1}, the random effects on L-BFGS, 20 iterations at 1e-7, L2 1; 2
   outer iterations; AUC and MULTI_AUC(userId); output mode ALL), which must
   write every file the reference writes and run the fixed effect on K1's
   tiles layout, one launch per objective pass; its best model equal to
   ``GameEstimator.fit`` on the same arrays within atol 1e-5; a rerun at 3
   outer iterations that logs its resume at outer iteration 2 for each grid
   entry and equals a fresh 3-iteration fit (rtol 1e-4, atol 1e-5);
   ``cli.score.main`` on the validation files, whose scores equal the loaded
   model's in-memory scores (atol 1e-5) and whose AUC equals the training
   run's best entry (1e-6); and ``cli.train_glm --format avro`` (3 lambda)
   equal to ``train_glm`` on the same batch (atol 1e-5). It prints the
   codec's write time and the driver's read time per record, each driver
   stage's seconds, K1's launches and the peak memory;
17. main_game_cli_full: the train driver again over the same files with
   main_e_projected's projectors, 4 hyperparameter-tuning refits after the
   grid and ``--diagnostics``: the six configurations, the best index and
   the best model (atol 1e-5) equal to ``GameEstimator.fit`` plus
   ``tune_game_hyperparameters`` on the same arrays and card, the report
   files written, K1's launches equal to the fixed-effect passes of all six
   fits; then the GLM twin with ``--summarize-features``, ``--validate
   VALIDATE_FULL``, ``--diagnostics`` and ``--prior-model`` (phase 16's twin
   model), equal to ``train_glm`` with the same prior (atol 1e-5). The files
   live in a scratch directory of the checkout, removed at the end;
18. main_glm_streamed_cli: ``cli.train_glm --format avro
   --streaming-chunk-rows 32768`` on phase 16's files (the global shard,
   65 columns, with validation, 3 lambda, 100 iterations at 1e-8): the
   statistics pass, the chunk fill and the validation chunks in ms a
   record, each stage's seconds and K1's launches (one per chunk of every
   value-and-gradient pass of the three lambda, nothing else); the first two
   4096-row chunks of one part read by the native decoder and by the
   Python codec equal bit for bit; every lambda's model equal to
   ``train_glm`` on the same arrays within rtol 1e-2 / atol 1e-3 with the
   same best lambda; a rerun into the same directory loads every lambda
   from ``checkpoints/``; then main_glm_multihost_cli: the same command
   with ``--multihost`` in two processes of this script on the card (gloo
   over loopback; the two training parts, one each), its best lambda and
   coefficients (rtol 1e-2 / atol 1e-3) main_glm_streamed_cli's, only
   process 0 writing (no ``best/`` or ``checkpoints/`` from process 1),
   and a rerun resuming every lambda from process 0's checkpoints (the
   file unchanged, the model within rtol 1e-6); then
   main_game_multihost_cli: ``cli.train --multihost`` in memory in two
   processes of this script on main_game_cli's files and 2-iteration
   configuration (every process reads every file to the host, one shard
   each on the card), the same command again, then ``cli.score
   --multihost`` on the validation files: the best index main_game_cli's,
   every model within rtol 1e-2 / atol 1e-3 of its 2-iteration run, only
   process 0 writing, the rerun resuming both grid entries with the same
   model and checkpoint, the scores part files' union equal to the
   one-process score driver's scores of the same model (1e-5) and the one
   ``metrics.json`` to its metrics (1e-6), K1 = the fixed effect's passes
   in each process;
18b. main_game_cli_streamed: ``cli.train.main --streaming-chunk-rows
   32768`` (8 chunks) on phase 16's files and configuration, 2 outer
   iterations, then a rerun to 3 that resumes both grid entries at outer
   iteration 2 from their visit checkpoints, then ``cli.score.main`` on its
   model: every dataset read on the native decoder, the best index and the
   best model (rtol 1e-2 / atol 1e-3) equal to phase 16's in-memory
   driver's, the best entry's validation AUC within 1e-3, the scores file
   equal to the library's scores of the same model (atol 1e-5), K1's
   launches = 8 x the fixed effect's value-and-gradient passes;
18c. main_game_cli_streamed_multihost: the same driver with
   ``--multihost`` in two processes of this script on the card, one
   training part each (4 chunks): 2 outer iterations, the same command at
   3 (each grid entry resumes at outer iteration 2 from the sharded
   checkpoints: process 0's model file, each process's score file), then 3
   iterations uninterrupted into other directories. The best index and
   the models (rtol 1e-2 / atol 1e-3) of the 2- and 3-iteration runs
   main_game_cli_streamed's; process 0 alone writing (process 1 only its
   score files); the resumed run bitwise the uninterrupted one, which runs
   with ``--telemetry-dir`` and ``PHOTON_TELEMETRY_FLEET=1``; K1 = the
   process's chunks x its fixed-effect passes in every run;
18d. main_telemetry: run telemetry (``obs``) and the profiler on the
   drivers. Phase 16's 2-iteration training command again with
   ``--telemetry-dir`` and ``--profile-dir``: its models and the scoring
   driver's scores and metrics of them (also with both flags) equal, record
   for record, to the same commands with the flags off; each run file
   valid (``validate_run``); every ``descent/visit`` span under a
   ``descent/iter`` under ``train/grid-fit``, the ``score/pass`` span;
   ``run_end``'s registry with ``re_solve.*``, every ``hbm_watermark``
   record ``available``; K1's kernel in the profiler's trace; K1's
   launches those of the run without telemetry. Phase 18's command again
   with ``--telemetry-dir`` (its models equal to phase 18's) and with TRON
   (one lambda, 5 iterations): K1's and K2's ``executable_cost`` bytes at
   the 32768-row chunk equal to the bytes their bounds divide, the
   registry's ``stream.passes`` equal to the solves' objective passes.
   Phase 18c's uninterrupted run wrote a canonical file and a ``.p1``
   shard of one run id, both valid. Each telemetry-on wall beside its
   telemetry-off twin's and each file's bytes are printed;
19. main_f: logistic at config A's width in float32, 2^22 rows (8 GiB) in
   16 host chunks of 2^18 rows drawn on the card, ``train_glm_streamed``
   with host L-BFGS (10 iterations at tolerance 0, lambda = 1) in three
   arms: a 2 GiB chunk cache, the default cache and
   ``PHOTON_PREFETCH_DEPTH=0`` (no worker threads, the default cache), each with its wall per pass, bytes copied
   a pass beside the pinned host-to-device rate of one 512 MiB copy, cache
   hits, misses and evictions, stage seconds, K1 launches (16 a pass),
   peak device and host memory, one more pass's wall, and for the first
   two arms the card's busy share over one profiled pass; the arms'
   coefficients bitwise equal,
   ``value_and_grad`` equal to the in-memory objective on the same 8 GiB on
   the card (value rtol 1e-5, gradient 1e-4) and the solve to the
   in-memory ``train_glm`` (|dAUC| <= 0.005, relative d(objective) <=
   1e-3); K1 alone at the chunk's shape, against its plain version; then
   main_f_multihost: two processes of this script on the card, each
   drawing main_f's 16 chunks in order and keeping its 8, a chunk cache of
   5 GiB each, ``train_glm_streamed(cross_process=True)`` (host L-BFGS 10
   iterations at tolerance 0, lambda = 1, each pass summed over gloo):
   the two processes' coefficients bitwise equal, K1 = 8 x passes in each,
   against main_f |dAUC| <= 0.005 and relative d(objective) <= 1e-3, the
   seconds in collectives per pass;
20. main_b_streamed: config B in 8 host chunks of 2^17 rows with host TRON
   (15 iterations): K1 on each chunk of every value-and-gradient pass and
   K2 on each chunk of every Hessian-vector pass; against main_b relative
   dRMSE <= 1e-4 and d(objective) <= 1e-3; K2 alone at the chunk's shape
   (``k2_time``: against its plain version at phase 3's tolerance, with
   card, device and enqueue times), and K1 alone there
   (``k1_time``, offsets and weights read);
21. main_a2_streamed: config A2's data in 8 host chunks of 2^16 rows, each
   chunk's K3 layouts built once through the layout cache (each chunk's
   build time), host L-BFGS 30 iterations with SIMPLE variances: K3 once
   per chunk and direction of every pass, a second objective over the
   same chunks with no cache miss, and against main_a2 |dAUC| <= 1e-3 and
   relative d(objective) <= 1e-4; K3 alone at the chunk's layouts, each
   direction against its plain version at 1e-5.

Every check that fails raises, and the script exits non-zero with no
result; a child process that fails or outlives its time (then killed)
fails its phase. The kernels are built once, before any child starts.
Its last lines are the smoke's wall, the kernel table as one JSON object (K1's
``launches`` adds up its launches on the main paths A, the sweep, B, D, E,
E on L-BFGS, E projected, the GAME drivers, the six out-of-core
phases, the seven data-parallel ones, the two out-of-core ones across
processes and main_telemetry, which ``launches_by_path`` lists one by one; ``at_main_d_shape``
and ``at_main_e_shape`` give its times at GAME's widths,
``at_streamed_chunk_shape`` each kernel's at its streamed chunk and
``at_streamed_game_chunk_shape`` K1's at main_e_streamed's), the line
``nvidia-smi --query-gpu=name,power.limit`` prints, and
``{"ok": true, "device": {...}}``. It needs one card, and refuses to run
without CUDA or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass, replace

import numpy as np
import torch

from photon_ml_tpu_torch.cli import score as cli_score
from photon_ml_tpu_torch.cli import train as cli_train
from photon_ml_tpu_torch.cli import train_glm as cli_train_glm
from photon_ml_tpu_torch.config import (
    FeatureShardConfig,
    FixedEffectCoordinateConfig,
    GameTrainingConfig,
    OptimizationConfig,
    OptimizerConfig,
    RandomEffectCoordinateConfig,
    RegularizationContext,
)
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.data.synthetic import synthetic_game_data, synthetic_glm_data
from photon_ml_tpu_torch.estimators import GameEstimator
from photon_ml_tpu_torch.evaluation import (
    auc_roc,
    grouped_auc,
    grouped_precision_at_k,
    make_evaluator,
    rmse,
)
from photon_ml_tpu_torch.game import coordinate as game_coordinate
from photon_ml_tpu_torch.game.coordinate import RandomEffectCoordinate
from photon_ml_tpu_torch.game.data import SparseFeatures, capacity_classes, make_game_batch
from photon_ml_tpu_torch.game.models import GameModel
from photon_ml_tpu_torch.game import random_effect as game_random_effect
from photon_ml_tpu_torch.game.projector import RandomProjector
from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer
from photon_ml_tpu_torch.hyperparameter.tuning import tune_game_hyperparameters
from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
from photon_ml_tpu_torch.io.data_reader import AvroDataReader
from photon_ml_tpu_torch.io.model_io import load_game_model, load_glm
from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu_torch.native import build as native_build
from photon_ml_tpu_torch.obs import REGISTRY
from photon_ml_tpu_torch.obs.report import load_run, validate_run
from photon_ml_tpu_torch.ops import _cuda, fused, prefetch, tile_cache
from photon_ml_tpu_torch.ops import sparse_tiled as st
from photon_ml_tpu_torch.ops.batch import DenseBatch, SparseBatch, hbm_budget_bytes, optimize_batch_layout
from photon_ml_tpu_torch.ops.glm import compute_variances, make_objective
from photon_ml_tpu_torch.ops.losses import LOSSES
from photon_ml_tpu_torch.ops.streaming import StreamingGLMObjective, dense_chunks, sparse_chunks
from photon_ml_tpu_torch.optim import lbfgs_minimize, select_minimize_fn
from photon_ml_tpu_torch.parallel import DistributedTrainer, data_mesh, sharded_objective
from photon_ml_tpu_torch.parallel.distributed import reduction_stats
from photon_ml_tpu_torch.parallel.mesh import process_mesh
from photon_ml_tpu_torch.parallel.multihost import (
    collective_stats,
    initialize_multihost,
    reset_collective_stats,
    shutdown_multihost,
)
from photon_ml_tpu_torch.supervised.training import train_glm, train_glm_streamed
from photon_ml_tpu_torch.transformers import GameTransformer
from photon_ml_tpu_torch.types import (
    ModelOutputMode,
    OptimizerType,
    RegularizationType,
    TaskType,
    VarianceComputationType,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-3, 2e-2)}  # (value rtol, vector rtol = atol)
# a kernel's traced device time under this share of its bound (the least
# time the card could take; the published rate's rounding allows a few
# percent) is a trace that missed kernels: late in a smoke the profiler has
# read K1 and K2 at the streamed chunks at 0.5-0.6 of their bounds
TRACE_FLOOR = 0.9
KERNEL_ROWS = {
    "fused_value_grad": dict(
        source="photon_ml_tpu_torch/csrc/fused_glm.cu",
        replaces="photon_ml_tpu/ops/fused.py:120 (_vg_kernel, launched at :230)",
    ),
    "fused_hvp": dict(
        source="photon_ml_tpu_torch/csrc/fused_glm.cu",
        replaces="photon_ml_tpu/ops/fused.py:246 (_hvp_kernel, launched at :299)",
    ),
}
K3_ROW = dict(
    source="photon_ml_tpu_torch/csrc/sparse_tiled.cu",
    replaces="photon_ml_tpu/ops/sparse_tiled.py:509 (_tile_kernel_seg, launched at :830)",
)
K4_REPLACES = "photon_ml_tpu/ops/sparse_tiled.py:654 (_tile_kernel, launched at :830)"
# config A2 (bench.py bench_a2_sparse_highdim): n, d, nonzeros a row
A2 = (1 << 19, 1 << 17, 32)
# GAME (bench.py _game_setup): 64 fixed features and an intercept; config E's
# effects at bench.py's depth and at MovieLens-20M's (GroupLens: 20,000,263
# ratings, 138,493 users, 27,278 movies)
D_FIXED = 64
E_BENCH = (1 << 18, {"userId": (20_000, 8), "itemId": (4_000, 8)})
E_ML20M = (20_000_263, {"userId": (138_493, 8), "itemId": (27_278, 8)})


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_ms(fn, calls: int = 100) -> float:
    """Host time per call of ``fn`` over ``calls`` back-to-back calls with
    nothing synchronized (after a warm-up call and a synchronize): what a
    call costs the host before the card runs it. Beside ``cuda_ms`` it
    says whether the card waits on the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def device_ms(fn, reps: int, floor_ms: float = 0.0) -> float | None:
    """Device time of ``fn`` per call: the durations of everything it runs
    on the card, from the events ``torch.profiler`` traced over ``reps``
    calls after one warm-up call. A trace with no device event is taken
    once more with the host's activity traced too. None (not measured)
    when both are blank, or when the traced time is below ``floor_ms``
    (``TRACE_FLOOR`` × the least time the card could take: the trace
    missed kernels);
    ``profiler_blank`` / ``profiler_partial`` record what the traces held.
    Beside ``cuda_ms`` (events around back-to-back calls) it says how much
    of a call's time the card works and how much it waits on the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    traces = []
    for activities in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        traces.append(dict(activities=[str(a) for a in activities], device_events=len(events),
                           names=sorted({e.name[:60] for e in events}),
                           traced_ms=sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps))
        if events:
            break
    if not traces[-1]["device_events"]:
        emit("profiler_blank", traces=traces)
        return None
    if traces[-1]["traced_ms"] < floor_ms:
        emit("profiler_partial", floor_ms=floor_ms, traces=traces)
        return None
    return traces[-1]["traced_ms"]


def close(got, ref, rtol: float, atol: float) -> tuple[bool, float]:
    """(every element within atol + rtol·|ref|, max |got − ref|)."""
    err = (got.double() - ref.double()).abs()
    ok = bool((err <= atol + rtol * ref.double().abs()).all()) and bool(torch.isfinite(got).all())
    return ok, float(err.max())


# ---------------------------------------------------------------------------
# phase 3: kernel parity and timing
# ---------------------------------------------------------------------------
def _labels(gen, loss: str, n: int, dev):
    if loss == "poisson":
        return torch.poisson(torch.ones(n, device=dev), generator=gen)
    if loss == "squared":
        return torch.randn(n, generator=gen, device=dev)
    return (torch.rand(n, generator=gen, device=dev) < 0.5).float()


def _aux(gen, n: int, dev):
    """Offsets and weights; every 7th row has weight 0 and offset 100, which
    overflows the Poisson loss there: the select must keep it at 0."""
    off = 0.1 * torch.randn(n, generator=gen, device=dev)
    wt = 0.5 + torch.rand(n, generator=gen, device=dev)
    wt[::7] = 0.0
    off[::7] = 100.0
    return off, wt


def parity(dev) -> None:
    shapes = [
        ("headline", N, 512, torch.bfloat16),
        ("config_b", N, 256, torch.float32),
        ("ragged_f32", N - 37, 124, torch.float32),
        ("ragged_bf16", N - 37, 124, torch.bfloat16),
        # GAME's fixed-effect width, and narrow bf16 with a partial last tile
        ("game_e", N, D_FIXED + 1, torch.float32),
        ("narrow_bf16", N - 37, D_FIXED + 1, torch.bfloat16),
    ]
    for name, n, d, dtype in shapes:
        gen = torch.Generator(device=dev).manual_seed(n + d)
        X = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        # margins and X·v of standard deviation 0.5 and 1
        u = 0.5 * torch.randn(d, generator=gen, device=dev) / d**0.5
        v = torch.randn(d, generator=gen, device=dev) / d**0.5
        c, cv = torch.tensor(0.1, device=dev), torch.tensor(-0.05, device=dev)
        off, wt = _aux(gen, n, dev)
        rtol_v, tol = TOL[str(dtype).removeprefix("torch.")]
        for loss_name, loss in LOSSES.items():
            y = _labels(gen, loss_name, n, dev)
            for aux in (False, True):
                o, w = (off, wt) if aux else (None, None)
                kv = fused.fused_value_grad(X, y, o, w, u, c, loss=loss)
                pv = fused.fused_value_grad_reference(X, y, o, w, u, c, loss=loss)
                kh = fused.fused_hvp(X, y, o, w, u, v, c, cv, loss=loss)
                ph = fused.fused_hvp_reference(X, y, o, w, u, v, c, cv, loss=loss)
                torch.cuda.synchronize()
                checks = {
                    "value": close(kv[0], pv[0], rtol_v, 0.0),
                    "grad": close(kv[1], pv[1], tol, tol),
                    "r_sum": close(kv[2], pv[2], tol, tol),
                    "hv": close(kh[0], ph[0], tol, tol),
                    "q_sum": close(kh[1], ph[1], tol, tol),
                }
                emit("parity", shape=name, n=n, d=d, dtype=str(dtype), loss=loss_name, aux=aux,
                     k1_layout=k1_layout(X, y, o, w),
                     max_abs_err={k: e for k, (_, e) in checks.items()},
                     ok=all(ok for ok, _ in checks.values()))
                bad = [k for k, (ok, _) in checks.items() if not ok]
                if bad:
                    raise AssertionError(f"kernel disagrees with its plain version: {name} "
                                         f"{loss_name} aux={aux}: {bad}")
        if name in ("headline", "game_e"):
            a = fused.fused_value_grad(X, y, off, wt, u, c, loss=loss)
            b = fused.fused_value_grad(X, y, off, wt, u, c, loss=loss)
            if not all(torch.equal(p, q) for p, q in zip(a, b)):
                raise AssertionError(f"K1 is not bitwise repeatable at {name}")
            emit("parity_k1_bitwise", shape=name, k1_layout=k1_layout(X, y, off, wt), ok=True)
        if name in ("config_b", "ragged_f32"):
            runs = [fused.fused_hvp(X, y, off, wt, u, v, c, cv, loss=loss) for _ in range(3)]
            if not all(torch.equal(p, q) for r in runs[1:] for p, q in zip(runs[0], r)):
                raise AssertionError(f"K2 is not bitwise repeatable at {name}")
            emit("parity_k2_bitwise", shape=name, repeats=3, ok=True)
        del X
        torch.cuda.empty_cache()


def k1_layout(X, labels, offsets, weights) -> str:
    """The layout K1 takes on these inputs (``fused.vg_plan``)."""
    aligned = fused.inputs_aligned(X, labels, offsets, weights)
    return fused.vg_plan(X.shape[1], X.dtype, aligned).layout


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing(dev) -> dict:
    """Each kernel at the shape and inputs the main path gives it: K1 at the
    headline (logistic, bfloat16, offsets and weights constant and not
    read), K2 at config B (squared, float32, ``k2_time``); K1 at config B
    besides. Each with its card, device and enqueue
    ms."""
    rows = {}
    cases = [
        ("fused_value_grad", "headline", 512, torch.bfloat16, "logistic"),
        ("fused_value_grad", "config_b", 256, torch.float32, "squared"),
        ("fused_hvp", "config_b", 256, torch.float32, "squared"),
    ]
    for kernel, shape, d, dtype, loss_name in cases:
        loss = LOSSES[loss_name]
        gen = torch.Generator(device=dev).manual_seed(d)
        X = torch.randn((N, d), generator=gen, device=dev).to(dtype)
        y = _labels(gen, loss_name, N, dev)
        u = 0.5 * torch.randn(d, generator=gen, device=dev) / d**0.5
        v = torch.randn(d, generator=gen, device=dev) / d**0.5
        c, cv = torch.tensor(0.1, device=dev), torch.tensor(-0.05, device=dev)
        itemsize = X.element_size()
        if kernel == "fused_value_grad":
            run = lambda: fused.fused_value_grad(X, y, None, None, u, c, loss=loss)  # noqa: E731
            plain = lambda: fused.fused_value_grad_reference(X, y, None, None, u, c, loss=loss)  # noqa: E731
            library = k1_library(X, y, None, u, c, loss)
            # X, labels and u read once; gradient, value and r-sum written once
            nbytes = N * d * itemsize + 4 * N + 4 * d + 4 * (d + 2)
            flops = 4.0 * N * d
            got, ref = run(), plain()
            err = float((got[1].double() - ref[1].double()).abs().max())
        else:
            rec = dict(kernel=kernel, shape=shape, loss=loss_name,
                       **k2_time(X, y, None, None, u, v, c, cv, loss))
            emit("timing", **rec)
            if not rec["ok"]:
                raise AssertionError(f"K2 disagrees with its plain version at {shape}")
            rows[kernel] = rec
            del X
            torch.cuda.empty_cache()
            continue
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(plain, 3)
        library_ms = cuda_ms(library, 20)
        ms_again = cuda_ms(run, 20)
        bound_ms, bound_by = _bound(nbytes, flops)
        rec = dict(kernel=kernel, shape=shape, n=N, d=d, dtype=str(dtype), loss=loss_name,
                   layout=k1_layout(X, y, None, None), ms=ms, ms_again=ms_again,
                   device_ms=device_ms(run, 20, floor_ms=TRACE_FLOOR * bound_ms),
                   enqueue_ms=enqueue_ms(run), plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
                   max_abs_err=err, hbm_share=bound_ms / ms)
        emit("timing", **rec)
        if shape == "headline":
            rows[kernel] = rec
        else:
            rows["k1_config_b"] = rec
        del X
        torch.cuda.empty_cache()
    return rows


def k1_library(X, labels, offsets, u, c, loss, weights=None):
    """One PyTorch computation of K1's function: cuBLAS X @ u, the
    elementwise loss, cuBLAS Xᵀ @ r (a yardstick; the port never calls it)."""
    def run():
        m = (X @ u.to(X.dtype)).float() - c
        if offsets is not None:
            m = m + offsets
        lv, r = loss.value(m, labels), loss.d1(m, labels)
        if weights is not None:
            lv, r = weights * lv, weights * r
        return lv.sum(), X.T @ r.to(X.dtype), r.sum()
    return run


def k1_time(X, labels, offsets, u, c, loss, reps: int = 20, weights=None) -> dict:
    """K1 on these inputs in each of its layouts that can run (``ms_rows``,
    ``ms_tiles``; the rule's first, twice; ``device_ms_*`` of each, and
    ``device_ms`` of the rule's; ``enqueue_ms`` of the rule's), its plain
    version, the library yardstick and the least time the card could take
    (X, labels, offsets, weights and u read once, the d + 2 results written
    once)."""
    n, d = X.shape
    layout = k1_layout(X, labels, offsets, weights)
    others = [k for k in fused.LAYOUTS if k != layout and (
        k == "rows" or fused.tile_plan(d, X.dtype) is not None)]
    in_layout = lambda k: lambda: fused.fused_value_grad_in_layout(  # noqa: E731
        X, labels, offsets, weights, u, c, loss=loss, layout=k)
    plain = lambda: fused.fused_value_grad_reference(X, labels, offsets, weights, u, c, loss=loss)  # noqa: E731
    got, ref = fused.fused_value_grad(X, labels, offsets, weights, u, c, loss=loss), plain()
    torch.cuda.synchronize()
    rtol_v, tol = TOL[str(X.dtype).removeprefix("torch.")]
    ok = close(got[0], ref[0], rtol_v, 0.0)[0] and close(got[1], ref[1], tol, tol)[0]
    rec = dict(n=n, d=d, dtype=str(X.dtype), layout=layout,
               max_abs_err=float((got[1].double() - ref[1].double()).abs().max()), ok=ok)
    del got, ref
    rec["ms"] = cuda_ms(in_layout(layout), reps)
    for k in others:
        rec[f"ms_{k}"] = cuda_ms(in_layout(k), reps)
    rec["ms_again"] = cuda_ms(in_layout(layout), reps)
    rec[f"ms_{layout}"] = rec["ms"]
    nbytes = (n * d * X.element_size() + 4 * n * (1 + (offsets is not None) + (weights is not None))
              + 4 * d + 4 * (d + 2))
    rec["bytes"] = nbytes
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, 4.0 * n * d)
    for k in (layout, *others):
        rec[f"device_ms_{k}"] = device_ms(in_layout(k), reps, floor_ms=TRACE_FLOOR * rec["bound_ms"])
    rec["device_ms"] = rec[f"device_ms_{layout}"]
    rec["enqueue_ms"] = enqueue_ms(in_layout(layout))
    rec["plain_ms"] = cuda_ms(plain, 2)
    rec["library_ms"] = cuda_ms(k1_library(X, labels, offsets, u, c, loss, weights), reps)
    rec["hbm_share"] = rec["bound_ms"] / rec["ms"]
    return rec


def timing_k1_layouts(dev) -> None:
    """K1 at n = 2^20 (logistic, no offsets or weights) at the widths where
    its two layouts cross, in both storage types: each layout's time beside
    the rule's choice."""
    for dtype in (torch.float32, torch.bfloat16):
        for d in (65, 124, 128, 256):
            gen = torch.Generator(device=dev).manual_seed(100 + d)
            X = torch.randn((N, d), generator=gen, device=dev).to(dtype)
            y = _labels(gen, "logistic", N, dev)
            u = 0.5 * torch.randn(d, generator=gen, device=dev) / d**0.5
            rec = k1_time(X, y, None, u, torch.tensor(0.1, device=dev), LOSSES["logistic"])
            emit("timing_k1_layouts", **rec)
            if not rec["ok"]:
                raise AssertionError(f"K1 disagrees with its plain version at d = {d} {dtype}")
            del X
            torch.cuda.empty_cache()


def k2_library(X, labels, offsets, weights, u, v, c, cv, loss):
    """One PyTorch computation of K2's function: cuBLAS X @ [u v], the
    elementwise curvature, cuBLAS Xᵀ @ q (a yardstick; the port never calls
    it)."""
    uv = torch.stack([u, v], dim=1).to(X.dtype)

    def run():
        muv = (X @ uv).float()
        m = muv[:, 0] - c
        if offsets is not None:
            m = m + offsets
        q = loss.d2(m, labels) * (muv[:, 1] - cv)
        if weights is not None:
            q = q * weights
        return X.T @ q.to(X.dtype), q.sum()
    return run


def k2_time(X, labels, offsets, weights, u, v, c, cv, loss, reps: int = 20) -> dict:
    """K2 on these inputs held to the plain version, then timed twice
    (``ms``, ``ms_again``), with its ``enqueue_ms``, its ``device_ms`` from
    the profiler, the plain version, the library yardstick and the least
    time the card could take (X, labels, offsets, weights, u and v read
    once, the d + 1 results written once)."""
    n, d = X.shape
    run = lambda: fused.fused_hvp(X, labels, offsets, weights, u, v, c, cv, loss=loss)  # noqa: E731
    plain = lambda: fused.fused_hvp_reference(X, labels, offsets, weights, u, v, c, cv, loss=loss)  # noqa: E731
    _, tol = TOL[str(X.dtype).removeprefix("torch.")]
    got, ref = run(), plain()
    torch.cuda.synchronize()
    (hv_ok, err), (sum_ok, sum_err) = close(got[0], ref[0], tol, tol), close(got[1], ref[1], tol, tol)
    del got, ref
    rec = dict(n=n, d=d, dtype=str(X.dtype), layout="rows", ok=hv_ok and sum_ok, max_abs_err=err,
               q_sum_abs_err=sum_err, ms=cuda_ms(run, reps), ms_again=cuda_ms(run, reps),
               enqueue_ms=enqueue_ms(run))
    nbytes = (n * d * X.element_size() + 4 * n * (1 + (offsets is not None) + (weights is not None))
              + 8 * d + 4 * (d + 1))
    rec["bytes"] = nbytes
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, 6.0 * n * d)
    rec["hbm_share"] = rec["bound_ms"] / rec["ms"]
    rec["device_ms"] = device_ms(run, reps, floor_ms=TRACE_FLOOR * rec["bound_ms"])
    rec["plain_ms"] = cuda_ms(plain, 2)
    rec["library_ms"] = cuda_ms(k2_library(X, labels, offsets, weights, u, v, c, cv, loss), reps)
    return rec


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------
def headline_problem(dev):
    """bench.py's headline shape: logistic, n = 2^20, d = 512 with the
    intercept at 511, bfloat16 X, offsets 0 and weights 1; a 2^16-row
    validation set from the same true weights."""
    batch, intercept, w_true = synthetic_glm_data(
        0, N, 511, TaskType.LOGISTIC_REGRESSION, dtype=torch.bfloat16, device=dev
    )
    gen = torch.Generator(device=dev).manual_seed(1)
    nv = 1 << 16
    Xv = torch.randn((nv, 512), generator=gen, device=dev)
    Xv[:, intercept] = 1.0
    yv = (torch.rand(nv, generator=gen, device=dev) < torch.sigmoid(Xv @ w_true)).float()
    val = DenseBatch(X=Xv.to(torch.bfloat16), labels=yv, offsets=torch.zeros(nv, device=dev),
                     weights=torch.ones(nv, device=dev))
    return batch, intercept, val


def launch_counts() -> dict:
    return {**fused.launch_counts, **{f"sparse_{k}": v for k, v in st.launch_counts.items()}}


def solve(batch, task, config, weights, dev, **kw):
    """``train_glm`` with every kernel's launch count zeroed just before it
    and read just after; returns (result, wall seconds, launches)."""
    fused.reset_launch_counts()
    st.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = train_glm(batch, task, optimizer_config=config, regularization_weights=weights,
                       device=dev, **kw)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, launch_counts()


def _record(t, wall, launches, **metrics) -> dict:
    return dict(iterations=t.iterations, reason=t.reason, objective_passes=t.objective_passes,
                objective=float(t.value), **metrics, wall_s=wall,
                wall_ms_per_pass=1e3 * wall / t.objective_passes, launches=launches)


def run_a(batch, intercept, dev) -> dict:
    task = TaskType.LOGISTIC_REGRESSION
    # the warm-up solve keeps first-call costs out of the timed one
    solve(batch, task, OptimizerConfig(max_iterations=2), [1.0], dev, intercept_index=intercept)
    result, wall, launches = solve(batch, task, OptimizerConfig(max_iterations=30, tolerance=0.0),
                                   [1.0], dev, intercept_index=intercept)
    auc = float(auc_roc(result.models[1.0].score(batch), batch.labels))
    return _record(result.trackers[1.0], wall, launches, train_auc=auc)


def run_sweep(batch, intercept, val, dev) -> dict:
    result, wall, launches = solve(
        batch, TaskType.LOGISTIC_REGRESSION, OptimizerConfig(max_iterations=30, tolerance=0.0),
        [0.1, 1.0, 10.0], dev, intercept_index=intercept, validation_batch=val,
    )
    per = {
        str(lam): dict(iterations=t.iterations, objective_passes=t.objective_passes,
                       objective=float(t.value), validation_auc=result.validation[lam].metrics["AUC"])
        for lam, t in result.trackers.items()
    }
    passes = sum(t.objective_passes for t in result.trackers.values())
    return dict(best_weight=result.best_weight, per_weight=per, wall_s=wall,
                wall_ms_per_pass=1e3 * wall / passes, launches=launches)


def run_b(dev) -> dict:
    task = TaskType.LINEAR_REGRESSION
    batch, _, _ = synthetic_glm_data(
        2, N, 256, task, noise=0.1, add_intercept=False, dtype=torch.float32, device=dev
    )
    tron = OptimizerType.TRON
    solve(batch, task, OptimizerConfig(optimizer_type=tron, max_iterations=2), [1.0], dev)
    result, wall, launches = solve(
        batch, task, OptimizerConfig(optimizer_type=tron, max_iterations=15, tolerance=0.0),
        [1.0], dev,
    )
    train_rmse = float(rmse(result.models[1.0].score(batch), batch.labels))
    return _record(result.trackers[1.0], wall, launches, train_rmse=train_rmse)

# ---------------------------------------------------------------------------
# phases 7-10: K3 and the high-dimensional sparse path (config A2)
# ---------------------------------------------------------------------------
def sparse_problem(dev, n, d, k, seed, kind="uniform"):
    """A padded-sparse logistic problem generated on the card as bench.py's
    ``_make_sparse_problem`` generates A2: indices uniform in [0, d), values
    N(0, 1), true weights N(0, 1)·0.3, y ~ Bernoulli(sigmoid(Σ val·w_true)),
    offsets 0 and weights 1. ``kind`` "duplicates" repeats the first half
    of each row's indices in its second half; "skewed" draws columns as
    floor(d·u²), so column j is drawn with probability about
    (sqrt(j + 1) − sqrt(j)) / sqrt(d): column 0 holds some 46 thousand of
    A2's 2^24 nonzeros. Returns (batch, w_true)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "skewed":
        u = torch.rand((n, k), generator=gen, device=dev)
        idx = (u * u * d).long().clamp_max(d - 1)
    else:
        idx = torch.randint(0, d, (n, k), generator=gen, device=dev)
    if kind == "duplicates":
        idx[:, k // 2:] = idx[:, : k - k // 2]
    val = torch.randn((n, k), generator=gen, device=dev)
    w_true = torch.randn(d, generator=gen, device=dev) * 0.3
    m = torch.sum(val * w_true[idx], dim=-1)
    y = (torch.rand(n, generator=gen, device=dev) < torch.sigmoid(m)).float()
    batch = SparseBatch(indices=idx, values=val, labels=y, offsets=torch.zeros(n, device=dev),
                        weights=torch.ones(n, device=dev), num_features=d)
    return batch, w_true


def timed_tiling(batch, rung):
    """``tile_sparse_batch`` on one storage rung (``PHOTON_KERNEL_DTYPE``,
    restored after); returns (tiled batch, seconds)."""
    prev = os.environ.get("PHOTON_KERNEL_DTYPE")
    os.environ["PHOTON_KERNEL_DTYPE"] = rung
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tiled = st.tile_sparse_batch(batch)
        torch.cuda.synchronize()
    finally:
        if prev is None:
            del os.environ["PHOTON_KERNEL_DTYPE"]
        else:
            os.environ["PHOTON_KERNEL_DTYPE"] = prev
    return tiled, time.perf_counter() - t0


def k3_directions(tiled, w, r):
    """(layout, source, square) of each direction."""
    return {"matvec": (tiled.m, w, False), "rmatvec": (tiled.g, r, False),
            "rmatvec_sq": (tiled.g, r, True)}


def parity_k3(dev) -> dict:
    """K3 against its plain version; returns the A2 f32 errors per direction."""
    n, d, k = A2
    shapes = [("a2", n, d, "uniform"), ("ragged", n - 37, d + 13, "uniform"),
              ("duplicates", n, d, "duplicates"), ("skewed", n, d, "skewed")]
    a2_err = {}
    for name, n_s, d_s, kind in shapes:
        batch, _ = sparse_problem(dev, n_s, d_s, k, seed=n_s + d_s, kind=kind)
        gen = torch.Generator(device=dev).manual_seed(7)
        w = torch.randn(d_s, generator=gen, device=dev)
        r = torch.randn(n_s, generator=gen, device=dev)
        for rung in st.KERNEL_DTYPES:
            tiled, build_s = timed_tiling(batch, rung)
            errs, bad = {}, []
            for direction, (lay, src, square) in k3_directions(tiled, w, r).items():
                got = st.sparse_apply(lay, src, square=square, direction=direction)
                ref = st.tiled_apply_reference(lay, src, square=square)
                torch.cuda.synchronize()
                if rung == "f32":
                    ok, err = close(got, ref, 1e-5, 1e-5)
                else:
                    ok, err = close(got, ref, 0.0, 1e-5 * float(ref.abs().max()))
                errs[direction] = err
                if not ok:
                    bad.append(direction)
                if name == "a2" and rung == "f32":
                    a2_err[direction] = err
            lens = tiled.g.offsets[1:] - tiled.g.offsets[:-1]
            emit("parity_k3", shape=name, n=n_s, d=d_s, k=k, rung=rung, nnz=tiled.m.nnz,
                 max_column_nnz=int(lens.max()), layout_build_s=build_s, max_abs_err=errs,
                 ok=not bad)
            if bad:
                raise AssertionError(f"K3 disagrees with its plain version: {name} {rung}: {bad}")
            if name == "a2" and rung == "f32":
                for direction, (lay, src, square) in k3_directions(tiled, w, r).items():
                    a = st.sparse_apply(lay, src, square=square, direction=direction)
                    b = st.sparse_apply(lay, src, square=square, direction=direction)
                    if not torch.equal(a, b):
                        raise AssertionError(f"K3 is not bitwise repeatable ({direction})")
                emit("parity_k3_bitwise", shape=name, rung=rung, ok=True)
            del tiled
        del batch
        torch.cuda.empty_cache()
    return a2_err


GATHER_PROBE = r"""
// 2^24 random float gathers and nothing else: indices from a hash, one sum
// per thread. Measures how fast the card serves K3's gathers alone.
__device__ unsigned mix(unsigned x) {
  x ^= x >> 16; x *= 0x7feb352dU; x ^= x >> 15; x *= 0x846ca68bU; return x ^ (x >> 16);
}
__global__ void probe(const float* __restrict__ src, unsigned mask, long long n, float* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x * 8;
  float acc = 0.f;
  for (long long k = i * 8; k < n; k += step) {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = __ldg(src + (mix((unsigned)(k + j)) & mask));
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += x[j];
  }
  out[i] = acc;
}
extern "C" int photon_gather_probe(const float* src, unsigned mask, long long n, float* out,
                                   int blocks, void* stream) {
  probe<<<blocks, 256, 0, (cudaStream_t)stream>>>(src, mask, n, out);
  return (int)cudaGetLastError();
}
"""


def gather_floor(dev) -> dict:
    """The time of 2^24 random gathers from a float32 source of A2's two
    sizes (d and n entries) with no stream beside them, from a probe built
    here: the least time K3 could take at A2 on this layout, whatever it
    streams. Returns {read_len: ms}."""
    import ctypes
    import tempfile
    from pathlib import Path

    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as tmp:
        cu, so = Path(tmp) / "gather_probe.cu", Path(tmp) / "libgather_probe.so"
        cu.write_text(GATHER_PROBE)
        subprocess.run([_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", str(so), str(cu)], check=True, timeout=300)
        lib = ctypes.CDLL(str(so))
    lib.photon_gather_probe.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_longlong,
                                        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    n, d, k = A2
    blocks = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(blocks * 256, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    floors = {}
    for read_len in (d, n):  # powers of two: the index is a hash under a mask
        src = torch.randn(read_len, device=dev)

        def run():
            if lib.photon_gather_probe(src.data_ptr(), read_len - 1, n * k, out.data_ptr(), blocks,
                                       stream):
                raise RuntimeError("the gather probe did not launch")

        floors[read_len] = cuda_ms(run, 20)
        emit("gather_floor", read_len=read_len, source_bytes=4 * read_len, gathers=n * k,
             ms=floors[read_len], ms_again=cuda_ms(run, 20))
    return floors


def time_k3(lay, src, square, direction, *, plain=True, library=True) -> dict:
    """One direction of K3 on one layout: its agreement with the plain
    version (``ok``, at ``parity_k3``'s tolerance for the layout's rung),
    the kernel twice (``ms``, ``ms_again``), beside its plain version and
    cuSPARSE on the same CSR (``library``), and the least time the card
    could take."""
    run = lambda: st.sparse_apply(lay, src, square=square, direction=direction)  # noqa: E731
    ref = st.tiled_apply_reference(lay, src, square=square)
    got = run()
    torch.cuda.synchronize()
    if lay.storage == "f32":
        ok, err = close(got, ref, 1e-5, 1e-5)
    else:
        ok, err = close(got, ref, 0.0, 1e-5 * float(ref.abs().max()))
    rec = dict(direction=direction, nnz=lay.nnz, max_abs_err=err, ok=ok)
    del got, ref
    rec["ms"] = cuda_ms(run, 20)
    if plain:
        rec["plain_ms"] = cuda_ms(lambda: st.tiled_apply_reference(lay, src, square=square), 3)
    if library:
        csr = torch.sparse_csr_tensor(
            lay.offsets, lay.read.long(), st.decoded_values(lay, square),
            size=(lay.write_len, lay.read_len), check_invariants=False,
        )
        operand = st.source_operand(lay, src)
        lib_out = csr @ operand
        torch.cuda.synchronize()
        rec["library_max_abs_err"] = float(
            (lib_out.double() - st.tiled_apply_reference(lay, src, square=square).double()).abs().max())
        rec["library_ms"] = cuda_ms(lambda: csr @ operand, 20)
        del csr, lib_out
    rec["ms_again"] = cuda_ms(run, 20)
    # streams read once, the source read once, the output written once
    nbytes = lay.stream_bytes() + 4 * lay.read_len + 4 * lay.write_len
    flops = 2.0 * lay.nnz * (2 if square else 1)
    bound_ms, bound_by = _bound(nbytes, flops)
    tile_meta, carry = lay.tile_bytes()
    rec.update(bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               stream_bytes_per_nnz=lay.stream_bytes() / lay.nnz,
               tile_meta_bytes=tile_meta, carry_bytes=carry, hbm_share=bound_ms / rec["ms"])
    return rec


def timing_k3(dev, floors: dict) -> dict:
    """Each direction at A2 on each rung; then, on f32, A2 with every read
    index set to 0 (each gather hits one L2 sector: the streams' time
    alone) and the power-law shape of ``parity_k3``. Each row carries the
    gather floor of its source's size (``floors``, from ``gather_floor``).
    Returns the A2 f32 rows by direction."""
    n, d, k = A2
    gen = torch.Generator(device=dev).manual_seed(8)
    w = torch.randn(d, generator=gen, device=dev)
    rows = {}
    for shape in ("a2", "skewed"):
        batch, _ = sparse_problem(dev, n, d, k, seed=1 if shape == "a2" else n + d, kind=(
            "uniform" if shape == "a2" else "skewed"))
        # the gradient direction's source at the scale the solve gives it
        r = torch.sigmoid(torch.randn(n, generator=gen, device=dev)) - batch.labels
        for rung in st.KERNEL_DTYPES if shape == "a2" else ("f32",):
            tiled, build_s = timed_tiling(batch, rung)
            lens = tiled.g.offsets[1:] - tiled.g.offsets[:-1]
            for direction, (lay, src, square) in k3_directions(tiled, w, r).items():
                rec = dict(shape=shape, rung=rung, n=n, d=d, max_column_nnz=int(lens.max()),
                           **time_k3(lay, src, square, direction), layout_build_s=build_s,
                           reference_bytes_per_nnz={"f32": 12, "bf16": 6, "int8": 4}[rung])
                rec["gather_floor_ms"] = floors[lay.read_len]
                rec["gather_floor_share"] = floors[lay.read_len] / rec["ms"]
                emit("timing_k3", **rec)
                if shape == "a2" and rung == "f32":
                    rows[direction] = rec
            if shape == "a2" and rung == "f32":
                for direction, (lay, src, square) in k3_directions(tiled, w, r).items():
                    zero = torch.zeros(lay.num_tiles * st.TILE_NNZ, dtype=torch.int32, device=dev)
                    rec = time_k3(replace(lay, read=zero[: lay.nnz]), src, square, direction,
                                  plain=False, library=False)
                    emit("timing_k3_streams_only", shape=shape, rung=rung, **rec,
                         share_of_gathered=rec["ms"] / rows[direction]["ms"])
            del tiled
            torch.cuda.empty_cache()
        del batch
    return rows


def a2_solve(batch, dev, **kw) -> tuple:
    return solve(batch, TaskType.LOGISTIC_REGRESSION,
                 OptimizerConfig(max_iterations=30, tolerance=0.0), [1.0], dev, **kw)


def run_a2(dev):
    """The A2 main path; returns (record, raw batch, w_true)."""
    n, d, k = A2
    batch, w_true = sparse_problem(dev, n, d, k, seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiled = optimize_batch_layout(batch, hbm_budget_bytes=hbm_budget_bytes(dev))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if not isinstance(tiled, st.TiledSparseBatch) or tiled.storage != "f32":
        raise AssertionError(f"A2 did not take the sparse kernel's f32 layout: {type(tiled)}")
    a2_solve(tiled, dev)  # warm-up: first-call costs stay out of the timed solve
    result, wall, launches = a2_solve(
        tiled, dev, variance_computation=VarianceComputationType.SIMPLE
    )
    model = result.models[1.0]
    auc = float(auc_roc(model.score(tiled), batch.labels))
    auc_true = float(auc_roc(batch.matvec(w_true), batch.labels))
    rec = _record(result.trackers[1.0], wall, launches, train_auc=auc, auc_true_weights=auc_true,
                  quality_ok=auc >= 0.98 * auc_true, layout_build_s=build_s, n=n, d=d,
                  nnz=tiled.m.nnz,
                  variances_finite=bool(torch.isfinite(model.coefficients.variances).all()))
    return rec, batch, model


def agreement_a2(batch, a2: dict, model_f32, dev) -> dict:
    """The A2 solve without K3 and on the reduced rungs, each after a
    warm-up solve that keeps first-call costs out of its wall time."""
    a2_solve(batch, dev)
    result, wall, launches = a2_solve(batch, dev)  # gather / index_add_, no kernel
    if any(launches.values()):
        raise AssertionError(f"the untiled solve launched a kernel: {launches}")
    t = result.trackers[1.0]
    auc_f32 = float(auc_roc(model_f32.score(batch), batch.labels))
    untiled = _record(t, wall, launches,
                      train_auc=float(auc_roc(result.models[1.0].score(batch), batch.labels)))
    out = dict(untiled=untiled,
               d_auc=abs(a2["train_auc"] - untiled["train_auc"]),
               rel_d_objective=abs(a2["objective"] - untiled["objective"]) / abs(untiled["objective"]),
               rungs={})
    for rung in ("bf16", "int8"):
        tiled, build_s = timed_tiling(batch, rung)
        a2_solve(tiled, dev)
        res, wall, launches = a2_solve(tiled, dev)
        tr = res.trackers[1.0]
        auc = float(auc_roc(res.models[1.0].score(batch), batch.labels))
        out["rungs"][rung] = dict(
            **_record(tr, wall, launches, train_auc=auc), layout_build_s=build_s,
            d_auc=abs(auc - auc_f32),
            rel_d_loss=abs(float(tr.value) - a2["objective"]) / abs(a2["objective"]),
        )
        del tiled
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 11-13: GAME (configs D and E)
# ---------------------------------------------------------------------------
def game_problem(dev, n: int, effects: dict, seed: int):
    """``synthetic_game_data`` drawn on the card (the reference's
    distributions) as a ``GameBatch``: shard "global" (64 features and the
    intercept) and, per effect, shard "per_<effect>" keyed by its id column.
    Returns (batch, data)."""
    data = synthetic_game_data(seed, n, D_FIXED, effects, device=dev)
    features = {"global": data.X, **{f"per_{k}": data.entity_X[k] for k in effects}}
    return make_game_batch(data.y, features, id_tags=data.entity_ids, device=dev), data


def game_config(effects: dict, iterations: int, re_solver: str = "NEWTON_CHOLESKY",
                re_regularization: RegularizationType = RegularizationType.L2,
                evaluators: tuple = ()) -> GameTrainingConfig:
    """bench.py's ``_game_setup``: the fixed effect unregularized on L-BFGS,
    each random effect on damped Newton with L2 1 and the ladder merged
    toward 8 buckets at 0.5 padding; 20 iterations at tolerance 1e-7.
    ``re_solver`` swaps the random effects' optimizer (LBFGS: the fixed
    effect's ``OptimizerConfig``, the default type) and
    ``re_regularization`` their regularization (ELASTIC_NET: α 0.5, weight
    1, so OWL-QN under LBFGS)."""
    fixed = OptimizationConfig(optimizer=OptimizerConfig(max_iterations=20, tolerance=1e-7))
    per_entity = OptimizationConfig(
        optimizer=OptimizerConfig(optimizer_type=OptimizerType(re_solver),
                                  max_iterations=20, tolerance=1e-7),
        regularization=RegularizationContext(re_regularization, alpha=0.5),
        regularization_weight=1.0,
    )
    return GameTrainingConfig(
        task_type=TaskType.LOGISTIC_REGRESSION,
        coordinate_update_sequence=("fixed", *(f"per_{k}" for k in effects)),
        coordinate_descent_iterations=iterations,
        fixed_effect_coordinates={"fixed": FixedEffectCoordinateConfig("global", fixed)},
        random_effect_coordinates={
            f"per_{k}": RandomEffectCoordinateConfig(
                random_effect_type=k, feature_shard_id=f"per_{k}", optimization=per_entity,
                bucket_target_count=8, bucket_max_padded_ratio=0.5,
            )
            for k in effects
        },
        evaluators=evaluators,
    )


_SCALAR_READS = ("__bool__", "__float__", "__int__", "item")


@contextmanager
def counting_readbacks():
    """Counts the host's reads of a CUDA tensor's value (``bool``,
    ``float``, ``int``, ``item``: each a round trip that waits for the
    card) while active; yields a one-element list holding the count."""
    count = [0]
    saved = {name: (name in torch.Tensor.__dict__, getattr(torch.Tensor, name))
             for name in _SCALAR_READS}

    def counted(fn):
        def read(self, *args, **kwargs):
            if self.is_cuda:
                count[0] += 1
            return fn(self, *args, **kwargs)
        return read

    for name, (_, fn) in saved.items():
        setattr(torch.Tensor, name, counted(fn))
    try:
        yield count
    finally:
        for name, (own, fn) in saved.items():
            if own:
                setattr(torch.Tensor, name, fn)
            else:
                delattr(torch.Tensor, name)


@contextmanager
def recording_visits():
    """Keeps, per random-effect coordinate, the residual offsets and the
    warm-start coefficients of its latest visit (the inputs of the lane
    solutions it returned)."""
    seen = {}
    train = RandomEffectCoordinate.train

    def recorded(self, offsets, initial=None):
        seen[self.coordinate_id] = (offsets, None if initial is None else initial.coefficients)
        return train(self, offsets, initial)

    RandomEffectCoordinate.train = recorded
    try:
        yield seen
    finally:
        RandomEffectCoordinate.train = train


def _exchange_snapshot() -> dict:
    """The host collectives' running totals a data-mesh fit reads per visit:
    the shard reductions (``reduction_s``), every gloo collective
    (``collective_s``) and the score row gathers (``score_exchange_*``)."""
    return dict(reduction_s=reduction_stats["seconds"], collective_s=collective_stats["seconds"],
                score_exchange_s=game_coordinate.score_exchange_stats["seconds"],
                score_exchange_bytes=game_coordinate.score_exchange_stats["bytes"])


def fit_game(batch, config: GameTrainingConfig, dev, on_mark=None, validation=None, mesh=None) -> dict:
    """``GameEstimator.fit`` and ``select_best`` with every kernel's launch
    count zeroed just before and read just after. The estimator's logger
    marks the end of the host ingest and of every coordinate visit (each
    mark synchronizes the card, then calls ``on_mark``), which times the
    visits and the outer iterations and counts each visit's read-backs
    (``counting_readbacks``). With a data ``mesh`` each visit also carries
    its seconds in the shard reductions, in gloo collectives and in the
    score row gather, and that gather's bytes."""
    marks = []

    def mark(msg: str) -> None:
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), msg, reads[0], _exchange_snapshot()))
        if on_mark is not None:
            on_mark()

    fused.reset_launch_counts()
    st.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counting_readbacks() as reads:
        est = GameEstimator(config, intercept_indices={"global": D_FIXED}, logger=mark, device=dev, mesh=mesh)
        best = est.select_best(est.fit(batch, validation_batch=validation))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    visits, (prev, _, prev_reads, prev_x) = [], marks[0]
    for t, msg, n_reads, x in marks[1:]:
        if not msg.startswith("iter "):
            continue  # the grid entry's closing validation line
        it, cid = msg.split(":")[0].removeprefix("iter ").split(" coordinate ")
        visits.append(dict(iteration=int(it), coordinate=cid, wall_s=t - prev, readbacks=n_reads - prev_reads,
                           **({k: x[k] - prev_x[k] for k in x} if mesh is not None else {})))
        prev, prev_reads, prev_x = t, n_reads, x
    iters = [sum(v["wall_s"] for v in visits if v["iteration"] == i)
             for i in range(config.coordinate_descent_iterations)]
    fixed = best.descent.trackers["fixed"]
    return dict(best=best, wall_s=wall, ingest_s=marks[0][0] - t0, visits=visits,
                iteration_wall_s=iters, launches=launch_counts(),
                fixed_objective_passes=sum(t.objective_passes for t in fixed),
                fixed_iterations=[t.iterations for t in fixed], fixed_objective=float(fixed[-1].value))


def game_quality(fit: dict, batch, data) -> dict:
    """Train AUC and log-loss of the fitted model beside the generating
    model's AUC."""
    score = fit["best"].model.score(batch)
    gen = data.X @ data.w_fixed
    for k, ids in data.entity_ids.items():
        gen = gen + torch.einsum("nd,nd->n", data.entity_X[k], data.w_entity[k][ids])
    auc, auc_true = float(auc_roc(score, batch.labels)), float(auc_roc(gen, batch.labels))
    loss = make_evaluator("LOGISTIC_LOSS")(score, batch.labels)
    return dict(train_auc=auc, auc_generating_model=auc_true, train_log_loss=loss,
                quality_ok=auc >= 0.95 * auc_true)


def bucket_report(fit: dict, batch, effects: dict, solver: str = "newton") -> dict:
    """Per random effect: the bucket capacities and lanes (the ladder the
    estimator built, recomputed from the entity counts), the padded slots
    over the active rows, and each bucket's solver iterations at the last
    visit (max and mean over its lanes). For Newton, the read-backs its
    loop makes (one per iteration and one to stop); for L-BFGS, the
    line-search steps over the bucket's lanes (each lane's objective
    passes less 1 + 2 per iteration): their sum and the most of one lane."""
    out = {}
    for k in effects:
        counts = np.bincount(batch.id_tags[k].cpu().numpy())
        caps, lanes = capacity_classes(counts, None, 8, 0.5)
        tracker = fit["best"].descent.trackers[f"per_{k}"][-1]
        rows = []
        for ids, _, it, _, passes in tracker.diag_refs:
            row = dict(lanes=len(ids), max=int(it.max()), mean=float(it.double().mean()))
            if solver == "lbfgs":
                ls = passes - 1 - 2 * it
                row.update(line_search_steps=int(ls.sum()), line_search_steps_max_lane=int(ls.max()))
            rows.append(row)
        out[k] = dict(entities=len(counts), capacities=list(caps), lanes=list(lanes),
                      padded_over_active=sum(c * p for c, p in zip(caps, lanes)) / int(counts.sum()),
                      largest_entity_rows=int(counts.max()), **{f"{solver}_last_visit": rows})
        if solver == "newton":
            out[k]["newton_readbacks_last_visit"] = sum(b["max"] + 1 for b in rows)
    return out


def _game_record(fit: dict, warmup: int = 0) -> dict:
    timed = fit["iteration_wall_s"][warmup:]
    per_visit, reads = {}, {}
    for v in fit["visits"]:
        if v["iteration"] >= warmup:
            per_visit.setdefault(v["coordinate"], []).append(v["wall_s"])
            reads.setdefault(v["coordinate"], []).append(v["readbacks"])
    return dict(wall_s=fit["wall_s"], ingest_s=fit["ingest_s"],
                iteration_wall_s=fit["iteration_wall_s"],
                timed_wall_s_per_outer_iteration=sum(timed) / len(timed),
                timed_wall_s_per_visit={c: sum(w) / len(w) for c, w in per_visit.items()},
                timed_readbacks_per_visit={c: sum(r) / len(r) for c, r in reads.items()},
                launches=fit["launches"], fixed_objective_passes=fit["fixed_objective_passes"],
                fixed_iterations=fit["fixed_iterations"], fixed_objective=fit["fixed_objective"])


def _exchange_per_visit(fit: dict, warmup: int) -> dict:
    """A data-mesh fit's timed visits: per coordinate the mean seconds in
    shard reductions, gloo collectives and the score row gather, and that
    gather's bytes, a visit."""
    out: dict = {}
    for v in fit["visits"]:
        if v["iteration"] >= warmup:
            row = out.setdefault(v["coordinate"], {k: [] for k in _exchange_snapshot()})
            for k in row:
                row[k].append(v[k])
    return {c: {k: sum(x) / len(x) for k, x in row.items()} for c, row in out.items()}


def run_d(dev) -> dict:
    """Config D through the estimator, against ``train_glm`` on the same
    batch and optimizer configuration."""
    batch, data = game_problem(dev, 1 << 18, {}, seed=4)
    fit_game(batch, game_config({}, 1), dev)  # warm-up: first-call costs stay out
    fit = fit_game(batch, game_config({}, 1), dev)
    w = fit["best"].model["fixed"].model.coefficients.means
    ref = train_glm(batch.batch_for("global"), TaskType.LOGISTIC_REGRESSION,
                    optimizer_config=OptimizerConfig(max_iterations=20, tolerance=1e-7),
                    intercept_index=D_FIXED, device=dev)
    ref_t = ref.trackers[0.0]
    rec = dict(_game_record(fit), n=batch.num_rows, d=D_FIXED + 1,
               max_abs_diff_vs_train_glm=float((w - ref.models[0.0].coefficients.means).abs().max()),
               train_glm_iterations=ref_t.iterations, train_glm_objective_passes=ref_t.objective_passes,
               **game_quality(fit, batch, data))
    rec["k1"] = k1_at(batch.features["global"].X, None, batch.labels, dev)
    return rec


def k1_at(X, offsets, labels, dev) -> dict:
    """K1 alone at a main-path shape (logistic, weights 1 and not read,
    offsets read where given): ``k1_time``'s record."""
    gen = torch.Generator(device=dev).manual_seed(11)
    d = X.shape[1]
    u = 0.5 * torch.randn(d, generator=gen, device=dev) / d**0.5
    return k1_time(X, labels, offsets, u, torch.tensor(0.1, device=dev), LOSSES["logistic"], reps=10)


def run_e(dev) -> tuple[dict, object, object, GameModel]:
    """Config E's widths at MovieLens-20M depth: 6 outer iterations in one
    fit, the first 2 a warm-up and the last 4 timed. Returns the record,
    the generated batch and data (``run_e_lbfgs`` reuses them) and the
    model (``run_e_sharded`` is held to it)."""
    n, effects = E_ML20M
    batch, data = game_problem(dev, n, effects, seed=4)
    torch.cuda.reset_peak_memory_stats(dev)
    fit = fit_game(batch, game_config(effects, 6), dev)
    rec = dict(_game_record(fit, warmup=2), n=n, effects={k: list(v) for k, v in effects.items()},
               buckets=bucket_report(fit, batch, effects), **game_quality(fit, batch, data),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        bool(torch.zeros(1, device=dev).all())
    rec["readback_round_trip_s"] = (time.perf_counter() - t0) / 100
    model = fit["best"].model
    del fit
    torch.cuda.empty_cache()
    rec["profile"] = profile_e(batch, effects, dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    rec["k1"] = k1_at(batch.features["global"].X, 0.1 * torch.randn(n, generator=gen, device=dev),
                      batch.labels, dev)
    return rec, batch, data, model


def run_e_lbfgs(dev, batch, data, newton: dict) -> dict:
    """``main_e``'s path (the same batch and schedule) with the random
    effects on L-BFGS, the default solver type, at the fixed effect's
    ``OptimizerConfig`` (20 iterations, tolerance 1e-7) with L2 1; held to
    ``main_e``'s Newton fit (``newton``), which solves the same L2
    problems."""
    n, effects = E_ML20M
    torch.cuda.reset_peak_memory_stats(dev)
    fit = fit_game(batch, game_config(effects, 6, re_solver="LBFGS"), dev)
    rec = dict(_game_record(fit, warmup=2), n=n, effects={k: list(v) for k, v in effects.items()},
               buckets=bucket_report(fit, batch, effects, solver="lbfgs"),
               **game_quality(fit, batch, data),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev))
    rec.update(
        newton_train_auc=newton["train_auc"], newton_train_log_loss=newton["train_log_loss"],
        d_auc_vs_newton=abs(rec["train_auc"] - newton["train_auc"]),
        rel_d_log_loss_vs_newton=abs(rec["train_log_loss"] - newton["train_log_loss"])
        / newton["train_log_loss"],
        newton_timed_wall_s_per_outer_iteration=newton["timed_wall_s_per_outer_iteration"],
    )
    del fit
    torch.cuda.empty_cache()
    rec["profile"] = profile_e(batch, effects, dev, re_solver="LBFGS")
    return rec


def profile_e(batch, effects: dict, dev, re_solver: str = "NEWTON_CHOLESKY") -> dict:
    """``torch.profiler`` over config E's second outer iteration (a fit of
    2; the profiler steps at every visit mark, so it records exactly the
    three visits of iteration 1): the card's busy share of that window's
    wall time (kernel time summed over the window, one stream), the kernel
    launches, and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # steps: 0 the ingest, 1-3 iteration 0's visits, 4-6 iteration 1's
    with profile(activities=acts, schedule=schedule(wait=3, warmup=1, active=3, repeat=1)) as prof:
        fit = fit_game(batch, game_config(effects, 2, re_solver=re_solver), dev, on_mark=prof.step)
    window = sum(v["wall_s"] for v in fit["visits"] if v["iteration"] == 1)
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)  # noqa: E731
    # kernels (and copies) are the entries of device type CUDA; a CPU op's
    # own device column repeats the time of the kernels it launched, and the
    # profiler's step annotations span the whole window
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0
              and not e.key.startswith("ProfilerStep")]
    busy_s = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:12]
    return dict(window_wall_s=window, device_busy_s=busy_s,
                device_busy_share=busy_s / window if window else None,
                device_ops=sum(e.count for e in events),
                top_device_ops=[dict(name=e.key[:90], device_ms=dev_us(e) / 1e3, count=e.count)
                                for e in top])


def agreement_e(dev) -> dict:
    """Config E at bench.py's shape on K1, then with the kernels vetoed."""
    n, effects = E_BENCH
    batch, data = game_problem(dev, n, effects, seed=4)
    config = game_config(effects, 4)
    runs = {}
    for arm in ("fused", "unfused"):
        if arm == "unfused":
            os.environ["PHOTON_DISABLE_FUSED"] = "1"
        try:
            fit_game(batch, config, dev)  # warm-up
            fit = fit_game(batch, config, dev)
        finally:
            os.environ.pop("PHOTON_DISABLE_FUSED", None)
        runs[arm] = dict(_game_record(fit), **game_quality(fit, batch, data))
    f, u = runs["fused"], runs["unfused"]
    return dict(n=n, effects={k: list(v) for k, v in effects.items()}, **runs,
                d_auc=abs(f["train_auc"] - u["train_auc"]),
                rel_d_log_loss=abs(f["train_log_loss"] - u["train_log_loss"]) / u["train_log_loss"])


# the random-effect solver variants of agreement_e_solvers: (optimizer,
# regularization, per-user shard handed over as SparseFeatures)
SOLVER_VARIANTS = {
    "lbfgs": ("LBFGS", RegularizationType.L2, False),
    "tron": ("TRON", RegularizationType.L2, False),
    "owlqn": ("LBFGS", RegularizationType.ELASTIC_NET, False),
    "lbfgs_sparse": ("LBFGS", RegularizationType.L2, True),
}
GROUPED_EVALUATORS = ("MULTI_AUC(userId)", "PRECISION_AT_K(5,userId)", "BUCKETED_AUC")


def sparse_shard(batch, shard: str):
    """The batch with one dense shard handed over as ``SparseFeatures``:
    every row's d columns as d nonzeros, the same values."""
    X = batch.features[shard].X
    n, d = X.shape
    idx = torch.arange(d, device=X.device).expand(n, d).contiguous()
    return replace(batch, features={**batch.features, shard: SparseFeatures(idx, X, d)})


def lanes_vs_single(batch, X, tag: str, lane_W, visit, opt: OptimizationConfig, dev,
                    count: int = 16) -> dict:
    """The lane solutions of a random effect's last visit (``lane_W``)
    against the port's single-GLM solver (``select_minimize_fn``'s, as the
    coordinate picks it) on each of ``count`` entities' rows (spread over
    the entities' row counts, the largest included), with that visit's
    residual offsets and warm start; atol 2e-3 / rtol 1e-2."""
    offsets, W0 = visit
    ids = batch.id_tags[tag]
    counts = torch.bincount(ids)
    present = torch.nonzero(counts).squeeze(1)
    by_rows = present[torch.argsort(counts[present], stable=True)]
    picks = by_rows[torch.linspace(0, len(by_rows) - 1, count, device=dev).round().long()]
    l1 = opt.regularization.l1_weight(opt.regularization_weight)
    l2 = opt.regularization.l2_weight(opt.regularization_weight)
    fn, extra = select_minimize_fn(opt.optimizer, l1)
    worst, ok = 0.0, True
    for e in picks.tolist():
        rows = torch.nonzero(ids == e).squeeze(1)
        b = DenseBatch(X=X[rows], labels=batch.labels[rows], offsets=offsets[rows],
                       weights=batch.weights[rows])
        obj = make_objective(b, LOSSES["logistic"], l2_weight=l2, fused=False, device=dev)
        w0 = torch.zeros(X.shape[1], device=dev) if W0 is None else W0[e]
        w = fn(obj, w0, opt.optimizer, **extra).w
        worst = max(worst, float((lane_W[e] - w).abs().max()))
        ok = ok and bool(torch.allclose(lane_W[e], w, rtol=1e-2, atol=2e-3))
    return dict(entities=len(picks), rows_min=int(counts[picks].min()),
                rows_max=int(counts[picks].max()), max_abs_diff=worst, ok=ok)


def agreement_e_solvers(dev, newton: dict) -> dict:
    """Config E at bench.py's shape with the random effects on L-BFGS,
    TRON, OWL-QN (ELASTIC_NET) and L-BFGS over a sparse per-user shard, 4
    outer iterations each; against ``agreement_e``'s Newton fit of the
    same shape (``newton``), the dense L-BFGS fit, the single-GLM solvers
    and, for the L-BFGS fit, the grouped validation metrics' host
    versions."""
    n, effects = E_BENCH
    batch, data = game_problem(dev, n, effects, seed=4)
    runs, models = {}, {}
    for name, (solver, reg, sparse) in SOLVER_VARIANTS.items():
        vbatch = sparse_shard(batch, "per_userId") if sparse else batch
        evaluators = GROUPED_EVALUATORS if name == "lbfgs" else ()
        config = game_config(effects, 4, re_solver=solver, re_regularization=reg,
                             evaluators=evaluators)
        with recording_visits() as visits:
            fit = fit_game(vbatch, config, dev, validation=batch if evaluators else None)
        best = fit["best"]
        rec = dict(_game_record(fit), **game_quality(fit, batch, data))
        _check_game_launches(f"agreement_e_solvers[{name}]", rec)
        rec["lanes_vs_single"] = {
            k: lanes_vs_single(batch, batch.features[f"per_{k}"].X, k,
                               best.model[f"per_{k}"].coefficients, visits[f"per_{k}"],
                               config.coordinate_config(f"per_{k}").optimization, dev)
            for k in effects
        }
        # coefficients of the entities that have rows
        W = {k: best.model[f"per_{k}"].coefficients[torch.bincount(batch.id_tags[k]) > 0]
             for k in effects}
        rec["exact_zeros"] = {k: int((w == 0).sum()) for k, w in W.items()}
        rec["coefficients"] = {k: int(w.numel()) for k, w in W.items()}
        if evaluators:
            score = best.model.score(batch)
            host = (score.cpu().numpy(), batch.labels.cpu().numpy(),
                    batch.id_tags["userId"].cpu().numpy())
            card = best.evaluation.metrics
            rec["evaluators"] = dict(
                card=dict(card), multi_auc_host=grouped_auc(*host),
                precision_at_5_host=grouped_precision_at_k(*host, 5),
                auc=float(auc_roc(score, batch.labels)))
        runs[name] = rec
        models[name] = best.model
    for name in ("lbfgs", "tron"):
        runs[name]["d_auc_vs_newton"] = abs(runs[name]["train_auc"] - newton["train_auc"])
        runs[name]["rel_d_log_loss_vs_newton"] = abs(
            runs[name]["train_log_loss"] - newton["train_log_loss"]) / newton["train_log_loss"]
    # the sparse shard against the dense one: the same problems, solved to
    # the same float32 stopping rules, which a lane near a threshold meets
    # one iteration apart under another summation order
    sp, de = runs["lbfgs_sparse"], runs["lbfgs"]
    sp["max_abs_diff_vs_dense"] = max(
        float((models["lbfgs_sparse"][cid].coefficient_means
               - models["lbfgs"][cid].coefficient_means).abs().max())
        for cid in models["lbfgs"].models)
    sp["close_to_dense"] = all(
        bool(torch.allclose(models["lbfgs_sparse"][cid].coefficient_means,
                            models["lbfgs"][cid].coefficient_means, rtol=1e-2, atol=2e-3))
        for cid in models["lbfgs"].models)
    sp["d_auc_vs_dense"] = abs(sp["train_auc"] - de["train_auc"])
    sp["rel_d_log_loss_vs_dense"] = abs(sp["train_log_loss"] - de["train_log_loss"]) / de["train_log_loss"]
    ev = runs["lbfgs"]["evaluators"]
    ev.update(d_multi_auc=abs(ev["card"]["MULTI_AUC(userId)"] - ev["multi_auc_host"]),
              d_precision_at_5=abs(ev["card"]["PRECISION_AT_K(5,userId)"] - ev["precision_at_5_host"]),
              d_bucketed_auc=abs(ev["card"]["BUCKETED_AUC"] - ev["auc"]))
    return dict(n=n, effects={k: list(v) for k, v in effects.items()}, newton=dict(
        train_auc=newton["train_auc"], train_log_loss=newton["train_log_loss"]), **runs)


# config E at its bench depth (64 global features and an intercept, 8 per user
# and 8 per item, 20,000 users and 4,000 items, Zipf 1.5), with a quarter as
# many validation rows, in Avro part files: the Python codec, not the card,
# keeps the depth below ML-20M's
GAME_CLI = dict(train=E_BENCH[0], val=E_BENCH[0] // 4, parts=2, effects=E_BENCH[1])
GAME_CLI_BAGS = {"userId": "userFeatures", "itemId": "itemFeatures"}
GAME_CLI_EVALUATORS = ("AUC", "MULTI_AUC(userId)")
RESUME_LINE = "resuming coordinate descent from checkpoint at outer iteration 2"


def game_cli_config(effects: dict, iterations: int, projections: dict | None = None,
                    tuning_iters: int = 0) -> GameTrainingConfig:
    """The GAME driver's configuration: the fixed effect on L-BFGS (20
    iterations at 1e-7, L2 over the grid λ ∈ {0.1, 1}), each random effect
    on the default L-BFGS at the same settings with L2 1 and E's bucket
    ladder; validated by AUC and MULTI_AUC(userId); every grid entry's
    model written (output mode ALL). ``projections`` (id tag → projector
    fields of its random effect) and ``tuning_iters`` (the Bayesian search's
    refits after the grid) add the options of ``main_game_cli_full``."""
    projections = projections or {}
    l2 = RegularizationContext(RegularizationType.L2)
    opt = OptimizerConfig(max_iterations=20, tolerance=1e-7)
    return GameTrainingConfig(
        task_type=TaskType.LOGISTIC_REGRESSION,
        coordinate_update_sequence=("fixed", *(f"per_{k}" for k in effects)),
        coordinate_descent_iterations=iterations,
        fixed_effect_coordinates={"fixed": FixedEffectCoordinateConfig(
            "global", OptimizationConfig(optimizer=opt, regularization=l2))},
        random_effect_coordinates={
            f"per_{k}": RandomEffectCoordinateConfig(
                random_effect_type=k, feature_shard_id=f"per_{k}",
                optimization=OptimizationConfig(optimizer=opt, regularization=l2,
                                                regularization_weight=1.0),
                bucket_target_count=8, bucket_max_padded_ratio=0.5, **projections.get(k, {}),
            )
            for k in effects
        },
        feature_shards={
            "global": FeatureShardConfig(feature_bags=("features",), has_intercept=True),
            **{f"per_{k}": FeatureShardConfig(feature_bags=(GAME_CLI_BAGS[k],), has_intercept=False)
               for k in effects},
        },
        evaluators=GAME_CLI_EVALUATORS,
        output_mode=ModelOutputMode.ALL,
        regularization_weight_grid={"fixed": (0.1, 1.0)},
        hyperparameter_tuning_iters=tuning_iters,
    )


def game_cli_records(host: dict, lo: int, hi: int):
    """``TrainingExampleAvro`` records of rows [lo, hi) (``host`` holds those
    rows only, as lists): the global bag (the 64 features; the reader adds
    the intercept), one bag per effect and the entity ids as metadata tags.
    Values are float32, so they cross the file exactly."""
    X, y = host["X"], host["y"]
    for r, i in enumerate(range(lo, hi)):
        rec = {"uid": i, "response": y[r], "offset": None, "weight": None,
               "features": [{"name": "g", "term": str(j), "value": v}
                            for j, v in enumerate(X[r][:D_FIXED])],
               "metadataMap": {k: f"{k}_{host['ids'][k][r]}" for k in GAME_CLI_BAGS}}
        for k, bag in GAME_CLI_BAGS.items():
            rec[bag] = [{"name": k, "term": str(j), "value": v} for j, v in enumerate(host["Xe"][k][r])]
        yield rec


def first_seen(ids: np.ndarray, n_train: int) -> np.ndarray:
    """Entity ids renumbered as the Avro reader numbers them: in order of
    first appearance in the training rows; ids absent from them become -1."""
    uniq, first = np.unique(ids[:n_train], return_index=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first)] = np.arange(len(uniq))
    pos = np.clip(np.searchsorted(uniq, ids), 0, len(uniq) - 1)
    return np.where(uniq[pos] == ids, rank[pos], -1)


@contextmanager
def recording_fits():
    """Keeps each ``GameEstimator.fit``'s training batch and results."""
    seen = []
    fit = GameEstimator.fit

    def recorded(self, batch, *args, **kwargs):
        results = fit(self, batch, *args, **kwargs)
        seen.append((batch, results))
        return results

    GameEstimator.fit = recorded
    try:
        yield seen
    finally:
        GameEstimator.fit = fit


@contextmanager
def recording_streamed_trainers():
    """Keeps each out-of-core trainer the GAME driver builds, with the row
    count of the data it fits (``rows``: the process's own)."""
    seen, real = [], cli_train.StreamedGameTrainer

    def trainer(*args, **kwargs):
        t = real(*args, **kwargs)
        fit = t.fit

        def recorded(data, *a, **k):
            t.rows = data.num_rows
            return fit(data, *a, **k)

        t.fit = recorded
        seen.append(t)
        return t

    cli_train.StreamedGameTrainer = trainer
    try:
        yield seen
    finally:
        cli_train.StreamedGameTrainer = real


@contextmanager
def stage_times(*modules):
    """Seconds of each ``timed`` stage the drivers of ``modules`` log, the
    card synchronized at its end."""
    times = {}
    saved = [(m, m.timed) for m in modules]

    @contextmanager
    def recording(logger, stage):
        t0 = time.perf_counter()
        with saved[0][1](logger, stage):
            yield
            torch.cuda.synchronize()
        times[stage] = times.get(stage, 0.0) + time.perf_counter() - t0

    for m, _ in saved:
        m.timed = recording
    try:
        yield times
    finally:
        for m, fn in saved:
            m.timed = fn


def _max_diff(a: GameModel, b: GameModel) -> float:
    return max(float((a[c].coefficient_means - b[c].coefficient_means.to(a[c].coefficient_means.device))
                     .abs().max()) for c in a.models)


def _close(a: GameModel, b: GameModel, rtol: float, atol: float) -> bool:
    return all(torch.allclose(a[c].coefficient_means, b[c].coefficient_means, rtol=rtol, atol=atol)
               for c in a.models)


@dataclass
class GameCliData:
    """The GAME driver phases' Avro part files (written under ``work``) and
    the same rows as arrays on the card, entities numbered as the reader
    numbers them."""

    work: str
    effects: dict
    n_train: int
    n_val: int
    arrays: list  # [training batch, validation batch]
    gen_margin: torch.Tensor  # the generating model's validation margins
    write_s: float
    avro_bytes: int


def _write_game_cli_part(path: str, schema: dict, host: dict, lo: int, hi: int) -> None:
    """One part file of rows [lo, hi) (``host``'s arrays hold those rows
    only): a worker process's share of ``game_cli_data``'s writing."""
    rows = dict(X=host["X"].tolist(), y=host["y"].tolist(), ids=host["ids"],
                Xe={k: v.tolist() for k, v in host["Xe"].items()})
    write_avro_file(path, schema, game_cli_records(rows, lo, hi))


def game_cli_data(dev, work: str, sizes: dict = GAME_CLI) -> GameCliData:
    """Config E's rows drawn on the card and written as Avro part files with
    the port's codec, one worker process a part file (all started
    together; the codec is pure Python)."""
    effects, n_tr, n_va = sizes["effects"], sizes["train"], sizes["val"]
    data = synthetic_game_data(7, n_tr + n_va, D_FIXED, effects, device=dev)
    host = dict(X=data.X.cpu().numpy(), y=data.y.cpu().numpy(),
                ids={k: v.cpu().numpy() for k, v in data.entity_ids.items()},
                Xe={k: v.cpu().numpy() for k, v in data.entity_X.items()})
    schema = json.loads(json.dumps(TRAINING_EXAMPLE_SCHEMA))
    for bag in GAME_CLI_BAGS.values():
        schema["fields"].insert(5, {"name": bag, "type": {"type": "array", "items": "NameTermValueAvro"},
                                    "default": []})
    parts = []
    for split, lo, n in (("train", 0, n_tr), ("val", n_tr, n_va)):
        step = n // sizes["parts"]
        os.makedirs(os.path.join(work, split), exist_ok=True)
        parts += [(os.path.join(work, split, f"part-{p:05d}.avro"), lo + p * step, lo + (p + 1) * step)
                  for p in range(sizes["parts"])]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(len(parts), mp_context=multiprocessing.get_context("spawn")) as pool:
        for f in [pool.submit(_write_game_cli_part, path, schema,
                              dict(X=host["X"][a:b], y=host["y"][a:b],
                                   ids={k: v[a:b] for k, v in host["ids"].items()},
                                   Xe={k: v[a:b] for k, v in host["Xe"].items()}), a, b)
                  for path, a, b in parts]:
            f.result()
    write_s = time.perf_counter() - t0
    avro_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(work) for f in fs)

    ids = {k: first_seen(v, n_tr) for k, v in host["ids"].items()}
    feats = {"global": data.X, **{f"per_{k}": data.entity_X[k] for k in effects}}
    arrays = [make_game_batch(data.y[rows], {s: f[rows] for s, f in feats.items()},
                              id_tags={k: v[rows] for k, v in ids.items()}, device=dev)
              for rows in (slice(0, n_tr), slice(n_tr, None))]
    gen_margin = data.X[n_tr:] @ data.w_fixed
    for k, v in data.entity_ids.items():
        gen_margin = gen_margin + torch.einsum("nd,nd->n", data.entity_X[k][n_tr:], data.w_entity[k][v[n_tr:]])
    return GameCliData(work=work, effects=effects, n_train=n_tr, n_val=n_va, arrays=arrays,
                       gen_margin=gen_margin, write_s=write_s, avro_bytes=avro_bytes)


@contextmanager
def recording_decoders():
    """The decoder (``"native"`` or ``"python"``) of every dataset the
    drivers read."""
    seen = []
    read = AvroDataReader.read

    def recorded(self, *args, **kwargs):
        ds = read(self, *args, **kwargs)
        seen.append(ds.decoder)
        return ds

    AvroDataReader.read = recorded
    try:
        yield seen
    finally:
        AvroDataReader.read = read


def _same_dataset(a, b) -> bool:
    """Two host datasets equal bit for bit: maps, ids, uids, every column."""
    if not (a.entity_maps == b.entity_maps and a.uids == b.uids
            and {s: list(m.items()) for s, m in a.index_maps.items()}
            == {s: list(m.items()) for s, m in b.index_maps.items()}):
        return False
    pa, pb = a.batch, b.batch
    cols = [(getattr(pa, c), getattr(pb, c)) for c in ("labels", "offsets", "weights")]
    cols += [(pa.id_tags[t], pb.id_tags[t]) for t in pa.id_tags]
    for sid, f in pa.features.items():
        g = pb.features[sid]
        cols += [(f.X, g.X)] if hasattr(f, "X") else [(f.indices, g.indices), (f.values, g.values)]
    return all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y) for x, y in cols)


def native_read_parity(data: GameCliData) -> dict:
    """One training part file read on the host by the native decoder and by
    the Python codec (its plain version): equal bit for bit; each one's ms
    a record."""
    shards = game_cli_config(data.effects, 1).feature_shards
    reader = AvroDataReader(shards)
    path = os.path.join(data.work, "train", "part-00000.avro")
    tags = tuple(GAME_CLI_BAGS)
    out = {}
    for use_native in (True, False):
        t0 = time.perf_counter()
        ds = reader.read(path, id_tags=tags, device="cpu", use_native=use_native)
        out["native" if use_native else "python"] = (ds, time.perf_counter() - t0)
    (nat, nat_s), (py, py_s) = out["native"], out["python"]
    rows = nat.batch.num_rows
    return dict(rows=rows, native_decoder=nat.decoder, python_decoder=py.decoder,
                native_ms_per_record=1e3 * nat_s / rows, python_ms_per_record=1e3 * py_s / rows,
                speedup=py_s / nat_s, bitwise_equal=_same_dataset(nat, py))


def run_game_cli(dev, data: GameCliData) -> dict:
    """The GAME train then score drivers on Avro part files, as a user runs
    them (``cli.train.main``, ``cli.score.main``, ``cli.train_glm.main``),
    each held to the library on the same arrays and the same card; every
    read on the native decoder."""
    work, effects, n_tr, n_va, arrays = data.work, data.effects, data.n_train, data.n_val, data.arrays
    out = os.path.join(work, "out")
    argv = lambda cfg: ["--config", cfg, "--train-data", os.path.join(work, "train"),  # noqa: E731
                        "--validation-data", os.path.join(work, "val"), "--output-dir", out,
                        "--device", dev.type]
    cfg_paths = {}
    for it in (2, 3):
        cfg_paths[it] = os.path.join(work, f"config-{it}.json")
        with open(cfg_paths[it], "w") as f:
            json.dump(game_cli_config(effects, it).to_dict(), f)

    # the driver, 2 outer iterations; K1's launches counted from 0
    torch.cuda.reset_peak_memory_stats()
    with recording_fits() as fits, stage_times(cli_train) as train_stages:
        fused.reset_launch_counts()
        st.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_train.main(argv(cfg_paths[2]))
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # the 2-iteration run's files, which main_game_multihost_cli is held to
    shutil.copytree(out, os.path.join(work, "out-2it"), ignore=shutil.ignore_patterns("checkpoints"))
    batch, results = fits[0]
    fixed_passes = sum(t.objective_passes for r in results for t in r.descent.trackers["fixed"])
    layout = k1_layout(batch.features["global"].X, batch.labels, batch.offsets, batch.weights)
    with open(os.path.join(out, "metrics.json")) as f:
        metrics2 = json.load(f)
    maps = {fn[:-4]: IndexMap.load(os.path.join(out, "index-maps", fn))
            for fn in os.listdir(os.path.join(out, "index-maps"))}
    with open(os.path.join(out, "entity-maps.json")) as f:
        ent = json.load(f)
    entity_ids = {f"per_{k}": ent[k] for k in effects}

    def load_best():
        return load_game_model(os.path.join(out, "best"), index_maps=maps, entity_ids=entity_ids,
                               device=dev)

    driver2 = load_best()
    files = sorted(os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out) for f in fs)
    expected = ["best/metadata.json", "entity-maps.json", "metrics.json", "photon.log",
                "checkpoints/config-0000/ckpt.npz", "checkpoints/config-0001/ckpt.npz",
                "models/0000/metadata.json", "models/0001/metadata.json",
                *[f"index-maps/{s}.npz" for s in ("global", *(f"per_{k}" for k in effects))],
                *[f"{m}/random-effect/per_{k}/coefficients/part-00000.avro"
                  for m in ("best", "models/0000", "models/0001") for k in effects],
                *[f"{m}/fixed-effect/fixed/coefficients/part-00000.avro"
                  for m in ("best", "models/0000", "models/0001")]]
    outputs_ok = (set(expected) <= set(files) and set(metrics2) == {"results", "best_index"}
                  and all(set(r["metrics"]) == set(GAME_CLI_EVALUATORS) for r in metrics2["results"])
                  and len(metrics2["results"]) == 2)

    # the library on the same arrays, the same card
    def library(iterations: int):
        est = GameEstimator(game_cli_config(effects, iterations), intercept_indices={"global": D_FIXED},
                            device=dev)
        res = est.fit(arrays[0], validation_batch=arrays[1])
        return res, est.select_best(res)

    t0 = time.perf_counter()
    lib2_results, lib2 = library(2)
    torch.cuda.synchronize()
    library_fit_s = time.perf_counter() - t0

    # resume: 3 outer iterations into the same directory, against a fresh run
    with stage_times(cli_train) as resume_stages:
        cli_train.main(argv(cfg_paths[3]))
    with open(os.path.join(out, "photon.log")) as f:
        resumed_lines = f.read().count(RESUME_LINE)
    with open(os.path.join(out, "metrics.json")) as f:
        metrics3 = json.load(f)
    driver3 = load_best()
    lib3_results, lib3 = library(3)

    # score the validation files with that directory
    score_out = os.path.join(work, "scores")
    with stage_times(cli_score) as score_stages:
        cli_score.main(["--model-dir", out, "--data", os.path.join(work, "val"), "--output-dir", score_out,
                        "--evaluators", *GAME_CLI_EVALUATORS, "--config", cfg_paths[3],
                        "--device", dev.type])
    _, recs = read_avro_file(os.path.join(score_out, "scores", "part-00000.avro"))
    file_scores = torch.tensor([r["predictionScore"] for r in recs], dtype=torch.float64)
    in_memory = GameTransformer(driver3, device=dev).transform(arrays[1]).double().cpu()
    with open(os.path.join(score_out, "metrics.json")) as f:
        score_metrics = json.load(f)
    best3 = metrics3["results"][metrics3["best_index"]]["metrics"]

    # the GLM twin on the training files' global shard, 3 λ
    glm_out = os.path.join(work, "glm")
    fused.reset_launch_counts()
    with stage_times(cli_train_glm) as glm_stages:
        cli_train_glm.main(["--task", "LOGISTIC_REGRESSION", "--format", "avro", "--train-data",
                            os.path.join(work, "train"), "--weights", "0.1", "1", "10",
                            "--max-iterations", "20", "--tolerance", "1e-7", "--device", dev.type,
                            "--output-dir", glm_out])
    glm_launches = launch_counts()
    twin = load_glm(os.path.join(glm_out, "best", "model.avro"), index_map=maps["global"], device=dev)
    ref = train_glm(arrays[0].batch_for("global"), TaskType.LOGISTIC_REGRESSION,
                    optimizer_config=OptimizerConfig(max_iterations=20, tolerance=1e-7),
                    regularization=RegularizationContext(RegularizationType.L2),
                    regularization_weights=[0.1, 1.0, 10.0], intercept_index=D_FIXED, device=dev)

    val_labels = arrays[1].labels
    rows = n_tr + n_va
    return dict(
        rows_train=n_tr, rows_validation=n_va, entities={k: len(ent[k]) for k in effects},
        avro_bytes=data.avro_bytes, write_s=data.write_s, write_ms_per_record=1e3 * data.write_s / rows,
        train_wall_s=train_wall, train_stages_s=train_stages,
        read_ms_per_record=1e3 * train_stages["read training data"] / n_tr,
        ingest_share=(train_stages["read training data"] + train_stages["read validation data"]) / train_wall,
        pr7_python_reader=dict(read_ms_per_record=0.307, train_wall_s=102.99, ingest_share=0.960),
        library_fit_s=library_fit_s, resume_stages_s=resume_stages, score_stages_s=score_stages,
        glm_stages_s=glm_stages, launches=launches, fixed_objective_passes=fixed_passes,
        k1_layout=layout, glm_launches=glm_launches, peak_memory_bytes=peak,
        outputs_ok=outputs_ok, best_index=metrics2["best_index"],
        validation_metrics={i: r["metrics"] for i, r in enumerate(metrics2["results"])},
        auc_generating_model=float(auc_roc(data.gen_margin, val_labels)),
        max_abs_diff_driver_vs_library=_max_diff(driver2, lib2.model),
        library_best_index=next(i for i, r in enumerate(lib2_results) if r is lib2),
        resumed_lines=resumed_lines,
        resume_ok=_close(driver3, lib3.model, 1e-4, 1e-5)
        and metrics3["best_index"] == next(i for i, r in enumerate(lib3_results) if r is lib3),
        max_abs_diff_resumed_vs_fresh=_max_diff(driver3, lib3.model),
        scores_rows=len(recs), scores_finite=bool(torch.isfinite(file_scores).all()),
        max_abs_diff_scores_file_vs_memory=float((file_scores - in_memory).abs().max()),
        score_auc=score_metrics["AUC"], train_best_auc=best3["AUC"],
        score_multi_auc=score_metrics["MULTI_AUC(userId)"],
        d_auc_score_vs_train=abs(score_metrics["AUC"] - best3["AUC"]),
        max_abs_diff_glm_twin_vs_train_glm=float(
            (twin.coefficients.means - ref.best_model.coefficients.means).abs().max()),
    )


# the projectors of main_game_cli_full and main_e_projected: each user in the
# subspace of its ceil(capacity / 4) most frequent columns (the buckets of
# capacity 1 to 16, where most users are, solve over 1 to 4 of their 8
# columns; at ratio 1 no bucket of capacity 8 or more, hence none at all
# under E's ladder, would be narrowed), the items over a shared random
# projection to half their 8 columns
PROJECTIONS = {"userId": dict(features_to_samples_ratio_upper_bound=0.25),
               "itemId": dict(random_projection_dim=4)}
TUNING_ITERS = 4


@contextmanager
def recording_random_effects():
    """Per random-effect coordinate: its buckets' lanes, capacity and solve
    width, and the lane solutions (in the solve space: projected for a
    random projection) of its latest visit."""
    seen: dict[str, dict] = {}
    train, solve = RandomEffectCoordinate.train, game_coordinate.train_prepared
    current = [None]

    def recorded_train(self, offsets, initial=None):
        current[0] = self.coordinate_id
        out = train(self, offsets, initial)
        seen.setdefault(self.coordinate_id, {})["buckets"] = [
            dict(lanes=pb.num_real, capacity=pb.capacity,
                 width=pb.static.X.shape[-1] if hasattr(pb.static, "X") else pb.static.num_features)
            for pb in self._prepared
        ]
        return out

    def recorded_solve(*args, **kwargs):
        res = solve(*args, **kwargs)
        seen.setdefault(current[0], {})["solution"] = res.coefficients
        return res

    RandomEffectCoordinate.train, game_coordinate.train_prepared = recorded_train, recorded_solve
    try:
        yield seen
    finally:
        RandomEffectCoordinate.train, game_coordinate.train_prepared = train, solve


def projection_exactness(model, batch, cid: str, tag: str, solution, dim: int, seed: int = 0) -> dict:
    """Scores of the stored original-space coefficients against (XP)·w_p
    from the lane solutions, on the card (P rebuilt as the estimator builds
    it)."""
    X = batch.features[cid].X
    P = RandomProjector.build(X.shape[1], dim, seed=seed, device=X.device).matrix
    ids = batch.id_tags[tag]
    stored = model[cid].score(batch)
    projected = torch.einsum("np,np->n", X.float() @ P, solution[ids])
    err = float((stored - projected).abs().max())
    scale = float(projected.abs().max())
    return dict(max_abs_diff=err, max_abs_score=scale, rel_to_scale=err / scale,
                ok=err <= 1e-5 * scale)


def run_game_cli_full(dev, data: GameCliData, glm_prior: str) -> dict:
    """The GAME train driver again over ``main_game_cli``'s part files with
    every option one host has: the per-user subspace and per-item random
    projection, the Bayesian search's refits after the grid, and
    ``--diagnostics``; held to ``GameEstimator.fit`` plus
    ``tune_game_hyperparameters`` on the same arrays and card. Then the GLM
    twin with ``--summarize-features``, ``--validate``, ``--diagnostics``
    and ``--prior-model`` (``main_game_cli``'s twin model), held to
    ``train_glm`` with the same prior."""
    work, effects, arrays = data.work, data.effects, data.arrays
    config = game_cli_config(effects, 2, projections=PROJECTIONS, tuning_iters=TUNING_ITERS)
    cfg_path, out = os.path.join(work, "config-full.json"), os.path.join(work, "out-full")
    with open(cfg_path, "w") as f:
        json.dump(config.to_dict(), f)
    torch.cuda.reset_peak_memory_stats()
    with recording_fits() as fits, stage_times(cli_train) as stages, recording_random_effects() as re_seen:
        fused.reset_launch_counts()
        st.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_train.main(["--config", cfg_path, "--train-data", os.path.join(work, "train"),
                        "--validation-data", os.path.join(work, "val"), "--output-dir", out,
                        "--diagnostics", "--device", dev.type])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    fixed_passes = sum(t.objective_passes for _, results in fits for r in results
                       for t in r.descent.trackers["fixed"])
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    maps = {fn[:-4]: IndexMap.load(os.path.join(out, "index-maps", fn))
            for fn in os.listdir(os.path.join(out, "index-maps"))}
    with open(os.path.join(out, "entity-maps.json")) as f:
        ent = json.load(f)
    driver = load_game_model(os.path.join(out, "best"), index_maps=maps,
                             entity_ids={f"per_{k}": ent[k] for k in effects}, device=dev)

    est = GameEstimator(config, intercept_indices={"global": D_FIXED}, device=dev)
    t0 = time.perf_counter()
    results = est.fit(arrays[0], validation_batch=arrays[1])
    results = list(results) + tune_game_hyperparameters(est, arrays[0], arrays[1], results, TUNING_ITERS)
    lib = est.select_best(results)
    torch.cuda.synchronize()
    library_s = time.perf_counter() - t0
    lambdas = lambda rs: [r["configuration"]["fixed"]["regularization_weight"] for r in rs]  # noqa: E731

    glm_out = os.path.join(work, "glm-full")
    fused.reset_launch_counts()
    with stage_times(cli_train_glm) as glm_stages:
        cli_train_glm.main(["--task", "LOGISTIC_REGRESSION", "--format", "avro", "--train-data",
                            os.path.join(work, "train"), "--weights", "0.1", "1", "10",
                            "--max-iterations", "20", "--tolerance", "1e-7", "--summarize-features",
                            "--validate", "VALIDATE_FULL", "--diagnostics", "--prior-model", glm_prior,
                            "--device", dev.type, "--output-dir", glm_out])
    glm_launches = launch_counts()
    twin = load_glm(os.path.join(glm_out, "best", "model.avro"), index_map=maps["global"], device=dev)
    prior = load_glm(glm_prior, index_map=maps["global"], num_features=D_FIXED + 1,
                     task=TaskType.LOGISTIC_REGRESSION, device=dev)
    ref = train_glm(arrays[0].batch_for("global"), TaskType.LOGISTIC_REGRESSION,
                    optimizer_config=OptimizerConfig(max_iterations=20, tolerance=1e-7),
                    regularization=RegularizationContext(RegularizationType.L2),
                    regularization_weights=[0.1, 1.0, 10.0], intercept_index=D_FIXED,
                    initial_model=prior, incremental=True, device=dev)
    files = {d: set(os.listdir(d)) for d in (out, glm_out)}
    return dict(
        train_wall_s=wall, train_stages_s=stages, library_fit_and_tuning_s=library_s,
        read_ms_per_record=1e3 * stages["read training data"] / data.n_train,
        ingest_share=(stages["read training data"] + stages["read validation data"]) / wall,
        fits=len(fits), launches=launches, fixed_objective_passes=fixed_passes, peak_memory_bytes=peak,
        configurations=len(metrics["results"]), fixed_lambdas=lambdas(metrics["results"]),
        library_fixed_lambdas=[r.configuration["fixed"].regularization_weight for r in results],
        best_index=metrics["best_index"], library_best_index=next(i for i, r in enumerate(results) if r is lib),
        best_metrics=metrics["results"][metrics["best_index"]]["metrics"],
        max_abs_diff_driver_vs_library=_max_diff(driver, lib.model),
        solve_widths={cid: v["buckets"] for cid, v in re_seen.items()},
        diagnostics_written={"diagnostics.json", "diagnostics.html"} <= files[out],
        glm_stages_s=glm_stages, glm_launches=glm_launches,
        glm_files_written={"diagnostics.json", "diagnostics.html", "summary", "best"} <= files[glm_out],
        max_abs_diff_glm_twin_vs_train_glm=float(
            (twin.coefficients.means - ref.best_model.coefficients.means).abs().max()),
    )


def run_e_projected(dev, batch, data, lbfgs: dict) -> dict:
    """``main_e_lbfgs``'s batch and schedule (MovieLens-20M depth, L-BFGS
    random effects, 2 warm-up and 4 timed outer iterations) with each user
    in its subspace and the items over a random projection to 4 columns."""
    n, effects = E_ML20M
    config = game_config(effects, 6, re_solver="LBFGS")
    config = config.replace(random_effect_coordinates={
        cid: c.replace(**PROJECTIONS[c.random_effect_type])
        for cid, c in config.random_effect_coordinates.items()
    })
    torch.cuda.reset_peak_memory_stats(dev)
    with recording_random_effects() as re_seen:
        fit = fit_game(batch, config, dev)
    rec = dict(_game_record(fit, warmup=2), n=n, effects={k: list(v) for k, v in effects.items()},
               **game_quality(fit, batch, data),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev),
               solve_widths={cid: v["buckets"] for cid, v in re_seen.items()})
    rec.update(lbfgs_train_auc=lbfgs["train_auc"], d_auc_vs_lbfgs=rec["train_auc"] - lbfgs["train_auc"],
               lbfgs_timed_wall_s_per_outer_iteration=lbfgs["timed_wall_s_per_outer_iteration"])
    rec["random_projection_scores"] = projection_exactness(
        fit["best"].model, batch, "per_itemId", "itemId", re_seen["per_itemId"]["solution"],
        PROJECTIONS["itemId"]["random_projection_dim"])
    return rec


# ---------------------------------------------------------------------------
# phases 18-21: the out-of-core GLM path
# ---------------------------------------------------------------------------
# main_f: config A's width (logistic, d = 512, float32), 2^22 rows: 8 GiB of
# X on the host in 16 chunks of 2^18 rows (512 MiB each)
F_ROWS, F_D, F_CHUNK = 1 << 22, 512, 1 << 18
B_CHUNK, A2_CHUNK, GLM_CLI_CHUNK = 1 << 17, 1 << 16, 1 << 15
E_STREAM_CHUNK = 1 << 20  # main_e_streamed: 20 chunks, the last 77,319 rows and padding
STREAMED_RESUME_LINE = "resuming streamed descent at outer iteration 2, coordinate index 0"
GLM_CLI_WEIGHTS = ("0.1", "1", "10")


def host_memory() -> dict:
    """The process's resident host memory and its peak so far, and the
    pinned memory PyTorch's caching host allocator holds (its byte
    counters since ``reset_peak_host_memory_stats``), bytes."""
    import resource

    out = {"peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
           "pinned": {k: v for k, v in torch.cuda.host_memory_stats().items() if "bytes" in k}}
    with open("/proc/self/status") as f:
        for line in f:
            key, _, rest = line.partition(":")
            if key == "VmRSS":
                out["rss_bytes"] = int(rest.split()[0]) * 1024
    return out


@contextmanager
def environment(values: dict):
    """``os.environ`` with ``values`` set, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def streamed_solve(chunks, task, d, config, dev, **kw):
    """``train_glm_streamed`` at λ = 1 with every kernel's launch count and
    the pipeline's stage counters zeroed just before it and read just
    after; returns (result, wall seconds, launches)."""
    fused.reset_launch_counts()
    st.reset_launch_counts()
    prefetch.reset_stage_seconds()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = train_glm_streamed(chunks, task, d, config, regularization_weights=[1.0], device=dev, **kw)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, launch_counts()


def f_chunks(dev, keep: range | None = None) -> list[dict]:
    """main_f's 16 chunks, drawn on the card from one seeded generator (X
    N(0, 1) with column j scaled by exp(4j/511 − 2), so the solve is
    ill-conditioned enough to take its iterations, the intercept at column
    511, labels Bernoulli(sigmoid(X·w))) and copied to the host. ``keep``
    names the chunks copied (all by default); every chunk is drawn, in
    order, so a kept chunk is main_f's whatever else is kept."""
    gen = torch.Generator(device=dev).manual_seed(21)
    w_true = torch.randn(F_D, generator=gen, device=dev) / F_D**0.5
    scale = torch.exp(torch.linspace(-2.0, 2.0, F_D, device=dev))
    chunks = []
    for i in range(F_ROWS // F_CHUNK):
        X = torch.randn((F_CHUNK, F_D), generator=gen, device=dev) * scale
        X[:, F_D - 1] = 1.0
        y = (torch.rand(F_CHUNK, generator=gen, device=dev) < torch.sigmoid(X @ w_true)).float()
        if keep is not None and i not in keep:
            continue
        chunks.append(dict(X=X.cpu().numpy(), labels=y.cpu().numpy(),
                           offsets=np.zeros(F_CHUNK, np.float32), weights=np.ones(F_CHUNK, np.float32)))
    return chunks


def pinned_h2d_gb_s(dev, nbytes: int = F_CHUNK * F_D * 4) -> float:
    """The card's host-to-device rate from pinned memory: one 512 MiB copy."""
    host = torch.ones(nbytes // 4, dtype=torch.float32).pin_memory()
    out = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
    ms = cuda_ms(lambda: out.copy_(host, non_blocking=True), 5)
    return nbytes / (ms * 1e-3) / 1e9


def busy_share(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the union of the
    intervals in which the card ran a kernel (and a kernel or a copy) over
    the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def union_s(spans) -> float:
        total, end = 0.0, -1.0
        for a, b in sorted(spans):
            if b > end:
                total += b - max(a, end)
                end = b
        return total / 1e6

    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [(e.time_range.start, e.time_range.end) for e in dev_events if "Memcpy" not in e.name]
    everything = [(e.time_range.start, e.time_range.end) for e in dev_events]
    if not everything:
        return dict(wall_s=wall, busy_share="not measured (no device events in the trace)")
    return dict(wall_s=wall, kernel_busy_s=union_s(kernels), busy_s=union_s(everything),
                kernel_busy_share=union_s(kernels) / wall, busy_share=union_s(everything) / wall)


def k2_at(X, labels) -> dict:
    """K2 alone at a streamed chunk's shape (squared loss, offsets and
    weights read as the streamed objective reads them): ``k2_time``'s
    record."""
    n, d = X.shape
    dev = X.device
    gen = torch.Generator(device=dev).manual_seed(12)
    u = 0.5 * torch.randn(d, generator=gen, device=dev) / d**0.5
    v = torch.randn(d, generator=gen, device=dev) / d**0.5
    off, wt = torch.zeros(n, device=dev), torch.ones(n, device=dev)
    return k2_time(X, labels, off, wt, u, v, torch.tensor(0.1, device=dev), torch.tensor(-0.05, device=dev),
                   LOSSES["squared"])


def k1_at_b_chunk(X, labels) -> dict:
    """K1 alone at config B's streamed chunk (squared loss, offsets and
    weights read as the streamed objective reads them): ``k1_time``'s
    record."""
    n, d = X.shape
    dev = X.device
    gen = torch.Generator(device=dev).manual_seed(13)
    u = 0.5 * torch.randn(d, generator=gen, device=dev) / d**0.5
    off, wt = torch.zeros(n, device=dev), torch.ones(n, device=dev)
    return k1_time(X, labels, off, u, torch.tensor(0.1, device=dev), LOSSES["squared"], weights=wt)


def run_f(dev, card: str) -> dict:
    """main_f: the dense out-of-core solve (host L-BFGS, 10 iterations at
    tolerance 0, λ = 1) over 8 GiB of host chunks in three arms: (a) a 2 GiB
    chunk cache, (b) the default cache, (c) ``PHOTON_PREFETCH_DEPTH=0``
    (no worker threads, the default cache);
    then ``value_and_grad`` and ``train_glm`` on the same 8 GiB on the card."""
    t0 = time.perf_counter()
    chunks = f_chunks(dev)
    rec = dict(card=card, n=F_ROWS, d=F_D, chunk_rows=F_CHUNK, chunks=len(chunks),
               host_bytes=sum(c["X"].nbytes for c in chunks), data_s=time.perf_counter() - t0,
               pinned_h2d_gb_s=pinned_h2d_gb_s(dev), arms={})
    X0 = torch.from_numpy(chunks[0]["X"]).to(dev)  # K1 alone at the chunk's shape, offsets read
    rec["k1_at_chunk"] = k1_at(X0, torch.zeros(F_CHUNK, device=dev), torch.from_numpy(chunks[0]["labels"]).to(dev),
                               dev)
    del X0
    cfg = OptimizerConfig(max_iterations=10, tolerance=0.0)
    arms = {"a_cache_2GiB": {"PHOTON_CHUNK_CACHE_BUDGET": str(2 << 30)}, "b_default": {},
            "c_depth_0": {"PHOTON_PREFETCH_DEPTH": "0"}}
    solutions = {}
    for name, env in arms.items():
        with environment(env):
            prefetch.clear_cache()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.reset_peak_host_memory_stats()
            result, wall, launches = streamed_solve(chunks, TaskType.LOGISTIC_REGRESSION, F_D, cfg, dev,
                                                    intercept_index=F_D - 1)
            t = result.trackers[1.0]
            stats, stages, copied = prefetch.cache_stats(), REGISTRY.timer_snapshot("prefetch."), dict(prefetch.copied)
            arm = dict(
                iterations=t.iterations, objective_passes=t.objective_passes, objective=float(t.value),
                wall_s=wall, wall_s_per_pass=wall / t.objective_passes, launches=launches,
                k1_per_chunk_and_pass=launches["fused_value_grad"] / (len(chunks) * t.objective_passes),
                bytes_copied_per_pass=copied["bytes"] / t.objective_passes,
                copy_gb_s=copied["bytes"] / wall / 1e9,
                copy_share_of_pinned_rate=copied["bytes"] / wall / 1e9 / rec["pinned_h2d_gb_s"],
                cache=stats, stage_seconds=stages, chunk_cache_budget_bytes=prefetch.chunk_cache_budget_bytes(dev),
                peak_device_bytes=torch.cuda.max_memory_allocated(), host=host_memory(),
            )
            solutions[name] = result.models[1.0].coefficients.means
            # one more value-and-gradient pass with the cache as the solve left it
            sobj = StreamingGLMObjective(chunks, LOSSES["logistic"], F_D, l2_weight=1.0,
                                         intercept_index=F_D - 1, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sobj.value_and_grad(solutions[name])
            torch.cuda.synchronize()
            arm["next_pass_s"] = time.perf_counter() - t1
            if name != "c_depth_0":  # the card's busy share over one pass, thrashing and resident
                arm["profiled_pass"] = busy_share(lambda: sobj.value_and_grad(solutions[name]))
            del sobj
            rec["arms"][name] = arm
    names = list(arms)
    rec["arms_bitwise_equal"] = all(torch.equal(solutions[names[0]], solutions[k]) for k in names[1:])
    rec["k1_launches_ok"] = all(
        a["launches"]["fused_value_grad"] == len(chunks) * a["objective_passes"] and not a["launches"]["fused_hvp"]
        for a in rec["arms"].values()
    )
    rec["launches"] = {k: sum(a["launches"][k] for a in rec["arms"].values()) for k in launch_counts()}

    # the same 8 GiB on the card: one objective pass and the in-memory solve
    X = torch.empty((F_ROWS, F_D), device=dev)
    y = torch.empty(F_ROWS, device=dev)
    for i, c in enumerate(chunks):
        X[i * F_CHUNK:(i + 1) * F_CHUNK].copy_(torch.from_numpy(c["X"]))
        y[i * F_CHUNK:(i + 1) * F_CHUNK].copy_(torch.from_numpy(c["labels"]))
    batch = DenseBatch(X=X, labels=y, offsets=torch.zeros(F_ROWS, device=dev), weights=torch.ones(F_ROWS, device=dev))
    w = solutions["b_default"]
    sobj = StreamingGLMObjective(chunks, LOSSES["logistic"], F_D, l2_weight=1.0, intercept_index=F_D - 1, device=dev)
    v_s, g_s = sobj.value_and_grad(w)
    v_m, g_m = make_objective(batch, LOSSES["logistic"], l2_weight=1.0, intercept_index=F_D - 1,
                              device=dev).value_and_grad(w)
    v_ok, v_err = close(v_s.reshape(1), v_m.reshape(1), 1e-5, 0.0)
    g_ok, g_err = close(g_s, g_m, 1e-4, 1e-4)
    del sobj
    prefetch.clear_cache()
    result, wall, launches = solve(batch, TaskType.LOGISTIC_REGRESSION, cfg, [1.0], dev, intercept_index=F_D - 1)
    t = result.trackers[1.0]
    auc_mem = float(auc_roc(batch.matvec(result.models[1.0].coefficients.means), y))
    auc_str = float(auc_roc(batch.matvec(w), y))
    obj_str = rec["arms"]["b_default"]["objective"]
    rec.update(
        value_and_grad_vs_in_memory=dict(value_ok=v_ok, value_abs_err=v_err, grad_ok=g_ok, grad_max_abs_err=g_err),
        in_memory=_record(t, wall, launches, train_auc=auc_mem),
        train_auc=auc_str, d_auc_vs_in_memory=abs(auc_str - auc_mem),
        rel_d_objective_vs_in_memory=abs(obj_str - float(t.value)) / abs(float(t.value)),
    )
    return rec


def run_b_streamed(dev, b: dict, card: str) -> dict:
    """main_b_streamed: config B (linear, 2^20 x 256 float32, as main_b
    draws it) in 8 host chunks of 2^17 rows, host TRON 15 iterations."""
    task = TaskType.LINEAR_REGRESSION
    batch, _, _ = synthetic_glm_data(2, N, 256, task, noise=0.1, add_intercept=False, dtype=torch.float32,
                                     device=dev)
    chunks = dense_chunks(batch.X.cpu().numpy(), batch.labels.cpu().numpy(), B_CHUNK)
    prefetch.clear_cache()
    result, wall, launches = streamed_solve(
        chunks, task, 256, OptimizerConfig(optimizer_type=OptimizerType.TRON, max_iterations=15, tolerance=0.0), dev
    )
    t = result.trackers[1.0]
    vg_passes = t.iterations + 1  # one value-and-gradient pass per outer iteration and the start
    hvp_passes = t.objective_passes - vg_passes
    train_rmse = float(rmse(result.models[1.0].score(batch), batch.labels))
    rec = _record(t, wall, launches, train_rmse=train_rmse, card=card, chunks=len(chunks), chunk_rows=B_CHUNK,
                  value_grad_passes=vg_passes, hvp_passes=hvp_passes,
                  k1_per_chunk_and_pass=launches["fused_value_grad"] / (len(chunks) * vg_passes),
                  k2_per_chunk_and_pass=launches["fused_hvp"] / (len(chunks) * max(hvp_passes, 1)),
                  cache=prefetch.cache_stats(), stage_seconds=REGISTRY.timer_snapshot("prefetch."))
    rec["launches_ok"] = (launches["fused_value_grad"] == len(chunks) * vg_passes
                          and launches["fused_hvp"] == len(chunks) * hvp_passes and hvp_passes > 0)
    rec["k2_at_chunk"] = k2_at(batch.X[:B_CHUNK], batch.labels[:B_CHUNK])
    rec["k1_at_chunk"] = k1_at_b_chunk(batch.X[:B_CHUNK], batch.labels[:B_CHUNK])
    rec["rel_d_rmse_vs_main_b"] = abs(train_rmse - b["train_rmse"]) / b["train_rmse"]
    rec["rel_d_objective_vs_main_b"] = abs(rec["objective"] - b["objective"]) / abs(b["objective"])
    prefetch.clear_cache()
    return rec


def run_a2_streamed(dev, a2: dict, card: str) -> dict:
    """main_a2_streamed: config A2's data (as main_a2 draws it) in 8 host
    chunks of 2^16 rows, each tiled for K3 through the layout cache; host
    L-BFGS 30 iterations at λ = 1 with SIMPLE variances."""
    n, d, k = A2
    batch, _ = sparse_problem(dev, n, d, k, seed=1)
    chunks = sparse_chunks(batch.indices.to(torch.int32).cpu().numpy(), batch.values.cpu().numpy(),
                           batch.labels.cpu().numpy(), A2_CHUNK)
    tile_cache.clear()
    prefetch.clear_cache()
    first = StreamingGLMObjective(chunks, LOSSES["logistic"], d, device=dev)
    packed = tile_cache.stats()
    result, wall, launches = streamed_solve(
        chunks, TaskType.LOGISTIC_REGRESSION, d, OptimizerConfig(max_iterations=30, tolerance=0.0), dev,
        variance_computation=VarianceComputationType.SIMPLE,
    )
    t = result.trackers[1.0]
    model = result.models[1.0]
    passes = t.objective_passes  # value-and-gradient passes; SIMPLE adds one Hessian-diagonal pass
    expected = {"matvec": len(chunks) * (passes + 1), "rmatvec": len(chunks) * (passes + 1),
                "rmatvec_sq": len(chunks)}
    k3 = {dname: launches[f"sparse_{dname}"] for dname in st.DIRECTIONS}
    auc = float(auc_roc(batch.matvec(model.coefficients.means), batch.labels))
    rec = _record(t, wall, launches, train_auc=auc, card=card, chunks=len(chunks), chunk_rows=A2_CHUNK,
                  tiled=first.tiled, layout_build_s=first.layout_build_s, first_objective_cache=packed,
                  second_objective_misses=tile_cache.stats()["misses"] - packed["misses"],
                  k3_launches=k3, k3_expected=expected, launches_ok=k3 == expected,
                  variances_finite=bool(torch.isfinite(model.coefficients.variances).all()),
                  cache=prefetch.cache_stats())
    m, g = first._tile_layouts[0]
    gen = torch.Generator(device=dev).manual_seed(13)
    w, r = torch.randn(d, generator=gen, device=dev), torch.randn(A2_CHUNK, generator=gen, device=dev)
    rec["k3_at_chunk"] = {dname: time_k3(lay, src, sq, dname)
                          for dname, (lay, src, sq) in {"matvec": (m, w, False), "rmatvec": (g, r, False),
                                                        "rmatvec_sq": (g, r, True)}.items()}
    rec["d_auc_vs_main_a2"] = abs(auc - a2["train_auc"])
    rec["rel_d_objective_vs_main_a2"] = abs(rec["objective"] - a2["objective"]) / abs(a2["objective"])
    del first
    tile_cache.clear()
    prefetch.clear_cache()
    return rec


def glm_streamed_argv(dev, work: str, out: str) -> list[str]:
    """main_glm_streamed_cli's command: the GLM driver out of core on the
    GAME driver's files (3 λ, 100 iterations at 1e-8)."""
    return ["--task", "LOGISTIC_REGRESSION", "--format", "avro", "--train-data", os.path.join(work, "train"),
            "--validation-data", os.path.join(work, "val"), "--weights", *GLM_CLI_WEIGHTS, "--max-iterations",
            "100", "--tolerance", "1e-8", "--streaming-chunk-rows", str(GLM_CLI_CHUNK), "--device", dev.type,
            "--output-dir", out]


def run_glm_streamed_cli(dev, data: GameCliData, card: str) -> dict:
    """main_glm_streamed_cli: ``cli.train_glm --format avro
    --streaming-chunk-rows 32768`` on main_game_cli's files (the global
    shard), held to ``train_glm`` on the same arrays; a rerun loads every λ
    from its checkpoints."""
    work, n_tr, n_va = data.work, data.n_train, data.n_val
    train_dir, val_dir = os.path.join(work, "train"), os.path.join(work, "val")
    reader = AvroDataReader()
    part = os.path.join(train_dir, "part-00000.avro")
    maps, _ = reader.streaming_ingest_stats(train_dir)
    rows = 4096  # the Python codec's first two chunks of one part, against the native decoder's
    native = reader.iter_batch_chunks(part, "global", rows, maps)
    python = reader.iter_batch_chunks(part, "global", rows, maps, use_native=False)
    chunk_parity = all(
        all(np.array_equal(a[key], b[key]) and a[key].dtype == b[key].dtype for key in a)
        for a, b, _ in zip(native, python, range(2))
    )
    out = os.path.join(work, "glm_streamed")
    argv = glm_streamed_argv(dev, work, out)
    streamed = []  # (chunk count, result) of the driver's streamed sweep
    real = cli_train_glm.train_glm_streamed

    def recorded(chunks, *args, **kwargs):
        streamed.append((len(chunks), real(chunks, *args, **kwargs)))
        return streamed[-1][1]

    fused.reset_launch_counts()
    st.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_train_glm.train_glm_streamed = recorded
    try:
        with stage_times(cli_train_glm) as stages:
            cli_train_glm.main(argv)
    finally:
        cli_train_glm.train_glm_streamed = real
    wall = time.perf_counter() - t0
    launches = launch_counts()
    # K1 on every chunk of every value-and-gradient pass of the three λ
    # (value-only passes and validation scoring run torch.matmul); nothing else
    chunks, result = streamed[0]
    vg_passes = sum(t.objective_passes for t in result.trackers.values())
    launches_ok = (vg_passes > 0 and launches["fused_value_grad"] == chunks * vg_passes
                   and not any(v for k, v in launches.items() if k != "fused_value_grad"))
    with open(os.path.join(out, "report.json")) as f:
        report = json.load(f)
    weights = [float(w) for w in GLM_CLI_WEIGHTS]
    ref = train_glm(data.arrays[0].batch_for("global"), TaskType.LOGISTIC_REGRESSION,
                    optimizer_config=OptimizerConfig(max_iterations=100, tolerance=1e-8),
                    regularization=RegularizationContext(RegularizationType.L2), regularization_weights=weights,
                    intercept_index=D_FIXED, validation_batch=data.arrays[1].batch_for("global"), device=dev)
    coef_ok, max_diff = True, 0.0
    for lam in weights:
        got = load_glm(os.path.join(out, "models", f"lambda-{lam:g}", "model.avro"), index_map=maps["global"],
                       device=dev).coefficients.means
        want = ref.models[lam].coefficients.means
        coef_ok = coef_ok and close(got, want, 1e-2, 1e-3)[0]
        max_diff = max(max_diff, float((got - want).abs().max()))
    again = cli_train_glm.run(TaskType.LOGISTIC_REGRESSION, [train_dir], out, data_format="avro",
                              validation_data=[val_dir], weights=weights, max_iterations=100, tolerance=1e-8,
                              streaming_chunk_rows=GLM_CLI_CHUNK, device=dev)
    stats_s, fill_s = stages["index maps (streaming pass, all files)"], stages["chunk training data"]
    return dict(
        card=card, rows_train=n_tr, rows_validation=n_va, chunk_rows=GLM_CLI_CHUNK, d=maps["global"].size,
        wall_s=wall, stages_s=stages, stats_pass_ms_per_record=1e3 * stats_s / n_tr,
        chunk_fill_ms_per_record=1e3 * fill_s / n_tr,
        validation_chunk_ms_per_record=1e3 * stages["chunk validation data"] / n_va,
        launches=launches, chunks=chunks, value_grad_passes=vg_passes, launches_ok=launches_ok,
        native_python_chunk_parity=chunk_parity, chunk_parity_rows=2 * rows,
        report=report, best_weight=report["best_weight"], library_best_weight=ref.best_weight,
        coefficients_ok=coef_ok, max_abs_diff_vs_train_glm=max_diff,
        rerun_loaded_every_lambda=again.trackers == {} and sorted(again.models) == weights,
    )


# ---------------------------------------------------------------------------
# data parallel: row shards on one card, and processes over gloo
# ---------------------------------------------------------------------------
SHARDS = 4
CHILD_TIMEOUT_S = 300
F_MULTIHOST_CACHE = 5 << 30  # each process's chunk cache: its 8 chunks (4 GiB) resident


def run_a_sharded(batch, intercept, a: dict, dev) -> dict:
    """main_a_sharded: the headline solve of main_a (L-BFGS 30 iterations at
    tolerance 0, λ = 1) through ``DistributedTrainer`` over 4 row shards of
    the card; then the same solve again, which must be bitwise equal, and
    on one shard (the same code path: its wall per pass is the baseline of
    the sharding's cost)."""
    mesh = data_mesh(num_shards=SHARDS)
    trainer = DistributedTrainer(mesh=mesh, config=OptimizerConfig(max_iterations=30, tolerance=0.0),
                                 loss=LOSSES["logistic"], l2_weight=1.0, intercept_index=intercept)
    w0 = torch.zeros(batch.num_features, device=dev)
    replace(trainer, config=OptimizerConfig(max_iterations=2)).train(batch, w0)  # warm-up
    runs = []
    for t in (trainer, trainer, replace(trainer, mesh=data_mesh(num_shards=1))):
        fused.reset_launch_counts()
        st.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = t.train(batch, w0)
        torch.cuda.synchronize()
        runs.append((res, time.perf_counter() - t0, launch_counts()))
    (res, wall, launches), (again, wall2, _), (one, wall1, _) = runs
    auc = float(auc_roc(batch.matvec(res.w), batch.labels))
    rec = dict(iterations=res.iterations, reason=res.reason, objective_passes=res.objective_passes,
               objective=float(res.value), train_auc=auc, wall_s=wall, wall_ms_per_pass=1e3 * wall / res.objective_passes,
               repeat_wall_ms_per_pass=1e3 * wall2 / again.objective_passes, launches=launches,
               mesh=[str(d) for d in mesh], shards=SHARDS, rows_per_shard=batch.num_rows // SHARDS,
               one_shard_wall_ms_per_pass=1e3 * wall1 / one.objective_passes,
               unsharded_wall_ms_per_pass=a["wall_ms_per_pass"])
    rec.update(
        k1_launches_ok=launches["fused_value_grad"] == SHARDS * res.objective_passes and not launches["fused_hvp"],
        repeat_bitwise=torch.equal(res.w, again.w) and torch.equal(res.value, again.value),
        d_auc_vs_main_a=abs(auc - a["train_auc"]),
        rel_d_objective_vs_main_a=abs(rec["objective"] - a["objective"]) / abs(a["objective"]),
        sharded_minus_one_shard_ms_per_pass=rec["wall_ms_per_pass"] - rec["one_shard_wall_ms_per_pass"],
    )
    return rec


def run_a2_sharded(batch, a2: dict, dev) -> dict:
    """main_a2_sharded: config A2 split into 4 row shards of the card, each
    with its own K3 layouts (``sharded_objective`` over every budget), host
    L-BFGS 30 iterations at λ = 1, then SIMPLE variances (one
    Hessian-diagonal pass); then the same on one shard (the baseline of
    the sharding's cost on the same code path)."""

    def timed_solve(shards: int):
        mesh = data_mesh(num_shards=shards)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obj = sharded_objective(batch, mesh, LOSSES["logistic"], l2_weight=1.0)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if not all(isinstance(o.batch, st.TiledSparseBatch) for o in obj.shards):
            raise AssertionError("A2's shards did not take the sparse kernel's layout")
        w0 = torch.zeros(batch.num_features, device=dev)
        lbfgs_minimize(obj, w0, OptimizerConfig(max_iterations=2))  # warm-up
        fused.reset_launch_counts()
        st.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lbfgs_minimize(obj, w0, OptimizerConfig(max_iterations=30, tolerance=0.0))
        variances = compute_variances(obj, res.w, VarianceComputationType.SIMPLE)
        torch.cuda.synchronize()
        return mesh, obj, build_s, res, variances, time.perf_counter() - t0, launch_counts()

    mesh, obj, build_s, res, variances, wall, launches = timed_solve(SHARDS)
    nnz = [o.batch.m.nnz for o in obj.shards]
    del obj
    _, _, _, one, _, wall1, _ = timed_solve(1)
    passes = res.objective_passes
    k3 = {d: launches[f"sparse_{d}"] for d in st.DIRECTIONS}
    expected = {"matvec": SHARDS * (passes + 1), "rmatvec": SHARDS * (passes + 1), "rmatvec_sq": SHARDS}
    auc = float(auc_roc(batch.matvec(res.w), batch.labels))
    return dict(iterations=res.iterations, reason=res.reason, objective_passes=passes, objective=float(res.value),
                train_auc=auc, wall_s=wall, wall_ms_per_pass=1e3 * wall / (passes + 1), launches=launches,
                mesh=[str(d) for d in mesh], layout_build_s=build_s, nnz_per_shard=nnz,
                k3_launches=k3, k3_expected=expected, launches_ok=k3 == expected,
                variances_finite=bool(torch.isfinite(variances).all()),
                one_shard_wall_ms_per_pass=1e3 * wall1 / (one.objective_passes + 1),
                unsharded_wall_ms_per_pass=a2["wall_ms_per_pass"],
                d_auc_vs_main_a2=abs(auc - a2["train_auc"]),
                rel_d_objective_vs_main_a2=abs(float(res.value) - a2["objective"]) / abs(a2["objective"]))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_children(mode: str, work: str, args: dict, dev, env: dict | None = None, n: int = 2,
                 ports: int = 1) -> list[dict]:
    """``n`` processes of this script in ``--child`` mode, one gloo group on
    a fresh loopback port (``ports`` fresh ports for children that form a
    group several times, in the spec's ``ports``); each writes
    ``work/rank<r>.json``. The kernels are built by the parent before
    (``_cuda.load``), so no two children build at once. A child that fails
    or outlives ``CHILD_TIMEOUT_S`` (then killed) fails the phase."""
    _cuda.load()
    native_build.build()
    os.makedirs(work, exist_ok=True)
    child_env = {k: v for k, v in os.environ.items()
                 if k not in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")}
    child_env.update(env or {})
    fresh = [_free_port() for _ in range(ports)]
    spec = json.dumps(dict(args, work=work, port=fresh[0], ports=fresh, processes=n, device=dev.type))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", mode, str(r), spec],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=child_env)
             for r in range(n)]
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0)))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{mode}: a child outlived {CHILD_TIMEOUT_S} s and was killed") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{mode}: child {r} exited {p.returncode}:\n{err[-4000:]}")
    results = []
    for r in range(n):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _child(mode: str, rank: int, spec: dict) -> int:
    """One process of a multi-process phase (``run_children``), on the
    parent's device."""
    global F_ROWS, F_D, F_CHUNK, E_STREAM_CHUNK
    dev = torch.device(spec["device"])
    if dev.type != "cuda":  # a rehearsal on the CPU: no card to wait for
        torch.cuda.synchronize = lambda *a, **k: None
    work = spec["work"]
    out: dict = {"rank": rank}
    if mode == "f_multihost":
        F_ROWS, F_D, F_CHUNK = spec["shape"]  # the parent's, so the chunks are its chunks
        t0 = time.perf_counter()
        per = (F_ROWS // F_CHUNK) // spec["processes"]
        chunks = f_chunks(dev, keep=range(rank * per, (rank + 1) * per))
        out["data_s"] = time.perf_counter() - t0
        initialize_multihost(f"127.0.0.1:{spec['port']}", spec["processes"], rank)
        reset_collective_stats()
        result, wall, launches = streamed_solve(chunks, TaskType.LOGISTIC_REGRESSION, F_D,
                                                OptimizerConfig(max_iterations=10, tolerance=0.0), dev,
                                                intercept_index=F_D - 1, cross_process=True)
        t = result.trackers[1.0]
        w = result.models[1.0].coefficients.means
        margins = torch.cat([torch.from_numpy(c["X"]).to(dev) @ w for c in chunks])
        labels = np.concatenate([c["labels"] for c in chunks])
        np.savez(os.path.join(work, f"rank{rank}.npz"), w=w.cpu().numpy(), margins=margins.cpu().numpy(),
                 labels=labels)
        out.update(chunks=len(chunks), iterations=t.iterations, objective_passes=t.objective_passes,
                   objective=float(t.value), wall_s=wall, wall_s_per_pass=wall / t.objective_passes,
                   launches=launches, collectives=dict(collective_stats),
                   collective_s_per_pass=collective_stats["seconds"] / t.objective_passes,
                   chunk_cache_budget_bytes=prefetch.chunk_cache_budget_bytes(dev), cache=prefetch.cache_stats(),
                   peak_device_bytes=torch.cuda.max_memory_allocated() if dev.type == "cuda" else None)
    elif mode == "glm_multihost_cli":
        os.environ.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{spec['port']}",
                          JAX_NUM_PROCESSES=str(spec["processes"]), JAX_PROCESS_ID=str(rank))
        streamed = []
        real = cli_train_glm.train_glm_streamed

        def recorded(chunks, *args, **kwargs):
            streamed.append((len(chunks), real(chunks, *args, **kwargs)))
            return streamed[-1][1]

        fused.reset_launch_counts()
        st.reset_launch_counts()
        reset_collective_stats()
        t0 = time.perf_counter()
        cli_train_glm.train_glm_streamed = recorded
        try:
            cli_train_glm.main(spec["argv"] + ["--output-dir", os.path.join(work, f"out{rank}")])
        finally:
            cli_train_glm.train_glm_streamed = real
        chunks, result = streamed[0]
        out.update(wall_s=time.perf_counter() - t0, launches=launch_counts(), chunks=chunks,
                   value_grad_passes=sum(t.objective_passes for t in result.trackers.values()),
                   trained_lambdas=sorted(result.trackers), best_weight=result.best_weight,
                   collectives=dict(collective_stats))
    elif mode == "e_multihost":
        n, effects = spec["shape"][0], {k: tuple(v) for k, v in spec["shape"][1].items()}  # the parent's
        t0 = time.perf_counter()
        batch, data = game_problem(dev, n, effects, seed=4)  # main_e's rows, drawn on the card
        host = batch.to("cpu")  # the replicated copy; the card keeps only this process's shards
        del batch, data
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        out["data_s"] = time.perf_counter() - t0
        initialize_multihost(f"127.0.0.1:{spec['port']}", spec["processes"], rank)
        mesh = process_mesh(spec["local_shards"], devices=[dev])
        fit = fit_game(host, game_config(effects, 6), dev, mesh=mesh)
        np.savez(os.path.join(work, f"rank{rank}.npz"),
                 **{cid: sub.coefficient_means.cpu().numpy() for cid, sub in fit["best"].model.models.items()})
        out.update(_game_record(fit, warmup=2), mesh=[str(d) for d in mesh.local],
                   global_shards=list(mesh.global_shards()), exchange_per_visit=_exchange_per_visit(fit, 2),
                   peak_device_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None)
    elif mode == "e_streamed_multihost":
        n, effects = spec["shape"][0], {k: tuple(v) for k, v in spec["shape"][1].items()}  # the parent's
        E_STREAM_CHUNK = spec["chunk_rows"]
        t0 = time.perf_counter()
        batch, data = game_problem(dev, n, effects, seed=4)  # main_e's rows, drawn on the card
        per = n // spec["processes"]
        rows = slice(rank * per, n if rank == spec["processes"] - 1 else (rank + 1) * per)
        host = streamed_game_data(batch, rows)  # this process's contiguous half, on its host only
        del batch, data
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.reset_peak_host_memory_stats()
        out["data_s"] = time.perf_counter() - t0
        initialize_multihost(f"127.0.0.1:{spec['port']}", spec["processes"], rank)
        reset_collective_stats()
        fit = fit_streamed(host, game_config(effects, 2), dev, multihost=True)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
        margins = score_streamed(fit["model"], host, dev)
        np.savez(os.path.join(work, f"rank{rank}.npz"), margins=margins.cpu().numpy(), labels=host.labels,
                 **{cid: sub.coefficient_means.cpu().numpy() for cid, sub in fit["model"].models.items()})
        out.update(rows=host.num_rows, chunks=-(-host.num_rows // E_STREAM_CHUNK), wall_s=fit["wall_s"],
                   iteration_wall_s=fit["iteration_wall_s"], visits=fit["visits"], launches=fit["launches"],
                   fixed_objective_passes=fit["fixed_objective_passes"],
                   fixed_objective=fit["info"]["fixed"].final_loss, exchange_totals=fit["trainer"].exchange_totals,
                   collectives=dict(collective_stats), peak_device_bytes=peak, host=host_memory())
    elif mode == "game_multihost_cli":
        phases = []
        for port, (command, argv) in zip(spec["ports"], spec["phases"]):
            os.environ.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                              JAX_NUM_PROCESSES=str(spec["processes"]), JAX_PROCESS_ID=str(rank))
            fused.reset_launch_counts()
            st.reset_launch_counts()
            reset_collective_stats()
            t0 = time.perf_counter()
            with recording_fits() as fits, recording_streamed_trainers() as trainers:
                (cli_train if command == "train" else cli_score).main([a.replace("{rank}", str(rank))
                                                                      for a in argv])
            torch.cuda.synchronize()
            ckpt = os.path.join(work, "out0", "checkpoints", "config-0000", "ckpt.npz")
            metrics = os.path.join(work, "out0", "metrics.json")
            phases.append(dict(
                command=command, wall_s=time.perf_counter() - t0, launches=launch_counts(),
                fixed_objective_passes=sum(t.objective_passes for _, results in fits for r in results
                                           for t in r.descent.trackers["fixed"])
                + sum(v.get("objective_passes", 0) for t in trainers for v in t.visit_stats),
                collectives=dict(collective_stats),
                checkpoint_mtime_ns=os.stat(ckpt).st_mtime_ns if os.path.exists(ckpt) else None,
                # the out-of-core entries: this process's rows, the resume, the row exchanges
                streamed=[dict(rows=t.rows, resumed_from=t.resumed_from, exchange_totals=t.exchange_totals,
                               visit_exchanges=_visit_exchanges(t.visit_stats)) for t in trainers]))
            if rank == 0 and os.path.exists(metrics):
                with open(metrics) as f:
                    phases[-1]["best_index"] = json.load(f).get("best_index")
            if rank == 0 and len(phases) == 1:  # the first run's models, for the rerun's check
                shutil.copytree(os.path.join(work, "out0", "best"), os.path.join(work, "first-best"))
        out["phases"] = phases
    else:
        raise ValueError(f"unknown child mode {mode!r}")
    shutdown_multihost()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def run_f_multihost(dev, f_rec: dict, card: str) -> dict:
    """main_f_multihost: main_f's solve (host L-BFGS 10 iterations at
    tolerance 0, λ = 1) by two processes on the card, each holding 8 of
    main_f's 16 chunks and a chunk cache of ``F_MULTIHOST_CACHE`` bytes,
    summing each pass over gloo (``train_glm_streamed(cross_process=True)``)."""
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="_f_multihost-", dir=ROOT)
    try:
        t0 = time.perf_counter()
        kids = run_children("f_multihost", work, {"shape": [F_ROWS, F_D, F_CHUNK]}, dev,
                            env={"PHOTON_CHUNK_CACHE_BUDGET": str(F_MULTIHOST_CACHE)})
        wall = time.perf_counter() - t0
        arrays = [np.load(os.path.join(work, f"rank{r}.npz")) for r in range(2)]
        margins = torch.from_numpy(np.concatenate([a["margins"] for a in arrays])).to(dev)
        labels = torch.from_numpy(np.concatenate([a["labels"] for a in arrays])).to(dev)
        auc = float(auc_roc(margins, labels))
        bitwise = arrays[0]["w"].tobytes() == arrays[1]["w"].tobytes()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    passes = kids[0]["objective_passes"]
    launches = {k: sum(c["launches"][k] for c in kids) for k in launch_counts()}
    ref_obj = f_rec["arms"]["b_default"]["objective"]
    return dict(
        card=card, processes=2, chunks_per_process=[c["chunks"] for c in kids], phase_wall_s=wall,
        children=kids, objective=kids[0]["objective"], objective_passes=passes, launches=launches,
        wall_s_per_pass=max(c["wall_s_per_pass"] for c in kids),
        one_process_wall_s_per_pass=f_rec["arms"]["b_default"]["wall_s_per_pass"],
        collective_s_per_pass=[c["collective_s_per_pass"] for c in kids],
        k1_launches_ok=all(c["launches"]["fused_value_grad"] == c["chunks"] * passes
                           and not c["launches"]["fused_hvp"] for c in kids),
        coefficients_bitwise_equal=bitwise, train_auc=auc, d_auc_vs_main_f=abs(auc - f_rec["train_auc"]),
        rel_d_objective_vs_main_f=abs(kids[0]["objective"] - ref_obj) / abs(ref_obj),
    )


def run_glm_multihost_cli(dev, data: GameCliData, glm_streamed: dict, card: str) -> dict:
    """main_glm_multihost_cli: ``cli.train_glm --multihost
    --streaming-chunk-rows 32768`` in two processes on main_game_cli's files
    (two training parts: one each), held to main_glm_streamed_cli's
    one-process run; then the same command into the same directories,
    which must resume every λ from process 0's checkpoints."""
    work, maps = data.work, AvroDataReader().streaming_ingest_stats(os.path.join(data.work, "train"))[0]
    argv = ["--task", "LOGISTIC_REGRESSION", "--format", "avro", "--train-data", os.path.join(work, "train"),
            "--validation-data", os.path.join(work, "val"), "--weights", *GLM_CLI_WEIGHTS,
            "--max-iterations", "100", "--tolerance", "1e-8", "--streaming-chunk-rows", str(GLM_CLI_CHUNK),
            "--device", dev.type, "--multihost"]
    out = os.path.join(work, "glm_multihost")
    t0 = time.perf_counter()
    kids = run_children("glm_multihost_cli", out, {"argv": argv}, dev)
    wall = time.perf_counter() - t0
    out0 = os.path.join(out, "out0")
    done = os.path.join(out0, "checkpoints", "sweep-done.npz")
    with open(os.path.join(out0, "report.json")) as f:
        report = json.load(f)
    weights = [float(w) for w in GLM_CLI_WEIGHTS]

    def model(root: str, lam: float) -> torch.Tensor:
        return load_glm(os.path.join(root, "models", f"lambda-{lam:g}", "model.avro"), index_map=maps["global"],
                        device=dev).coefficients.means

    one = os.path.join(work, "glm_streamed")
    coef_ok, max_diff = True, 0.0
    for lam in weights:
        got, want = model(out0, lam), model(one, lam)
        coef_ok = coef_ok and close(got, want, 1e-2, 1e-3)[0]
        max_diff = max(max_diff, float((got - want).abs().max()))
    first = {lam: model(out0, lam) for lam in weights}
    mtime = os.stat(done).st_mtime_ns
    t1 = time.perf_counter()
    rerun = run_children("glm_multihost_cli", out, {"argv": argv}, dev)
    rerun_wall = time.perf_counter() - t1
    resumed = (os.stat(done).st_mtime_ns == mtime and all(k["trained_lambdas"] == [] for k in rerun)
               and all(close(model(out0, lam), first[lam], 1e-6, 0.0)[0] for lam in weights))
    vg = kids[0]["value_grad_passes"]
    launches = {k: sum(c["launches"][k] for c in kids) for k in launch_counts()}
    out1 = os.path.join(out, "out1")
    return dict(
        card=card, processes=2, wall_s=wall, rerun_wall_s=rerun_wall, children=kids, rerun_children=rerun,
        chunks_per_process=[c["chunks"] for c in kids], value_grad_passes=vg, launches=launches,
        launches_ok=vg > 0 and all(c["launches"]["fused_value_grad"] == c["chunks"] * vg for c in kids)
        and not any(v for k, v in launches.items() if k != "fused_value_grad"),
        best_weight=report["best_weight"], one_process_best_weight=glm_streamed["best_weight"],
        coefficients_ok=coef_ok, max_abs_diff_vs_one_process=max_diff,
        only_process_0_wrote=not os.path.exists(os.path.join(out1, "best"))
        and not os.path.exists(os.path.join(out1, "checkpoints")) and os.path.exists(done),
        rerun_resumed=resumed,
    )


E_SHARDS = 4  # main_e_sharded's shards, main_e_multihost's global shards (2 processes x 2)


def _model_bytes(model: GameModel) -> dict:
    return {cid: sub.coefficient_means.detach().cpu().numpy().tobytes() for cid, sub in model.models.items()}


def run_e_sharded(dev, batch, data, e_rec: dict, e_model: GameModel) -> tuple[dict, GameModel]:
    """main_e_sharded: main_e's batch and schedule (Newton random effects,
    6 outer iterations, the first 2 a warm-up) over a data mesh of 4 shards
    of the card: the fixed effect row-sharded (K1 once per shard a pass,
    the partials summed in shard order), each bucket's entity lanes split
    over the shards; then the same fit again, which must be bitwise equal.
    Held to main_e's fit (``e_model``). Returns the record and the model
    (main_e_multihost is held to it)."""
    n, effects = E_ML20M
    mesh = data_mesh(E_SHARDS)
    fits = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats(dev)
        fits.append((fit_game(batch, game_config(effects, 6), dev, mesh=mesh), torch.cuda.max_memory_allocated(dev)))
    (fit, peak), (again, _) = fits
    model = fit["best"].model
    rec = dict(_game_record(fit, warmup=2), n=n, mesh=[str(d) for d in mesh], shards=E_SHARDS,
               exchange_per_visit=_exchange_per_visit(fit, 2), max_memory_allocated_bytes=peak,
               repeat_timed_wall_s_per_outer_iteration=_game_record(again, warmup=2)[
                   "timed_wall_s_per_outer_iteration"],
               main_e_timed_wall_s_per_outer_iteration=e_rec["timed_wall_s_per_outer_iteration"],
               **game_quality(fit, batch, data))
    passes, launches = rec["fixed_objective_passes"], rec["launches"]
    random = {cid: close(model[cid].coefficient_means, e_model[cid].coefficient_means, 1e-2, 2e-3)
              for cid in model.models if cid != "fixed"}
    rec.update(
        k1_launches_ok=launches["fused_value_grad"] == E_SHARDS * passes > 0
        and not any(v for k, v in launches.items() if k != "fused_value_grad"),
        repeat_bitwise=_model_bytes(model) == _model_bytes(again["best"].model),
        d_auc_vs_main_e=abs(rec["train_auc"] - e_rec["train_auc"]),
        rel_d_fixed_objective_vs_main_e=abs(rec["fixed_objective"] - e_rec["fixed_objective"])
        / abs(e_rec["fixed_objective"]),
        random_effects_within_lane_tolerance=all(ok for ok, _ in random.values()),
        max_abs_diff_random_effects_vs_main_e={cid: err for cid, (_, err) in random.items()},
    )
    return rec, model


def run_e_multihost(dev, e_rec: dict, sharded: GameModel, card: str) -> dict:
    """main_e_multihost: two processes of this script on the card, each with
    2 local shards of a 4-shard process-spanning mesh (global shards 0-1
    and 2-3), each drawing main_e's rows from the seed on the card, keeping
    the replicated copy on the host and staging only its shards: main_e's
    schedule, the partials of all 4 shards gathered over gloo each pass and
    the random effects' lanes and the (n,) scores combined in one host
    gather each. Held to main_e_sharded (one process x 4 shards) bit for
    bit."""
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="_e_multihost-", dir=ROOT)
    try:
        t0 = time.perf_counter()
        kids = run_children("e_multihost", work, {"local_shards": E_SHARDS // 2, "shape": E_ML20M}, dev)
        wall = time.perf_counter() - t0
        arrays = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    want = _model_bytes(sharded)
    ranks_equal = all(arrays[0][c].tobytes() == arrays[1][c].tobytes() for c in want)
    vs_sharded = {c: arrays[0][c].tobytes() == want[c] for c in want}
    diff = {c: float(np.abs(arrays[0][c] - sharded[c].coefficient_means.cpu().numpy()).max()) for c in want}
    launches = {k: sum(c["launches"][k] for c in kids) for k in launch_counts()}
    return dict(
        card=card, processes=2, local_shards=E_SHARDS // 2, phase_wall_s=wall, children=kids, launches=launches,
        timed_wall_s_per_outer_iteration=max(c["timed_wall_s_per_outer_iteration"] for c in kids),
        main_e_timed_wall_s_per_outer_iteration=e_rec["timed_wall_s_per_outer_iteration"],
        exchange_per_visit=[c["exchange_per_visit"] for c in kids],
        peak_device_bytes=[c["peak_device_bytes"] for c in kids],
        main_e_peak_device_bytes=e_rec["max_memory_allocated_bytes"],
        models_bitwise_equal_across_ranks=ranks_equal, bitwise_equal_to_main_e_sharded=vs_sharded,
        max_abs_diff_vs_main_e_sharded=diff,
        k1_launches_ok=all(c["launches"]["fused_value_grad"] == (E_SHARDS // 2) * c["fixed_objective_passes"] > 0
                           for c in kids),
        peak_below_main_e=all(c["peak_device_bytes"] < e_rec["max_memory_allocated_bytes"] for c in kids),
    )


def _scores_by_uid(score_dir: str) -> dict:
    out = {}
    for fn in sorted(os.listdir(os.path.join(score_dir, "scores"))):
        for rec in read_avro_file(os.path.join(score_dir, "scores", fn))[1]:
            out[rec["uid"]] = rec["predictionScore"]
    return out


def run_game_multihost_cli(dev, data: GameCliData, cli: dict, card: str) -> dict:
    """main_game_multihost_cli: ``cli.train --multihost`` in memory in two
    processes on main_game_cli's files and 2-iteration configuration (every
    process reads every file to the host, one shard each on the card), the
    same command again (a resume), then ``cli.score --multihost`` on the
    validation files (one part file each); held to main_game_cli's
    one-process run and to the one-process score driver on the same
    model."""
    work, effects = data.work, data.effects
    root = os.path.join(work, "game_multihost")
    cfg = os.path.join(work, "config-2.json")
    train = ["--config", cfg, "--train-data", os.path.join(work, "train"), "--validation-data",
             os.path.join(work, "val"), "--device", dev.type, "--multihost", "--output-dir",
             os.path.join(root, "out{rank}")]
    score = ["--model-dir", os.path.join(root, "out0"), "--data", os.path.join(work, "val"), "--evaluators",
             *GAME_CLI_EVALUATORS, "--config", cfg, "--device", dev.type, "--multihost", "--output-dir",
             os.path.join(root, "score{rank}")]
    t0 = time.perf_counter()
    kids = run_children("game_multihost_cli", root, {"phases": [("train", train), ("train", train),
                                                               ("score", score)]}, dev, ports=3)
    wall = time.perf_counter() - t0
    out0, one_2it = os.path.join(root, "out0"), os.path.join(work, "out-2it")
    with open(os.path.join(out0, "metrics.json")) as f:
        metrics = json.load(f)
    maps = {fn[:-4]: IndexMap.load(os.path.join(out0, "index-maps", fn))
            for fn in os.listdir(os.path.join(out0, "index-maps"))}
    with open(os.path.join(out0, "entity-maps.json")) as f:
        ent = json.load(f)

    def load(path: str) -> GameModel:
        return load_game_model(path, index_maps=maps, entity_ids={f"per_{k}": ent[k] for k in effects}, device=dev)

    pairs = [(load(os.path.join(out0, m)), load(os.path.join(one_2it, m))) for m in ("best", "models/0000",
                                                                                       "models/0001")]
    rerun_same = _close(load(os.path.join(out0, "best")), load(os.path.join(root, "first-best")), 1e-6, 0.0)
    with open(os.path.join(out0, "photon.log")) as f:
        resumed = f.read().count(RESUME_LINE)
    # the one-process score driver on the model the processes scored
    one_score = os.path.join(root, "one_score")
    cli_score.main(["--model-dir", out0, "--data", os.path.join(work, "val"), "--output-dir", one_score,
                    "--evaluators", *GAME_CLI_EVALUATORS, "--config", cfg, "--device", dev.type])
    got, want = _scores_by_uid(os.path.join(root, "score0")), _scores_by_uid(one_score)
    got.update(_scores_by_uid(os.path.join(root, "score1")))
    with open(os.path.join(root, "score0", "metrics.json")) as f:
        score_metrics = json.load(f)
    with open(os.path.join(one_score, "metrics.json")) as f:
        one_metrics = json.load(f)
    first, rerun, scoring = ([c["phases"][i] for c in kids] for i in range(3))
    launches = {k: sum(p["launches"][k] for c in kids for p in c["phases"]) for k in launch_counts()}
    return dict(
        card=card, processes=2, wall_s=wall, train_wall_s=[p["wall_s"] for p in first],
        rerun_wall_s=[p["wall_s"] for p in rerun], score_wall_s=[p["wall_s"] for p in scoring],
        collectives=[p["collectives"] for p in first], launches=launches,
        fixed_objective_passes=[p["fixed_objective_passes"] for p in first],
        launches_ok=all(p["launches"]["fused_value_grad"] == p["fixed_objective_passes"] > 0 for p in first)
        and not any(p["launches"]["fused_value_grad"] for p in rerun + scoring),
        best_index=metrics["best_index"], one_process_best_index=cli["best_index"],
        models_ok=all(_close(a, b, 1e-2, 1e-3) for a, b in pairs),
        max_abs_diff_vs_one_process=max(_max_diff(a, b) for a, b in pairs),
        validation_metrics={i: r["metrics"] for i, r in enumerate(metrics["results"])},
        only_process_0_wrote=not os.path.exists(os.path.join(root, "out1"))
        and sorted(os.listdir(os.path.join(root, "score1"))) == ["scores"]
        and os.listdir(os.path.join(root, "score1", "scores")) == ["part-00001.avro"],
        resumed_lines=resumed, rerun_same_model=rerun_same,
        rerun_checkpoint_unchanged=first[0]["checkpoint_mtime_ns"] == rerun[0]["checkpoint_mtime_ns"] is not None,
        scores_rows=len(got), scores_ok=sorted(got) == sorted(want) and len(want) == data.n_val,
        max_abs_diff_scores_vs_one_process=max(abs(got[u] - want[u]) for u in want),
        metrics=score_metrics, one_process_metrics=one_metrics,
        max_abs_diff_metrics=max(abs(score_metrics[k] - v) for k, v in one_metrics.items()),
    )


def streamed_game_data(batch, rows: slice = slice(None)) -> StreamedGameData:
    """A ``GameBatch``'s columns (its ``rows``) copied to host numpy, the
    out-of-core trainer's input."""
    def host(t):
        return t[rows].cpu().numpy()

    return StreamedGameData(labels=host(batch.labels), features={s: host(f.X) for s, f in batch.features.items()},
                            id_tags={k: host(v) for k, v in batch.id_tags.items()})


def score_streamed(model: GameModel, data: StreamedGameData, dev, rows: int = E_STREAM_CHUNK) -> torch.Tensor:
    """The model's scores of host rows, computed on the card a block of
    rows at a time."""
    out = []
    for lo in range(0, data.num_rows, rows):
        hi = min(lo + rows, data.num_rows)
        block = make_game_batch(data.labels[lo:hi], {s: f[lo:hi] for s, f in data.features.items()},
                                id_tags={k: v[lo:hi] for k, v in data.id_tags.items()}, device=dev)
        out.append(model.score(block))
    return torch.cat(out)


def fit_streamed(data: StreamedGameData, config: GameTrainingConfig, dev, on_mark=None, **trainer_kw) -> dict:
    """``StreamedGameTrainer.fit`` (chunks of ``E_STREAM_CHUNK`` rows, and
    ``trainer_kw``) with every kernel's launch count, the chunk cache and
    the copy counters zeroed just before and read just after. The trainer's
    logger marks the end of every visit (each mark synchronizes the card,
    then calls ``on_mark``); per visit: wall, scalar read-backs, cache hits
    and misses, bytes copied, and the trainer's own visit record."""
    marks = []

    def mark(msg: str) -> None:
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), msg, reads[0], prefetch.cache_stats(), dict(prefetch.copied)))
        if on_mark is not None:
            on_mark()

    prefetch.clear_cache()
    fused.reset_launch_counts()
    st.reset_launch_counts()
    game_random_effect.reset_launch_counts()
    prefetch.reset_stage_seconds()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = (t0, 0, prefetch.cache_stats(), dict(prefetch.copied))
    # the entity-iteration counts read the iterations back at each visit's
    # flush; with no telemetry sink the port reads them only when asked
    with counting_readbacks() as reads, environment({"PHOTON_RE_ITER_ACCOUNTING": "1"}):
        trainer = StreamedGameTrainer(config, chunk_rows=E_STREAM_CHUNK, intercept_indices={"global": D_FIXED},
                                      logger=mark, device=dev, **trainer_kw)
        model, info = trainer.fit(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    visits, prev = [], start
    for (t, msg, n_reads, stats, copied), own in zip([m for m in marks if m[1].startswith("iter ")],
                                                      trainer.visit_stats):
        visits.append(dict(own, wall_s=t - prev[0], readbacks=n_reads - prev[1],
                           cache_misses=stats["misses"] - prev[2]["misses"],
                           cache_hits=stats["device_hits"] - prev[2]["device_hits"],
                           bytes_copied_total=copied["bytes"] - prev[3]["bytes"]))
        prev = (t, n_reads, stats, copied)
    fixed = [v for v in visits if v["coordinate"] == "fixed"]
    return dict(model=model, info=info, trainer=trainer, wall_s=wall, visits=visits,
                iteration_wall_s=[sum(v["wall_s"] for v in visits if v["iteration"] == i)
                                  for i in range(config.coordinate_descent_iterations)],
                launches=launch_counts(), re_launches=dict(game_random_effect.launch_counts),
                fixed_objective_passes=sum(v["objective_passes"] for v in fixed),
                cache=prefetch.cache_stats(), stage_seconds=REGISTRY.timer_snapshot("prefetch."))


def profile_streamed(data: StreamedGameData, config: GameTrainingConfig, dev) -> dict:
    """``torch.profiler`` over the streamed fit's second outer iteration (a
    fit of 2; the profiler steps at every visit mark and records the three
    visits of iteration 1): the card's busy share of that window, as
    ``profile_e`` reads it."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # steps: 0-2 iteration 0's visits (set-up in step 0), 3-5 iteration 1's
    with profile(activities=acts, schedule=schedule(wait=2, warmup=1, active=3, repeat=1)) as prof:
        fit = fit_streamed(data, config, dev, on_mark=prof.step)
    window = fit["iteration_wall_s"][1]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)  # noqa: E731
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0 and not e.key.startswith("ProfilerStep")]
    busy_s = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:10]
    return dict(window_wall_s=window, device_busy_s=busy_s,
                device_busy_share=busy_s / window if events and window else "not measured (no device events)",
                top_device_ops=[dict(name=e.key[:90], device_ms=dev_us(e) / 1e3, count=e.count) for e in top])


def e_streamed_reference(dev, batch, data) -> tuple[StreamedGameData, dict]:
    """main_e_streamed's inputs, taken while main_e's batch is on the card:
    its rows copied to host numpy, and the in-memory ``GameEstimator`` fit
    of main_e_streamed's configuration (2 outer iterations) on them."""
    t0 = time.perf_counter()
    host = streamed_game_data(batch)
    to_host_s = time.perf_counter() - t0
    mem = fit_game(batch, game_config(E_ML20M[1], 2), dev)
    return host, dict(_game_record(mem), **game_quality(mem, batch, data), to_host_s=to_host_s)


def run_e_streamed(dev, host: StreamedGameData, mem: dict, e_rec: dict, card: str) -> tuple[dict, GameModel]:
    """main_e_streamed: config E at MovieLens-20M depth (main_e's rows, seed
    4) out of core from host numpy: 2 outer iterations of
    ``StreamedGameTrainer`` in chunks of 2^20 rows (the fixed effect
    streamed through K1, the random effects' buckets gathered on the host
    every visit), held to the in-memory fit ``mem`` of the same
    configuration on the same rows (``e_streamed_reference``). Returns the
    record and the model (main_e_streamed_multihost is held to it)."""
    n, effects = E_ML20M
    config = game_config(effects, 2)
    chunks = -(-n // E_STREAM_CHUNK)
    rec = dict(card=card, n=n, effects={k: list(v) for k, v in effects.items()}, chunk_rows=E_STREAM_CHUNK,
               chunks=chunks, last_chunk_rows=n - (chunks - 1) * E_STREAM_CHUNK,
               host_bytes=sum(a.nbytes for a in (host.labels, *host.features.values(), *host.id_tags.values())),
               in_memory=mem, pinned_h2d_gb_s=pinned_h2d_gb_s(dev))
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.reset_peak_host_memory_stats()
    fit = fit_streamed(host, config, dev)
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    rec["host"] = host_memory()
    scores = score_streamed(fit["model"], host, dev)
    labels = torch.as_tensor(host.labels, device=dev)
    auc, log_loss = float(auc_roc(scores, labels)), make_evaluator("LOGISTIC_LOSS")(scores, labels)
    del scores, labels
    fixed = [v for v in fit["visits"] if v["coordinate"] == "fixed"]
    first_chunk = torch.as_tensor(host.features["global"][:E_STREAM_CHUNK], device=dev)
    first_labels = torch.as_tensor(host.labels[:E_STREAM_CHUNK], device=dev)
    ones = torch.ones(E_STREAM_CHUNK, device=dev)
    rec.update(
        wall_s=fit["wall_s"], iteration_wall_s=fit["iteration_wall_s"],
        timed_wall_s_per_outer_iteration=fit["iteration_wall_s"][1],
        visits=fit["visits"], launches=fit["launches"], re_solve_launches=fit["re_launches"],
        fixed_objective_passes=fit["fixed_objective_passes"],
        bytes_copied_per_fixed_pass=[v["bytes_copied_total"] / v["objective_passes"] for v in fixed],
        cache=fit["cache"], stage_seconds=fit["stage_seconds"],
        re_copy_s_at_pinned_rate={f"{v['iteration']}/{v['coordinate']}": v["bytes_copied"] / 1e9
                                  / rec["pinned_h2d_gb_s"] for v in fit["visits"] if "bytes_copied" in v},
        k1_layout=k1_layout(first_chunk, first_labels, ones, ones),
        train_auc=auc, train_log_loss=log_loss, auc_generating_model=mem["auc_generating_model"],
        quality_ok=auc >= 0.95 * mem["auc_generating_model"], fixed_objective=fit["info"]["fixed"].final_loss,
        d_auc_vs_in_memory=abs(auc - mem["train_auc"]),
        rel_d_log_loss_vs_in_memory=abs(log_loss - mem["train_log_loss"]) / mem["train_log_loss"],
        main_e_timed_wall_s_per_outer_iteration=e_rec["timed_wall_s_per_outer_iteration"],
    )
    # the second fixed visit copies only its residual offsets: one array a chunk
    rec["second_fixed_visit_misses"] = fixed[1]["cache_misses"]
    rec["launches_ok"] = (rec["fixed_objective_passes"] > 0
                          and fit["launches"]["fused_value_grad"] == chunks * rec["fixed_objective_passes"]
                          and not any(v for k, v in fit["launches"].items() if k != "fused_value_grad"))
    model = fit["model"]
    del fit
    torch.cuda.empty_cache()
    rec["profile"] = profile_streamed(host, config, dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    rec["k1_at_chunk"] = k1_at(first_chunk, 0.1 * torch.randn(E_STREAM_CHUNK, generator=gen, device=dev),
                               first_labels, dev)
    prefetch.clear_cache()
    return rec, model


def _visit_exchanges(visits: list) -> list:
    """Each random-effect visit's offset and score exchanges (seconds,
    bytes sent) and its host gather seconds."""
    keys = ("offsets_exchange_s", "offsets_exchange_bytes", "scores_exchange_s", "scores_exchange_bytes", "gather_s")
    return [dict(iteration=v["iteration"], coordinate=v["coordinate"], **{k: v[k] for k in keys})
            for v in visits if "offsets_exchange_s" in v]


def run_e_streamed_multihost(dev, e_streamed: dict, e_model: GameModel, card: str) -> dict:
    """main_e_streamed_multihost: main_e_streamed's problem (config E at
    ML-20M depth, 2 outer iterations, chunks of 2^20 rows) in two processes
    of this script on the card, each drawing main_e's rows from the seed on
    the card and keeping one contiguous half on its host:
    ``StreamedGameTrainer(multihost=True)`` (each process streams its own
    chunks through K1 and the passes sum over gloo; each entity's rows
    travel to their owner once, and the offsets and scores every visit).
    Held to main_e_streamed (one process, every row)."""
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="_e_streamed_multihost-", dir=ROOT)
    try:
        t0 = time.perf_counter()
        kids = run_children("e_streamed_multihost", work, {"shape": E_ML20M, "chunk_rows": E_STREAM_CHUNK}, dev)
        wall = time.perf_counter() - t0
        arrays = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cids = list(e_model.models)
    margins = torch.from_numpy(np.concatenate([a["margins"] for a in arrays])).to(dev)
    labels = torch.from_numpy(np.concatenate([a["labels"] for a in arrays])).to(dev)
    auc = float(auc_roc(margins, labels))
    del margins, labels
    random = {c: close(torch.from_numpy(arrays[0][c]).to(dev), e_model[c].coefficient_means, 1e-2, 2e-3)
              for c in cids if c != "fixed"}
    launches = {k: sum(c["launches"][k] for c in kids) for k in launch_counts()}
    fixed_objective = kids[0]["fixed_objective"]
    return dict(
        card=card, processes=2, phase_wall_s=wall, launches=launches,
        rows=[c["rows"] for c in kids], chunks=[c["chunks"] for c in kids], data_s=[c["data_s"] for c in kids],
        wall_s=[c["wall_s"] for c in kids], iteration_wall_s=[c["iteration_wall_s"] for c in kids],
        timed_wall_s_per_outer_iteration=max(c["iteration_wall_s"][1] for c in kids),
        main_e_streamed_timed_wall_s_per_outer_iteration=e_streamed["timed_wall_s_per_outer_iteration"],
        visit_wall_s=[{f"{v['iteration']}/{v['coordinate']}": v["wall_s"] for v in c["visits"]} for c in kids],
        ingest_exchange={c: [k["exchange_totals"][f"ingest/{c}"] for k in kids] for c in cids if c != "fixed"},
        visit_exchanges=[_visit_exchanges(c["visits"]) for c in kids], collectives=[c["collectives"] for c in kids],
        fixed_objective_passes=[c["fixed_objective_passes"] for c in kids],
        peak_device_bytes=[c["peak_device_bytes"] for c in kids],
        main_e_streamed_peak_device_bytes=e_streamed["peak_device_bytes"],
        # at the fit's end (a child's getrusage peak starts at its parent's size at the fork)
        host_rss_bytes=[c["host"].get("rss_bytes") for c in kids],
        models_bitwise_equal_across_ranks=all(arrays[0][c].tobytes() == arrays[1][c].tobytes() for c in cids),
        train_auc=auc, d_auc_vs_main_e_streamed=abs(auc - e_streamed["train_auc"]),
        fixed_objective=fixed_objective,
        rel_d_fixed_objective_vs_main_e_streamed=abs(fixed_objective - e_streamed["fixed_objective"])
        / abs(e_streamed["fixed_objective"]),
        random_effects_within_lane_tolerance=all(ok for ok, _ in random.values()),
        max_abs_diff_random_effects_vs_main_e_streamed={c: err for c, (_, err) in random.items()},
        k1_launches_ok=all(c["fixed_objective_passes"] > 0
                           and c["launches"]["fused_value_grad"] == c["chunks"] * c["fixed_objective_passes"]
                           and not any(v for k, v in c["launches"].items() if k != "fused_value_grad")
                           for c in kids),
    )


def run_game_cli_streamed(dev, data: GameCliData, card: str) -> dict:
    """main_game_cli_streamed: ``cli.train.main --streaming-chunk-rows
    32768`` on main_game_cli's files and configuration (2 outer iterations,
    the λ grid; its outputs kept in ``work/out_streamed-2it``), then a
    rerun to 3 iterations that resumes from its visit checkpoints, then
    ``cli.score.main`` on the streamed model; held to main_game_cli's
    in-memory driver output (its 3-iteration run, in ``work/out``) and to
    the library's scores of the same model."""
    work, effects, n_tr = data.work, data.effects, data.n_train
    out = os.path.join(work, "out_streamed")
    argv = lambda it: ["--config", os.path.join(work, f"config-{it}.json"),  # noqa: E731
                       "--train-data", os.path.join(work, "train"), "--validation-data", os.path.join(work, "val"),
                       "--output-dir", out, "--device", dev.type, "--streaming-chunk-rows", str(GLM_CLI_CHUNK)]
    decoders = []
    real_read, real_streamed = AvroDataReader.read, AvroDataReader.read_streamed_game

    def read(self, *args, **kwargs):
        ds = real_read(self, *args, **kwargs)
        decoders.append(ds.decoder)
        return ds

    def read_streamed(self, *args, **kwargs):
        ds = real_streamed(self, *args, **kwargs)
        decoders.append(ds.decoder)
        return ds

    runs = {}
    AvroDataReader.read, AvroDataReader.read_streamed_game = read, read_streamed
    try:
        for it in (2, 3):
            fused.reset_launch_counts()
            st.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with stage_times(cli_train) as stages, recording_streamed_trainers() as trainers:
                cli_train.main(argv(it))
            torch.cuda.synchronize()
            passes = sum(v["objective_passes"] for t in trainers for v in t.visit_stats if "objective_passes" in v)
            runs[it] = dict(wall_s=time.perf_counter() - t0, stages_s=stages, launches=launch_counts(),
                            fixed_objective_passes=passes, resumed_from=[t.resumed_from for t in trainers])
            if it == 2:  # main_game_cli_streamed_multihost's first run is held to this one
                shutil.copytree(out, out + "-2it", ignore=shutil.ignore_patterns("checkpoints"))
        score_out = os.path.join(work, "scores_streamed")
        with stage_times(cli_score) as score_stages:
            cli_score.main(["--model-dir", out, "--data", os.path.join(work, "val"), "--output-dir", score_out,
                            "--evaluators", *GAME_CLI_EVALUATORS, "--config", os.path.join(work, "config-3.json"),
                            "--device", dev.type])
    finally:
        AvroDataReader.read, AvroDataReader.read_streamed_game = real_read, real_streamed
    chunks = -(-n_tr // GLM_CLI_CHUNK)
    for r in runs.values():
        r["launches_ok"] = (r["fixed_objective_passes"] > 0
                            and r["launches"]["fused_value_grad"] == chunks * r["fixed_objective_passes"]
                            and not any(v for k, v in r["launches"].items() if k != "fused_value_grad"))
    with open(os.path.join(out, "photon.log")) as f:
        resumed_lines = f.read().count(STREAMED_RESUME_LINE)

    streamed, s_metrics = driver_output(out, effects, dev)
    in_memory, m_metrics = driver_output(os.path.join(work, "out"), effects, dev)
    best = s_metrics["best_index"]
    _, recs = read_avro_file(os.path.join(score_out, "scores", "part-00000.avro"))
    file_scores = torch.tensor([r["predictionScore"] for r in recs], dtype=torch.float64)
    library = GameTransformer(streamed, device=dev).transform(data.arrays[1]).double().cpu()
    coef_ok = all(close(streamed[c].coefficient_means, in_memory[c].coefficient_means, 1e-2, 1e-3)[0]
                  for c in streamed.models)
    return dict(
        card=card, rows_train=n_tr, chunk_rows=GLM_CLI_CHUNK, chunks=chunks, runs=runs, decoders=decoders,
        score_stages_s=score_stages, launches={k: runs[2]["launches"][k] + runs[3]["launches"][k]
                                               for k in runs[2]["launches"]},
        launches_ok=all(r["launches_ok"] for r in runs.values()), resumed_lines=resumed_lines,
        resume_ok=resumed_lines == 2 and runs[3]["resumed_from"] == [(2, 0), (2, 0)],
        best_index=best, in_memory_best_index=m_metrics["best_index"],
        best_primary=s_metrics["results"][best]["primary"],
        in_memory_best_auc=m_metrics["results"][m_metrics["best_index"]]["metrics"]["AUC"],
        coefficients_ok=coef_ok, max_abs_diff_vs_in_memory_driver=_max_diff(streamed, in_memory),
        validation_history_visits=len(s_metrics["validation_history"]),
        scores_rows=len(recs), scores_finite=bool(torch.isfinite(file_scores).all()),
        max_abs_diff_scores_file_vs_library=float((file_scores - library).abs().max()),
    )


def driver_output(d: str, effects: dict, dev, best: str = "best") -> tuple[GameModel, dict]:
    """A GAME train driver's model in ``best`` (under ``d`` unless absolute),
    read through its index and entity maps, and its ``metrics.json``."""
    maps = {fn[:-4]: IndexMap.load(os.path.join(d, "index-maps", fn))
            for fn in os.listdir(os.path.join(d, "index-maps"))}
    with open(os.path.join(d, "entity-maps.json")) as f:
        ent = json.load(f)
    model = load_game_model(os.path.join(d, best), index_maps=maps,
                            entity_ids={f"per_{k}": ent[k] for k in effects}, device=dev)
    with open(os.path.join(d, "metrics.json")) as f:
        return model, json.load(f)


def run_game_cli_streamed_multihost(dev, data: GameCliData, card: str) -> dict:
    """main_game_cli_streamed_multihost: ``cli.train --multihost
    --streaming-chunk-rows 32768`` in two processes of this script on
    main_game_cli's files (two training parts: one a process; every
    process's statistics pass reads both), as main_game_cli_streamed runs
    it: 2 outer iterations, then the same command at 3, which resumes both
    grid entries at outer iteration 2 from the sharded checkpoints (each
    process's score files); then 3 iterations uninterrupted into other
    directories, which the resumed run must equal bit for bit. Held to
    main_game_cli_streamed's 2- and 3-iteration runs."""
    work, effects = data.work, data.effects
    root = os.path.join(work, "game_streamed_multihost")

    def train(it: int, out: str) -> tuple:
        return ("train", ["--config", os.path.join(work, f"config-{it}.json"), "--train-data",
                          os.path.join(work, "train"), "--validation-data", os.path.join(work, "val"),
                          "--device", dev.type, "--streaming-chunk-rows", str(GLM_CLI_CHUNK), "--multihost",
                          "--output-dir", os.path.join(root, out)])

    # the uninterrupted run writes fleet telemetry (main_telemetry reads it):
    # the resumed run, telemetry off, must equal it bit for bit
    telemetry = os.path.join(root, "telemetry")
    t0 = time.perf_counter()
    kids = run_children("game_multihost_cli", root, {"phases": [
        train(2, "out{rank}"), train(3, "out{rank}"),
        ("train", train(3, "fresh{rank}")[1] + ["--telemetry-dir", telemetry]),
    ]}, dev, env={"PHOTON_TELEMETRY_FLEET": "1"}, ports=3)
    wall = time.perf_counter() - t0
    first, rerun, fresh = ([c["phases"][i] for c in kids] for i in range(3))
    out0 = os.path.join(root, "out0")
    first_model, _ = driver_output(out0, effects, dev, best=os.path.join(root, "first-best"))
    rerun_model, metrics = driver_output(out0, effects, dev)
    fresh_model, fresh_metrics = driver_output(os.path.join(root, "fresh0"), effects, dev)
    one_2it, one_2it_metrics = driver_output(os.path.join(work, "out_streamed-2it"), effects, dev)
    one_3it, one_3it_metrics = driver_output(os.path.join(work, "out_streamed"), effects, dev)
    with open(os.path.join(out0, "photon.log")) as f:
        resumed_lines = f.read().count(STREAMED_RESUME_LINE)

    def files(d: str) -> list:
        return sorted(os.path.relpath(os.path.join(p, f), d) for p, _, fs in os.walk(d) for f in fs)

    def k1_ok(p: dict) -> bool:  # K1 once a chunk of this process's rows a pass, nothing else
        chunks = -(-p["streamed"][0]["rows"] // GLM_CLI_CHUNK)
        return (p["fixed_objective_passes"] > 0
                and p["launches"]["fused_value_grad"] == chunks * p["fixed_objective_passes"]
                and not any(v for k, v in p["launches"].items() if k != "fused_value_grad"))

    score_files = [f"checkpoints/grid-000{i}/scores-shard-00001.npz" for i in range(2)]
    phases = (first, rerun, fresh)
    launches = {k: sum(p["launches"][k] for ph in phases for p in ph) for k in launch_counts()}
    return dict(
        card=card, processes=2, wall_s=wall, chunk_rows=GLM_CLI_CHUNK,
        train_wall_s=[p["wall_s"] for p in first], rerun_wall_s=[p["wall_s"] for p in rerun],
        fresh_wall_s=[p["wall_s"] for p in fresh],
        rows=[[s["rows"] for s in p["streamed"]] for p in first],
        ingest_exchange=[[s["exchange_totals"] for s in p["streamed"]] for p in first],
        visit_exchanges=[[s["visit_exchanges"] for s in p["streamed"]] for p in first],
        collectives=[p["collectives"] for p in first], launches=launches,
        fixed_objective_passes=[[p["fixed_objective_passes"] for p in ph] for ph in phases],
        launches_ok=all(k1_ok(p) for ph in phases for p in ph),
        best_index=first[0]["best_index"], one_process_best_index=one_2it_metrics["best_index"],
        rerun_best_index=metrics["best_index"], one_process_rerun_best_index=one_3it_metrics["best_index"],
        models_ok=_close(first_model, one_2it, 1e-2, 1e-3) and _close(rerun_model, one_3it, 1e-2, 1e-3),
        max_abs_diff_vs_one_process=max(_max_diff(first_model, one_2it), _max_diff(rerun_model, one_3it)),
        only_process_0_wrote=files(os.path.join(root, "out1")) == score_files
        and files(os.path.join(root, "fresh1")) == score_files and os.path.exists(os.path.join(out0, "best")),
        resumed_lines=resumed_lines, resumed_from=[[s["resumed_from"] for s in p["streamed"]] for p in rerun],
        rerun_bitwise_uninterrupted=_model_bytes(rerun_model) == _model_bytes(fresh_model)
        and metrics["best_index"] == fresh_metrics["best_index"],
        fleet_telemetry=fleet_telemetry_files(telemetry),
    )


def fleet_telemetry_files(directory: str) -> dict:
    """A fleet run's files: the canonical one and its shards, each checked
    by the port's ``validate_run``, with their run ids and sizes."""
    files = sorted(os.listdir(directory))
    runs = [load_run(os.path.join(directory, f)) for f in files]
    return dict(files=files, bytes=[os.path.getsize(os.path.join(directory, f)) for f in files],
                run_ids=[r[0].get("run_id") for r in runs], process_index=[r[0].get("process_index") for r in runs],
                problems=[validate_run(r) for r in runs],
                spans=[sorted({x["name"] for x in r if x["event"] == "span"}) for r in runs])


# ---------------------------------------------------------------------------
# run telemetry: the drivers with --telemetry-dir and --profile-dir
# ---------------------------------------------------------------------------
def decoded_outputs(d: str, skip: tuple = ("checkpoints", "photon.log", "report.json")) -> dict:
    """A driver's output files decoded (Avro records, npz arrays as bytes,
    JSON), by relative path: Avro's sync markers are random, so two runs
    compare by their records."""
    got = {}
    for p, _, fs in os.walk(d):
        for f in fs:
            rel = os.path.relpath(os.path.join(p, f), d)
            if rel.split(os.sep)[0] in skip:
                continue
            full = os.path.join(p, f)
            if f.endswith(".avro"):
                got[rel] = read_avro_file(full)[1]
            elif f.endswith(".npz"):
                with np.load(full) as z:
                    got[rel] = {k: z[k].tobytes() for k in z.files}
            elif f.endswith(".json"):
                with open(full) as fh:
                    got[rel] = json.load(fh)
    return got


def telemetry_run(directory: str) -> tuple[list, dict]:
    """The one run file in ``directory``: its records and a summary (size,
    problems, span names, record kinds, the registry's counters at its
    end less those at its start)."""
    (name,) = os.listdir(directory)
    path = os.path.join(directory, name)
    records = load_run(path)
    end = records[-1].get("metrics", {}).get("counters", {})
    base = records[0].get("metrics_baseline", {}).get("counters", {})
    counters = {k: v["value"] - base.get(k, {"value": 0.0})["value"] for k, v in end.items()}
    return records, dict(file=name, bytes=os.path.getsize(path), problems=validate_run(records),
                         records=len(records), kinds=sorted({r["event"] for r in records}),
                         counters=counters)


def _ancestors(span: dict, by_id: dict) -> list[str]:
    names = []
    while span is not None:
        names.append(span["name"])
        span = by_id.get(span.get("parent_id"))
    return names


def k1_bound_bytes(n: int, d: int, itemsize: int, offsets: bool, weights: bool) -> int:
    """The bytes K1's bound divides (``k1_time``'s count): X, labels,
    offsets and weights where read, u; the d + 2 results."""
    return n * d * itemsize + 4 * n * (1 + offsets + weights) + 4 * d + 4 * (d + 2)


def k2_bound_bytes(n: int, d: int, itemsize: int, offsets: bool, weights: bool) -> int:
    """The bytes K2's bound divides (``k2_time``'s count)."""
    return n * d * itemsize + 4 * n * (1 + offsets + weights) + 8 * d + 4 * (d + 1)


def run_telemetry(dev, data: GameCliData, cli: dict, glm_streamed: dict) -> dict:
    """main_telemetry: main_game_cli's 2-iteration training command again
    with ``--telemetry-dir`` and ``--profile-dir`` into a new directory, and
    the scoring driver on both runs' models (telemetry off and on);
    main_glm_streamed_cli's command again with ``--telemetry-dir``, then
    with TRON (one λ, 5 iterations). Each run's outputs against its
    telemetry-off twin's, its file checked by ``validate_run``, its span
    tree, registry, memory and cost records read."""
    work, effects = data.work, data.effects
    cfg2 = os.path.join(work, "config-2.json")
    out_on = os.path.join(work, "out-telemetry")
    tel_game, prof = os.path.join(work, "telemetry-game"), os.path.join(work, "profile-game")

    # the GAME driver in memory, telemetry and the profiler on
    torch.cuda.reset_peak_memory_stats()
    fused.reset_launch_counts()
    st.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_train.main(["--config", cfg2, "--train-data", os.path.join(work, "train"), "--validation-data",
                    os.path.join(work, "val"), "--output-dir", out_on, "--device", dev.type,
                    "--telemetry-dir", tel_game, "--profile-dir", prof])
    torch.cuda.synchronize()
    game_wall = time.perf_counter() - t0
    game_launches = launch_counts()
    game_peak = torch.cuda.max_memory_allocated()
    off = decoded_outputs(os.path.join(work, "out-2it"))
    on = decoded_outputs(out_on)
    records, game_run = telemetry_run(tel_game)
    spans = [r for r in records if r["event"] == "span"]
    by_id = {x["span_id"]: x for x in spans}
    visits = [x for x in spans if x["name"] == "descent/visit"]
    watermarks = [r for r in records if r["event"] == "hbm_watermark"]
    with open(os.path.join(prof, "grid-fit", "trace.json")) as f:
        trace_names = {e.get("name", "") for e in json.load(f).get("traceEvents", [])}
    k1_in_trace = sorted(n for n in trace_names if "vg_tiles_kernel" in n or "vg_kernel" in n)

    # the scoring driver on both models: telemetry off, then on
    score = {}
    for label, model_dir, extra in (("off", os.path.join(work, "out-2it"), []),
                                    ("on", out_on, ["--telemetry-dir", os.path.join(work, "telemetry-score"),
                                                    "--profile-dir", prof])):
        dest = os.path.join(work, f"scores-telemetry-{label}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_score.main(["--model-dir", model_dir, "--data", os.path.join(work, "val"), "--output-dir", dest,
                        "--evaluators", *GAME_CLI_EVALUATORS, "--config", cfg2, "--device", dev.type, *extra])
        torch.cuda.synchronize()
        score[label] = dict(wall_s=time.perf_counter() - t0, outputs=decoded_outputs(dest))
    score_records, score_run = telemetry_run(os.path.join(work, "telemetry-score"))

    # the streamed GLM driver, telemetry on: L-BFGS (main_glm_streamed_cli's twin), then TRON
    glm = {}
    for label, extra in (("lbfgs", []), ("tron", ["--optimizer", "TRON", "--weights", "1",
                                                  "--max-iterations", "5"])):
        out = os.path.join(work, f"glm_streamed-telemetry-{label}")
        tel = os.path.join(work, f"telemetry-glm-{label}")
        fused.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_train_glm.main(glm_streamed_argv(dev, work, out) + ["--telemetry-dir", tel] + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recs, run = telemetry_run(tel)
        costs: dict[str, set] = {}  # label -> the bytes of each signature it recorded
        for r in recs:
            if r["event"] == "executable_cost":
                costs.setdefault(r["label"], set()).add(r["bytes_accessed"])
        glm[label] = dict(wall_s=wall, run=run, launches=launch_counts(),
                          solve_passes=sum(r["objective_passes"] for r in recs if r["event"] == "optim_result"),
                          stream_passes=run["counters"].get("stream.passes", 0.0),
                          costs={k: sorted(v) for k, v in costs.items()})
        if label == "lbfgs":
            glm_models = {k: v for k, v in decoded_outputs(out).items() if k.startswith(("models", "best"))}
    n, d = GLM_CLI_CHUNK, glm_streamed["d"]
    k1_bytes, k2_bytes = k1_bound_bytes(n, d, 4, True, True), k2_bound_bytes(n, d, 4, True, True)
    glm_off = decoded_outputs(os.path.join(work, "glm_streamed"))
    launches = {k: game_launches[k] + glm["lbfgs"]["launches"][k] + glm["tron"]["launches"][k]
                for k in game_launches}
    return dict(
        game=dict(wall_s_telemetry_and_profiler=game_wall, wall_s_off=cli["train_wall_s"], run=game_run,
                  launches=game_launches, launches_off=cli["launches"],
                  hbm_watermarks=len(watermarks),
                  hbm_peak_bytes=max((w.get("peak_bytes_in_use", 0) for w in watermarks), default=None),
                  peak_memory_bytes=game_peak, peak_memory_bytes_off=cli["peak_memory_bytes"],
                  k1_kernels_in_trace=k1_in_trace,
                  cuda_build_s=records[-1]["metrics"]["timers"].get("cuda.build_s")),
        score=dict(wall_s_on=score["on"]["wall_s"], wall_s_off=score["off"]["wall_s"], run=score_run),
        glm_streamed=dict(wall_s_off=glm_streamed["wall_s"], **glm, k1_bound_bytes=k1_bytes,
                          k2_bound_bytes=k2_bytes),
        launches=launches,
        outputs_bitwise=bool(off) and off == {k: v for k, v in on.items() if k in off} and off.keys() <= on.keys(),
        scores_bitwise=bool(score["off"]["outputs"]) and score["off"]["outputs"] == score["on"]["outputs"],
        glm_models_bitwise=bool(glm_models) and all(glm_off.get(k) == v for k, v in glm_models.items()),
        jsonl_valid=not game_run["problems"] and not score_run["problems"]
        and not glm["lbfgs"]["run"]["problems"] and not glm["tron"]["run"]["problems"],
        span_tree=bool(visits) and all(
            _ancestors(v, by_id)[:2] == ["descent/visit", "descent/iter"] and "train/grid-fit" in _ancestors(v, by_id)
            for v in visits) and "score/pass" in {x["name"] for x in score_records if x["event"] == "span"},
        re_solve=game_run["counters"].get("re_solve.launches", 0) > 0
        and game_run["counters"].get("re_solve.executed_entity_iterations", 0) > 0,
        hbm_available=bool(watermarks) and all(w["available"] for w in watermarks),
        k1_in_profile=bool(k1_in_trace),
        # a signature is recorded once a process: K1's chunk in the first run, K2's in the second
        k1_cost_bytes=glm["lbfgs"]["costs"].get("fused.value_grad") == [k1_bytes],
        k2_cost_bytes=glm["tron"]["costs"].get("fused.hvp") == [k2_bytes],
        stream_passes=all(r["solve_passes"] > 0 and r["stream_passes"] == r["solve_passes"] for r in glm.values()),
        same_launches_as_off=game_launches == cli["launches"]
        and glm["lbfgs"]["launches"] == glm_streamed["launches"],
    )


def _check_game_launches(phase: str, rec: dict) -> None:
    """Every fixed-effect objective pass ran on K1, and nothing else
    launched a kernel."""
    launches = rec["launches"]
    others = {k: v for k, v in launches.items() if k != "fused_value_grad" and v}
    if launches["fused_value_grad"] != rec["fixed_objective_passes"] or not launches[
        "fused_value_grad"
    ] or others:
        raise AssertionError(f"{phase}: K1 launches {launches} against "
                             f"{rec['fixed_objective_passes']} fixed-effect objective passes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    name, power_limit = [s.strip() for s in smi.split(",", 1)]
    emit("device", name=name, power_limit=power_limit, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ for the Avro decoder beside nvcc
        native_lib = pool.submit(native_build.build)
        lib = _cuda.build()
        native_lib = native_lib.result()
    spills = {
        src.name: sum(1 for line in _cuda.log_path(lib, src).read_text().splitlines()
                      if "spill" in line and " 0 bytes spill" not in line)
        for src in _cuda.SOURCES
    }
    emit("build", seconds=time.perf_counter() - t0, library=lib.name, spill_lines=spills,
         native_library=native_lib.name)

    parity(dev)
    k3_err = parity_k3(dev)
    rows = timing(dev)
    k1_config_b = rows.pop("k1_config_b")
    timing_k1_layouts(dev)
    k3_rows = timing_k3(dev, gather_floor(dev))

    # main path A: the headline solve, then the sweep
    batch, intercept, val = headline_problem(dev)
    a = run_a(batch, intercept, dev)
    emit("main_a", **a)
    if a["launches"]["fused_value_grad"] != a["objective_passes"] or a["launches"]["fused_hvp"]:
        raise AssertionError(f"main path A did not run on K1 alone: {a['launches']}")
    sweep = run_sweep(batch, intercept, val, dev)
    emit("main_a_sweep", **sweep)
    if sweep["launches"]["fused_value_grad"] == 0:
        raise AssertionError("the sweep launched no K1")
    # the same solve over 4 row shards of the card
    a_sharded = run_a_sharded(batch, intercept, a, dev)
    emit("main_a_sharded", **a_sharded)
    failed = [name for name, ok in (
        ("k1_launches", a_sharded["k1_launches_ok"]),
        ("repeat_bitwise", a_sharded["repeat_bitwise"]),
        ("vs_main_a", a_sharded["d_auc_vs_main_a"] <= 0.005 and a_sharded["rel_d_objective_vs_main_a"] <= 1e-3),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_a_sharded failed: {failed}")

    # main path B: TRON on config B
    b = run_b(dev)
    emit("main_b", **b)
    k1, k2 = b["launches"]["fused_value_grad"], b["launches"]["fused_hvp"]
    if k1 != b["iterations"] + 1 or k2 == 0 or k1 + k2 != b["objective_passes"]:
        raise AssertionError(f"main path B did not run on K1 and K2: {b['launches']}")

    # agreement: the same solves with the kernels vetoed
    os.environ["PHOTON_DISABLE_FUSED"] = "1"
    try:
        a0 = run_a(batch, intercept, dev)
        del batch, val
        torch.cuda.empty_cache()
        b0 = run_b(dev)
    finally:
        del os.environ["PHOTON_DISABLE_FUSED"]
    if any(a0["launches"].values()) or any(b0["launches"].values()):
        raise AssertionError("the unfused runs launched a kernel")
    agree = dict(
        a_unfused=a0, b_unfused=b0,
        d_auc=abs(a["train_auc"] - a0["train_auc"]),
        a_rel_d_objective=abs(a["objective"] - a0["objective"]) / abs(a0["objective"]),
        b_rel_d_objective=abs(b["objective"] - b0["objective"]) / abs(b0["objective"]),
        b_rel_d_rmse=abs(b["train_rmse"] - b0["train_rmse"]) / b0["train_rmse"],
    )
    emit("agreement", **agree)
    if not (agree["d_auc"] <= 0.005 and agree["a_rel_d_objective"] <= 1e-3
            and agree["b_rel_d_objective"] <= 1e-3 and agree["b_rel_d_rmse"] <= 1e-4):
        raise AssertionError("fused and unfused solves disagree")

    # main path A2: the high-dimensional sparse solve on K3, f32 rung
    os.environ["PHOTON_KERNEL_DTYPE"] = "f32"
    try:
        a2, a2_batch, a2_model = run_a2(dev)
        emit("main_a2", **a2)
        k3 = {d: a2["launches"][f"sparse_{d}"] for d in st.DIRECTIONS}
        if min(k3.values()) == 0 or k3["matvec"] < a2["objective_passes"]:
            raise AssertionError(f"main path A2 did not run on K3 in all directions: {k3}")
        if not (a2["quality_ok"] and a2["variances_finite"]):
            raise AssertionError(f"A2 solve quality: AUC {a2['train_auc']} against "
                                 f"{a2['auc_true_weights']} for the true weights")
        # the same data over 4 row shards, one K3 layout each
        a2_sharded = run_a2_sharded(a2_batch, a2, dev)
        emit("main_a2_sharded", **a2_sharded)
        failed = [name for name, ok in (
            ("k3_launches", a2_sharded["launches_ok"]),
            ("vs_main_a2", a2_sharded["d_auc_vs_main_a2"] <= 1e-3 and a2_sharded["rel_d_objective_vs_main_a2"] <= 1e-4),
            ("variances", a2_sharded["variances_finite"]),
        ) if not ok]
        if failed:
            raise AssertionError(f"main_a2_sharded failed: {failed}")
        torch.cuda.empty_cache()
        agree_a2 = agreement_a2(a2_batch, a2, a2_model, dev)
    finally:
        del os.environ["PHOTON_KERNEL_DTYPE"]
    emit("agreement_a2", **agree_a2)
    gates = {"bf16": (0.005, 1e-3), "int8": (0.01, 5e-3)}
    if not (agree_a2["d_auc"] <= 1e-3 and agree_a2["rel_d_objective"] <= 1e-4 and all(
        agree_a2["rungs"][r]["d_auc"] <= auc_tol and agree_a2["rungs"][r]["rel_d_loss"] <= loss_tol
        for r, (auc_tol, loss_tol) in gates.items()
    )):
        raise AssertionError("the A2 solves disagree")

    # GAME: config D, config E at MovieLens-20M depth, config E's agreement
    d_rec = run_d(dev)
    emit("main_d", **d_rec)
    _check_game_launches("main_d", d_rec)
    if not d_rec["max_abs_diff_vs_train_glm"] <= 1e-4:
        raise AssertionError(f"config D differs from train_glm: {d_rec['max_abs_diff_vs_train_glm']}")
    e_rec, e_batch, e_data, e_model = run_e(dev)
    emit("main_e", **e_rec)
    _check_game_launches("main_e", e_rec)
    if not (d_rec["k1"]["ok"] and d_rec["k1"]["layout"] == "tiles"):
        raise AssertionError(f"K1 at D's shape: {d_rec['k1']}")
    if not (e_rec["quality_ok"] and e_rec["k1"]["ok"] and e_rec["k1"]["layout"] == "tiles"):
        raise AssertionError(f"config E: AUC {e_rec['train_auc']} against "
                             f"{e_rec['auc_generating_model']}; K1 ok {e_rec['k1']['ok']}")
    # main_e over 4 shards of the card, then over two processes of 2 shards each
    e_sharded, e_sharded_model = run_e_sharded(dev, e_batch, e_data, e_rec, e_model)
    emit("main_e_sharded", **e_sharded)
    failed = [name for name, ok in (
        ("k1_launches", e_sharded["k1_launches_ok"]),
        ("repeat_bitwise", e_sharded["repeat_bitwise"]),
        ("vs_main_e", e_sharded["d_auc_vs_main_e"] <= 0.005
         and e_sharded["rel_d_fixed_objective_vs_main_e"] <= 1e-3
         and e_sharded["random_effects_within_lane_tolerance"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_e_sharded failed: {failed}")
    del e_model
    e_multi = run_e_multihost(dev, e_rec, e_sharded_model, smi)
    emit("main_e_multihost", **e_multi)
    failed = [name for name, ok in (
        ("models_bitwise_equal_across_ranks", e_multi["models_bitwise_equal_across_ranks"]),
        ("bitwise_equal_to_main_e_sharded", all(e_multi["bitwise_equal_to_main_e_sharded"].values())),
        ("k1_launches", e_multi["k1_launches_ok"]),
        ("peak_below_main_e", e_multi["peak_below_main_e"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_e_multihost failed: {failed}")
    del e_sharded_model
    agree_e = agreement_e(dev)
    emit("agreement_e", **agree_e)
    _check_game_launches("agreement_e", agree_e["fused"])
    if any(agree_e["unfused"]["launches"].values()):
        raise AssertionError(f"the vetoed GAME run launched a kernel: {agree_e['unfused']['launches']}")
    if not (agree_e["d_auc"] <= 0.005 and agree_e["rel_d_log_loss"] <= 1e-3):
        raise AssertionError("the GAME runs with and without K1 disagree")

    # config E at MovieLens-20M depth with the random effects on L-BFGS,
    # on main_e's batch; then the lane solvers' agreement at bench depth
    e_lbfgs = run_e_lbfgs(dev, e_batch, e_data, e_rec)
    emit("main_e_lbfgs", **e_lbfgs)
    _check_game_launches("main_e_lbfgs", e_lbfgs)
    if not (e_lbfgs["quality_ok"] and e_lbfgs["d_auc_vs_newton"] <= 0.005
            and e_lbfgs["rel_d_log_loss_vs_newton"] <= 1e-3):
        raise AssertionError(f"config E on L-BFGS: AUC {e_lbfgs['train_auc']} (Newton "
                             f"{e_rec['train_auc']}, generating {e_lbfgs['auc_generating_model']}), "
                             f"relative d log-loss {e_lbfgs['rel_d_log_loss_vs_newton']}")
    # the same batch with the per-user subspace and the per-item random projection
    e_proj = run_e_projected(dev, e_batch, e_data, e_lbfgs)
    e_host, e_mem = e_streamed_reference(dev, e_batch, e_data)
    del e_batch, e_data
    torch.cuda.empty_cache()
    emit("main_e_projected", **e_proj)
    _check_game_launches("main_e_projected", e_proj)
    if not (e_proj["quality_ok"] and e_proj["random_projection_scores"]["ok"]):
        raise AssertionError(f"config E projected: AUC {e_proj['train_auc']} against "
                             f"{e_proj['auc_generating_model']}; scores {e_proj['random_projection_scores']}")
    # the same rows out of core, from host memory
    e_streamed, e_streamed_model = run_e_streamed(dev, e_host, e_mem, e_rec, smi)
    del e_host
    emit("main_e_streamed", **e_streamed)
    failed = [name for name, ok in (
        ("vs_in_memory", e_streamed["d_auc_vs_in_memory"] <= 0.005
         and e_streamed["rel_d_log_loss_vs_in_memory"] <= 1e-3),
        ("quality", e_streamed["quality_ok"]),
        ("k1_launches", e_streamed["launches_ok"] and e_streamed["k1_layout"] == "tiles"),
        ("second_fixed_visit_misses_offsets_only", e_streamed["second_fixed_visit_misses"] == e_streamed["chunks"]),
        ("k1_at_chunk", e_streamed["k1_at_chunk"]["ok"] and e_streamed["k1_at_chunk"]["layout"] == "tiles"),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_e_streamed failed: {failed}")
    # the same problem in two processes, each holding half of the rows
    e_streamed_multi = run_e_streamed_multihost(dev, e_streamed, e_streamed_model, smi)
    del e_streamed_model
    emit("main_e_streamed_multihost", **e_streamed_multi)
    failed = [name for name, ok in (
        ("models_bitwise_equal_across_ranks", e_streamed_multi["models_bitwise_equal_across_ranks"]),
        ("vs_main_e_streamed", e_streamed_multi["d_auc_vs_main_e_streamed"] <= 0.005
         and e_streamed_multi["rel_d_fixed_objective_vs_main_e_streamed"] <= 1e-3
         and e_streamed_multi["random_effects_within_lane_tolerance"]),
        ("k1_launches", e_streamed_multi["k1_launches_ok"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_e_streamed_multihost failed: {failed}")
    solvers = agreement_e_solvers(dev, agree_e["fused"])
    emit("agreement_e_solvers", **solvers)
    ev = solvers["lbfgs"]["evaluators"]
    failed = [name for name, ok in (
        ("lbfgs_vs_newton", solvers["lbfgs"]["d_auc_vs_newton"] <= 0.005
         and solvers["lbfgs"]["rel_d_log_loss_vs_newton"] <= 1e-3),
        ("tron_vs_newton", solvers["tron"]["d_auc_vs_newton"] <= 0.005
         and solvers["tron"]["rel_d_log_loss_vs_newton"] <= 1e-3),
        ("sparse_vs_dense", solvers["lbfgs_sparse"]["close_to_dense"]
         and solvers["lbfgs_sparse"]["d_auc_vs_dense"] <= 1e-4
         and solvers["lbfgs_sparse"]["rel_d_log_loss_vs_dense"] <= 1e-4),
        ("owlqn_quality", solvers["owlqn"]["quality_ok"]),
        ("lanes_vs_single", all(r["ok"] for v in SOLVER_VARIANTS
                                for r in solvers[v]["lanes_vs_single"].values())),
        ("evaluators", ev["d_multi_auc"] <= 1e-6 and ev["d_precision_at_5"] <= 1e-6
         and ev["d_bucketed_auc"] <= 1e-4),
    ) if not ok]
    if failed:
        raise AssertionError(f"agreement_e_solvers failed: {failed}")

    # main path GAME CLI: the train and score drivers on Avro part files,
    # every read on the native decoder; then the drivers with every option
    work = tempfile.mkdtemp(prefix="_game_cli-", dir=ROOT)
    try:
        data = game_cli_data(dev, work)
        native = native_read_parity(data)
        with recording_decoders() as decoders:
            cli = run_game_cli(dev, data)
        cli.update(native_read=native, decoders=decoders)
        with recording_decoders() as decoders:
            full = run_game_cli_full(dev, data, os.path.join(work, "glm", "best", "model.avro"))
        full["decoders"] = decoders
        # the out-of-core GLM driver on the same files
        glm_streamed = run_glm_streamed_cli(dev, data, smi)
        # the same command in two processes over gloo
        glm_multihost = run_glm_multihost_cli(dev, data, glm_streamed, smi)
        # the GAME drivers' --multihost in memory, in two processes
        game_multihost = run_game_multihost_cli(dev, data, cli, smi)
        # the out-of-core GAME driver on the same files, against the in-memory one
        game_streamed = run_game_cli_streamed(dev, data, smi)
        # the same driver across two processes, one training part each
        game_streamed_multi = run_game_cli_streamed_multihost(dev, data, smi)
        # the drivers again with run telemetry and the profiler on
        telemetry = run_telemetry(dev, data, cli, glm_streamed)
        del data
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("main_game_cli", **cli)
    _check_game_launches("main_game_cli", cli)
    best_auc = cli["validation_metrics"][cli["best_index"]]["AUC"]
    failed = [name for name, ok in (
        ("native_read", native["bitwise_equal"] and native["native_decoder"] == "native"
         and native["python_decoder"] == "python"),
        ("native_decoder_in_every_read", cli["decoders"] == ["native"] * 6),
        ("outputs", cli["outputs_ok"]),
        ("k1_tiles", cli["k1_layout"] == "tiles"),
        ("driver_vs_library", cli["max_abs_diff_driver_vs_library"] <= 1e-5
         and cli["best_index"] == cli["library_best_index"]),
        ("resume", cli["resumed_lines"] == 2 and cli["resume_ok"]),
        ("scores", cli["scores_rows"] == GAME_CLI["val"] and cli["scores_finite"]
         and cli["max_abs_diff_scores_file_vs_memory"] <= 1e-5 and cli["d_auc_score_vs_train"] <= 1e-6),
        ("glm_twin", cli["max_abs_diff_glm_twin_vs_train_glm"] <= 1e-5
         and cli["glm_launches"]["fused_value_grad"] > 0),
        ("quality", best_auc >= 0.9 * cli["auc_generating_model"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_game_cli failed: {failed}")
    emit("main_game_cli_full", **full)
    _check_game_launches("main_game_cli_full", full)
    failed = [name for name, ok in (
        ("native_decoder_in_every_read", full["decoders"] == ["native"] * 3),
        ("configurations", full["configurations"] == 2 + TUNING_ITERS
         and full["fixed_lambdas"] == full["library_fixed_lambdas"]),
        ("driver_vs_library", full["max_abs_diff_driver_vs_library"] <= 1e-5
         and full["best_index"] == full["library_best_index"]),
        ("diagnostics", full["diagnostics_written"]),
        ("glm_twin", full["glm_files_written"] and full["max_abs_diff_glm_twin_vs_train_glm"] <= 1e-5
         and full["glm_launches"]["fused_value_grad"] > 0),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_game_cli_full failed: {failed}")

    emit("main_game_multihost_cli", **game_multihost)
    failed = [name for name, ok in (
        ("best_index", game_multihost["best_index"] == game_multihost["one_process_best_index"]),
        ("vs_one_process", game_multihost["models_ok"]),
        ("only_process_0_wrote", game_multihost["only_process_0_wrote"]),
        ("rerun_resumed", game_multihost["resumed_lines"] == 2 and game_multihost["rerun_same_model"]
         and game_multihost["rerun_checkpoint_unchanged"]),
        ("scores", game_multihost["scores_ok"] and game_multihost["max_abs_diff_scores_vs_one_process"] <= 1e-5),
        ("metrics", game_multihost["max_abs_diff_metrics"] <= 1e-6),
        ("k1_launches", game_multihost["launches_ok"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_game_multihost_cli failed: {failed}")

    emit("main_game_cli_streamed", **game_streamed)
    failed = [name for name, ok in (
        ("native_decoder_in_every_read", game_streamed["decoders"] == ["native"] * 5),
        ("best_index", game_streamed["best_index"] == game_streamed["in_memory_best_index"]),
        ("vs_in_memory_driver", game_streamed["coefficients_ok"]
         and abs(game_streamed["best_primary"] - game_streamed["in_memory_best_auc"]) <= 1e-3),
        ("resume", game_streamed["resume_ok"]),
        ("scores", game_streamed["scores_rows"] == GAME_CLI["val"] and game_streamed["scores_finite"]
         and game_streamed["max_abs_diff_scores_file_vs_library"] <= 1e-5),
        ("k1_launches", game_streamed["launches_ok"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_game_cli_streamed failed: {failed}")
    gsm = game_streamed_multi
    emit("main_game_cli_streamed_multihost", **gsm)
    failed = [name for name, ok in (
        ("best_index", gsm["best_index"] == gsm["one_process_best_index"]
         and gsm["rerun_best_index"] == gsm["one_process_rerun_best_index"]),
        ("vs_one_process", gsm["models_ok"]),
        ("only_process_0_wrote", gsm["only_process_0_wrote"]),
        ("rerun_resumed", gsm["resumed_lines"] == 2 and gsm["resumed_from"] == [[[2, 0], [2, 0]]] * 2),
        ("rerun_bitwise_uninterrupted", gsm["rerun_bitwise_uninterrupted"]),
        ("k1_launches", gsm["launches_ok"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_game_cli_streamed_multihost failed: {failed}")
    fleet = gsm["fleet_telemetry"]
    telemetry.update(card=smi, fleet=fleet, fleet_wall_s=gsm["fresh_wall_s"])
    emit("main_telemetry", **telemetry)
    failed = [name for name, ok in (
        *((gate, telemetry[gate]) for gate in (
            "outputs_bitwise", "scores_bitwise", "glm_models_bitwise", "jsonl_valid", "span_tree", "re_solve",
            "hbm_available", "k1_in_profile", "k1_cost_bytes", "k2_cost_bytes", "stream_passes",
            "same_launches_as_off")),
        # the uninterrupted two-process run (telemetry on) equals the resumed one (off) bit for bit
        ("fleet_files", len(fleet["files"]) == 2 and fleet["files"][1].endswith(".p1.jsonl")
         and fleet["process_index"] == [0, 1] and len(set(fleet["run_ids"])) == 1
         and fleet["problems"] == [[], []] and all("game/fit" in sp for sp in fleet["spans"])),
        ("fleet_bitwise", gsm["rerun_bitwise_uninterrupted"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_telemetry failed: {failed}")

    # the out-of-core GLM path: the driver (above, on the GAME files), then
    # main_f, config B and config A2 streamed from host chunks
    emit("main_glm_streamed_cli", **glm_streamed)
    failed = [name for name, ok in (
        ("chunk_parity", glm_streamed["native_python_chunk_parity"]),
        ("vs_train_glm", glm_streamed["coefficients_ok"]
         and glm_streamed["best_weight"] == glm_streamed["library_best_weight"]),
        ("k1_launches", glm_streamed["launches_ok"]),
        ("rerun_from_checkpoints", glm_streamed["rerun_loaded_every_lambda"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_glm_streamed_cli failed: {failed}")
    emit("main_glm_multihost_cli", **glm_multihost)
    failed = [name for name, ok in (
        ("best_weight", glm_multihost["best_weight"] == glm_multihost["one_process_best_weight"]),
        ("vs_one_process", glm_multihost["coefficients_ok"]),
        ("only_process_0_wrote", glm_multihost["only_process_0_wrote"]),
        ("rerun_resumed", glm_multihost["rerun_resumed"]),
        ("k1_launches", glm_multihost["launches_ok"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_glm_multihost_cli failed: {failed}")
    f_rec = run_f(dev, smi)
    emit("main_f", **f_rec)
    vg = f_rec["value_and_grad_vs_in_memory"]
    failed = [name for name, ok in (
        ("arms_bitwise_equal", f_rec["arms_bitwise_equal"]),
        ("k1_launches", f_rec["k1_launches_ok"]),
        ("value_and_grad_vs_in_memory", vg["value_ok"] and vg["grad_ok"]),
        ("solve_vs_in_memory", f_rec["d_auc_vs_in_memory"] <= 0.005
         and f_rec["rel_d_objective_vs_in_memory"] <= 1e-3),
        ("k1_at_chunk", f_rec["k1_at_chunk"]["ok"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_f failed: {failed}")
    f_multi = run_f_multihost(dev, f_rec, smi)
    emit("main_f_multihost", **f_multi)
    failed = [name for name, ok in (
        ("coefficients_bitwise_equal", f_multi["coefficients_bitwise_equal"]),
        ("k1_launches", f_multi["k1_launches_ok"]),
        ("vs_main_f", f_multi["d_auc_vs_main_f"] <= 0.005 and f_multi["rel_d_objective_vs_main_f"] <= 1e-3),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_f_multihost failed: {failed}")
    torch.cuda.empty_cache()
    b_streamed = run_b_streamed(dev, b, smi)
    emit("main_b_streamed", **b_streamed)
    failed = [name for name, ok in (
        ("launches", b_streamed["launches_ok"]),
        ("k2_at_chunk", b_streamed["k2_at_chunk"]["ok"]),
        ("vs_main_b", b_streamed["rel_d_rmse_vs_main_b"] <= 1e-4
         and b_streamed["rel_d_objective_vs_main_b"] <= 1e-3),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_b_streamed failed: {failed}")
    a2_streamed = run_a2_streamed(dev, a2, smi)
    emit("main_a2_streamed", **a2_streamed)
    failed = [name for name, ok in (
        ("tiled", a2_streamed["tiled"]),
        ("k3_launches", a2_streamed["launches_ok"]),
        ("k3_at_chunk", all(r["ok"] for r in a2_streamed["k3_at_chunk"].values())),
        ("second_objective_no_misses", a2_streamed["second_objective_misses"] == 0),
        ("vs_main_a2", a2_streamed["d_auc_vs_main_a2"] <= 1e-3
         and a2_streamed["rel_d_objective_vs_main_a2"] <= 1e-4),
        ("variances", a2_streamed["variances_finite"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_a2_streamed failed: {failed}")
    streamed_paths = {"main_f": f_rec, "main_b_streamed": b_streamed, "main_a2_streamed": a2_streamed,
                      "main_glm_streamed_cli": glm_streamed, "main_e_streamed": e_streamed,
                      "main_game_cli_streamed": game_streamed}
    # out of core across processes
    parallel_streamed_paths = {"main_e_streamed_multihost": e_streamed_multi,
                               "main_game_cli_streamed_multihost": game_streamed_multi}
    # the drivers with run telemetry on
    telemetry_paths = {"main_telemetry": telemetry}
    # data parallel: row shards of the card, and two processes over gloo
    parallel_paths = {"main_a_sharded": a_sharded, "main_a2_sharded": a2_sharded,
                      "main_f_multihost": f_multi, "main_glm_multihost_cli": glm_multihost,
                      "main_e_sharded": e_sharded, "main_e_multihost": e_multi,
                      "main_game_multihost_cli": game_multihost}

    # launches over the main path: A, the sweep and B, then D, E, E on L-BFGS,
    # E projected and the GAME drivers (each path counted from 0 just before it ran)
    by_path = {
        k: {"main_a": a["launches"][k], "main_a_sweep": sweep["launches"][k],
            "main_b": b["launches"][k], "main_d": d_rec["launches"][k],
            "main_e": e_rec["launches"][k], "main_e_lbfgs": e_lbfgs["launches"][k],
            "main_e_projected": e_proj["launches"][k], "main_game_cli": cli["launches"][k],
            "main_game_cli_full": full["launches"][k],
            **{path: rec["launches"][k]
               for path, rec in {**streamed_paths, **parallel_paths, **parallel_streamed_paths,
                                 **telemetry_paths}.items()}}
        for k in KERNEL_ROWS
    }
    kernels = [
        dict(name=kernel, route="cuda", **KERNEL_ROWS[kernel], layout=rec["layout"],
             launches=sum(by_path[kernel].values()), launches_by_path=by_path[kernel],
             max_abs_err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
             bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=rec["library_ms"],
             device_ms=rec["device_ms"], enqueue_ms=rec["enqueue_ms"])
        for kernel, rec in rows.items()
    ]
    at_shape_keys = ("n", "d", "layout", "ms", "ms_rows", "ms_tiles", "device_ms", "enqueue_ms", "plain_ms",
                     "library_ms", "bound_ms", "bound_by", "hbm_share", "max_abs_err")
    for key, rec in (("at_main_e_shape", e_rec["k1"]), ("at_main_d_shape", d_rec["k1"]),
                     ("at_config_b_shape", k1_config_b),
                     ("at_b_streamed_chunk_shape", b_streamed["k1_at_chunk"]),
                     ("at_streamed_chunk_shape", f_rec["k1_at_chunk"]),
                     ("at_streamed_game_chunk_shape", e_streamed["k1_at_chunk"])):
        # a time the profiler did not read (None) is left out, not written as 0
        kernels[0][key] = {k: rec[k] for k in at_shape_keys if rec.get(k) is not None}
    k2_chunk = b_streamed["k2_at_chunk"]
    kernels[1]["at_streamed_chunk_shape"] = {k: k2_chunk[k] for k in at_shape_keys
                                             if k2_chunk.get(k) is not None}
    k3_paths = {**streamed_paths, **parallel_paths, **parallel_streamed_paths, **telemetry_paths}
    k3_kernels = [  # K3 at A2 on the f32 rung, one row per direction; launches over A2's paths and the rest
        dict(name=f"sparse_apply[{direction}]", route="cuda", **K3_ROW,
             launches=k3[direction] + sum(r["launches"][f"sparse_{direction}"] for r in k3_paths.values()),
             launches_by_path={"main_a2": k3[direction], **{path: r["launches"][f"sparse_{direction}"]
                                                           for path, r in k3_paths.items()}},
             max_abs_err=k3_err[direction], ms=rec["ms"], plain_ms=rec["plain_ms"],
             bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=rec["library_ms"],
             at_streamed_chunk_shape={k: a2_streamed["k3_at_chunk"][direction][k] for k in (
                 "nnz", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "hbm_share", "max_abs_err")})
        for direction, rec in k3_rows.items()
    ]
    # K4, the reference's per-group variant of the same function, runs as K3
    k4 = dict(k3_kernels[0], name="_tile_kernel (K4), closed by sparse_apply[matvec] (K3)",
              replaces=K4_REPLACES)
    kernels += k3_kernels + [k4]
    emit("smoke_wall", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:  # one process of a multi-process phase
        sys.exit(_child(sys.argv[2], int(sys.argv[3]), json.loads(sys.argv[4])))
    sys.exit(main())
