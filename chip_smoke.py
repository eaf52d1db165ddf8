#!/usr/bin/env python3
"""Drive the PyTorch port's dense and high-dimensional sparse GLM training
paths, its GAME mixed-effect training path (random effects on damped
Newton, on the default lane solvers, compacted and fused, and in per-entity
subspaces, capacity-class projections and random projections), its GAME train and score drivers on Avro files, read by
the native columnar decoder, its out-of-core GLM and GAME paths (host
data streamed through the card), and its data-parallel GLM and GAME
paths (shards of the card, and two processes over gloo and the framed
mesh, in memory and out of core, through a peer's loss) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the CUDA kernels from
``photon_ml_tpu_torch/csrc`` and prints one JSON line per phase:

1. device: the card's name and power limit;
2. build: the kernels compiled with nvcc for sm_90a (one nvcc per source,
   started together), with the spill lines of each source's report, and
   beside them the native library (the Avro decoder, the index store)
   with g++; then main_lint: ``photon-ml-tpu-torch lint`` over this
   checkout (exit 0 with its baseline, no finding; the suppressed and
   waived counts printed), the live knob snapshot's keys against the
   registry's, and each snapshot knob set to a valid non-default value,
   which must move ``devcost._knob_raw_state()`` and the snapshot (each
   variable restored after), with the phase's seconds beside the card's
   name and power limit;
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
12. main_e: config E's widths at MovieLens-10M depth (10,000,054 rows,
   69,878 users and 10,677 items with 8 features each, Zipf skew 1.5,
   generated on the card): fixed (L-BFGS 20 iterations, no
   regularization), per-user and per-item random effects (damped Newton
   20 iterations, L2 1, capacity ladder merged toward 8 buckets at 0.5
   padding) through ``GameEstimator.fit``, 2 warm-up outer iterations and
   4 timed ones; wall per outer iteration and per coordinate visit, the
   buckets and their Newton iterations, K1's launches against the fixed
   effect's objective passes, train AUC >= 0.95 x the generating model's;
   then K1 alone at that shape (10,000,054 x 65, float32, offsets read) as
   at D's; K1 must take its tiles layout at both shapes;
12a. main_serve: main_e's model published (``publish_game_model``) and
   served on the card: a parity set of 2,011 requests (rows of main_e's
   batch, 11 with out-of-range ids, a last partial window) through the
   micro-window server, bitwise ``GameModel.score`` on the rows each
   window scores and within rtol = atol = 1e-5 of it on the whole set;
   one user's refresh (L-BFGS and TRON) bitwise its offline solve;
   ``photon-ml-tpu-torch serve`` with the driver's defaults (10,000
   requests at 2,000 Hz offered, Zipf(1), the 25% hot budget, max batch
   32, max wait 2 ms) and its telemetry: the hot set's hits and misses
   equal to the reference's LRU rule replayed in numpy on the run's
   windows; the report's serving section and a gate of the run against
   itself; the same with ``--poll-every 2500`` while the refreshed model
   is published, swapped in with the scores after the swap the new
   snapshot's; and the reference bench's serving shape (S_serve_zipf:
   1,024 members, 64 items), whose hit rate must reach 0.8;
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
   bytes); then main_e_multihost_re_shard: main_e_multihost's layout with
   PHOTON_RE_SHARD=1 at E's bench depth (2^18 rows, to keep the smoke in
   its time; owned buckets: whole buckets placed over the two processes by
   their rows, each solved by its owner on its first shard's device, one
   host gather of the rows a visit): the ranks bitwise equal, train AUC
   >= 0.95 x the generating model's, K1 = 2 x passes in each; the wall per
   outer iteration and the combine's seconds and bytes a visit; and one
   per-user visit on identical offsets solved owned across the processes
   and without a mesh on the card, bit for bit; then main_e_multihost_re_split:
   the same layout and knob (2 processes x 2 local shards of the card, E at
   bench depth, 3 outer iterations, the first a warm-up) in one pair of
   children, arm after arm: the knob-off twin, PHOTON_RE_SPLIT=16, the same
   with PHOTON_RE_SPLIT_WEIGHT=bytes, PHOTON_RE_COMBINE=segments and
   PHOTON_RE_DEVICE_SPLIT=1 (each process's buckets over its two shards'
   entries of the card). Every arm's ranks bitwise equal; the segments and
   device-split arms bitwise the twin, the split arms within the lane
   tolerance of it (a split parent's lanes solve in batches of other lane
   counts, whose bits the card does not keep at E's sizes: re_skew's
   witness), whether bitwise recorded; the segments combine fewer bytes a
   process than the twin's dense combine; K1 = 2 x passes in each. Per arm
   the wall per outer iteration, the combine's bytes and seconds a
   process, the placement gauges (balance, atoms, split classes) and the
   device gauges (devices, device balance);
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
   log-loss) <= 1e-3; the lane solves' launches and executed and useful
   entity iterations (``re_solve.*``, read back once a visit);
14b. main_e_lbfgs_compact: main_e_lbfgs again with
   PHOTON_RE_COMPACT_EVERY=4 and PHOTON_RE_FUSE_BUCKETS=1: whether the
   model is bitwise main_e_lbfgs's, and (gates) within the lane tolerance
   with |dAUC| <= 1e-4 and relative d(training log-loss) <= 1e-4; both
   arms' lane launches, executed and useful entity iterations, read-backs
   a visit, wall per outer iteration and peak device bytes;
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
   rows: 10, the last 562,870 rows and padding; the fixed effect streamed
   through K1, the random effects' buckets gathered on the host into pinned
   memory every visit), against an in-memory ``GameEstimator`` fit of the
   same configuration on the same rows: |dAUC| <= 0.005 and relative
   d(training log-loss) <= 1e-3, train AUC >= 0.95 x the generating
   model's, K1's launches = 10 x the fixed effect's value-and-gradient
   passes on its tiles layout and nothing else launched, the second fixed
   visit missing the chunk cache once a chunk (its offsets; X stays
   resident); wall per outer iteration and per visit, each visit's cache
   hits and misses and bytes copied, each random-effect visit's host gather
   seconds, copy bytes and read-backs, peak device memory and host RSS, the
   card's busy share over a profiled second iteration, and K1 alone at the
   chunk's shape (2^20 x 65, float32, offsets read) against its plain
   version;
15d. main_e_streamed_multihost: config E at bench depth (2^18 rows, seed
   4; run at bench depth to keep the smoke in its time) in two processes
   of this script on the card (gloo over loopback), each drawing the rows
   from the seed on the card and keeping one contiguous half (2^17 rows)
   on its host: ``StreamedGameTrainer(multihost=True)``, each process
   streaming its chunk through K1 with every pass summed over the
   processes, each entity's rows exchanged to its owner (entity % 2) once
   and the offsets and scores every visit. The ranks' models bitwise
   equal; against a one-process streamed fit of the same rows and
   configuration |dAUC| <= 0.005, relative d(fixed objective) <= 1e-3 and
   the random effects within atol 2e-3 / rtol 1e-2; K1 = the process's
   chunks x the fixed effect's passes in each. It records the wall per
   outer iteration beside the one process's, per coordinate the ingest
   exchange's seconds and bytes, per visit the offset and score exchanges'
   seconds and bytes and the host gather seconds, and each process's peak
   device bytes and host RSS;
15e. main_e_streamed_multihost_re_shard: 15d with PHOTON_RE_SHARD=1, in
   the same pair of children after 15d's fit: the entities placed by their
   rows (LPT over the allreduced per-entity rows, the global capacity
   ladder), the offsets exchange issued before each random-effect visit's
   solve and joined by its first bucket gather, the scores exchange riding
   under the diagnostics gather, both on the exchange worker over the
   framed mesh (``multihost.exchange_rows_async``). The ranks' models
   bitwise equal; the random effects against
   15d's within rtol 5e-3 / atol 1e-3 (15d's owners bucket their entities
   on capacity ladders of their own rows, so lanes pad to other widths);
   against the one-process fit |dAUC| <= 0.005; K1 = the process's chunks
   x the fixed effect's passes in each; per random effect the trainer's
   plan (``trainer.placements``) the same on both ranks, its loads the
   global rows of the owners it chose. It records the wall per outer
   iteration beside 15d's and the one process's; per visit the offset and
   score exchanges' seconds, bytes and blocked seconds, the owner's gather
   seconds; the exchange timers and the overlap ratio; per random effect
   the plan's balance and loads beside the balance ``e % 2`` gives the
   same rows; peak device bytes;
15e'. main_e_streamed_multihost_re_split: 15e's trainer at E's bench depth
   in one pair of children, the knob-on
   twin and then PHOTON_RE_SPLIT=16 with PHOTON_RE_DEVICE_SPLIT=1 (the
   buckets over two entries of the card a process): the ranks bitwise
   equal, the split arm within 15e's tolerance of the twin (rtol 5e-3 /
   atol 1e-3; another owner map), K1 = chunks x passes; per arm the wall
   per outer iteration and the placement and device gauges;
15e''. main_faults: peer loss and recovery (``run_faults``), config E at
   bench depth in pairs of children on the card with CRC, 2 retries, a 3 s
   mesh timeout and a 2 s roll call (``FAULT_ENV``) and PHOTON_RE_SHARD=1:
   (1) the ring on a healthy group, a third arm of 15d / 15e's children
   (15e's fit with the fault knobs armed and no plan): bitwise 15e's, the
   ranks alike, no recovery counter, K1 = chunks x passes, each visit's
   exchange seconds and bytes on the mesh; its checkpoint after outer
   iteration 0 is the anchor; (2) the streamed peer kill: process 1
   killed at its first offsets send of iteration 1 (exit 137, the only
   death allowed); the survivor resumes at (1, 0) with ``fleet.peer_lost``,
   ``fleet.recoveries`` and ``p2p.giveups`` each 1, bitwise one process's
   fit over its rows resumed from the anchor (run here); (3) the in-memory
   descent (fixed effect whole on each process, random effects owned,
   ``PHOTON_RE_COMBINE=segments``, ``PHOTON_DESCENT_DEGRADE=1``) resumed
   for a second outer iteration with process 1 killed at its first
   owner-segment combine send: ``run`` returns on the survivor with
   ``fleet.degraded_descents`` 1, bitwise one process's descent resumed
   from the same anchor here; (4) elastic rejoin: (2)'s pair with
   PHOTON_REJOIN=1 and the op ``rejoin``, process 1 re-exec'd 1 s after
   its death as a rejoin boot on the card and admitted back at the first
   visit boundary after the degrade: both final models bitwise (1)'s armed
   pair (the uninterrupted run), ``fleet.rejoins`` 1 on both, K1 = chunks x
   passes on the rejoined process. The three pairs run at once, each with
   a time limit of its own; it prints the seconds from the kill to the
   roll call's end and on to the resumed visit (the re-run iteration's
   end), and for (4) the re-entry, the wait for the rejoiner and the
   rejoin roll call too;
15f. re_skew: bench.py's R_re_skew (1024 entities of 32 rows, d = 8, one
   in 16 ill-conditioned, 200 iterations at 1e-7) through
   ``train_random_effects`` on L-BFGS, OWL-QN and TRON over
   PHOTON_RE_COMPACT_EVERY in {0, 1, 4, 16} x PHOTON_RE_FUSE_BUCKETS in
   {0, 1} (L-BFGS also on the bucket cut into 4): every cell against the
   knob-off cell, whether bitwise and (gate) within the lane tolerance,
   with its lane launches, executed and useful entity iterations, host
   reads, peak device bytes and wall, beside the witness (the slow lanes
   solved knob off as a bucket of their own against the whole bucket's);
   then OWL-QN and TRON at agreement_e_solvers' depth with both knobs
   set, within the lane tolerance of that phase's fits (gate);
15g. main_e_streamed_compact: config E at bench depth (2^18 rows) out of
   core with L-BFGS random effects, knobs off and set: whether bitwise,
   within the lane tolerance (gate), lane launches and iterations,
   read-backs a random-effect visit;
15h. main_re_project: bench.py's projection recipe (Zipf rows, class-
   correlated column support, d = 32) at MovieLens-20M's 138,493 users,
   in memory, arms off (unset), off0 (PHOTON_RE_PROJECT=0), support and
   hash (PHOTON_RE_PROJECT_DIM=16), each cold and then warm with the MAP
   prior, and a streamed support arm on the same rows. Gates: off0 bitwise
   off, launches too; support's held-out AUC within 1e-4 of off's, cold
   and warm, with a class solving below 32 wide, and, solved until its
   lanes stop (25 iterations at 1e-9), within the lane tolerance of off
   with every column off its class support exactly 0; hash |dAUC| <=
   0.005 on a held-out draw; streamed support within the lane tolerance
   of the in-memory one. It prints the ``re_project.*`` gauges and each
   arm's solve wall;
16. main_game_cli: config E at its bench depth (64 global features, 8 per
   user and 8 per item, 20,000 users and 4,000 items, Zipf 1.5; 2^18
   training and 2^16 validation rows), generated on the card and written as
   Avro part files (two each) with the port's codec by four forked
   processes while agreement_e_solvers, re_skew, main_e_streamed_compact
   and main_re_project run (after main_faults); one training part read on the host
   by the native decoder and by the Python codec (its plain version), in a
   forked process beside the drivers, equal bit for bit, each with its ms
   a record; then the drivers
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
18e. main_tools: the tools and the run report through the umbrella
   ``photon-ml-tpu-torch`` (``cli.main.main``), once phases 16-18d have
   ended, so nothing runs beside them. ``name-term-bags`` and
   ``index-features`` over phase 16's training files (2^18 records, two
   parts; the native decoder), then phase 16's 2-iteration command with
   ``--index-maps``: its files equal to phase 16's record for record, none
   added, K1 once a fixed-effect pass and nothing else. A
   ``NativeIndexStore`` of every shard map: ``lookup_all`` over every key
   equal to the map's indices, an unknown key -1. ``report --json`` (and
   ``--export-trace``) over phase 18d's GAME run (phases ingest, train,
   descent) and over phase 18c's fleet run (game, ingest, descent): each
   summary's ``compile_s`` 0, as the kernels were built before these runs
   (the card test ``-k tools`` reads a run that builds them);
   ``--diff`` of the GAME and score runs, ``report validate``, ``report
   fleet`` naming processes 0 and 1; ``report gate`` writing a baseline,
   passing against it, and failing (exit 1) against a copy with ``wall_s``
   halved under a wall tier of rel 0.5, the same for ``--fleet``. Each
   command's exit code read from ``SystemExit`` against the one expected,
   its seconds, the tools' ms a record;
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
19a. main_stream_executor: every streamed consumer with
   ``PHOTON_STREAM_EXECUTOR`` off, then on, both caches emptied before
   each arm: (a) host L-BFGS (10 iterations, tolerance 0, lambda = 1)
   over main_f's first 4 chunks (2 GiB) with the value of a validation
   objective over a loader's own copies of those chunks (fresh host
   arrays, equal content) taken at every iteration: final coefficients
   and every validation value bitwise, the on arm's copied bytes below
   the off arm's (``stream.cache.miss_bytes`` against
   ``prefetch.cache.miss_bytes``), K1 on each chunk of every training
   pass, and the seconds of the content fingerprint's first sight of a
   fresh 512 MiB chunk; (b) A2 in main_a2_streamed's chunks, tiled for
   K3: the streamed objective's value, gradient, Hessian diagonal and
   scores, and the module scorer, bitwise, K3's launches by direction;
   (c) config E at bench depth out of core as main_e_streamed_compact
   runs it: the model and its scores bitwise, ``stream.re_gather.items``
   and the hit and miss bytes of ``re_scores``; (d)
   ``cross_validate_glm`` (k = 2, lambda = 1, L-BFGS 20 iterations) at
   config D's shape: the metric values and the refit bitwise; (e)
   main_serve's published model: 1,000 requests through the micro-window
   server while a second thread refreshes 16 users
   (``refresh_stream``): the scores and the refreshed rows bitwise, and
   ``stream.refresh.yields`` (timing-dependent, not gated);
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
   direction against its plain version at 1e-5;
22. main_a2_streamed_fe_shard: A2's shape with power-law columns
   (``sparse_problem`` kind "skewed") in 8 host chunks of 2^16 rows,
   ``train_glm_streamed`` (host L-BFGS 10 iterations at tolerance 0,
   lambda = 1, SIMPLE variances), then the module scorer, with the fixed
   effect's features split into ranges over processes
   (``PHOTON_FE_SHARD``): in this process the knob unset, "0" and "1" (one
   range; bitwise the unset arm), then 2 and 4 gloo children with the knob
   on (and 2 with ``PHOTON_FE_SPLIT_WEIGHT=width``). Per arm the plan's
   boundaries, the ``fe_shard.*`` gauges, the packed K3 bytes per process
   against one range's, seconds per evaluation, the phase-A reduction's
   seconds and float32 bytes per evaluation, K3 launches per process and
   direction against the count the evaluations give, peak device bytes;
   every rank bitwise the others, against the one-process arm |dAUC| <=
   0.005 and relative d(objective) <= 1e-4, the widths summing to d and
   the ranges' nonzeros to the data's, nnz balance <= 1.15 on the nnz
   arms; and K3 against its plain version on a chunk restricted to the
   4-range plan's second range, each direction at f32 rtol = atol = 1e-5.

Every check that fails raises, and the script exits non-zero with no
result; a child process that fails or outlives its time (then killed)
fails its phase. The kernels are built once, before any child starts.
Its last lines are the smoke's wall, the kernel table as one JSON object (K1's
``launches`` adds up its launches on the main paths A, the sweep, B, D, E,
E on L-BFGS, E projected, the GAME drivers, the seven out-of-core
phases (main_stream_executor's K3 launches too), the eight data-parallel ones, the five out-of-core ones across
processes, main_faults, main_telemetry and main_tools, which ``launches_by_path`` lists one by one; ``at_main_d_shape``
and ``at_main_e_shape`` give its times at GAME's widths,
``at_streamed_chunk_shape`` each kernel's at its streamed chunk and
``at_streamed_game_chunk_shape`` K1's at main_e_streamed's), the line
``nvidia-smi --query-gpu=name,power.limit`` prints, and
``{"ok": true, "device": {...}}``. It needs one card, and refuses to run
without CUDA or outside a checkout of the repository.
"""

from __future__ import annotations

import atexit
import contextlib
import hashlib
import io
import json
import multiprocessing
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass, replace

import numpy as np
import torch

from photon_ml_tpu_torch.cli import main as cli_main
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
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.checkpoint import peek_fingerprint
from photon_ml_tpu_torch.game.descent import CoordinateDescent
from photon_ml_tpu_torch.game.data import (
    DenseFeatures,
    EntityBuckets,
    SparseFeatures,
    bucket_entities,
    capacity_classes,
    group_by_entity,
    GameBatch,
    make_game_batch,
)
from photon_ml_tpu_torch.game.models import GameModel, RandomEffectModel
from photon_ml_tpu_torch.game import random_effect as game_random_effect
from photon_ml_tpu_torch.game.projector import RandomProjector, class_activity, projection_ladder
from photon_ml_tpu_torch.game.random_effect import train_random_effects
from photon_ml_tpu_torch.game.streaming import StreamedGameData, StreamedGameTrainer
from photon_ml_tpu_torch.hyperparameter.tuning import tune_game_hyperparameters
from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file
from photon_ml_tpu_torch.io.data_reader import AvroDataReader
from photon_ml_tpu_torch.io.model_io import load_game_model, load_glm, model_fingerprint, publish_game_model
from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_SCHEMA
from photon_ml_tpu_torch.native import NativeIndexStore
from photon_ml_tpu_torch.native import build as native_build
from photon_ml_tpu_torch.analysis import registry as lint_registry
from photon_ml_tpu_torch.analysis import runner as lint_runner
from photon_ml_tpu_torch.obs import REGISTRY, devcost
from photon_ml_tpu_torch.obs import sink as obs_sink
from photon_ml_tpu_torch.obs.report import fleet_run_paths, latest_run, load_run, validate_run
from photon_ml_tpu_torch.ops import _cuda, fused, prefetch, stream_executor, tile_cache
from photon_ml_tpu_torch.ops import sparse_tiled as st
from photon_ml_tpu_torch.ops.batch import DenseBatch, SparseBatch, hbm_budget_bytes, optimize_batch_layout
from photon_ml_tpu_torch.ops.glm import compute_variances, make_objective
from photon_ml_tpu_torch.ops.losses import LOSSES
from photon_ml_tpu_torch.data.index_map import plan_feature_ranges
from photon_ml_tpu_torch.ops import streaming
from photon_ml_tpu_torch.ops.streaming import StreamingGLMObjective, dense_chunks, sparse_chunks, stream_scores
from photon_ml_tpu_torch.optim import host_lbfgs_minimize, lbfgs_minimize, select_minimize_fn
from photon_ml_tpu_torch.parallel import DistributedTrainer, data_mesh, sharded_objective
from photon_ml_tpu_torch.parallel.distributed import reduction_stats
from photon_ml_tpu_torch.parallel.mesh import process_mesh
from photon_ml_tpu_torch.parallel import faults
from photon_ml_tpu_torch.parallel import multihost as mh
from photon_ml_tpu_torch.parallel.multihost import (
    allreduce_sum_host,
    collective_stats,
    initialize_multihost,
    reset_collective_stats,
    shutdown_multihost,
    sync_processes,
)
from photon_ml_tpu_torch.parallel.placement import plan_entity_placement, plan_from_owner
from photon_ml_tpu_torch.supervised.training import train_glm, train_glm_streamed
from photon_ml_tpu_torch.serve.refresh import entity_event_batch, refresh_entity, refresh_stream, solve_entity_offline
from photon_ml_tpu_torch.serve.router import MicroWindowServer, ScoreRequest
from photon_ml_tpu_torch.serve.store import HotModelStore
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
# effects at bench.py's depth and at MovieLens-10M's (GroupLens: 10,000,054
# ratings, 69,878 users, 10,677 movies), the E chain's depth since
# main_faults joined: at MovieLens-20M's (20,000,263 ratings, 138,493 users,
# 27,278 movies) the smoke passed its time limit on a slower machine
D_FIXED = 64
E_BENCH = (1 << 18, {"userId": (20_000, 8), "itemId": (4_000, 8)})
E_ML10M = (10_000_054, {"userId": (69_878, 8), "itemId": (10_677, 8)})


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line; ``at_s``: seconds since the script started,
    so the gaps between lines give each phase's share of the smoke."""
    print(json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - _START}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def run_lint(smi: str) -> dict:
    """main_lint: the port's static analysis over this checkout must exit
    0 with no finding; then, live on the card, the knob snapshot's keys
    must be the registry's (each snapshot knob's key and the declared
    constants), and each snapshot knob set to its registered non-default
    value must move both ``devcost._knob_raw_state()`` and its snapshot
    key (the variable restored after)."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(root, "photon_ml_tpu_torch", "__init__.py")):
        raise AssertionError(f"main_lint: {root} holds no photon_ml_tpu_torch/ to lint")
    doc = lint_runner.lint(root)
    if doc["baseline"] != "lint_baseline_torch.json":
        raise AssertionError(f"main_lint: {root} holds no lint_baseline_torch.json")
    if doc["exit"] != 0 or doc["findings"]:
        raise AssertionError("main_lint: photon-ml-tpu-torch lint found "
                             + "; ".join(f"{f['file']}:{f['line']} [{f['code']}] {f['scope']}"
                                         for f in doc["findings"][:20]))
    base = obs_sink._knob_snapshot()
    if set(base) != lint_registry.sink_keys():
        raise AssertionError(f"main_lint: snapshot keys {sorted(set(base) ^ lint_registry.sink_keys())} differ "
                             "from the registry's")
    stuck = []
    for k in lint_registry.KNOBS:
        if k.sink_key is None:
            continue
        old = os.environ.get(k.name)
        raw = devcost._knob_raw_state()
        os.environ[k.name] = k.alt
        try:
            if devcost._knob_raw_state() == raw or obs_sink._knob_snapshot().get(k.sink_key) == base[k.sink_key]:
                stuck.append(k.name)
        finally:
            if old is None:
                del os.environ[k.name]
            else:
                os.environ[k.name] = old
    if stuck:
        raise AssertionError(f"main_lint: setting {stuck} did not move both the devcost fingerprint and the snapshot")
    if obs_sink._knob_snapshot() != base:
        raise AssertionError("main_lint: the snapshot did not come back with the variables restored")
    return dict(findings=len(doc["findings"]), suppressed=doc["suppressed"], waived=doc["waived"],
                passes=doc["passes"], baseline=doc["baseline"], snapshot_keys=len(base),
                knobs_moved=sum(1 for k in lint_registry.KNOBS if k.sink_key), seconds=time.perf_counter() - t0,
                device=smi)


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
    (``collective_s``), the score row gathers (``score_exchange_*``) and the
    owned-bucket combines (``combine_*``)."""
    return dict(reduction_s=reduction_stats["seconds"], collective_s=collective_stats["seconds"],
                score_exchange_s=game_coordinate.score_exchange_stats["seconds"],
                score_exchange_bytes=game_coordinate.score_exchange_stats["bytes"],
                combine_s=game_random_effect.combine_stats["seconds"],
                combine_bytes=game_random_effect.combine_stats["bytes"])


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
    """Config E's widths at MovieLens-10M depth: 6 outer iterations in one
    fit, the first 2 a warm-up and the last 4 timed. Returns the record,
    the generated batch and data (``run_e_lbfgs`` reuses them) and the
    model (``run_e_sharded`` is held to it)."""
    n, effects = E_ML10M
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


def fit_lane_counted(batch, config: GameTrainingConfig, dev) -> dict:
    """``fit_game`` with the random-effect lane solves' counters
    (``re_solve.*``: launches, executed and useful entity iterations)
    zeroed just before and read just after, the lane iterations read back
    once a visit (``PHOTON_RE_ITER_ACCOUNTING=1``; the compacted schedule
    reads them between its chunks anyway), and the peak device bytes."""
    game_random_effect.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with environment({"PHOTON_RE_ITER_ACCOUNTING": "1"}):
        fit = fit_game(batch, config, dev)
    fit["re_solve"] = dict(game_random_effect.launch_counts)
    fit["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    return fit


def run_e_lbfgs(dev, batch, data, newton: dict) -> tuple[dict, GameModel]:
    """``main_e``'s path (the same batch and schedule) with the random
    effects on L-BFGS, the default solver type, at the fixed effect's
    ``OptimizerConfig`` (20 iterations, tolerance 1e-7) with L2 1; held to
    ``main_e``'s Newton fit (``newton``), which solves the same L2
    problems. Returns the record and the model (``run_e_lbfgs_compact``
    holds its knob-on fit to it)."""
    n, effects = E_ML10M
    fit = fit_lane_counted(batch, game_config(effects, 6, re_solver="LBFGS"), dev)
    rec = dict(_game_record(fit, warmup=2), n=n, effects={k: list(v) for k, v in effects.items()},
               buckets=bucket_report(fit, batch, effects, solver="lbfgs"),
               **game_quality(fit, batch, data), re_solve=fit["re_solve"],
               max_memory_allocated_bytes=fit["peak_device_bytes"])
    rec.update(
        newton_train_auc=newton["train_auc"], newton_train_log_loss=newton["train_log_loss"],
        d_auc_vs_newton=abs(rec["train_auc"] - newton["train_auc"]),
        rel_d_log_loss_vs_newton=abs(rec["train_log_loss"] - newton["train_log_loss"])
        / newton["train_log_loss"],
        newton_timed_wall_s_per_outer_iteration=newton["timed_wall_s_per_outer_iteration"],
    )
    model = fit["best"].model
    del fit
    torch.cuda.empty_cache()
    rec["profile"] = profile_e(batch, effects, dev, re_solver="LBFGS")
    return rec, model


# the random-effect schedule knobs' arm: chunks of 4 iterations, same-geometry buckets fused
SCHEDULE_KNOBS = {"PHOTON_RE_COMPACT_EVERY": "4", "PHOTON_RE_FUSE_BUCKETS": "1"}


LANE_TOL = dict(rtol=1e-2, atol=2e-3)  # the lane solvers' pinned tolerance (ROADMAP queue 3)


def models_agree(a: GameModel, b: GameModel) -> dict:
    """Two models of the same configuration: bitwise, the largest
    coefficient difference, and within the lane tolerance."""
    pairs = [(sub.coefficient_means, b.models[cid].coefficient_means) for cid, sub in a.models.items()]
    return dict(bitwise=a.models.keys() == b.models.keys() and all(torch.equal(x, y) for x, y in pairs),
                max_abs_diff=max(float((x - y).abs().max()) for x, y in pairs),
                within_lane_tolerance=all(bool(torch.allclose(x, y, **LANE_TOL)) for x, y in pairs))


def lane_counters(re_solve: dict, visits: int) -> dict:
    """The lane solves' launches and entity iterations, and their
    useful / executed share, over a fit and a random-effect visit."""
    ex, us = re_solve["executed_entity_iterations"], re_solve["useful_entity_iterations"]
    return dict(lane_launches=re_solve["launches"], executed_entity_iterations=ex, useful_entity_iterations=us,
                useful_share=us / ex if ex else None, lane_launches_per_visit=re_solve["launches"] / visits,
                executed_per_visit=ex / visits)


def run_e_lbfgs_compact(dev, batch, data, lbfgs: dict, lbfgs_model: GameModel) -> dict:
    """main_e_lbfgs_compact: main_e_lbfgs's batch and schedule with
    ``SCHEDULE_KNOBS`` (lane compaction every 4 iterations, launch
    fusion), against main_e_lbfgs's knob-off fit of the same run: whether
    the models are bitwise, their largest difference, and (gates) the
    coefficients within the lane tolerance, |dAUC| <= 1e-4 and relative
    d(training log-loss) <= 1e-4 (a front of other lane counts takes other
    cuBLAS and reduction kernels on the card, so its lanes' bits move:
    re_skew's witness); the lane solves' launches, executed and useful
    entity iterations and read-backs a visit of either arm, wall per outer
    iteration and peak device bytes."""
    n, effects = E_ML10M
    config = game_config(effects, 6, re_solver="LBFGS")
    with environment(SCHEDULE_KNOBS):
        fit = fit_lane_counted(batch, config, dev)
    re_visits = 6 * len(effects)
    on = dict(_game_record(fit, warmup=2), knobs=SCHEDULE_KNOBS, peak_device_bytes=fit["peak_device_bytes"],
              **lane_counters(fit["re_solve"], re_visits))
    off = dict(timed_wall_s_per_outer_iteration=lbfgs["timed_wall_s_per_outer_iteration"],
               timed_readbacks_per_visit=lbfgs["timed_readbacks_per_visit"],
               peak_device_bytes=lbfgs["max_memory_allocated_bytes"], **lane_counters(lbfgs["re_solve"], re_visits))
    on.update(game_quality(fit, batch, data))
    agree = models_agree(fit["best"].model, lbfgs_model)
    return dict(n=n, effects={k: list(v) for k, v in effects.items()}, on=on, off=off, launches=fit["launches"],
                fixed_objective_passes=fit["fixed_objective_passes"], models=agree,
                d_auc_vs_off=abs(on["train_auc"] - lbfgs["train_auc"]),
                rel_d_log_loss_vs_off=abs(on["train_log_loss"] - lbfgs["train_log_loss"]) / lbfgs["train_log_loss"],
                executed_drop=1.0 - on["executed_entity_iterations"] / off["executed_entity_iterations"])


RE_SKEW = (1024, 32, 8)  # bench.py R_re_skew: entities, rows each, features
RE_SKEW_CELLS = [(c, f) for c in ("0", "1", "4", "16") for f in ("0", "1")]
RE_SKEW_SOLVERS = {"lbfgs": ("LBFGS", 0.0), "owlqn": ("LBFGS", 0.05), "tron": ("TRON", 0.0)}


def re_skew_problem(dev):
    """bench.py's R_re_skew on the card: E entities of C rows, d features,
    every 16th entity's features scaled 1-60 (several times the others'
    iterations), logistic labels; one bucket of E lanes."""
    E, C, d = RE_SKEW
    rng = np.random.default_rng(7)
    ids = np.repeat(np.arange(E), C).astype(np.int64)
    n = E * C
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[np.isin(ids, np.arange(0, E, 16))] *= np.geomspace(1.0, 60.0, d).astype(np.float32)
    W_true = (rng.normal(size=(E, d)) * 0.5).astype(np.float32)
    margin = np.clip(np.sum(W_true[ids] * X, axis=1), -60.0, 60.0)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    w0 = (np.random.default_rng(2).normal(size=(E, d)) * 1e-3).astype(np.float32)
    return dict(features=DenseFeatures(X=torch.from_numpy(X).to(dev)), labels=y,
                offsets=np.zeros(n, np.float32), weights=np.ones(n, np.float32),
                buckets=bucket_entities(group_by_entity(ids, num_entities=E)), num_entities=E,
                loss=LOSSES["logistic"], l2_weight=1.0, initial_coefficients=torch.from_numpy(w0).to(dev),
                device=dev)


def split_buckets(buckets: EntityBuckets, parts: int) -> EntityBuckets:
    """Each bucket cut into ``parts`` buckets of the same capacity (fusion's
    target: same-geometry buckets)."""
    ent, rows, caps = [], [], []
    for e, r, c in zip(buckets.entity_ids, buckets.row_indices, buckets.capacities):
        for part in np.array_split(np.arange(len(e)), parts):
            ent.append(e[part])
            rows.append(r[part])
            caps.append(c)
    return EntityBuckets(capacities=tuple(caps), entity_ids=ent, row_indices=rows)


def run_re_skew(dev) -> dict:
    """re_skew: bench.py's R_re_skew (E = 1024, C = 32, d = 8, one entity
    in 16 ill-conditioned, 200 iterations at tolerance 1e-7) through
    ``train_random_effects`` on L-BFGS, OWL-QN (l1 0.05) and TRON, each
    over ``PHOTON_RE_COMPACT_EVERY`` in {0, 1, 4, 16} x
    ``PHOTON_RE_FUSE_BUCKETS`` in {0, 1}: every cell's coefficients,
    variances, final objectives and iterations bitwise the (0, 0) cell's
    (gate); per cell the lane launches, executed and useful entity
    iterations, the host reads of the card, the peak device bytes and the
    wall (after one warm-up solve a solver). The natural bucketing gives
    one bucket, so fusion has nothing to fuse there; the L-BFGS sweep also
    runs on the bucket cut into 4 of the same capacity (``split4_*``),
    where fusion takes 4 launches to 1. Each cell is held to the (0, 0)
    cell: whether bitwise, the largest coefficient difference, and (gate)
    within the lane tolerance. The witness: the slow entities' lanes (the
    front compaction keeps longest) solved knob off as a bucket of their
    own, against the same lanes of the whole bucket: the difference a
    lane's batch alone makes on this card, with no knob set."""
    prob = re_skew_problem(dev)
    out = {}
    for name, (solver, l1) in RE_SKEW_SOLVERS.items():
        config = OptimizerConfig(optimizer_type=OptimizerType(solver), max_iterations=200, tolerance=1e-7)
        train_random_effects(config=config, l1_weight=l1, variance_computation=VarianceComputationType.SIMPLE,
                             **prob)  # warm-up
        cells, ref = {}, None
        grid = [("", ce, fuse) for ce, fuse in RE_SKEW_CELLS]
        if name == "lbfgs":
            grid += [("split4_", ce, fuse) for ce, fuse in (("0", "0"), ("0", "1"), ("4", "1"))]
        for variant, ce, fuse in grid:
            buckets = split_buckets(prob["buckets"], 4) if variant else prob["buckets"]
            game_random_effect.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            with environment({"PHOTON_RE_COMPACT_EVERY": ce, "PHOTON_RE_FUSE_BUCKETS": fuse,
                              "PHOTON_RE_ITER_ACCOUNTING": "1"}), counting_readbacks() as reads:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = train_random_effects(config=config, l1_weight=l1,
                                           variance_computation=VarianceComputationType.SIMPLE,
                                           **dict(prob, buckets=buckets))
                got = (res.coefficients, res.variances, torch.as_tensor(res.loss_values),
                       torch.as_tensor(res.iterations))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if ref is None:
                ref = got
            cells[f"{variant}compact_{ce}_fuse_{fuse}"] = dict(
                wall_s=wall, readbacks=reads[0], bitwise=all(torch.equal(a, b) for a, b in zip(got, ref)),
                max_abs_diff=float((got[0] - ref[0]).abs().max()),
                within_lane_tolerance=bool(torch.allclose(got[0], ref[0], **LANE_TOL)),
                lanes_other_iterations=int((got[3] != ref[3]).sum()),
                peak_device_bytes=torch.cuda.max_memory_allocated(dev),
                **lane_counters(dict(game_random_effect.launch_counts), 1))
        # the witness: the slow lanes as a bucket of their own, knob off
        b = prob["buckets"]
        slow = np.flatnonzero(np.isin(b.entity_ids[0], np.arange(0, RE_SKEW[0], 16)))
        own = EntityBuckets(capacities=b.capacities[:1], entity_ids=[b.entity_ids[0][slow]],
                            row_indices=[b.row_indices[0][slow]])
        with environment({"PHOTON_RE_COMPACT_EVERY": "0", "PHOTON_RE_FUSE_BUCKETS": "0"}):
            alone = train_random_effects(config=config, l1_weight=l1,
                                         variance_computation=VarianceComputationType.SIMPLE,
                                         **dict(prob, buckets=own)).coefficients
        ids = torch.as_tensor(b.entity_ids[0][slow], device=dev)
        out[name] = dict(cells=cells, iterations_max=int(ref[3].max()), iterations_median=float(ref[3].median()),
                         bitwise=all(c["bitwise"] for c in cells.values()),
                         within_lane_tolerance=all(c["within_lane_tolerance"] for c in cells.values()),
                         witness=dict(lanes=len(slow), bitwise=bool(torch.equal(alone[ids], ref[0][ids])),
                                      max_abs_diff=float((alone[ids] - ref[0][ids]).abs().max())))
    return dict(entities=RE_SKEW[0], rows_each=RE_SKEW[1], d=RE_SKEW[2], max_iterations=200, tolerance=1e-7,
                **out, bitwise=all(out[k]["bitwise"] for k in out),
                within_lane_tolerance=all(out[k]["within_lane_tolerance"] for k in out))


def run_e_solvers_compact(dev, models: dict) -> dict:
    """OWL-QN and TRON with ``SCHEDULE_KNOBS`` at agreement_e_solvers'
    depth and schedule, against that phase's knob-off fits (``models``):
    whether bitwise, the largest difference and (gate) the lane
    tolerance, with the lane counters and wall of each."""
    n, effects = E_BENCH
    batch, _ = game_problem(dev, n, effects, seed=4)
    out = {}
    for name in ("owlqn", "tron"):
        solver, reg, _ = SOLVER_VARIANTS[name]
        with environment(SCHEDULE_KNOBS):
            fit = fit_lane_counted(batch, game_config(effects, 4, re_solver=solver, re_regularization=reg), dev)
        out[name] = dict(_game_record(fit), models=models_agree(fit["best"].model, models[name]),
                         **lane_counters(fit["re_solve"], 4 * len(effects)))
    return out


E_STREAMED_COMPACT = E_BENCH  # bench depth: 2^18 rows, one chunk


def run_e_streamed_compact(dev) -> dict:
    """main_e_streamed_compact: config E at bench depth (2^18 rows, seed 4)
    out of core with the random effects on L-BFGS, 2 outer iterations,
    knob off and with ``SCHEDULE_KNOBS``: whether the models are bitwise,
    their largest difference and (gate) the lane tolerance; per arm the
    lane launches and entity iterations, the random-effect visits'
    read-backs, wall per outer iteration and K1's launches."""
    n, effects = E_STREAMED_COMPACT
    batch, _ = game_problem(dev, n, effects, seed=4)
    host = streamed_game_data(batch)
    del batch
    config = game_config(effects, 2, re_solver="LBFGS")
    arms = {}
    for arm, knobs in (("off", {}), ("on", SCHEDULE_KNOBS)):
        with environment(knobs):
            fit = fit_streamed(host, config, dev)
        re_visits = [v for v in fit["visits"] if v["coordinate"] != "fixed"]
        arms[arm] = dict(fit=fit, rec=dict(
            wall_s=fit["wall_s"], iteration_wall_s=fit["iteration_wall_s"], launches=fit["launches"],
            fixed_objective_passes=fit["fixed_objective_passes"],
            readbacks_per_re_visit=sum(v["readbacks"] for v in re_visits) / len(re_visits),
            **lane_counters(fit["re_launches"], len(re_visits))))
    prefetch.clear_cache()
    on, off = arms["on"], arms["off"]
    return dict(n=n, effects={k: list(v) for k, v in effects.items()}, knobs=SCHEDULE_KNOBS,
                off=off["rec"], on=on["rec"], models=models_agree(on["fit"]["model"], off["fit"]["model"]),
                launches=on["fit"]["launches"],
                launches_ok=all(a["fit"]["launches"]["fused_value_grad"] == a["fit"]["fixed_objective_passes"] > 0
                                for a in arms.values()))


RE_PROJECT_D, RE_PROJECT_DIM = 32, 16  # bench.py's projection recipe (MULTICHIP_R11_D, _DIM)
RE_PROJECT_E = 138_493  # MovieLens-20M's users


def re_project_dataset(E: int) -> dict:
    """bench.py's projection recipe (``_multichip_r11_dataset``): Zipf row
    counts (E / (1 + i))^0.9, at least 6 an entity; each row activates 3
    signal columns and 2 weak noise columns among its entity's first
    ncols(e) columns, ncols growing with the entity's rows (so the
    capacity class follows the support width); signal on one column per
    distinct hash slot of the d = 32 -> 16 fold; a held-out twin draw."""
    from photon_ml_tpu_torch.game.projector import _hash_fold

    rng = np.random.default_rng(1111)
    sizes = np.maximum(np.maximum(((E / (1.0 + np.arange(E))) ** 0.9).astype(np.int64), 1), 6)
    d = RE_PROJECT_D
    ncols = np.minimum(d, 3 + (np.ceil(np.log2(sizes + 1.0)) * 3).astype(np.int64))
    ids = np.repeat(np.arange(E), sizes).astype(np.int64)
    ids = ids[rng.permutation(len(ids))]
    n = len(ids)
    slots, _ = _hash_fold(np.arange(d, dtype=np.int64), RE_PROJECT_DIM, None)
    sig_cols = np.asarray([j for j in range(d) if slots[j] not in slots[:j]], np.int64)  # a slot's first column
    noise_cols = np.setdiff1d(np.arange(d), sig_cols)
    n_sig, n_noi = np.searchsorted(sig_cols, ncols), np.searchsorted(noise_cols, ncols)
    W_true = np.zeros((E, d), np.float32)
    W_true[:, sig_cols] = (rng.normal(size=(E, len(sig_cols)))
                           / np.sqrt(1.0 + np.arange(len(sig_cols)))[None, :]).astype(np.float32)

    def draw():
        X = np.zeros((n, d), np.float32)
        for _ in range(3):
            c = sig_cols[rng.integers(0, 1 << 30, size=n) % n_sig[ids]]
            X[np.arange(n), c] = rng.normal(size=n).astype(np.float32)
        for _ in range(2):
            c = noise_cols[rng.integers(0, 1 << 30, size=n) % n_noi[ids]]
            X[np.arange(n), c] = (0.2 * rng.normal(size=n)).astype(np.float32)
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-2.0 * np.sum(W_true[ids] * X, axis=1)))).astype(np.float32)
        return X, y

    X, y = draw()
    X_eval, y_eval = draw()
    return dict(E=E, n=n, ids=ids, X=X, y=y, X_eval=X_eval, y_eval=y_eval)


def run_re_project(dev) -> dict:
    """main_re_project: bench.py's projection recipe at MovieLens-20M's
    138,493 users (one random effect, d = 32, L-BFGS 4 iterations at 1e-8,
    L2 1, SIMPLE variances) in memory, arms ``off`` (the knob unset),
    ``off0`` (``PHOTON_RE_PROJECT=0``), ``support`` and ``hash``
    (``PHOTON_RE_PROJECT_DIM=16``), each cold and then warm with the MAP
    prior at the cold solution; then a streamed ``support`` arm on the same
    rows (one outer iteration, against the in-memory support solve), and
    support against off solved to the reference test's stopping rule (25
    iterations at 1e-9). Gates: off0 bitwise off, launches too; support's
    held-out AUC within 1e-4 of off's, cold and warm, with at least one
    class solving below 32 wide (at 4 iterations the lanes are far from
    their optimum, where a narrower solve's other summation order moves a
    line search; its largest difference is printed); support solved until
    its lanes stop within the lane tolerance of off (the float32 stopping
    floors of ROADMAP queue 3 leave lanes up to about 3e-3 apart), with
    every column off its class support exactly 0; hash |dAUC| <=
    0.005 against off on the held-out draw; streamed support within the
    lane tolerance of the in-memory one. Prints each arm's ``re_project.*``
    gauges, launches, solve walls and largest differences from off."""
    data = re_project_dataset(RE_PROJECT_E)
    E, n, ids = data["E"], data["n"], data["ids"]
    feats = DenseFeatures(X=torch.from_numpy(data["X"]).to(dev))
    common = dict(features=feats, labels=data["y"], offsets=np.zeros(n, np.float32),
                  weights=np.ones(n, np.float32), buckets=bucket_entities(group_by_entity(ids, num_entities=E)),
                  num_entities=E, loss=LOSSES["logistic"], config=OptimizerConfig(max_iterations=4, tolerance=1e-8),
                  l2_weight=1.0, variance_computation=VarianceComputationType.SIMPLE, device=dev)
    X_eval = torch.from_numpy(data["X_eval"]).to(dev)
    y_eval = torch.from_numpy(data["y_eval"]).to(dev)
    ids_t = torch.from_numpy(ids).to(dev)

    def held_out_auc(W):
        return float(auc_roc(torch.einsum("nd,nd->n", X_eval, W[ids_t]), y_eval))

    train_random_effects(**common)  # warm-up
    arms, models = {}, {}
    for arm, env in (("off", {}), ("off0", {"PHOTON_RE_PROJECT": "0"}), ("support", {"PHOTON_RE_PROJECT": "support"}),
                     ("hash", {"PHOTON_RE_PROJECT": "hash", "PHOTON_RE_PROJECT_DIM": str(RE_PROJECT_DIM)})):
        REGISTRY.reset("re_project.")
        game_random_effect.reset_launch_counts()
        saved = os.environ.pop("PHOTON_RE_PROJECT", None)
        try:
            with environment(env):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cold = train_random_effects(**common)
                W, V = cold.coefficients, cold.variances
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                warm = train_random_effects(initial_coefficients=W, prior_coefficients=W, prior_variances=V, **common)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
        finally:
            if saved is not None:
                os.environ["PHOTON_RE_PROJECT"] = saved
        models[arm] = (W, V, warm.coefficients, warm.variances)
        arms[arm] = dict(cold_wall_s=t1 - t0, warm_wall_s=t2 - t1,
                         launches=game_random_effect.launch_counts["launches"],
                         gauges=REGISTRY.snapshot("re_project.")["gauges"], held_out_auc=held_out_auc(W),
                         warm_held_out_auc=held_out_auc(warm.coefficients),
                         finite=bool(torch.isfinite(W).all() and torch.isfinite(warm.coefficients).all()))
    off, sup, hsh = models["off"], models["support"], models["hash"]
    gates = dict(
        off0_bitwise=all(torch.equal(a, b) for a, b in zip(models["off0"], off))
        and arms["off0"]["launches"] == arms["off"]["launches"],
        support_auc=all(abs(arms["support"][k] - arms["off"][k]) <= 1e-4
                        for k in ("held_out_auc", "warm_held_out_auc")),
        support_narrower=arms["support"]["gauges"].get("re_project.mean_ratio", 1.0) < 1.0,
        hash_auc=abs(arms["hash"]["held_out_auc"] - arms["off"]["held_out_auc"]) <= 0.005,
        finite=all(a["finite"] for a in arms.values()),
    )
    rec = dict(entities=E, rows=n, d=RE_PROJECT_D, hash_dim=RE_PROJECT_DIM, arms=arms,
               support_max_abs_diff=float((sup[0] - off[0]).abs().max()),
               support_warm_max_abs_diff=float((sup[2] - off[2]).abs().max()),
               support_within_lane_tolerance=all(bool(torch.allclose(a, b, **LANE_TOL))
                                                 for a, b in zip(sup[::2], off[::2])),
               hash_max_abs_diff=float((hsh[0] - off[0]).abs().max()))
    # support against off at the reference test's stopping rule
    converged = dict(common, config=OptimizerConfig(max_iterations=25, tolerance=1e-9))
    with environment({"PHOTON_RE_PROJECT": "support"}):
        W_sup = train_random_effects(**converged).coefficients
    saved = os.environ.pop("PHOTON_RE_PROJECT", None)
    try:
        W_off = train_random_effects(**converged).coefficients
    finally:
        if saved is not None:
            os.environ["PHOTON_RE_PROJECT"] = saved
    buckets = common["buckets"]
    classes, activity = class_activity(feats.X, buckets.capacities, buckets.row_indices)
    ladder = projection_ladder(classes, activity, RE_PROJECT_D, "support", RE_PROJECT_DIM, None)
    off_support = []
    for cap, ent in zip(buckets.capacities, buckets.entity_ids):
        spec = ladder[int(cap)]
        if spec is not None:
            outside = np.setdiff1d(np.arange(RE_PROJECT_D), spec.columns)
            off_support.append(W_sup[torch.as_tensor(ent, device=dev)][:, torch.as_tensor(outside, device=dev)])
    rec["converged"] = dict(max_iterations=25, tolerance=1e-9, support_max_abs_diff=float((W_sup - W_off).abs().max()),
                            zeros_off_support=int(sum(int((t == 0).sum()) for t in off_support)),
                            entries_off_support=int(sum(t.numel() for t in off_support)))
    gates["support_converged_close"] = bool(torch.allclose(W_sup, W_off, **LANE_TOL))
    gates["support_zero_off_support"] = (rec["converged"]["zeros_off_support"]
                                         == rec["converged"]["entries_off_support"] > 0)
    del feats, common, converged, W_sup, W_off
    torch.cuda.empty_cache()
    # the same rows out of core, support arm, one random effect and no fixed effect
    opt = OptimizationConfig(optimizer=OptimizerConfig(max_iterations=4, tolerance=1e-8),
                             regularization=RegularizationContext(RegularizationType.L2), regularization_weight=1.0)
    config = GameTrainingConfig(
        task_type=TaskType.LOGISTIC_REGRESSION, coordinate_update_sequence=("per_user",),
        coordinate_descent_iterations=1, fixed_effect_coordinates={},
        random_effect_coordinates={"per_user": RandomEffectCoordinateConfig("userId", "user", opt)},
        variance_computation=VarianceComputationType.SIMPLE)
    host = StreamedGameData(labels=data["y"], features={"user": data["X"]}, id_tags={"userId": ids})
    REGISTRY.reset("re_project.")
    with environment({"PHOTON_RE_PROJECT": "support"}):
        fit = fit_streamed(host, config, dev)
    W_s = fit["model"]["per_user"].coefficients.to(dev)
    rec["streamed_support"] = dict(wall_s=fit["wall_s"], gauges=REGISTRY.snapshot("re_project.")["gauges"],
                                   held_out_auc=held_out_auc(W_s), re_launches=fit["re_launches"],
                                   max_abs_diff_vs_in_memory=float((W_s - sup[0]).abs().max()))
    gates["streamed_support_close"] = bool(torch.allclose(W_s, sup[0], rtol=1e-2, atol=2e-3))
    prefetch.clear_cache()
    return dict(rec, gates=gates)


def profile_e(batch, effects: dict, dev, re_solver: str = "NEWTON_CHOLESKY") -> dict:
    """``torch.profiler`` over config E's second outer iteration (a fit of
    2; the profiler steps at every visit mark, so it records exactly the
    three visits of iteration 1): the card's busy share of that window's
    wall time (kernel time summed over the window, one stream), the kernel
    launches, and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile, schedule

    # the card's activity alone: the host's ops are not read, and parsing
    # them took seconds a trace
    acts = [ProfilerActivity.CUDA]
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


def agreement_e_solvers(dev, newton: dict) -> tuple[dict, dict]:
    """Config E at bench.py's shape with the random effects on L-BFGS,
    TRON, OWL-QN (ELASTIC_NET) and L-BFGS over a sparse per-user shard, 4
    outer iterations each; against ``agreement_e``'s Newton fit of the
    same shape (``newton``), the dense L-BFGS fit, the single-GLM solvers
    and, for the L-BFGS fit, the grouped validation metrics' host
    versions. Returns the record and each variant's model."""
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
        train_auc=newton["train_auc"], train_log_loss=newton["train_log_loss"]), **runs), models


# config E at its bench depth (64 global features and an intercept, 8 per user
# and 8 per item, 20,000 users and 4,000 items, Zipf 1.5), with a quarter as
# many validation rows, in Avro part files: the Python codec, not the card,
# keeps the depth below ML-10M's
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


def _write_game_cli_part(path: str, schema: dict, host: dict, lo: int, hi: int) -> float:
    """One part file of rows [lo, hi) (``host``'s arrays hold those rows
    only): a worker process's share of ``game_cli_data``'s writing. Returns
    its seconds."""
    t0 = time.perf_counter()
    rows = dict(X=host["X"].tolist(), y=host["y"].tolist(), ids=host["ids"],
                Xe={k: v.tolist() for k, v in host["Xe"].items()})
    write_avro_file(path, schema, game_cli_records(rows, lo, hi))
    return time.perf_counter() - t0


def game_cli_data(dev, work: str, sizes: dict = GAME_CLI) -> GameCliData:
    """Config E's rows drawn on the card and written as Avro part files with
    the port's codec (``start_game_cli_data``, then
    ``finish_game_cli_data``)."""
    return finish_game_cli_data(start_game_cli_data(dev, work, sizes))


def start_game_cli_data(dev, work: str, sizes: dict = GAME_CLI) -> dict:
    """``game_cli_data``'s first half: config E's rows drawn on the card and
    their part files being written with the port's codec, one worker
    process a part file (all started together, forked from
    ``start_forkserver``'s server where it runs; the codec is pure Python). The caller
    goes on meanwhile; ``finish_game_cli_data`` waits for the files."""
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
    pool = ProcessPoolExecutor(len(parts), mp_context=multiprocessing.get_context(
        "forkserver" if start_forkserver() else "spawn"))
    futures = [pool.submit(_write_game_cli_part, path, schema,
                           dict(X=host["X"][a:b], y=host["y"][a:b], ids={k: v[a:b] for k, v in host["ids"].items()},
                                Xe={k: v[a:b] for k, v in host["Xe"].items()}), a, b)
               for path, a, b in parts]
    return dict(dev=dev, work=work, sizes=sizes, data=data, ids=host["ids"], pool=pool, futures=futures)


def finish_game_cli_data(pending: dict) -> GameCliData:
    """``game_cli_data``'s second half: the part files waited for, and the
    arrays the library is held to on the card. ``write_s`` is the slowest
    writer's own seconds (the four write at once)."""
    try:
        write_s = max(f.result() for f in pending["futures"])
    finally:
        pending["pool"].shutdown(cancel_futures=True)
    dev, work, data, sizes = pending["dev"], pending["work"], pending["data"], pending["sizes"]
    effects, n_tr, n_va = sizes["effects"], sizes["train"], sizes["val"]
    avro_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(work) for f in fs)

    ids = {k: first_seen(v, n_tr) for k, v in pending["ids"].items()}
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


@contextmanager
def recording_native_index_passes():
    """How many index-map passes the native decoder made (the reader's
    streaming pass falls back to the Python codec without one)."""
    seen = []
    native = AvroDataReader._streaming_stats_native

    def recorded(self, plans):
        seen.append(len(plans))
        return native(self, plans)

    AvroDataReader._streaming_stats_native = recorded
    try:
        yield seen
    finally:
        AvroDataReader._streaming_stats_native = native


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


def native_read_parity(work: str, effects: dict) -> dict:
    """One training part file of ``work`` read on the host by the native
    decoder and by the Python codec (its plain version): equal bit for bit;
    each one's ms a record. The smoke runs it in a forked child beside the
    drivers (mode ``native_read_parity``): it does not touch the card."""
    shards = game_cli_config(effects, 1).feature_shards
    reader = AvroDataReader(shards)
    path = os.path.join(work, "train", "part-00000.avro")
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
    """``main_e_lbfgs``'s batch and schedule (MovieLens-10M depth, L-BFGS
    random effects, 2 warm-up and 4 timed outer iterations) with each user
    in its subspace and the items over a random projection to 4 columns."""
    n, effects = E_ML10M
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
E_STREAM_CHUNK = 1 << 20  # main_e_streamed: 10 chunks, the last 562,870 rows and padding
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


# main_stream_executor: every arm runs with PHOTON_STREAM_EXECUTOR off, then on
STREAM_EXECUTOR_ARMS = ("0", "1")
SX_CHUNKS = range(4)  # (a): main_f's first 4 chunks, 4 x 2^18 x 512 float32 = 2 GiB
SX_ITERATIONS = 10
SX_SERVE_REQUESTS, SX_REFRESH_ENTITIES = 1_000, 16
SX_CV_ROWS = 1 << 18  # (d): config D's rows


def _stream_counters() -> dict:
    """The executor's and the chunk cache's registry counters."""
    snap = REGISTRY.snapshot()
    out = {k: v["value"] for k, v in snap["counters"].items() if k.startswith(("stream.", "prefetch.cache."))}
    out["prefetch.consumer_wait_s"] = snap["timers"].get("prefetch.consumer_wait_s", {}).get("seconds", 0.0)
    return out


@contextmanager
def executor_arm(knob: str):
    """One arm of main_stream_executor: the knob set, both caches empty,
    every kernel's launch count and the stage timers zeroed just before;
    yields a dict that holds, after the block, the arm's counter deltas,
    wall and launches."""
    out = {}
    with environment({"PHOTON_STREAM_EXECUTOR": knob}):
        prefetch.clear_cache()
        stream_executor.clear()
        prefetch.reset_stage_seconds()
        fused.reset_launch_counts()
        st.reset_launch_counts()
        before = _stream_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        after = _stream_counters()
        out["counters"] = {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}
        out["launches"] = launch_counts()
        out["stream_cache"] = stream_executor.cache_stats()
    prefetch.clear_cache()
    stream_executor.clear()


def _bits(*tensors) -> list:
    return [t.detach().cpu().numpy().tobytes() if isinstance(t, torch.Tensor) else np.asarray(t).tobytes()
            for t in tensors]


def sx_dedup(dev) -> dict:
    """(a) A validation loader's own copies of the training chunks: host
    L-BFGS (10 iterations, tolerance 0, λ = 1) over main_f's first 4
    chunks, the validation objective's value over content-equal fresh
    host arrays taken at every iteration (bench.py ``bench_x_stream``'s
    design at config A's width)."""
    t0 = time.perf_counter()
    chunks = f_chunks(dev, keep=SX_CHUNKS)
    val_chunks = [{k: np.array(v) for k, v in c.items()} for c in chunks]
    data_s = time.perf_counter() - t0
    loss, cfg = LOSSES["logistic"], OptimizerConfig(max_iterations=SX_ITERATIONS, tolerance=0.0)
    rec = dict(n=F_CHUNK * len(chunks), d=F_D, chunks=len(chunks), host_bytes=sum(
        a.nbytes for c in chunks for a in c.values()), data_s=data_s, arms={})
    outs = {}
    for knob in STREAM_EXECUTOR_ARMS:
        with executor_arm(knob) as arm:
            train = StreamingGLMObjective(chunks, loss, F_D, l2_weight=1.0, intercept_index=F_D - 1, device=dev)
            val = StreamingGLMObjective(val_chunks, loss, F_D, l2_weight=1.0, intercept_index=F_D - 1, device=dev)
            visits = []
            res = host_lbfgs_minimize(train, np.zeros(F_D), cfg,
                                      iteration_callback=lambda it, w, v: visits.append(val.value(w)))
            del train, val
        key = "stream.cache.miss_bytes" if knob == "1" else "prefetch.cache.miss_bytes"
        c = arm["counters"]
        outs[knob] = _bits(res.w, *visits)
        rec["arms"][knob] = dict(
            wall_s=arm["wall_s"], iterations=res.iterations, objective_passes=res.objective_passes,
            validation_values=len(visits), transfer_bytes=c.get(key, 0.0),
            hit_bytes=c.get("stream.cache.hit_bytes", 0.0),
            shared_hit_bytes=c.get("stream.cache.shared_hit_bytes", 0.0),
            consumer_wait_s=c.get("prefetch.consumer_wait_s", 0.0), counters=c, launches=arm["launches"],
            k1_launches=arm["launches"]["fused_value_grad"], stream_cache=arm["stream_cache"])
    off, on = rec["arms"]["0"], rec["arms"]["1"]
    rec["bitwise"] = outs["0"] == outs["1"] and len(outs["0"]) == SX_ITERATIONS + 1
    rec["on_over_off_transfer"] = on["transfer_bytes"] / off["transfer_bytes"]
    # K1 runs the training passes (value and gradient); a validation value is a matrix-vector product
    rec["k1_launches_ok"] = all(a["k1_launches"] == len(chunks) * a["objective_passes"] > 0
                                for a in rec["arms"].values())
    # the content fingerprint's first sight of a fresh 512 MiB chunk (the
    # memo makes every later pass free): one core, warm host memory
    fresh = np.array(chunks[0]["X"])
    t0 = time.perf_counter()
    stream_executor._content_fingerprint(fresh)
    fp_s = time.perf_counter() - t0
    rec["fingerprint"] = dict(bytes=fresh.nbytes, seconds=fp_s, gb_s=fresh.nbytes / fp_s / 1e9)
    stream_executor.clear()
    return rec


def sx_sparse(dev) -> dict:
    """(b) A2's data in main_a2_streamed's chunks (2^16 rows, tiled for
    K3): the streamed objective's value and gradient, its Hessian
    diagonal and its scores, and the module scorer."""
    n, d, k = A2
    batch, _ = sparse_problem(dev, n, d, k, seed=1)
    chunks = sparse_chunks(batch.indices.to(torch.int32).cpu().numpy(), batch.values.cpu().numpy(),
                           batch.labels.cpu().numpy(), A2_CHUNK)
    del batch
    w = np.random.default_rng(5).normal(size=d).astype(np.float32) * 0.1
    tile_cache.clear()
    rec, outs = dict(n=n, d=d, chunks=len(chunks), chunk_rows=A2_CHUNK, arms={}), {}
    for knob in STREAM_EXECUTOR_ARMS:
        with executor_arm(knob) as arm:
            obj = StreamingGLMObjective(chunks, LOSSES["logistic"], d, device=dev)
            v, g = obj.value_and_grad(w)
            outs[knob] = _bits(v, g, obj.hessian_diag(w), obj.stream_scores(w, n),
                               stream_scores(chunks, w, n, num_features=d, device=dev))
            tiled = obj.tiled
            del obj
        rec["arms"][knob] = dict(wall_s=arm["wall_s"], tiled=tiled, launches=arm["launches"], counters=arm["counters"],
                                 k3_launches={dname: arm["launches"][f"sparse_{dname}"] for dname in st.DIRECTIONS})
    tile_cache.clear()
    rec["bitwise"] = outs["0"] == outs["1"]
    k3 = [a["k3_launches"] for a in rec["arms"].values()]
    rec["k3_launches_ok"] = (all(a["tiled"] for a in rec["arms"].values()) and k3[0] == k3[1]
                             and min(k3[0].values()) >= len(chunks))
    return rec


def sx_game(dev) -> dict:
    """(c) Config E at bench depth out of core (as main_e_streamed_compact
    runs it: L-BFGS random effects, 2 outer iterations): the fixed
    effect's passes ("objective"), the bucket gathers ("re_gather") and the
    per-visit scoring ("re_scores")."""
    n, effects = E_STREAMED_COMPACT
    batch, _ = game_problem(dev, n, effects, seed=4)
    host = streamed_game_data(batch)
    del batch
    config = game_config(effects, 2, re_solver="LBFGS")
    rec, fits = dict(n=n, effects={k: list(v) for k, v in effects.items()}, arms={}), {}
    for knob in STREAM_EXECUTOR_ARMS:
        with executor_arm(knob) as arm:
            fit = fit_streamed(host, config, dev)
            scores = score_streamed(fit["model"], host, dev)
        c = arm["counters"]
        fits[knob] = (fit, scores)
        rec["arms"][knob] = dict(
            wall_s=arm["wall_s"], launches=fit["launches"], fixed_objective_passes=fit["fixed_objective_passes"],
            re_gather_items=c.get("stream.re_gather.items", 0.0),
            re_scores_hit_bytes=c.get("stream.re_scores.hit_bytes", 0.0),
            re_scores_miss_bytes=c.get("stream.re_scores.miss_bytes", 0.0), counters=c)
    (f0, s0), (f1, s1) = fits["0"], fits["1"]
    rec["models"] = models_agree(f1["model"], f0["model"])
    rec["bitwise"] = rec["models"]["bitwise"] and torch.equal(s0, s1)
    rec["k1_launches_ok"] = all(a["launches"]["fused_value_grad"] == a["fixed_objective_passes"] > 0
                                for a in rec["arms"].values())
    prefetch.clear_cache()
    return rec


def sx_cv(dev) -> dict:
    """(d) ``cross_validate_glm`` with k = 2 at config D's shape (2^18 x 65,
    logistic, L-BFGS 20 iterations, λ = 1): the folds' ingest ("cv")."""
    from photon_ml_tpu_torch.supervised.cross_validation import cross_validate_glm

    batch, _ = game_problem(dev, SX_CV_ROWS, {}, seed=4)
    glm = batch.batch_for("global")
    rec, outs = dict(n=glm.num_rows, d=D_FIXED + 1, k=2, arms={}), {}
    for knob in STREAM_EXECUTOR_ARMS:
        with executor_arm(knob) as arm:
            res = cross_validate_glm(glm, TaskType.LOGISTIC_REGRESSION, k=2, regularization_weights=[1.0],
                                     optimizer_config=OptimizerConfig(max_iterations=20, tolerance=1e-7),
                                     intercept_index=D_FIXED, device=dev)
        outs[knob] = (res.metric_values, _bits(res.final.models[1.0].coefficients.means))
        rec["arms"][knob] = dict(wall_s=arm["wall_s"], metric_values=res.metric_values[1.0],
                                 launches=arm["launches"], cv_items=arm["counters"].get("stream.cv.items", 0.0))
    rec["bitwise"] = outs["0"] == outs["1"]
    rec["k1_launches_ok"] = all(a["launches"]["fused_value_grad"] > 0 for a in rec["arms"].values())
    return rec


def serve_with_refresh(dev, model: GameModel, requests: list, items: list) -> tuple[np.ndarray, dict, float]:
    """The requests through a ``MicroWindowServer`` on this thread while a
    second thread runs ``refresh_stream`` over ``items``: (scores, the
    refreshed random-effect coefficients, the refresh's seconds)."""
    import threading

    out, refreshed, errors, seconds = [], {}, [], [0.0]

    def refresh():
        try:
            t0 = time.perf_counter()
            m, _ = refresh_stream(model, items, OptimizerConfig(max_iterations=20, tolerance=1e-7), l2_weight=1.0,
                                  device=dev)
            torch.cuda.synchronize()
            seconds[0] = time.perf_counter() - t0
            refreshed.update({cid: sub.coefficients for cid, sub in m.models.items()
                              if isinstance(sub, RandomEffectModel)})
        except BaseException as e:  # raised again on this thread
            errors.append(e)

    server = MicroWindowServer(HotModelStore(model, device=dev), on_scores=lambda w, s: out.append(s),
                               max_batch=SERVE_MAX_BATCH, max_wait_ms=1e9)
    worker = threading.Thread(target=refresh)
    worker.start()
    for r in requests:
        server.submit(r)
    server.drain()
    worker.join()
    if errors:
        raise errors[0]
    return np.concatenate(out), refreshed, seconds[0]


def sx_serve(dev, serve_root: str) -> dict:
    """(e) main_serve's published model: 1,000 requests through the
    micro-window server while a second thread refreshes 16 users
    (``refresh_stream``, "refresh", priority 10 under the serve windows'
    100)."""
    from photon_ml_tpu_torch.cli import serve as serve_cli

    model, _ = serve_cli._load(serve_root, dev)
    requests = serve_cli._synthetic_requests(model, SX_SERVE_REQUESTS, 1.0, 0)
    user_cid = next(cid for cid, sub in model.models.items() if isinstance(sub, RandomEffectModel))
    d_re = model[user_cid].coefficients.shape[1]
    gen = np.random.default_rng(31)
    items = []
    for e in range(SX_REFRESH_ENTITIES):
        k = 8 + e
        items.append((user_cid, 97 * e, gen.normal(size=(k, d_re)).astype(np.float32),
                      (gen.uniform(size=k) < 0.5).astype(np.float32), 0.1 * gen.normal(size=k).astype(np.float32),
                      None))
    rec, outs = dict(requests=len(requests), entities=len(items), arms={}), {}
    for knob in STREAM_EXECUTOR_ARMS:
        with executor_arm(knob) as arm:
            scores, refreshed, refresh_s = serve_with_refresh(dev, model, requests, items)
        outs[knob] = (scores.tobytes(), _bits(*(refreshed[c] for c in sorted(refreshed))))
        rec["arms"][knob] = dict(wall_s=arm["wall_s"], refresh_s=refresh_s, launches=arm["launches"],
                                 refresh_yields=arm["counters"].get("stream.refresh.yields", 0.0),
                                 refresh_items=arm["counters"].get("stream.refresh.items", 0.0))
    rec["bitwise"] = outs["0"] == outs["1"]
    return rec


def run_stream_executor(dev, card: str, serve_root: str) -> dict:
    """main_stream_executor: arms (a)-(e), each knob off then on."""
    rec = dict(card=card)
    for name, fn in (("dedup", lambda: sx_dedup(dev)), ("sparse", lambda: sx_sparse(dev)),
                     ("game", lambda: sx_game(dev)), ("cv", lambda: sx_cv(dev)),
                     ("serve_refresh", lambda: sx_serve(dev, serve_root))):
        t0 = time.perf_counter()
        rec[name] = fn()
        rec[name]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    arms = [a for part in ("dedup", "sparse", "game", "cv", "serve_refresh") for a in rec[part]["arms"].values()]
    rec["launches"] = {k: sum(a["launches"][k] for a in arms) for k in launch_counts()}
    rec["gates"] = {
        "dedup_bitwise": rec["dedup"]["bitwise"],
        "dedup_fewer_bytes": rec["dedup"]["arms"]["1"]["transfer_bytes"] < rec["dedup"]["arms"]["0"]["transfer_bytes"],
        "dedup_k1_launches": rec["dedup"]["k1_launches_ok"],
        "sparse_bitwise": rec["sparse"]["bitwise"],
        "sparse_k3_launches": rec["sparse"]["k3_launches_ok"],
        "game_bitwise": rec["game"]["bitwise"],
        "game_k1_launches": rec["game"]["k1_launches_ok"],
        "game_executor_ran": rec["game"]["arms"]["1"]["re_gather_items"] > 0
        and rec["game"]["arms"]["1"]["re_scores_hit_bytes"] > 0,
        "cv_bitwise": rec["cv"]["bitwise"] and rec["cv"]["arms"]["1"]["cv_items"] == 2,
        "cv_k1_launches": rec["cv"]["k1_launches_ok"],
        "serve_refresh_bitwise": rec["serve_refresh"]["bitwise"]
        and rec["serve_refresh"]["arms"]["1"]["refresh_items"] == SX_REFRESH_ENTITIES,
    }
    return rec


# main_a2_streamed_fe_shard: the children's arms, by process count
A2_FE_ITERATIONS = 10
A2_FE_CHILD_ARMS = {2: {"nnz": {}, "width": {"PHOTON_FE_SPLIT_WEIGHT": "width"}}, 4: {"nnz": {}}}


def a2_fe_chunks(dev) -> tuple[list[dict], torch.Tensor]:
    """A2's shape with power-law columns (``sparse_problem`` kind
    "skewed"), in 8 host chunks of 2^16 rows; and its labels on the card.
    Every process draws the same chunks from the seed."""
    n, d, k = A2
    batch, _ = sparse_problem(dev, n, d, k, seed=1, kind="skewed")
    chunks = sparse_chunks(batch.indices.to(torch.int32).cpu().numpy(), batch.values.cpu().numpy(),
                           batch.labels.cpu().numpy(), A2_CHUNK)
    labels = batch.labels
    del batch
    torch.cuda.empty_cache()
    return chunks, labels


@contextmanager
def timed_fe_evaluations(stats: dict):
    """Seconds in each of the streamed objective's evaluations
    (``value_and_grad``, ``hessian_diag``; the card synchronized after
    each), and the phase-A reductions' seconds, calls and the bytes this
    process puts on the wire (float32), summed into ``stats``."""
    real_vg, real_hd, real_reduce = (StreamingGLMObjective.value_and_grad, StreamingGLMObjective.hessian_diag,
                                     streaming._fe_allreduce)

    def timed(fn, key):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            if key == "eval":
                torch.cuda.synchronize()
            else:
                stats["reduce_bytes"] += sum(np.asarray(a, np.float32).nbytes for a in args)
            stats[f"{key}_s"] += time.perf_counter() - t0
            stats[f"{key}_calls"] += 1
            return out
        return call

    stats.update(eval_s=0.0, eval_calls=0, reduce_s=0.0, reduce_calls=0, reduce_bytes=0)
    StreamingGLMObjective.value_and_grad = timed(real_vg, "eval")
    StreamingGLMObjective.hessian_diag = timed(real_hd, "eval")
    streaming._fe_allreduce = timed(real_reduce, "reduce")
    try:
        yield stats
    finally:
        StreamingGLMObjective.value_and_grad, StreamingGLMObjective.hessian_diag = real_vg, real_hd
        streaming._fe_allreduce = real_reduce


def _sha(t) -> str:
    a = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def fe_shard_arm(dev, chunks: list[dict], labels: torch.Tensor) -> dict:
    """One arm of main_a2_streamed_fe_shard under the environment as it
    stands: an objective built first (its K3 layouts packed through the
    cache; the plan, the ``fe_shard`` gauges and the packed bytes read),
    then ``train_glm_streamed`` with its launches counted and its
    evaluations and reductions timed, then the module scorer over the
    training chunks (its launches counted apart)."""
    n, d, _ = A2
    tile_cache.clear()
    prefetch.clear_cache()
    REGISTRY.reset("fe_shard.")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = StreamingGLMObjective(chunks, LOSSES["logistic"], d, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    plan = first._fe_plan
    rec = dict(fe_active=first.fe_active, tiled=first.tiled, build_s=build_s,
               packed_k3_bytes=tile_cache.stats()["bytes"],
               plan_boundaries=None if plan is None else list(plan.boundaries),
               plan_balance=None if plan is None else plan.balance, fe_range=first._fe_range,
               gauges={k.removeprefix("fe_shard."): v for k, v in REGISTRY.snapshot("fe_shard.")["gauges"].items()})
    del first
    stats: dict = {}
    reset_collective_stats()
    with timed_fe_evaluations(stats):
        result, wall, launches = streamed_solve(
            chunks, TaskType.LOGISTIC_REGRESSION, d, OptimizerConfig(max_iterations=A2_FE_ITERATIONS, tolerance=0.0),
            dev, variance_computation=VarianceComputationType.SIMPLE)
    collectives = dict(collective_stats)
    t = result.trackers[1.0]
    coef = result.models[1.0].coefficients
    fused.reset_launch_counts()
    st.reset_launch_counts()
    t0 = time.perf_counter()
    scores = stream_scores(chunks, coef.means, n, num_features=d, device=dev)
    torch.cuda.synchronize()
    scorer_s = time.perf_counter() - t0
    scorer_launches = launch_counts()
    passes = t.objective_passes  # value-and-gradient evaluations; SIMPLE adds one Hessian-diagonal evaluation
    c = len(chunks)
    expected = {"matvec": c * (passes + 1), "rmatvec": c * (passes if rec["fe_active"] else passes + 1),
                "rmatvec_sq": c}
    k3 = {direction: launches[f"sparse_{direction}"] for direction in st.DIRECTIONS}
    evals = max(stats["eval_calls"], 1)
    rec.update(
        iterations=t.iterations, reason=t.reason, objective_passes=passes, objective=float(t.value),
        train_auc=float(auc_roc(torch.as_tensor(scores, device=dev), labels)), solve_wall_s=wall,
        wall_ms_per_evaluation=1e3 * stats["eval_s"] / evals, evaluations=stats["eval_calls"],
        reduce_ms_per_evaluation=1e3 * stats["reduce_s"] / evals, reduce_calls=stats["reduce_calls"],
        reduce_bytes_per_evaluation=stats["reduce_bytes"] / evals, reduce_wire_dtype="float32",
        collectives=collectives, scorer_s=scorer_s,
        launches={k: launches[k] + scorer_launches[k] for k in launches},
        k3_launches=k3, k3_expected=expected, scorer_k3_matvec=scorer_launches["sparse_matvec"],
        launches_ok=k3 == expected and scorer_launches["sparse_matvec"] == c,
        peak_device_bytes=torch.cuda.max_memory_allocated() if dev.type == "cuda" else None,
        variances_finite=bool(torch.isfinite(coef.variances).all()),
        sha={"means": _sha(coef.means), "variances": _sha(coef.variances), "scores": _sha(scores)})
    tile_cache.clear()
    prefetch.clear_cache()
    return rec


def _fe_child_record(ranks: list[dict], one: dict, one_range: dict, d: int, total_nnz: int) -> dict:
    """A children's arm across its ranks, against the one-process arm."""
    r0 = ranks[0]
    return dict(
        processes=len(ranks), plan_boundaries=r0["plan_boundaries"], plan_balance=r0["plan_balance"],
        gauges=[x["gauges"] for x in ranks], packed_k3_bytes=[x["packed_k3_bytes"] for x in ranks],
        packed_share_of_one_range=[x["packed_k3_bytes"] / one_range["packed_k3_bytes"] for x in ranks],
        build_s=[x["build_s"] for x in ranks], solve_wall_s=[x["solve_wall_s"] for x in ranks],
        wall_ms_per_evaluation=[x["wall_ms_per_evaluation"] for x in ranks],
        reduce_ms_per_evaluation=[x["reduce_ms_per_evaluation"] for x in ranks],
        reduce_bytes_per_evaluation=r0["reduce_bytes_per_evaluation"], reduce_wire_dtype=r0["reduce_wire_dtype"],
        collectives=[x["collectives"] for x in ranks], k3_launches=[x["k3_launches"] for x in ranks],
        k3_expected=[x["k3_expected"] for x in ranks], peak_device_bytes=[x["peak_device_bytes"] for x in ranks],
        iterations=r0["iterations"], objective_passes=r0["objective_passes"], objective=r0["objective"],
        train_auc=r0["train_auc"], launches={k: sum(x["launches"][k] for x in ranks) for k in launch_counts()},
        launches_ok=all(x["launches_ok"] for x in ranks),
        ranks_bitwise=all(x["sha"] == r0["sha"] and x["objective"] == r0["objective"]
                          and x["iterations"] == r0["iterations"] and x["train_auc"] == r0["train_auc"]
                          for x in ranks),
        widths_cover_d=sum(x["gauges"]["width"] for x in ranks) == float(d),
        nnz_covers_data=sum(x["gauges"]["nnz_local"] for x in ranks) == float(total_nnz),
        nnz_balance=r0["gauges"]["nnz_balance"],
        d_auc_vs_one_process=abs(r0["train_auc"] - one["train_auc"]),
        rel_d_objective_vs_one_process=abs(r0["objective"] - one["objective"]) / abs(one["objective"]),
        variances_finite=all(x["variances_finite"] for x in ranks))


def run_a2_streamed_fe_shard(dev, card: str) -> dict:
    """main_a2_streamed_fe_shard (the module docstring, phase 22)."""
    t_phase = time.perf_counter()
    n, d, _ = A2
    os.environ.pop("PHOTON_FE_SHARD", None)
    chunks, labels = a2_fe_chunks(dev)
    total_nnz = int(sum(np.count_nonzero(c["values"]) for c in chunks))
    arms = {}
    for arm, env in (("unset", {}), ("off0", {"PHOTON_FE_SHARD": "0"}), ("on1", {"PHOTON_FE_SHARD": "1"})):
        with environment(env):
            arms[arm] = fe_shard_arm(dev, chunks, labels)
    one = arms["unset"]
    one_range_bitwise = {arm: arms[arm]["sha"] == one["sha"] and arms[arm]["objective"] == one["objective"]
                         for arm in ("off0", "on1")}

    # K3 on a chunk restricted to the second of four ranges (lo > 0)
    plan4 = plan_feature_ranges(streaming._fe_nnz_histogram(chunks, d), 4, mode="nnz")
    lo, hi = plan4.range_of(1)
    r = streaming._fe_restrict_chunks(chunks[:1], lo, hi)[0][0]
    rows = r["labels"].shape[0]
    restricted = st.tile_sparse_batch(SparseBatch(
        indices=torch.from_numpy(r["indices"]).long().to(dev), values=torch.from_numpy(r["values"]).to(dev),
        labels=torch.zeros(rows, device=dev), offsets=torch.zeros(rows, device=dev),
        weights=torch.ones(rows, device=dev), num_features=hi - lo), fe_range=(1, lo, hi, 4))
    gen = torch.Generator(device=dev).manual_seed(29)
    w, y = torch.randn(hi - lo, generator=gen, device=dev), torch.randn(rows, generator=gen, device=dev)
    k3_parity = {}
    for direction, (lay, src, square) in k3_directions(restricted, w, y).items():
        got = st.sparse_apply(lay, src, square=square, direction=direction)
        ok, err = close(got, st.tiled_apply_reference(lay, src, square=square), 1e-5, 1e-5)
        k3_parity[direction] = dict(ok=ok, max_abs_err=err)
    k3_shape = dict(range=[lo, hi], width=hi - lo, rows=rows, nnz=restricted.m.nnz, row_width=r["values"].shape[1])
    del restricted, labels
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    children = {}
    work_root = tempfile.mkdtemp(prefix="_a2_fe_shard-", dir=ROOT)
    try:
        for p, child_arms in A2_FE_CHILD_ARMS.items():
            t0 = time.perf_counter()
            kids = run_children("a2_fe_shard", os.path.join(work_root, f"p{p}"),
                                {"arms": child_arms, "shape": A2, "chunk_rows": A2_CHUNK}, dev,
                                env={"PHOTON_FE_SHARD": "1"}, n=p)
            for arm in child_arms:
                children[f"p{p}_{arm}"] = dict(
                    _fe_child_record([kid["arms"][arm] for kid in kids], one, arms["on1"], d, total_nnz),
                    children_wall_s=time.perf_counter() - t0)
    finally:
        shutil.rmtree(work_root, ignore_errors=True)
    all_arms = [*arms.values(), *children.values()]
    return dict(card=card, n=n, d=d, chunks=len(chunks), chunk_rows=A2_CHUNK, total_nnz=total_nnz,
                iterations=A2_FE_ITERATIONS, one_process=arms, one_range_bitwise_unset=one_range_bitwise,
                k3_restricted_parity=k3_parity, k3_restricted_shape=k3_shape, processes=children,
                launches={k: sum(a["launches"][k] for a in all_arms) for k in launch_counts()},
                phase_wall_s=time.perf_counter() - t_phase)


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


_PORTS_GIVEN: set[int] = set()


def _free_port() -> int:
    """A free loopback port this run has not handed out before: groups that
    start at once (main_faults' pairs) must not meet on one store."""
    import socket

    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port not in _PORTS_GIVEN:
            _PORTS_GIVEN.add(port)
            return port


def start_children(mode: str, work: str, args: dict, dev, env: dict | None = None, n: int = 2,
                   ports: int = 1, allow_kill: tuple = (), timeout_s: float = CHILD_TIMEOUT_S,
                   rejoin: bool = False) -> dict:
    """``run_children``'s first half: the children started, not waited on
    (their limit counts from here). ``join_children`` waits for them. Each
    child forks from ``start_forkserver``'s server where it runs, its output
    in a ``_child_logs-*`` directory of the checkout. ``rejoin``: each child is
    the ``--child`` command instead, and its ``PHOTON_REJOIN_CMD``, so a
    plan's ``rejoin`` op re-execs it; a child in ``allow_kill`` then leaves
    the record of its re-exec'd process, which holds its pipes."""
    _cuda.load()
    native_build.build()
    os.makedirs(work, exist_ok=True)
    child_env = {k: v for k, v in os.environ.items()
                 if k not in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")}
    child_env.update(env or {})
    fresh = [_free_port() for _ in range(ports)]
    spec = json.dumps(dict(args, work=work, port=fresh[0], ports=fresh, processes=n, device=dev.type))
    logs = tempfile.mkdtemp(prefix="_child_logs-", dir=ROOT)
    procs = []
    for r in range(n):
        argv = [sys.executable, os.path.abspath(__file__), "--child", mode, str(r), spec]
        if rejoin or not start_forkserver():
            # a command: a rejoin plan re-execs it, and the rejoiner inherits its pipes
            procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                          cwd=ROOT, env=dict(child_env, PHOTON_REJOIN_CMD=json.dumps(argv)) if rejoin
                                          else child_env))
        else:
            procs.append(_ForkedChild(mode, r, json.loads(spec), child_env,
                                      (os.path.join(logs, f"{r}.out"), os.path.join(logs, f"{r}.err"))))
    return dict(mode=mode, work=work, n=n, procs=procs, allow_kill=allow_kill, timeout_s=timeout_s,
                deadline=time.monotonic() + timeout_s, rejoin=rejoin, logs=logs)


_FORKSERVER: bool | None = None  # whether the server runs; None: not started yet


def start_forkserver() -> bool:
    """Start the server that forks every ``start_children`` child: it imports
    this script once (torch and the port: 11 s on the card's host), in the
    background, and never touches the card, so each child forks ready and
    only makes its own CUDA context. False, for the whole run, where it
    cannot start (its socket's path under ``TMPDIR`` too long for a Unix
    socket): children are then the ``--child`` command and the writers
    spawned processes, as slow as before it."""
    global _FORKSERVER
    if _FORKSERVER is None:
        from multiprocessing import forkserver

        try:
            multiprocessing.get_context("forkserver").set_forkserver_preload(
                [os.path.splitext(os.path.basename(__file__))[0]])
            forkserver.ensure_running()
            _FORKSERVER = True
        except OSError as e:
            print(f"chip_smoke: no forkserver ({e}); children start as commands", file=sys.stderr)
            _FORKSERVER = False
    return _FORKSERVER


def _forked_child(mode: str, rank: int, spec: dict, env: dict, logs: tuple[str, str]) -> None:
    """A forked child's body: its standard output and error to ``logs``, the
    environment the ``--child`` command would get (torch's thread count
    from its ``OMP_NUM_THREADS``, which OpenMP read when the server loaded
    it), then ``_child``."""
    for fd, path in zip((1, 2), logs):
        f = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        os.dup2(f, fd)
        os.close(f)
    os.environ.clear()
    os.environ.update(env)
    if env.get("OMP_NUM_THREADS"):
        torch.set_num_threads(int(env["OMP_NUM_THREADS"]))
    os.chdir(ROOT)
    if torch.cuda._is_in_bad_fork():
        raise RuntimeError("the forkserver touched CUDA before it forked this child")
    sys.exit(_child(mode, rank, spec))


class _ForkedChild:
    """One ``--child`` process forked from ``start_forkserver``'s server,
    with the part of ``subprocess.Popen`` that ``join_children`` reads: its
    exit code (a negative signal number when killed) and its output."""

    def __init__(self, mode: str, rank: int, spec: dict, env: dict, logs: tuple[str, str]):
        import importlib

        ctx = multiprocessing.get_context("forkserver")
        # by the module's name, so the server's import of it runs the child
        target = importlib.import_module(os.path.splitext(os.path.basename(__file__))[0])._forked_child
        self.logs = logs
        self.proc = ctx.Process(target=target, args=(mode, rank, spec, env, logs), name=f"{mode}-{rank}")
        self.proc.start()

    @property
    def returncode(self) -> int | None:
        return self.proc.exitcode

    def poll(self) -> int | None:
        return self.proc.exitcode

    def kill(self) -> None:
        self.proc.kill()

    def communicate(self, timeout: float | None = None) -> tuple[str, str]:
        self.proc.join(timeout)
        if self.proc.exitcode is None:
            raise subprocess.TimeoutExpired(self.proc.name, timeout)
        out = []
        for path in self.logs:
            with open(path, errors="replace") as f:
                out.append(f.read())
        return tuple(out)


def join_children(kids: dict) -> list[dict]:
    """Wait for ``start_children``'s children and return their records
    (``run_children``'s rules). A re-exec'd process (``rejoin``) runs in a
    session of its own and writes its pid to ``work/rejoiner.pid``: it is
    killed with the rest when the pair outlives its limit."""
    mode, procs, allow_kill = kids["mode"], kids["procs"], kids["allow_kill"]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(kids["deadline"] - time.monotonic(), 1.0)))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{mode}: a child outlived {kids['timeout_s']} s and was killed") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(kids["logs"], ignore_errors=True)
        pid_file = os.path.join(kids["work"], "rejoiner.pid")
        if kids.get("rejoin") and os.path.exists(pid_file):
            try:
                with open(pid_file) as f:
                    os.kill(int(f.read()), signal.SIGKILL)
            except ProcessLookupError:  # it has finished
                pass
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        want = 137 if r in allow_kill else 0
        if p.returncode != want:
            raise AssertionError(f"{mode}: child {r} exited {p.returncode} (expected {want}):\n{err[-4000:]}")
    results = []
    for r in range(kids["n"]):
        path = os.path.join(kids["work"], f"rank{r}.json")
        if r in allow_kill and not kids.get("rejoin"):
            results.append(None)
            continue
        if not os.path.exists(path):
            raise AssertionError(f"{mode}: child {r} left no record:\n{outs[r][1][-4000:]}")
        with open(path) as f:
            results.append(json.load(f))
    return results


def run_children(mode: str, work: str, args: dict, dev, env: dict | None = None, n: int = 2,
                 ports: int = 1, allow_kill: tuple = (), timeout_s: float = CHILD_TIMEOUT_S) -> list[dict]:
    """``n`` processes of this script's ``_child`` (forked ready from
    ``start_forkserver``'s server), one gloo group on
    a fresh loopback port (``ports`` fresh ports for children that form a
    group several times, in the spec's ``ports``); each writes
    ``work/rank<r>.json``. The kernels are built by the parent before
    (``_cuda.load``), so no two children build at once. A child that fails
    or outlives ``timeout_s`` (then killed) fails the phase; a child in
    ``allow_kill`` (a fault plan's kill) must exit 137 instead, and has no
    record (None in its place)."""
    return join_children(start_children(mode, work, args, dev, env, n, ports, allow_kill, timeout_s))


def placement_balances(trainer: StreamedGameTrainer, host: StreamedGameData, effects: dict,
                       processes: int) -> dict:
    """Per random effect: the balance (max / mean rows an owner) and the
    loads of the plan the trainer placed its entities by
    (``trainer.placements``), beside the balance the modular rule ``e % P``
    gives the same rows, and whether the trainer's loads are the global
    rows of the owners it chose (every process's rows counted here: a
    collective)."""
    out = {}
    for tag in effects:
        cid = f"per_{tag}"
        plan = trainer.placements[cid]
        counts = allreduce_sum_host(np.bincount(host.id_tags[tag], minlength=len(plan.owner)).astype(np.float64))
        out[cid] = dict(planned=plan.balance, loads=plan.loads.tolist(),
                        modular=plan_entity_placement(counts, processes, skew_aware=False).balance,
                        loads_are_global_rows=bool(np.array_equal(
                            plan_from_owner(plan.owner, counts, processes).loads, plan.loads)))
    return out


def owned_visit_bitwise(host, effects: dict, dev, mesh) -> dict:
    """One per-user random-effect visit on identical seeded offsets (E's
    Newton configuration, a cold start): owned buckets across the processes
    (``mesh``, PHOTON_RE_SHARD=1; features on the host, each process staging
    its own buckets) against the no-mesh solve with everything on the card.
    Bit for bit, with each solve's seconds."""
    tag = next(iter(effects))
    cid = f"per_{tag}"
    c = game_config(effects, 1).random_effect_coordinates[cid]
    ids = host.id_tags[tag].numpy()
    buckets = bucket_entities(group_by_entity(ids, num_entities=effects[tag][0]), c.sample_bucket_sizes,
                              target_buckets=c.bucket_target_count, max_padded_ratio=c.bucket_max_padded_ratio)
    gen = torch.Generator().manual_seed(21)
    kw = dict(labels=host.labels, offsets=0.1 * torch.randn(host.num_rows, generator=gen), weights=host.weights,
              buckets=buckets, num_entities=effects[tag][0], loss=LOSSES["logistic"], config=c.optimization.optimizer,
              l2_weight=1.0)
    out = {}
    for name, feats, where in (("owned", host.features[cid], None),
                               ("plain", DenseFeatures(X=host.features[cid].X.to(dev)), dev)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_random_effects(feats, mesh=mesh if where is None else None, device=where, **kw)
        W = res.coefficients.cpu().numpy()
        out[f"{name}_s"] = time.perf_counter() - t0
        out[name] = W
    W_owned, W_plain = out.pop("owned"), out.pop("plain")
    return dict(out, coordinate=cid, bitwise=W_owned.tobytes() == W_plain.tobytes(),
                max_abs_diff=float(np.abs(W_owned - W_plain).max()))


def _child(mode: str, rank: int, spec: dict) -> int:
    """One process of a multi-process phase (``run_children``), on the
    parent's device."""
    global F_ROWS, F_D, F_CHUNK, E_STREAM_CHUNK, A2, A2_CHUNK
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
        # the quality check's inputs (main_e_multihost_re_shard, at bench depth), else nothing
        kept = (batch, data) if spec.get("quality") else None
        del batch, data
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        out["data_s"] = time.perf_counter() - t0
        initialize_multihost(f"127.0.0.1:{spec['port']}", spec["processes"], rank)
        mesh = process_mesh(spec["local_shards"], devices=[dev])
        game_random_effect.reset_combine_stats()
        fit = fit_game(host, game_config(effects, 6), dev, mesh=mesh)
        np.savez(os.path.join(work, f"rank{rank}.npz"),
                 **{cid: sub.coefficient_means.cpu().numpy() for cid, sub in fit["best"].model.models.items()})
        out.update(_game_record(fit, warmup=2), mesh=[str(d) for d in mesh.local],
                   global_shards=list(mesh.global_shards()), exchange_per_visit=_exchange_per_visit(fit, 2),
                   peak_device_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None)
        if kept is not None:
            out["quality"] = game_quality(fit, *kept)
        if os.environ.get("PHOTON_RE_SHARD") == "1":
            out.update(re_shard=REGISTRY.snapshot("re_shard.")["gauges"],
                       re_visit=owned_visit_bitwise(host, effects, dev, mesh))
    elif mode == "e_re_split":
        n, effects = spec["shape"][0], {k: tuple(v) for k, v in spec["shape"][1].items()}  # the parent's
        batch, _ = game_problem(dev, n, effects, seed=4)
        host = batch.to("cpu")
        del batch
        initialize_multihost(f"127.0.0.1:{spec['port']}", spec["processes"], rank)
        mesh = process_mesh(spec["local_shards"], devices=[dev])
        out["arms"] = {}
        for arm, env in RE_SPLIT_ARMS.items():
            with environment(env):
                REGISTRY.reset("re_shard.")
                REGISTRY.reset("re_combine.")
                game_random_effect.reset_combine_stats()
                fit = fit_game(host, game_config(effects, 3), dev, mesh=mesh)
            np.savez(os.path.join(work, f"{arm}-rank{rank}.npz"),
                     **{cid: sub.coefficient_means.cpu().numpy() for cid, sub in fit["best"].model.models.items()})
            out["arms"][arm] = dict(_game_record(fit, warmup=1), **_re_split_telemetry())
    elif mode == "e_streamed_re_split":
        n, effects = spec["shape"][0], {k: tuple(v) for k, v in spec["shape"][1].items()}  # the parent's
        E_STREAM_CHUNK = spec["chunk_rows"]
        batch, _ = game_problem(dev, n, effects, seed=4)
        per = n // spec["processes"]
        host = streamed_game_data(batch, slice(rank * per, n if rank == spec["processes"] - 1 else (rank + 1) * per))
        del batch
        initialize_multihost(f"127.0.0.1:{spec['port']}", spec["processes"], rank)
        out["arms"] = {}
        for arm, env in RE_SPLIT_STREAMED_ARMS.items():
            with environment(env):
                REGISTRY.reset("re_shard.")
                fit = fit_streamed(host, game_config(effects, 2), dev, multihost=True,
                                   local_devices=[dev, dev] if "PHOTON_RE_DEVICE_SPLIT" in env else None)
            np.savez(os.path.join(work, f"{arm}-rank{rank}.npz"),
                     **{cid: sub.coefficient_means.cpu().numpy() for cid, sub in fit["model"].models.items()})
            out["arms"][arm] = dict(
                iteration_wall_s=fit["iteration_wall_s"], launches=fit["launches"],
                fixed_objective_passes=fit["fixed_objective_passes"], chunks=-(-host.num_rows // E_STREAM_CHUNK),
                **_re_split_telemetry())
    elif mode == "a2_fe_shard":
        A2, A2_CHUNK = tuple(spec["shape"]), spec["chunk_rows"]  # the parent's, so the chunks are its chunks
        chunks, labels = a2_fe_chunks(dev)
        initialize_multihost(f"127.0.0.1:{spec['port']}", spec["processes"], rank)
        out["arms"] = {}
        for arm, env in spec["arms"].items():
            with environment(env):
                out["arms"][arm] = fe_shard_arm(dev, chunks, labels)
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
        out["data_s"] = time.perf_counter() - t0
        initialize_multihost(f"127.0.0.1:{spec['port']}", spec["processes"], rank)
        out["arms"] = {}
        for arm, env in spec["arms"]:  # in turn, in this process group
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                torch.cuda.reset_peak_host_memory_stats()
            reset_collective_stats()
            REGISTRY.reset("re_shard.")
            REGISTRY.reset("re_exchange.")
            REGISTRY.reset("p2p.")
            REGISTRY.reset("fleet.")
            mh._reset_host_links()  # each arm builds its mesh afresh (its CRC negotiated anew)
            rec = {}
            kw = {}
            if arm == "armed":  # main_faults' healthy ring, which checkpoints its anchor
                kw = dict(checkpoint_dir=os.path.join(work, "ckpt-armed"),
                          checkpoint_every_n_visits=len(effects) + 1, sharded_checkpoints=False,
                          on_log=_anchor_logger(rec, os.path.join(work, "ckpt-armed"), spec["anchor_dir"], rank))
            with environment(env):
                fit = fit_streamed(host, game_config(effects, 2), dev, multihost=True, **kw)
                if env.get("PHOTON_RE_SHARD") == "1":
                    rec["re_shard"] = dict(placement=placement_balances(fit["trainer"], host, effects,
                                                                        spec["processes"]),
                                           gauges=REGISTRY.snapshot("re_shard.")["gauges"],
                                           timers=REGISTRY.timer_snapshot("re_exchange."))
            peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
            margins = score_streamed(fit["model"], host, dev)
            np.savez(os.path.join(work, f"{arm}-rank{rank}.npz"), margins=margins.cpu().numpy(), labels=host.labels,
                     **{cid: sub.coefficient_means.cpu().numpy() for cid, sub in fit["model"].models.items()})
            rec.update(rows=host.num_rows, chunks=-(-host.num_rows // E_STREAM_CHUNK), wall_s=fit["wall_s"],
                       iteration_wall_s=fit["iteration_wall_s"], visits=fit["visits"], launches=fit["launches"],
                       fixed_objective_passes=fit["fixed_objective_passes"],
                       fixed_objective=fit["info"]["fixed"].final_loss,
                       exchange_totals=fit["trainer"].exchange_totals, collectives=dict(collective_stats),
                       peak_device_bytes=peak, host=host_memory(),
                       counters={k: v["value"] for k, v in (REGISTRY.snapshot("p2p.")["counters"]
                                                            | REGISTRY.snapshot("fleet.")["counters"]).items()})
            out["arms"][arm] = rec
            del fit, margins
            prefetch.clear_cache()
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
    elif mode == "faults_kill":
        n, effects = spec["shape"][0], {k: tuple(v) for k, v in spec["shape"][1].items()}  # the parent's
        E_STREAM_CHUNK = spec["chunk_rows"]
        batch, _ = game_problem(dev, n, effects, seed=4)
        per = n // spec["processes"]
        host = streamed_game_data(batch, slice(rank * per, (rank + 1) * per))
        del batch
        torch.cuda.empty_cache()
        times = _stamp_fault_events(work, rank)
        initialize_multihost(f"127.0.0.1:{spec['port']}", spec["processes"], rank)

        def on_log(msg):
            if msg.startswith("resuming streamed descent"):
                times.setdefault("resume_t", time.time())

        fit = fit_streamed(host, game_config(effects, 2), dev, on_log=on_log, multihost=True,
                           checkpoint_dir=os.path.join(work, "ckpt"), checkpoint_every_n_visits=len(effects) + 1,
                           sharded_checkpoints=False)
        np.savez(os.path.join(work, f"kill-rank{rank}.npz"),
                 **{cid: sub.coefficient_means.cpu().numpy() for cid, sub in fit["model"].models.items()})
        counters = REGISTRY.snapshot("p2p.")["counters"] | REGISTRY.snapshot("fleet.")["counters"]
        out.update(resumed_from=fit["trainer"].resumed_from, launches=fit["launches"], wall_s=fit["wall_s"],
                   counters={k: v["value"] for k, v in counters.items()}, times=dict(times))
    elif mode == "faults_rejoin":
        n, effects = spec["shape"][0], {k: tuple(v) for k, v in spec["shape"][1].items()}  # the parent's
        E_STREAM_CHUNK = spec["chunk_rows"]
        started_t = time.time()
        boot = bool(os.environ.get("PHOTON_REJOIN_BOOT"))  # re-exec'd by the plan's rejoin op
        if boot:
            with open(os.path.join(work, "rejoiner.pid"), "w") as f:
                f.write(str(os.getpid()))
        batch, _ = game_problem(dev, n, effects, seed=4)
        per = n // spec["processes"]
        host = streamed_game_data(batch, slice(rank * per, (rank + 1) * per))
        del batch
        torch.cuda.empty_cache()
        times = _stamp_fault_events(work, rank)
        times["started_t"] = started_t
        if boot:
            mh.bootstrap_rejoin()  # the identity and addresses from the mesh cache; no gloo group
        else:
            initialize_multihost(f"127.0.0.1:{spec['port']}", spec["processes"], rank)
        resumes = times.setdefault("resume_ts", [])

        def on_log(msg):
            if msg.startswith("resuming streamed descent"):
                resumes.append(time.time())

        fit = fit_streamed(host, game_config(effects, 2), dev, on_log=on_log, multihost=True,
                           checkpoint_dir=os.path.join(work, "ckpt"), checkpoint_every_n_visits=len(effects) + 1,
                           sharded_checkpoints=False)
        np.savez(os.path.join(work, f"rejoin-rank{rank}.npz"),
                 **{cid: sub.coefficient_means.cpu().numpy() for cid, sub in fit["model"].models.items()})
        counters = REGISTRY.snapshot("p2p.")["counters"] | REGISTRY.snapshot("fleet.")["counters"]
        out.update(booted=boot, resumed_from=fit["trainer"].resumed_from, launches=fit["launches"],
                   wall_s=fit["wall_s"], fixed_objective_passes=fit["fixed_objective_passes"],
                   chunks=-(-host.num_rows // E_STREAM_CHUNK), counters={k: v["value"] for k, v in counters.items()},
                   times=dict(times))
    elif mode == "faults_descent":
        n, effects = spec["shape"][0], {k: tuple(v) for k, v in spec["shape"][1].items()}  # the parent's
        batch, _ = game_problem(dev, n, effects, seed=4)  # every row on every process (in memory)
        times = _stamp_fault_events(work, rank)
        initialize_multihost(f"127.0.0.1:{spec['port']}", spec["processes"], rank)
        mesh = process_mesh(1, devices=[dev])
        anchor, chaos = os.path.join(work, "anchor"), os.path.join(work, "chaos")
        descent, seq = degradable_descent(batch, effects, mesh)
        descent.run(seq, 1, checkpoint_dir=anchor, checkpoint_fingerprint="e-descent-p2")
        if rank == 0:
            shutil.copytree(anchor, chaos)
        sync_processes("faults-descent-anchor")
        # the resumed run, with process 1's first owner-segment combine send killed
        mh._reset_host_links()
        faults.reset()
        os.environ["PHOTON_FAULT_PLAN"] = json.dumps(spec["plan"])
        REGISTRY.reset("p2p.")
        REGISTRY.reset("fleet.")
        fused.reset_launch_counts()
        st.reset_launch_counts()
        descent, seq = degradable_descent(batch, effects, mesh)
        t0 = time.perf_counter()
        res = descent.run(seq, 2, checkpoint_dir=chaos, checkpoint_fingerprint="e-descent-p2")
        torch.cuda.synchronize()
        times["end_t"] = time.time()
        np.savez(os.path.join(work, f"chaos-rank{rank}.npz"),
                 **{cid: sub.coefficient_means.cpu().numpy() for cid, sub in res.model.models.items()})
        counters = REGISTRY.snapshot("p2p.")["counters"] | REGISTRY.snapshot("fleet.")["counters"]
        out.update(iterations_recorded=len(res.trackers["fixed"]), wall_s=time.perf_counter() - t0,
                   launches=launch_counts(), counters={k: v["value"] for k, v in counters.items()},
                   fixed_objective_passes=sum(t.objective_passes for t in res.trackers["fixed"]),
                   times=dict(times))
    elif mode == "native_read_parity":  # host only
        out.update(native_read_parity(spec["data_work"], GAME_CLI["effects"]))
    else:
        raise ValueError(f"unknown child mode {mode!r}")
    shutdown_multihost()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    if mode.startswith("faults_"):
        # a degraded survivor leaves at once: nothing may wait on the dead peer at exit
        sys.stdout.flush()
        os._exit(0)
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
    n, effects = E_ML10M
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
        kids = run_children("e_multihost", work, {"local_shards": E_SHARDS // 2, "shape": E_ML10M}, dev)
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


def run_e_multihost_re_shard(dev, e_multi: dict, card: str) -> dict:
    """main_e_multihost_re_shard: main_e_multihost's layout (two processes
    x 2 local shards, E's Newton schedule over 6 outer iterations, the
    first 2 a warm-up) with PHOTON_RE_SHARD=1 in both children, at E's
    bench depth (2^18 rows) to keep the smoke inside its time: the random
    effects in owned buckets, each whole bucket solved by the process the
    row-balanced plan gives it, on its first shard's device, and every
    bucket's rows, variances and diagnostics brought to every process by
    one host gather a visit; the fixed effect over the 4-shard mesh. Held
    to: the ranks bit for bit, train AUC >= 0.95 x the generating model's,
    K1 = 2 x passes in each process, and one per-user visit on identical
    offsets, owned across the processes against no mesh on the card, bit
    for bit (``owned_visit_bitwise``)."""
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="_e_multihost-", dir=ROOT)
    try:
        t0 = time.perf_counter()
        kids = run_children("e_multihost", work, {"local_shards": E_SHARDS // 2, "shape": E_BENCH, "quality": True},
                            dev, env={"PHOTON_RE_SHARD": "1"})
        wall = time.perf_counter() - t0
        arrays = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    visits = [c["re_visit"] for c in kids]
    return dict(
        card=card, n=E_BENCH[0], processes=2, local_shards=E_SHARDS // 2, phase_wall_s=wall,
        launches={k: sum(c["launches"][k] for c in kids) for k in launch_counts()},
        timed_wall_s_per_outer_iteration=max(c["timed_wall_s_per_outer_iteration"] for c in kids),
        timed_wall_s_per_visit=[c["timed_wall_s_per_visit"] for c in kids],
        main_e_multihost_n=E_ML10M[0],
        main_e_multihost_timed_wall_s_per_outer_iteration=e_multi["timed_wall_s_per_outer_iteration"],
        exchange_per_visit=[c["exchange_per_visit"] for c in kids], re_shard=[c["re_shard"] for c in kids],
        peak_device_bytes=[c["peak_device_bytes"] for c in kids], quality=kids[0]["quality"],
        models_bitwise_equal_across_ranks=all(arrays[0][c].tobytes() == arrays[1][c].tobytes() for c in arrays[0]),
        k1_launches_ok=all(c["launches"]["fused_value_grad"] == (E_SHARDS // 2) * c["fixed_objective_passes"] > 0
                           for c in kids),
        owned_visit=visits, owned_visit_bitwise=all(v["bitwise"] for v in visits),
    )


# main_e_multihost_re_split's arms, each child running them in turn under
# PHOTON_RE_SHARD=1 (the first the knob-off twin). At 4 and 8 no capacity
# class of E passes the row cap (the heaviest class is one entity with 38%
# of the rows); 16 splits two classes a coordinate by rows.
RE_SPLIT_ARMS = {
    "off": {}, "split": {"PHOTON_RE_SPLIT": "16"},
    "split_bytes": {"PHOTON_RE_SPLIT": "16", "PHOTON_RE_SPLIT_WEIGHT": "bytes"},
    "segments": {"PHOTON_RE_COMBINE": "segments"}, "device_split": {"PHOTON_RE_DEVICE_SPLIT": "1"},
}
RE_SPLIT_STREAMED_ARMS = {"off": {}, "split_device": {"PHOTON_RE_SPLIT": "16", "PHOTON_RE_DEVICE_SPLIT": "1"}}


def _re_split_telemetry() -> dict:
    """A child's placement and device gauges and its owned combines' bytes
    and seconds (the registry's ``re_combine.*`` and the dense combine's
    own books) since they were reset."""
    snap = REGISTRY.snapshot()
    return dict(
        re_shard={k: v for k, v in snap["gauges"].items() if k.startswith("re_shard.")},
        re_combine=dict(counters={k: v["value"] for k, v in snap["counters"].items() if k.startswith("re_combine.")},
                        timers=REGISTRY.timer_snapshot("re_combine."),
                        gauges={k: v for k, v in snap["gauges"].items() if k.startswith("re_combine.")},
                        seconds=game_random_effect.combine_stats["seconds"],
                        calls=game_random_effect.combine_stats["calls"]))


def _arms_against_twin(work: str, arms, cids, processes: int, rtol: float, atol: float) -> dict:
    """Each arm's models (``work/<arm>-rank<r>.npz``): whether the ranks
    agree bit for bit, and against the ``off`` twin whether bitwise, within
    (rtol, atol), and the largest difference."""
    got = {arm: [dict(np.load(os.path.join(work, f"{arm}-rank{r}.npz"))) for r in range(processes)] for arm in arms}
    out = {}
    for arm in arms:
        a, off = got[arm][0], got["off"][0]
        out[arm] = dict(
            ranks_bitwise=all(x[c].tobytes() == a[c].tobytes() for x in got[arm] for c in cids),
            bitwise_vs_off=all(a[c].tobytes() == off[c].tobytes() for c in cids),
            within_tolerance_vs_off=all(np.allclose(a[c], off[c], rtol=rtol, atol=atol) for c in cids),
            max_abs_diff_vs_off={c: float(np.abs(a[c] - off[c]).max()) for c in cids})
    return out


def run_e_multihost_re_split(dev, card: str) -> dict:
    """main_e_multihost_re_split (the module docstring, phase 12): the
    12d-iii knobs in memory, every arm against its knob-off twin in the
    same pair of children."""
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="_e_re_split-", dir=ROOT)
    try:
        t0 = time.perf_counter()
        kids = run_children("e_re_split", work, {"local_shards": E_SHARDS // 2, "shape": E_BENCH}, dev,
                            env={"PHOTON_RE_SHARD": "1"})
        wall = time.perf_counter() - t0
        cids = ["fixed", *(f"per_{k}" for k in E_BENCH[1])]
        models = _arms_against_twin(work, RE_SPLIT_ARMS, cids, 2, 1e-2, 2e-3)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    arms = {}
    for arm in RE_SPLIT_ARMS:
        rows = [c["arms"][arm] for c in kids]
        arms[arm] = dict(
            models[arm],
            timed_wall_s_per_outer_iteration=max(r["timed_wall_s_per_outer_iteration"] for r in rows),
            timed_wall_s_per_visit=[r["timed_wall_s_per_visit"] for r in rows],
            combine_bytes_sent=[r["re_combine"]["counters"].get("re_combine.bytes_sent", 0.0) for r in rows],
            combine_exchanges=[r["re_combine"]["counters"].get("re_combine.exchanges", 0.0) for r in rows],
            combine_seconds=[r["re_combine"]["seconds"] for r in rows],
            combine_exchange_s=[r["re_combine"]["timers"].get("re_combine.exchange_s", {}).get("seconds")
                                for r in rows],
            combine_wait_s=[r["re_combine"]["timers"].get("re_combine.wait_s", {}).get("seconds") for r in rows],
            combine_overlap_ratio=[r["re_combine"]["gauges"].get("re_combine.overlap_ratio") for r in rows],
            re_shard=[{k.removeprefix("re_shard."): v for k, v in r["re_shard"].items()
                       if k.split(".")[1] in ("balance", "atoms", "split_classes", "devices", "device_balance")}
                      for r in rows],
            launches={k: sum(r["launches"][k] for r in rows) for k in launch_counts()},
            k1_launches_ok=all(r["launches"]["fused_value_grad"] == (E_SHARDS // 2) * r["fixed_objective_passes"] > 0
                               for r in rows))
    seg, off = arms["segments"], arms["off"]
    return dict(
        card=card, n=E_BENCH[0], processes=2, local_shards=E_SHARDS // 2, phase_wall_s=wall, arms=arms,
        launches={k: sum(a["launches"][k] for a in arms.values()) for k in launch_counts()},
        ranks_bitwise=all(a["ranks_bitwise"] for a in arms.values()),
        bitwise_where_promised=seg["bitwise_vs_off"] and arms["device_split"]["bitwise_vs_off"],
        split_within_lane_tolerance=all(arms[a]["within_tolerance_vs_off"] for a in ("split", "split_bytes")),
        segments_fewer_bytes=all(0 < s_ < o_ for s_, o_ in zip(seg["combine_bytes_sent"], off["combine_bytes_sent"])),
        split_placed=all(r["split_classes"] > 0 for r in arms["split"]["re_shard"]),
        device_split_placed=all(r.get("devices") == 2.0 for r in arms["device_split"]["re_shard"]),
        k1_launches_ok=all(a["k1_launches_ok"] for a in arms.values()),
    )


def run_e_streamed_multihost_re_split(dev, card: str) -> dict:
    """main_e_streamed_multihost_re_split (the module docstring, phase
    15e'): the split and the device split out of core, against the knob-on
    twin in the same pair of children."""
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="_e_streamed_re_split-", dir=ROOT)
    try:
        t0 = time.perf_counter()
        kids = run_children("e_streamed_re_split", work, {"shape": E_BENCH, "chunk_rows": E_STREAM_CHUNK}, dev,
                            env={"PHOTON_RE_SHARD": "1"})
        wall = time.perf_counter() - t0
        cids = ["fixed", *(f"per_{k}" for k in E_BENCH[1])]
        models = _arms_against_twin(work, RE_SPLIT_STREAMED_ARMS, cids, 2, 5e-3, 1e-3)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    arms = {}
    for arm in RE_SPLIT_STREAMED_ARMS:
        rows = [c["arms"][arm] for c in kids]
        arms[arm] = dict(
            models[arm], timed_wall_s_per_outer_iteration=max(r["iteration_wall_s"][1] for r in rows),
            iteration_wall_s=[r["iteration_wall_s"] for r in rows],
            re_shard=[{k.removeprefix("re_shard."): v for k, v in r["re_shard"].items()
                       if k.split(".")[1] in ("balance", "atoms", "split_classes", "devices", "device_balance")}
                      for r in rows],
            launches={k: sum(r["launches"][k] for r in rows) for k in launch_counts()},
            k1_launches_ok=all(r["fixed_objective_passes"] > 0
                               and r["launches"]["fused_value_grad"] == r["chunks"] * r["fixed_objective_passes"]
                               for r in rows))
    on = arms["split_device"]
    return dict(
        card=card, n=E_BENCH[0], processes=2, phase_wall_s=wall, arms=arms,
        launches={k: sum(a["launches"][k] for a in arms.values()) for k in launch_counts()},
        ranks_bitwise=all(a["ranks_bitwise"] for a in arms.values()),
        split_within_tolerance=on["within_tolerance_vs_off"],
        placed=all(r["split_classes"] > 0 and r.get("devices") == 2.0 for r in on["re_shard"]),
        k1_launches_ok=all(a["k1_launches_ok"] for a in arms.values()),
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


def fit_streamed(data: StreamedGameData, config: GameTrainingConfig, dev, on_mark=None, on_log=None,
                 before_fit=None, **trainer_kw) -> dict:
    """``StreamedGameTrainer.fit`` (chunks of ``E_STREAM_CHUNK`` rows, and
    ``trainer_kw``) with every kernel's launch count, the chunk cache and
    the copy counters zeroed just before and read just after. The trainer's
    logger marks the end of every visit (each mark synchronizes the card,
    then calls ``on_mark``, and ``on_log`` with the line); per visit: wall,
    scalar read-backs, cache hits and misses, bytes copied, and the
    trainer's own visit record. ``before_fit(trainer)`` runs before the
    fit (a recovery's resume fingerprints)."""
    marks = []

    def mark(msg: str) -> None:
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), msg, reads[0], prefetch.cache_stats(), dict(prefetch.copied)))
        if on_mark is not None:
            on_mark()
        if on_log is not None:
            on_log(msg)

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
        if before_fit is not None:
            before_fit(trainer)
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

    acts = [ProfilerActivity.CUDA]  # the card's activity alone, as profile_e
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
    mem = fit_game(batch, game_config(E_ML10M[1], 2), dev)
    return host, dict(_game_record(mem), **game_quality(mem, batch, data), to_host_s=to_host_s)


def run_e_streamed(dev, host: StreamedGameData, mem: dict, e_rec: dict, card: str) -> dict:
    """main_e_streamed: config E at MovieLens-10M depth (main_e's rows, seed
    4) out of core from host numpy: 2 outer iterations of
    ``StreamedGameTrainer`` in chunks of 2^20 rows (the fixed effect
    streamed through K1, the random effects' buckets gathered on the host
    every visit), held to the in-memory fit ``mem`` of the same
    configuration on the same rows (``e_streamed_reference``)."""
    n, effects = E_ML10M
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
    del fit
    torch.cuda.empty_cache()
    rec["profile"] = profile_streamed(host, config, dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    rec["k1_at_chunk"] = k1_at(first_chunk, 0.1 * torch.randn(E_STREAM_CHUNK, generator=gen, device=dev),
                               first_labels, dev)
    prefetch.clear_cache()
    return rec


def _visit_exchanges(visits: list) -> list:
    """Each random-effect visit's offset and score exchanges (seconds,
    bytes sent, and under PHOTON_RE_SHARD the seconds the consumer blocked)
    and its host gather seconds."""
    keys = ("offsets_exchange_s", "offsets_exchange_bytes", "scores_exchange_s", "scores_exchange_bytes", "gather_s",
            "offsets_wait_s", "scores_wait_s")  # the blocked seconds: the overlapped schedule only
    return [dict(iteration=v["iteration"], coordinate=v["coordinate"], **{k: v[k] for k in keys if k in v})
            for v in visits if "offsets_exchange_s" in v]


# -- main_faults: peer loss and recovery (ROADMAP 12d-v-a) -----------------------------
# the fault knobs of every fault child (the drills' timing: detection in
# retries x (backoff + timeout), a roll call of 2 s)
FAULT_ENV = {"PHOTON_P2P_CRC": "1", "PHOTON_P2P_RETRIES": "2", "PHOTON_P2P_BACKOFF_S": "0.1",
             "PHOTON_P2P_TIMEOUT_S": "3", "PHOTON_ROLLCALL_WINDOW_S": "2"}
FAULT_LAST_COORDINATE = f"per_{list(E_BENCH[1])[-1]}"
FAULT_CHILD_TIMEOUT_S = 150  # each fault child pair's own limit
# the two fault pairs run at once: two host threads a child keep the four
# children and this process inside the host's cores, so that no peer's
# compute outlasts the mesh's 3 s timeout and passes for a loss
FAULT_CHILD_THREADS = {"OMP_NUM_THREADS": "2"}
# main_faults' rejoin pair, beside the two others: one host thread a child,
# the rejoiner re-exec'd about 1 s after its death, and a wait at the first
# boundary after the degrade long enough for its start on the card
REJOIN_CHILD_ENV = {"OMP_NUM_THREADS": "1", "PHOTON_REJOIN": "1", "PHOTON_REJOIN_WINDOW_S": "30"}
REJOIN_DELAY_S = 1.0


def _stamp_fault_events(work: str, rank: int) -> dict:
    """Wall-clock stamps of the recovery's steps in this process (the
    processes share the host's clock): a ``kill`` or ``rejoin`` spec's
    firing, written to ``work/kill.json`` before the process dies, and, on
    a survivor, the start of the loss's confirmation and the roll call's
    end; with rejoin, the first probe for returning processes and the
    rejoin roll call's start and end, and on the rejoiner the invite's
    arrival. The returned dict fills in place."""
    times: dict = {}
    apply, confirm, roll = faults.apply_send_fault, mh.confirm_peer_loss, mh.roll_call
    probe, wait = mh.probe_rejoiners, mh.rejoin_wait

    def stamped_probe(*a, **k):
        times.setdefault("first_probe_t", time.time())
        return probe(*a, **k)

    def stamped_wait(*a, **k):
        out = wait(*a, **k)
        times.setdefault("invited_t", time.time())
        return out

    def stamped_apply(spec, frames, sock):
        if spec.op in ("kill", "rejoin"):
            with open(os.path.join(work, "kill.json"), "w") as f:
                json.dump({"t": time.time(), "rank": rank, "tag": spec.tag, "seq": spec.seq}, f)
        return apply(spec, frames, sock)

    def stamped_confirm(err):
        times.setdefault("confirm_t", time.time())
        return confirm(err)

    def stamped_roll(*a, **k):
        if k.get("candidates") is not None:  # a rejoin roll call
            times.setdefault("rejoin_rollcall_start_t", time.time())
            out = roll(*a, **k)
            times.setdefault("rejoin_rollcall_end_t", time.time())
            return out
        out = roll(*a, **k)
        times.setdefault("rollcall_end_t", time.time())
        return out

    faults.apply_send_fault, mh.confirm_peer_loss, mh.roll_call = stamped_apply, stamped_confirm, stamped_roll
    mh.probe_rejoiners, mh.rejoin_wait = stamped_probe, stamped_wait
    return times


def _anchor_logger(rec: dict, ckpt: str, anchor_dir: str, rank: int):
    """The trainer log hook of main_faults' healthy armed arm: at the end of
    outer iteration 0 it records the frame sets this process sent to
    process 0 (the kill plan names the next), and at the end of the first
    visit of iteration 1, process 0 copies the checkpoint then on disk, the
    one after iteration 0 (next visit (1, 0)), to ``anchor_dir``."""

    def on_log(msg: str) -> None:
        if msg.startswith(f"iter 0 coordinate {FAULT_LAST_COORDINATE}"):
            rec["seq_after_iteration_0"] = mh._LINK_SEQ["send"].get(0, 0)
        elif msg.startswith("iter 1 coordinate fixed") and rank == 0 and "anchor" not in rec:
            os.makedirs(anchor_dir, exist_ok=True)
            shutil.copy(os.path.join(ckpt, "ckpt.npz"), os.path.join(anchor_dir, "ckpt.npz"))
            rec["anchor"] = True

    return on_log


def degradable_descent(batch, effects: dict, mesh=None) -> tuple[CoordinateDescent, list]:
    """Config E's coordinates (``game_config``) as an in-memory descent
    that can degrade in place: the fixed effect solved whole on each
    process (no mesh: K1 over every row, the same bits on each), each random
    effect over ``mesh`` (owned buckets under ``PHOTON_RE_SHARD=1``), or
    over no mesh for the one-process arm. Returns the descent and its
    update sequence."""
    cfg = game_config(effects, 1)
    coords = {"fixed": FixedEffectCoordinate(
        coordinate_id="fixed", batch=batch, feature_shard_id="global",
        config=cfg.fixed_effect_coordinates["fixed"].optimization, task_type=cfg.task_type,
        intercept_index=D_FIXED)}
    for cid, c in cfg.random_effect_coordinates.items():
        ids = batch.id_tags[c.random_effect_type].cpu().numpy()
        grouping = group_by_entity(ids, num_entities=int(ids.max()) + 1)
        coords[cid] = RandomEffectCoordinate(
            coordinate_id=cid, batch=batch, feature_shard_id=c.feature_shard_id,
            random_effect_type=c.random_effect_type, config=c.optimization, grouping=grouping,
            buckets=bucket_entities(grouping, c.sample_bucket_sizes, target_buckets=c.bucket_target_count,
                                    max_padded_ratio=c.bucket_max_padded_ratio),
            task_type=cfg.task_type, num_entities=grouping.num_entities, mesh=mesh)
    return CoordinateDescent(coords, batch, cfg.task_type), list(cfg.coordinate_update_sequence)


def _recovery_seconds(times: dict, kill_t: float, end_key: str) -> dict:
    return dict(kill_to_confirm_s=times["confirm_t"] - kill_t,
                confirm_to_rollcall_end_s=times["rollcall_end_t"] - times["confirm_t"],
                kill_to_rollcall_end_s=times["rollcall_end_t"] - kill_t,
                rollcall_end_to_resume_s=times[end_key] - times["rollcall_end_t"])


def run_faults(dev, card: str, ring: dict, anchor: str) -> dict:
    """main_faults: peer loss and recovery on the card, config E at bench
    depth (``E_STREAMED_PAIR``, seed 4) in pairs of children, with
    ``FAULT_ENV`` (2 retries, a 2 s roll call) and ``PHOTON_RE_SHARD=1``.

    1. The ring on a healthy group (``ring``, from main_e_streamed_multihost's
       children: their ``armed`` arm, CRC and the reliable mode armed and no
       plan, held bitwise to the knob-unset ``on`` arm of 15e; the armed arm
       checkpointed once an outer iteration, its checkpoint after iteration
       0 is ``anchor``, and it counted the frame sets process 1 sent to
       process 0 in iteration 0).
    2. The streamed peer kill: a pair fits 2 outer iterations with process 1
       killed at its first offsets send of iteration 1 (link 1->0, the next
       frame set). The survivor resumes at (1, 0), its ``fleet.peer_lost``,
       ``fleet.recoveries`` and ``p2p.giveups`` each 1, and its model is
       bitwise one process's fit over its rows resumed from the anchor (run
       here, with the anchor's fingerprint and row base 0).
    3. The descent's degrade in place: a pair runs the in-memory descent of
       ``degradable_descent`` (``PHOTON_RE_COMBINE=segments``,
       ``PHOTON_DESCENT_DEGRADE=1``) for one outer iteration (the anchor),
       then resumed for the second with process 1 killed at its first
       owner-segment combine send. ``run`` returns on the survivor,
       ``fleet.degraded_descents`` 1, its model bitwise one process's
       descent (no mesh) resumed from the anchor here.
    4. Elastic rejoin (``PHOTON_REJOIN=1``, the mesh cache in the pair's
       directory): 2.'s pair and plan with the op ``rejoin``: process 1
       dies at its first offsets send of iteration 1 and re-execs
       ``REJOIN_DELAY_S`` later as a rejoin boot, on the card; process 0
       degrades, re-enters and, at the first visit boundary, waits for
       it, invites it and runs the rejoin roll call; both resume from the
       checkpoint after iteration 0. Both final models bitwise the armed
       pair's of 1. (the uninterrupted two-process run, saved by
       ``run_e_streamed_multihost`` beside the anchor), ``fleet.rejoins``
       1 on both, the survivor's ``fleet.peer_lost`` and
       ``fleet.recoveries`` 1, K1 = chunks x passes on the rejoined
       process.

    The pairs of 2., 3. and 4. run at once, each on its own port, and the
    streamed clean arm runs in this process meanwhile (so each pair's
    ``phase_wall_s`` counts from their common start to its end, and the
    recovery seconds are taken beside the other pairs' work). Every fault
    child pair has a limit of its own, and only process 1 may die, with
    137. It prints the seconds from the kill to the roll call's end and
    from there to the resumed visit (2) and the re-run iteration's end
    (3); for 4., kill → confirm, confirm → the degrade roll call's end,
    the re-entry, the wait for the rejoiner, the rejoin roll call and the
    resumed visit."""
    n, effects = E_STREAMED_PAIR
    spec = {"shape": [n, effects], "chunk_rows": E_STREAM_CHUNK}
    cids = ["fixed", *(f"per_{k}" for k in effects)]
    rec: dict = dict(card=card, n=n, processes=2, knobs=FAULT_ENV, ring=ring)
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="_faults-", dir=ROOT)
    try:
        # the two pairs run at once, each on its own port (2. and 3.); the
        # streamed clean arm runs here meanwhile
        plan = [{"op": "kill", "link": [1, 0], "seq": ring["frame_sets_iteration_0"] + 1, "tag": "offsets"}]
        dplan = [{"op": "kill", "link": [1, 0], "seq": 1, "tag": "re_combine/wv"}]
        t0 = time.perf_counter()
        kill_kids = start_children("faults_kill", os.path.join(work, "kill"), spec, dev,
                                   env=dict(FAULT_ENV, **FAULT_CHILD_THREADS, PHOTON_RE_SHARD="1",
                                            PHOTON_FAULT_PLAN=json.dumps(plan)),
                                   allow_kill=(1,), timeout_s=FAULT_CHILD_TIMEOUT_S)
        desc_kids = start_children("faults_descent", os.path.join(work, "descent"), dict(spec, plan=dplan), dev,
                                   env=dict(FAULT_ENV, **FAULT_CHILD_THREADS, PHOTON_RE_SHARD="1",
                                            PHOTON_RE_COMBINE="segments", PHOTON_DESCENT_DEGRADE="1"),
                                   allow_kill=(1,), timeout_s=FAULT_CHILD_TIMEOUT_S)
        rplan = [dict(plan[0], op="rejoin", delay_s=REJOIN_DELAY_S)]
        rejoin_kids = start_children("faults_rejoin", os.path.join(work, "rejoin"), spec, dev,
                                     env=dict(FAULT_ENV, **REJOIN_CHILD_ENV, PHOTON_RE_SHARD="1",
                                              PHOTON_MESH_CACHE=os.path.join(work, "rejoin", "mesh.json"),
                                              PHOTON_FAULT_PLAN=json.dumps(rplan)),
                                     allow_kill=(1,), timeout_s=FAULT_CHILD_TIMEOUT_S, rejoin=True)
        try:
            batch, _ = game_problem(dev, n, effects, seed=4)
            host = streamed_game_data(batch, slice(0, n // 2))  # the survivor's rows
            del batch
            fp = peek_fingerprint(anchor)

            def resume_from_anchor(trainer):
                trainer.resume_fingerprints, trainer.resume_row_base = [fp], 0

            clean = fit_streamed(host, game_config(effects, 2), dev, before_fit=resume_from_anchor,
                                 checkpoint_dir=anchor, checkpoint_every_n_visits=len(effects) + 1)
            clean_w = {cid: sub.coefficient_means.cpu().numpy() for cid, sub in clean["model"].models.items()}
            clean_objective_passes = clean["fixed_objective_passes"]
            clean_resumed_from = list(clean["trainer"].resumed_from or ())
            clean_launches = clean["launches"]
            del clean, host
            prefetch.clear_cache()
        finally:
            surv = join_children(kill_kids)[0]
            chaos_wall = time.perf_counter() - t0
            desc = join_children(desc_kids)
            desc_wall = time.perf_counter() - t0
            rejoined = join_children(rejoin_kids)
            rejoin_wall = time.perf_counter() - t0
        # 2. the streamed peer kill
        with open(os.path.join(work, "kill", "kill.json")) as f:
            kill = json.load(f)
        survivor = dict(np.load(os.path.join(work, "kill", "kill-rank0.npz")))
        rec["streamed_kill"] = dict(
            phase_wall_s=chaos_wall, plan=plan, killed=kill, resumed_from=surv["resumed_from"],
            counters=surv["counters"], clean_resumed_from=clean_resumed_from,
            bitwise_vs_clean={c: survivor[c].tobytes() == clean_w[c].tobytes() for c in cids},
            max_abs_diff_vs_clean={c: float(np.max(np.abs(survivor[c] - clean_w[c]))) for c in cids},
            **_recovery_seconds(surv["times"], kill["t"], "resume_t"),
            launches={k: surv["launches"][k] + clean_launches[k] for k in launch_counts()},
            clean_launches=clean_launches, survivor_launches=surv["launches"],
            k1_launches_ok=clean_launches["fused_value_grad"] == (-(-(n // 2) // E_STREAM_CHUNK)
                                                                  * clean_objective_passes))

        # 3. the descent's degrade in place
        with open(os.path.join(work, "descent", "kill.json")) as f:
            dkill = json.load(f)
        dsurv = dict(np.load(os.path.join(work, "descent", "chaos-rank0.npz")))
        batch, _ = game_problem(dev, n, effects, seed=4)
        fused.reset_launch_counts()
        st.reset_launch_counts()
        descent, seq_ids = degradable_descent(batch, effects)
        res = descent.run(seq_ids, 2, checkpoint_dir=os.path.join(work, "descent", "anchor"),
                          checkpoint_fingerprint="e-descent-p1", resume_fingerprints=["e-descent-p2"])
        torch.cuda.synchronize()
        dclean = {cid: sub.coefficient_means.cpu().numpy() for cid, sub in res.model.models.items()}
        dlaunch = launch_counts()
        del batch, descent, res
        torch.cuda.empty_cache()
        rec["descent_degrade"] = dict(
            phase_wall_s=desc_wall, plan=dplan, killed=dkill, counters=desc[0]["counters"],
            iterations_recorded=desc[0]["iterations_recorded"],
            bitwise_vs_clean={c: dsurv[c].tobytes() == dclean[c].tobytes() for c in cids},
            max_abs_diff_vs_clean={c: float(np.max(np.abs(dsurv[c] - dclean[c]))) for c in cids},
            **_recovery_seconds(desc[0]["times"], dkill["t"], "end_t"),
            launches={k: desc[0]["launches"][k] + dlaunch[k] for k in launch_counts()},
            survivor_launches=desc[0]["launches"], clean_launches=dlaunch,
            k1_launches_ok=desc[0]["launches"]["fused_value_grad"] > 0 and dlaunch["fused_value_grad"] > 0)
        # 4. elastic rejoin
        with open(os.path.join(work, "rejoin", "kill.json")) as f:
            rkill = json.load(f)
        final = [dict(np.load(os.path.join(work, "rejoin", f"rejoin-rank{r}.npz"))) for r in range(2)]
        whole = [dict(np.load(os.path.join(os.path.dirname(anchor), f"uninterrupted-rank{r}.npz")))
                 for r in range(2)]
        survivor, rejoiner = rejoined
        rec["rejoin"] = dict(
            phase_wall_s=rejoin_wall, plan=rplan, killed=rkill, booted=[r["booted"] for r in rejoined],
            resumed_from=[r["resumed_from"] for r in rejoined], counters=[r["counters"] for r in rejoined],
            bitwise_vs_uninterrupted={f"{c}[{r}]": final[r][c].tobytes() == whole[r][c].tobytes()
                                      for r in range(2) for c in cids},
            max_abs_diff_vs_uninterrupted={f"{c}[{r}]": float(np.max(np.abs(final[r][c] - whole[r][c])))
                                           for r in range(2) for c in cids},
            **_rejoin_seconds(survivor["times"], rejoiner["times"], rkill["t"]),
            launches={k: survivor["launches"][k] + rejoiner["launches"][k] for k in launch_counts()},
            survivor_launches=survivor["launches"], rejoiner_launches=rejoiner["launches"],
            k1_launches_ok=survivor["launches"]["fused_value_grad"] > 0 and rejoiner["fixed_objective_passes"] > 0
            and rejoiner["launches"]["fused_value_grad"] == rejoiner["chunks"] * rejoiner["fixed_objective_passes"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the phase's launches: the armed ring arm, the survivor and clean fits of 2, the descent's, the rejoin pair's
    rec["launches"] = {k: ring["launches"][k] + rec["streamed_kill"]["launches"][k]
                       + rec["descent_degrade"]["launches"][k] + rec["rejoin"]["launches"][k]
                       for k in launch_counts()}
    return rec


def _rejoin_seconds(survivor: dict, rejoiner: dict, kill_t: float) -> dict:
    """The rejoin's steps on the host's clock: the loss's detection and
    roll call (as ``_recovery_seconds``), the re-entry under the degraded
    group to its first probe, the wait from there to the rejoin roll
    call's start (the invite included), that roll call, and from its end to
    the resumed visit; the rejoiner's start after the kill and its start to
    the invite."""
    return dict(kill_to_confirm_s=survivor["confirm_t"] - kill_t,
                confirm_to_rollcall_end_s=survivor["rollcall_end_t"] - survivor["confirm_t"],
                rollcall_end_to_first_probe_s=survivor["first_probe_t"] - survivor["rollcall_end_t"],
                linger_s=survivor["rejoin_rollcall_start_t"] - survivor["first_probe_t"],
                rejoin_rollcall_s=survivor["rejoin_rollcall_end_t"] - survivor["rejoin_rollcall_start_t"],
                rejoin_rollcall_end_to_resume_s=survivor["resume_ts"][-1] - survivor["rejoin_rollcall_end_t"],
                kill_to_rejoiner_start_s=rejoiner["started_t"] - kill_t,
                rejoiner_start_to_invite_s=rejoiner["invited_t"] - rejoiner["started_t"],
                kill_to_resume_s=survivor["resume_ts"][-1] - kill_t)


# main_e_streamed_multihost and its PHOTON_RE_SHARD=1 twin run at bench
# depth (to keep the smoke in its time), held to a one-process fit there
E_STREAMED_PAIR = E_BENCH


def e_streamed_one_process(dev) -> tuple[dict, GameModel]:
    """The one-process twin of main_e_streamed_multihost at its depth
    (``E_STREAMED_PAIR``'s rows, seed 4, out of core in one process, 2
    outer iterations, chunks of ``E_STREAM_CHUNK`` rows): its record (train
    AUC, fixed objective, wall per outer iteration, peak device bytes) and
    its model, which the two-process arms are held to."""
    n, effects = E_STREAMED_PAIR
    batch, _ = game_problem(dev, n, effects, seed=4)
    host = streamed_game_data(batch)
    del batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fit = fit_streamed(host, game_config(effects, 2), dev)
    peak = torch.cuda.max_memory_allocated(dev)
    scores = score_streamed(fit["model"], host, dev)
    auc = float(auc_roc(scores, torch.as_tensor(host.labels, device=dev)))
    prefetch.clear_cache()
    return dict(n=n, train_auc=auc, fixed_objective=fit["info"]["fixed"].final_loss,
                iteration_wall_s=fit["iteration_wall_s"], timed_wall_s_per_outer_iteration=fit["iteration_wall_s"][1],
                peak_device_bytes=peak, launches=fit["launches"],
                fixed_objective_passes=fit["fixed_objective_passes"]), fit["model"]


def run_e_streamed_multihost(dev, one: dict, one_model: GameModel, card: str,
                             anchor_dir: str) -> tuple[dict, dict, dict]:
    """main_e_streamed_multihost and main_e_streamed_multihost_re_shard
    (phases 15d, 15e): config E at bench depth (``E_STREAMED_PAIR``, 2
    outer iterations, chunks of 2^20 rows) in two processes of this script
    on the card, each drawing the rows from the seed on the card and
    keeping one contiguous half on its host: ``StreamedGameTrainer(
    multihost=True)`` knob off, then with PHOTON_RE_SHARD=1, in the same
    pair of children (``phase_wall_s`` is the pair's). Knob off is held to
    the one-process fit ``one`` / ``one_model``
    (``e_streamed_one_process``), knob on to knob off (rtol 5e-3 / atol
    1e-3) and to ``one`` for AUC. A third arm, ``armed``, is main_faults'
    ring on a healthy group: the knob-on fit with CRC and the reliable mode
    armed and no plan (``FAULT_ENV``), which checkpoints once an outer
    iteration and leaves its checkpoint after iteration 0 in ``anchor_dir``.
    Returns the two records and main_faults' ring record."""
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="_e_streamed_multihost-", dir=ROOT)
    arms = [["off", {}], ["on", {"PHOTON_RE_SHARD": "1"}], ["armed", dict(FAULT_ENV, PHOTON_RE_SHARD="1")]]
    try:
        t0 = time.perf_counter()
        kids = run_children("e_streamed_multihost", work, {"shape": E_STREAMED_PAIR, "chunk_rows": E_STREAM_CHUNK,
                                                           "arms": arms, "anchor_dir": anchor_dir}, dev)
        wall = time.perf_counter() - t0
        arrays = {arm: [dict(np.load(os.path.join(work, f"{arm}-rank{r}.npz"))) for r in range(2)] for arm, _ in arms}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cids = list(one_model.models)
    # the armed pair's models: the uninterrupted run main_faults' rejoin part is held to
    for r in range(2):
        np.savez(os.path.join(os.path.dirname(anchor_dir), f"uninterrupted-rank{r}.npz"),
                 **{c: arrays["armed"][r][c] for c in cids})
    recs = {}
    for arm, _ in arms[:2]:
        rows, got = [c["arms"][arm] for c in kids], arrays[arm]
        margins = torch.from_numpy(np.concatenate([a["margins"] for a in got])).to(dev)
        labels = torch.from_numpy(np.concatenate([a["labels"] for a in got])).to(dev)
        auc = float(auc_roc(margins, labels))
        del margins, labels
        random = {c: close(torch.from_numpy(got[0][c]).to(dev), one_model[c].coefficient_means, 1e-2, 2e-3)
                  for c in cids if c != "fixed"}
        fixed_objective = rows[0]["fixed_objective"]
        recs[arm] = dict(
            card=card, n=E_STREAMED_PAIR[0], processes=2, phase_wall_s=wall,
            launches={k: sum(r["launches"][k] for r in rows) for k in launch_counts()},
            rows=[r["rows"] for r in rows], chunks=[r["chunks"] for r in rows], data_s=[c["data_s"] for c in kids],
            wall_s=[r["wall_s"] for r in rows], iteration_wall_s=[r["iteration_wall_s"] for r in rows],
            timed_wall_s_per_outer_iteration=max(r["iteration_wall_s"][1] for r in rows),
            one_process_timed_wall_s_per_outer_iteration=one["timed_wall_s_per_outer_iteration"],
            visit_wall_s=[{f"{v['iteration']}/{v['coordinate']}": v["wall_s"] for v in r["visits"]} for r in rows],
            ingest_exchange={c: [r["exchange_totals"][f"ingest/{c}"] for r in rows] for c in cids if c != "fixed"},
            visit_exchanges=[_visit_exchanges(r["visits"]) for r in rows], collectives=[r["collectives"] for r in rows],
            fixed_objective_passes=[r["fixed_objective_passes"] for r in rows],
            peak_device_bytes=[r["peak_device_bytes"] for r in rows],
            one_process_peak_device_bytes=one["peak_device_bytes"],
            # at the arm's end (a child's getrusage peak starts at its parent's size at the fork)
            host_rss_bytes=[r["host"].get("rss_bytes") for r in rows],
            models_bitwise_equal_across_ranks=all(got[0][c].tobytes() == got[1][c].tobytes() for c in cids),
            train_auc=auc, d_auc_vs_one_process=abs(auc - one["train_auc"]), fixed_objective=fixed_objective,
            rel_d_fixed_objective_vs_one_process=abs(fixed_objective - one["fixed_objective"])
            / abs(one["fixed_objective"]),
            random_effects_within_lane_tolerance=all(ok for ok, _ in random.values()),
            max_abs_diff_random_effects_vs_one_process={c: err for c, (_, err) in random.items()},
            k1_launches_ok=all(r["fixed_objective_passes"] > 0
                               and r["launches"]["fused_value_grad"] == r["chunks"] * r["fixed_objective_passes"]
                               and not any(v for k, v in r["launches"].items() if k != "fused_value_grad")
                               for r in rows),
            **({"re_shard": [r["re_shard"] for r in rows]} if arm == "on" else {}),
        )
    off, on = recs["off"], recs["on"]
    on_w, off_w = arrays["on"][0], arrays["off"][0]
    random = {c: close(torch.from_numpy(on_w[c]).to(dev), torch.from_numpy(off_w[c]).to(dev), 5e-3, 1e-3)
              for c in cids if c != "fixed"}
    per_visit = [[{k: v[k] for k in ("offsets_exchange_s", "offsets_wait_s", "scores_exchange_s", "scores_wait_s",
                                     "gather_s")} for v in visits] for visits in on["visit_exchanges"]]
    on.update(
        knob_off_timed_wall_s_per_outer_iteration=off["timed_wall_s_per_outer_iteration"],
        knob_off_visit_exchanges=off["visit_exchanges"], visit_seconds=per_visit,
        random_effects_within_knob_off_tolerance=all(ok for ok, _ in random.values()),
        max_abs_diff_random_effects_vs_knob_off={c: err for c, (_, err) in random.items()},
        bitwise_equal_to_knob_off={c: on_w[c].tobytes() == off_w[c].tobytes() for c in cids},
        placement_ok=all(p["loads_are_global_rows"] and p == kid["placement"][c]
                         for kid in on["re_shard"] for c, p in on["re_shard"][0]["placement"].items()),
    )
    armed = [c["arms"]["armed"] for c in kids]
    ring = dict(
        bitwise_armed_vs_unset=all(arrays["armed"][r][c].tobytes() == arrays["on"][r][c].tobytes()
                                   for r in range(2) for c in cids),
        ranks_bitwise=all(arrays["armed"][0][c].tobytes() == arrays["armed"][1][c].tobytes() for c in cids),
        no_recovery_counters=all(not a["counters"] for a in armed),
        anchor_written=os.path.exists(os.path.join(anchor_dir, "ckpt.npz")),
        frame_sets_iteration_0=armed[1]["seq_after_iteration_0"],
        wall_s=[a["wall_s"] for a in armed], unset_wall_s=on["wall_s"],
        visit_exchanges=[_visit_exchanges(a["visits"]) for a in armed], unset_visit_exchanges=on["visit_exchanges"],
        launches={k: sum(a["launches"][k] for a in armed) for k in launch_counts()},
        k1_launches_ok=all(a["fixed_objective_passes"] > 0
                           and a["launches"]["fused_value_grad"] == a["chunks"] * a["fixed_objective_passes"]
                           for a in armed))
    return off, on, ring


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


# ---------------------------------------------------------------------------
# the tools and the run report: main_tools
# ---------------------------------------------------------------------------
TOOLS_BAGS = ("features", *GAME_CLI_BAGS.values())
# a wall tier that a baseline with its wall halved fails (the defaults,
# rel 1 and 10 s, pass it)
TIGHT_WALL = json.dumps({"wall_s": {"rel": 0.5, "abs": 0.0}})


def umbrella(argv: list[str]) -> tuple[int, str, float]:
    """One umbrella command in this process: its exit code (read from
    ``SystemExit``; 0 when it returns), its standard output, its seconds."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            cli_main.main(argv)
        code = 0
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    return code, buf.getvalue(), time.perf_counter() - t0


def run_tools(dev, data: GameCliData, card: str) -> dict:
    """main_tools: (a) ``name-term-bags`` and ``index-features`` over
    main_game_cli's training files, each timed alone, then its 2-iteration
    training command with ``--index-maps`` (K1 counted from 0), its files
    against ``out-2it``; (b) a ``NativeIndexStore`` of every shard map;
    (c) ``report`` over main_telemetry's GAME, score and fleet runs;
    (d) ``report gate`` and its baselines."""
    work, n_tr = data.work, data.n_train
    cfg2, train, val = (os.path.join(work, f) for f in ("config-2.json", "train", "val"))
    bags_dir, index_dir = os.path.join(work, "bags"), os.path.join(work, "index")
    tool_s, tool_codes = {}, {}
    with recording_native_index_passes() as native_passes:
        for argv in (["name-term-bags", "--data", train, "--bags", *TOOLS_BAGS, "--output-dir", bags_dir],
                     ["index-features", "--data", train, "--config", cfg2, "--output-dir", index_dir]):
            tool_codes[argv[0]], _, tool_s[argv[0]] = umbrella(argv)
    bags = {}
    for bag in TOOLS_BAGS:
        with open(os.path.join(bags_dir, f"{bag}.json")) as f:
            bags[bag] = len(json.load(f))
    with open(os.path.join(index_dir, "_sizes.json")) as f:
        sizes = json.load(f)
    maps = {fn[:-4]: IndexMap.load(os.path.join(index_dir, fn)) for fn in sorted(os.listdir(index_dir))
            if fn.endswith(".npz")}
    with open(os.path.join(bags_dir, "photon.log")) as f:
        # name-term-bags logs a fall-back to the Python codec
        tools_native = "Python codec" not in f.read() and native_passes == [GAME_CLI["parts"]]

    # (a) the 2-iteration command on the indexed maps, K1 counted from 0
    out = os.path.join(work, "out-indexed")
    with recording_fits() as fits:
        fused.reset_launch_counts()
        st.reset_launch_counts()
        torch.cuda.synchronize()
        code_train, _, train_s = umbrella(["train", "--config", cfg2, "--train-data", train, "--validation-data",
                                           val, "--output-dir", out, "--device", dev.type,
                                           "--index-maps", index_dir])
        torch.cuda.synchronize()
    launches = launch_counts()
    batch, results = fits[0]
    fixed_passes = sum(t.objective_passes for r in results for t in r.descent.trackers["fixed"])
    with open(os.path.join(out, "photon.log")) as f:
        loaded_maps = "loaded index maps" in f.read()
    ref, got = decoded_outputs(os.path.join(work, "out-2it")), decoded_outputs(out)
    extra_files = sorted(set(got) - set(ref))

    # (b) the native store of every shard map
    store = {}
    for sid, imap in maps.items():
        keys = [k for k, _ in imap.items()]
        t0 = time.perf_counter()
        s = NativeIndexStore.build(os.path.join(work, "stores", f"{sid}.pidx"), imap.items())
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        found = s.lookup_all(keys + ["\x00unknown\x01key"])
        lookup_s = time.perf_counter() - t0
        store[sid] = dict(keys=len(keys), build_s=build_s, lookup_s=lookup_s,
                          bytes=os.path.getsize(s.path),
                          ok=bool(np.array_equal(found[:-1], imap.lookup_all(np.array(keys))))
                          and found[-1] == -1 and s.get("\x00unknown\x01key") == -1 and s.size == imap.size)
        s.close()

    # (c) the report over main_telemetry's runs
    tel_game, tel_score = os.path.join(work, "telemetry-game"), os.path.join(work, "telemetry-score")
    fleet_dir = os.path.join(work, "game_streamed_multihost", "telemetry")
    runs = {"game": latest_run(tel_game), "score": latest_run(tel_score), "fleet": fleet_run_paths(fleet_dir)[0]}
    codes, seconds, summaries = {}, {}, {}

    def call(label: str, argv: list[str], expect: int) -> str:
        code, text, sec = umbrella(["report", *argv])
        codes[label], seconds[label] = [code, expect], sec
        return text

    trace = os.path.join(work, "game-trace.json")
    for name, path in runs.items():
        extra = ["--export-trace", trace] if name == "game" else []
        text = call(f"summary_{name}", [path, "--json", *extra], 0)
        summaries[name] = json.loads(text) if text.strip() else {}
    with open(trace) as f:
        trace_events = len(json.load(f)["traceEvents"])
    diff = call("diff", [runs["game"], "--diff", runs["score"]], 0)
    for name in runs:
        call(f"validate_{name}", ["validate", runs[name]], 0)
    fleet_text = call("fleet", ["fleet", fleet_dir], 0)
    fleet_json = call("fleet_json", ["fleet", fleet_dir, "--json"], 0)
    fleet_view = json.loads(fleet_json) if fleet_json.strip() else {}

    # (d) the gate: write, pass, fail against a halved wall; the same on the fleet
    gates_dir = os.path.join(work, "gate")
    os.makedirs(gates_dir, exist_ok=True)
    baselines = {}
    for kind, run, flags in (("run", runs["game"], []), ("fleet", fleet_dir, ["--fleet"])):
        base, doctored = (os.path.join(gates_dir, f"{kind}-{x}.json") for x in ("base", "halved"))
        call(f"gate_{kind}_write", ["gate", run, *flags, "--write-baseline", base], 0)
        call(f"gate_{kind}_pass", ["gate", run, *flags, "--baseline", base], 0)
        with open(base) as f:
            doc = json.load(f)
        wall_key = "wall_s" if kind == "run" else "fleet/wall_s"
        doc["metrics"][wall_key] /= 2
        with open(doctored, "w") as f:
            json.dump(doc, f)
        call(f"gate_{kind}_halved_default_tiers", ["gate", run, *flags, "--baseline", doctored], 0)
        call(f"gate_{kind}_halved_tight_wall", ["gate", run, *flags, "--baseline", doctored,
                                                "--thresholds", TIGHT_WALL], 1)
        call(f"gate_{kind}_update_and_verify", ["gate", run, *flags, "--baseline", base, "--write-baseline",
                                                os.path.join(gates_dir, f"{kind}-updated.json")], 0)
        baselines[kind] = dict(metrics=len(doc["metrics"]), wall_s=2 * doc["metrics"][wall_key])

    game, fleet_sum = summaries["game"], summaries["fleet"]
    compile_s = {name: summaries[name].get("compile_s") for name in runs}
    nbytes = {name: os.path.getsize(path) for name, path in runs.items()}
    gates = dict(
        exit_codes=all(got == want for got, want in codes.values()) and code_train == 0
        and all(c == 0 for c in tool_codes.values()),
        tools_on_the_native_decoder=tools_native,
        tool_outputs=bags == {"features": D_FIXED, **{GAME_CLI_BAGS[k]: w for k, (_, w) in data.effects.items()}}
        and sizes == {"global": D_FIXED + 1, **{f"per_{k}": w for k, (_, w) in data.effects.items()}}
        and set(maps) == set(sizes),
        train_read_the_maps=loaded_maps,
        outputs_bitwise_out_2it=bool(ref) and all(got.get(k) == v for k, v in ref.items()),
        no_extra_files=extra_files == [],
        store_lookups=bool(store) and all(r["ok"] for r in store.values()),
        game_phases={"ingest", "train", "descent"} <= set(game.get("phases", {})),
        fleet_run_phases={"game", "ingest", "descent"} <= set(fleet_sum.get("phases", {})),
        # the kernels were built before these runs: no cuda.build_s in them
        compile_s_zero_without_a_build=all(v == 0.0 for v in compile_s.values()),
        diff=all(os.path.basename(runs[k]) in diff for k in ("game", "score"))
        and all(any(line.split()[:1] == [row] for line in diff.splitlines()) for row in ("wall", "compile")),
        fleet_names_processes=sorted(fleet_view.get("processes", {})) == ["0", "1"]
        and " p0 " in fleet_text and " p1 " in fleet_text,
        trace=trace_events > 0,
    )
    rows_s = {name: 1e3 * s / n_tr for name, s in tool_s.items()}
    return dict(
        card=card, records=n_tr, parts=GAME_CLI["parts"], avro_bytes=data.avro_bytes,
        tool_s=tool_s, tool_ms_per_record=rows_s, bags=bags, index_sizes=sizes,
        train_wall_s=train_s, launches=launches, fixed_objective_passes=fixed_passes,
        extra_files=extra_files, store=store, report_s=seconds, run_bytes=nbytes, compile_s=compile_s,
        phases={k: sorted(v.get("phases", {})) for k, v in summaries.items()}, baselines=baselines,
        exit_codes={**codes, **{k: [v, 0] for k, v in tool_codes.items()}}, gates=gates,
    )


# main_serve: the serving driver's defaults (cli/serve.py), the parity set
SERVE_REQUESTS, SERVE_RATE_HZ, SERVE_MAX_BATCH = 10_000, 2000.0, 32
SERVE_PARITY_ROWS, SERVE_OUT_OF_RANGE = 2_000, 11
SERVE_POLL_EVERY = 2_500
SERVE_TOL = dict(rtol=1e-5, atol=1e-5)  # float32 scores of one model by two row groupings
SERVE_BENCH_SHAPE = (1_024, 64, 16, 8)  # bench.py S_serve_zipf: members, items, d_fe, d_re
SERVE_HIT_RATE_FLOOR = 0.8  # the reference's gated operating point (bench.py S_serve_zipf)


def serve_windows(tel_dir: str) -> list[int]:
    """The requests of each ``serve/window`` span of the run, in flush
    order."""
    return [r["attrs"]["requests"] for r in load_run(latest_run(tel_dir))
            if r.get("event") == "span" and r.get("name") == "serve/window"]


def summarize_serve(tel_dir: str) -> dict:
    """The serving section of the run's report (``report RUN --json``);
    empty when the report failed."""
    code, text, _ = umbrella(["report", latest_run(tel_dir), "--json"])
    return json.loads(text).get("serve", {}) if code == 0 else {}


def lru_replay(model: GameModel, requests: list, windows: list[int], budget_bytes: int) -> dict:
    """The reference's hot-set rule replayed in numpy: window by window,
    each random effect in the model's order, its in-range ids in request
    order, through an LRU of ``budget_bytes`` over rows of 4·d bytes.
    Returns hits, misses and the first-touch bound 1 − distinct / lookups."""
    from collections import OrderedDict

    re = [(cid, sub.random_effect_type, sub.num_entities, 4 * sub.coefficients.shape[1])
          for cid, sub in model.models.items() if isinstance(sub, RandomEffectModel)]
    lru, used, hits, misses, lo = OrderedDict(), 0, 0, 0, 0
    for w in windows:
        for cid, tag, E, nbytes in re:
            for r in requests[lo:lo + w]:
                e = r.id_tags.get(tag, -1)
                if not 0 <= e < E:
                    continue
                if (cid, e) in lru:
                    hits += 1
                    lru.move_to_end((cid, e))
                    continue
                misses += 1
                if nbytes <= budget_bytes:
                    lru[(cid, e)] = nbytes
                    used += nbytes
                    while used > budget_bytes:
                        used -= lru.popitem(last=False)[1]
        lo += w
    assert lo == len(requests), (lo, len(requests))
    lookups = hits + misses
    distinct = len({(cid, r.id_tags[tag]) for cid, tag, E, _ in re for r in requests if 0 <= r.id_tags[tag] < E})
    return dict(hits=hits, misses=misses, hit_rate=hits / lookups, first_touch_bound=1 - distinct / lookups)


def serve_scores(store: HotModelStore, requests: list) -> np.ndarray:
    out = []
    server = MicroWindowServer(store, on_scores=lambda w, s: out.append(s), max_batch=SERVE_MAX_BATCH,
                               max_wait_ms=1e9)
    for r in requests:
        server.submit(r)
    server.drain()
    return np.concatenate(out)


def batch_scores(model: GameModel, requests: list, dev) -> np.ndarray:
    """``GameModel.score`` over the requests' rows as one batch on the card."""
    shards = list(requests[0].features)
    tags = list(requests[0].id_tags)
    batch = make_game_batch(np.zeros(len(requests), np.float32),
                            {s: np.stack([r.features[s] for r in requests]) for s in shards},
                            id_tags={t: np.asarray([r.id_tags[t] for r in requests], np.int64) for t in tags},
                            offsets=np.asarray([r.offset for r in requests], np.float32), device=dev)
    return model.score(batch).cpu().numpy()


def window_shaped_scores(model: GameModel, requests: list, dev) -> np.ndarray:
    """``GameModel.score`` on the rows each window scores: windows of the
    max batch, each padded with zero rows of id -1."""
    out = []
    for lo in range(0, len(requests), SERVE_MAX_BATCH):
        win = requests[lo:lo + SERVE_MAX_BATCH]
        pad = [ScoreRequest(rid=-1, features={s: np.zeros_like(v) for s, v in win[0].features.items()},
                            id_tags={t: -1 for t in win[0].id_tags}) for _ in range(SERVE_MAX_BATCH - len(win))]
        out.append(batch_scores(model, win + pad, dev)[:len(win)])
    return np.concatenate(out)


def serve_gate(got: np.ndarray, model: GameModel, requests: list, dev) -> dict:
    """Serve-path scores against the batch scorer: bitwise at the window
    shape (the witness), and on the whole set bitwise or within
    ``SERVE_TOL``."""
    whole = batch_scores(model, requests, dev)
    diff = np.abs(got - whole)
    return dict(window_shape_bitwise=bool(np.array_equal(got.view(np.uint32),
                                                         window_shaped_scores(model, requests, dev).view(np.uint32))),
                whole_bitwise=bool(np.array_equal(got.view(np.uint32), whole.view(np.uint32))),
                whole_rows_differing=int((diff > 0).sum()), whole_max_abs_diff=float(diff.max()),
                whole_within_tol=bool(np.allclose(got, whole, **SERVE_TOL)))


def run_serve(dev, batch, model: GameModel, card: str) -> tuple[dict, dict]:
    """main_serve on main_e's model (see the module docstring, 12a).
    Returns the record and its gates (name → passed)."""
    import threading

    from photon_ml_tpu_torch.cli import serve as serve_cli
    from photon_ml_tpu_torch.convert import game_model_from_numpy

    work = tempfile.mkdtemp(prefix="_serve-", dir=ROOT)
    fused.reset_launch_counts()
    st.reset_launch_counts()
    try:
        root = os.path.join(work, "published")
        t0 = time.perf_counter()
        publish_game_model(model, root)
        publish_s = time.perf_counter() - t0
        ref = model.models
        re_cids = [cid for cid, sub in ref.items() if isinstance(sub, RandomEffectModel)]

        # (1) the parity set on the card, from the published root
        t0 = time.perf_counter()
        loaded, fingerprint = serve_cli._load(root, dev)
        load_s = time.perf_counter() - t0
        store = HotModelStore(loaded, device=dev)
        gen = np.random.default_rng(23)
        rows = np.sort(gen.choice(batch.num_rows, SERVE_PARITY_ROWS, replace=False))
        rows_t = torch.as_tensor(rows, device=dev)
        feats = {sid: f.X[rows_t].float().cpu().numpy() for sid, f in batch.features.items()}
        tags = {t: v[rows_t].cpu().numpy() for t, v in batch.id_tags.items()}
        offsets = (0.1 * gen.normal(size=SERVE_PARITY_ROWS)).astype(np.float32)
        parity_reqs = [ScoreRequest(rid=i, features={s: feats[s][i] for s in feats},
                                    id_tags={t: int(tags[t][i]) for t in tags}, offset=float(offsets[i]))
                       for i in range(SERVE_PARITY_ROWS)]
        for j in range(SERVE_OUT_OF_RANGE):  # ids below 0, at E and past it, on each effect in turn
            src = parity_reqs[j]
            tag = ref[re_cids[j % len(re_cids)]].random_effect_type
            E = ref[re_cids[j % len(re_cids)]].num_entities
            parity_reqs.append(ScoreRequest(rid=SERVE_PARITY_ROWS + j, features=src.features,
                                            id_tags=dict(src.id_tags, **{tag: (-1, E, E + 7)[j % 3]}),
                                            offset=src.offset))
        t0 = time.perf_counter()
        got = serve_scores(store, parity_reqs)
        parity_s = time.perf_counter() - t0
        parity = dict(requests=len(parity_reqs), last_window=len(parity_reqs) % SERVE_MAX_BATCH, seconds=parity_s,
                      hot_rows_on=store.shard_for(re_cids[0], 0).device.type,
                      fingerprint_equal=fingerprint == model_fingerprint(model),
                      **serve_gate(got, model, parity_reqs, dev))

        # (2) one user's refresh from half its rows: the most requested user of
        # the serve trace among those with 16 rows or more in main_e's batch
        trace = serve_cli._synthetic_requests(loaded, SERVE_REQUESTS, 1.0, 0)
        user_cid = re_cids[0]
        user_tag = ref[user_cid].random_effect_type
        E_user = ref[user_cid].num_entities
        rows_of = torch.bincount(batch.id_tags[user_tag], minlength=E_user).cpu().numpy()
        asked = np.bincount([r.id_tags[user_tag] for r in trace], minlength=E_user)
        head = int(next(e for e in np.argsort(-asked, kind="stable") if rows_of[e] >= 16))
        mine = torch.nonzero(batch.id_tags[user_tag] == head).flatten()
        mine = mine[: len(mine) // 2]
        sub_batch = GameBatch(labels=batch.labels[mine], offsets=batch.offsets[mine], weights=batch.weights[mine],
                              features={sid: f.take(mine) for sid, f in batch.features.items()},
                              id_tags={t: v[mine] for t, v in batch.id_tags.items()})
        others = sum(sub.score(sub_batch) for cid, sub in ref.items() if cid != user_cid)
        events = entity_event_batch(sub_batch.features[ref[user_cid].feature_shard_id].X.float().cpu().numpy(),
                                    sub_batch.labels.cpu().numpy(), offsets=others.cpu().numpy(), device=dev)
        refresh, refreshed = {}, None
        for name, solver in (("lbfgs", OptimizerType.LBFGS), ("tron", OptimizerType.TRON)):
            cfg = OptimizerConfig(optimizer_type=solver, max_iterations=20, tolerance=1e-7)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            updated, res = refresh_entity(model, user_cid, head, events, cfg, l2_weight=1.0)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            offline = solve_entity_offline(model[user_cid], head, events, cfg, l2_weight=1.0)
            W0, W1 = model[user_cid].coefficients, updated[user_cid].coefficients
            others_same = torch.equal(torch.cat([W0[:head], W0[head + 1:]]), torch.cat([W1[:head], W1[head + 1:]]))
            refresh[name] = dict(seconds=seconds, iterations=int(res.iterations[0]),
                                 bitwise_offline=bool(torch.equal(res.w, offline.w)), others_unchanged=others_same,
                                 row_moved=float((W1[head] - W0[head]).abs().max()))
            refreshed = refreshed or updated
        refresh.update(entity=head, requests_in_trace=int(asked[head]), events=int(len(mine)),
                       padded_rows=int(events.X.shape[0]))

        # (3) the driver with its defaults, telemetry on
        tel = os.path.join(work, "telemetry")
        code, text, serve_s = umbrella(["serve", "--model-root", root, "--telemetry-dir", tel])
        line = json.loads(text.strip().splitlines()[-1]) if code == 0 else {}
        run_path = latest_run(tel)
        windows = serve_windows(tel)
        replay = lru_replay(loaded, trace, windows, line.get("hot_budget_bytes", 0))
        section = summarize_serve(tel)
        base = os.path.join(work, "serve-baseline.json")
        gate_codes = [umbrella(["report", "gate", run_path, "--write-baseline", base])[0],
                      umbrella(["report", "gate", run_path, "--baseline", base])[0]]
        row_bytes = 4 * ref[user_cid].coefficients.shape[1]
        served = dict(
            code=code, seconds=serve_s, line=line, windows_in_telemetry=len(windows),
            offered_hz=SERVE_RATE_HZ, achieved_hz=line.get("requests", 0) / max(line.get("elapsed_s", 0.0), 1e-9),
            hits=section.get("hot_hit_bytes", 0) / row_bytes, misses=section.get("hot_miss_bytes", 0) / row_bytes,
            replay=replay, total_re_bytes=store.total_re_bytes, report_serve=section, gate_codes=gate_codes)

        # (4) a hot swap: the refreshed model published while the driver polls
        def publish_later():
            time.sleep(0.5)
            publish_game_model(refreshed, root)

        publisher = threading.Thread(target=publish_later)
        t0 = time.perf_counter()
        publisher.start()
        with contextlib.redirect_stdout(io.StringIO()):
            swap = serve_cli.run(root, poll_every=SERVE_POLL_EVERY, device=dev)
        publisher.join()
        swap_s = time.perf_counter() - t0
        at = swap["swap_at"][0] if swap["swap_at"] else len(trace)
        swap_scores = np.asarray([swap["scores"][r.rid] for r in trace], np.float32)
        before = np.abs(swap_scores[:at] - batch_scores(model, trace[:at], dev)) if at else np.zeros(1)
        after_reqs = trace[at:]
        after_new = batch_scores(refreshed, after_reqs, dev) if after_reqs else np.zeros(0)
        after_old = batch_scores(model, after_reqs, dev) if after_reqs else np.zeros(0)
        head_after = np.asarray([r.id_tags[user_tag] == head for r in after_reqs], bool)
        hot_swap = dict(
            seconds=swap_s, snapshot_swaps=swap["snapshot_swaps"], swap_at=swap["swap_at"],
            fingerprint_new=swap["fingerprint"] == model_fingerprint(refreshed),
            before_within_tol=bool(np.allclose(swap_scores[:at], batch_scores(model, trace[:at], dev), **SERVE_TOL))
            if at else True,
            before_max_abs_diff=float(before.max()),
            after_within_tol_of_new=bool(np.allclose(swap_scores[at:], after_new, **SERVE_TOL)),
            head_requests_after=int(head_after.sum()),
            head_moved_after=float(np.abs(after_new - after_old)[head_after].max()) if head_after.any() else 0.0)

        # (5) the reference bench's serving shape, where the 0.8 hit-rate line was drawn
        members, items, d_fe, d_re = SERVE_BENCH_SHAPE
        g = np.random.default_rng(13)
        bench_model = game_model_from_numpy({
            "fixed": {"feature_shard_id": "global", "means": (g.normal(size=d_fe) * 0.5).astype(np.float32)},
            "per_member": {"feature_shard_id": "member_f", "random_effect_type": "member",
                           "coefficients": (g.normal(size=(members, d_re)) * 0.5).astype(np.float32)},
            "per_item": {"feature_shard_id": "item_f", "random_effect_type": "item",
                         "coefficients": (g.normal(size=(items, d_re)) * 0.5).astype(np.float32)},
        }, TaskType.LOGISTIC_REGRESSION, device=dev)
        root_b, tel_b = os.path.join(work, "published-bench"), os.path.join(work, "telemetry-bench")
        publish_game_model(bench_model, root_b)
        bcode, btext, bench_s = umbrella(["serve", "--model-root", root_b, "--telemetry-dir", tel_b])
        bline = json.loads(btext.strip().splitlines()[-1]) if bcode == 0 else {}
        bsection = summarize_serve(tel_b)
        bench_point = dict(code=bcode, seconds=bench_s, line=bline, report_serve=bsection,
                           replay=lru_replay(serve_cli._load(root_b, dev)[0],
                                             serve_cli._synthetic_requests(bench_model, SERVE_REQUESTS, 1.0, 0),
                                             serve_windows(tel_b), bline.get("hot_budget_bytes", 0)),
                           hits=bsection.get("hot_hit_bytes", 0) / (4 * d_re),
                           misses=bsection.get("hot_miss_bytes", 0) / (4 * d_re))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec = dict(card=card, publish_s=publish_s, load_s=load_s, parity=parity, refresh=refresh, serve=served,
               hot_swap=hot_swap, bench_point=bench_point, launches=launch_counts())
    gates = {
        "fingerprint": parity["fingerprint_equal"],
        "hot_rows_on_the_card": parity["hot_rows_on"] == "cuda",
        "parity_window_shape_bitwise": parity["window_shape_bitwise"],
        "parity_whole_set": parity["whole_bitwise"] or parity["whole_within_tol"],
        "refresh_bitwise": all(refresh[k]["bitwise_offline"] and refresh[k]["others_unchanged"]
                               and refresh[k]["row_moved"] > 0 for k in ("lbfgs", "tron")),
        "serve_ran": code == 0 and line.get("requests") == SERVE_REQUESTS and line.get("device") == "cuda"
        and served["windows_in_telemetry"] == line.get("windows"),
        "hit_rate_equals_replay": (served["hits"], served["misses"]) == (replay["hits"], replay["misses"]),
        "report_serving_section": all(section.get(k) is not None for k in (
            "latency_p50_ms", "latency_p99_ms", "hot_hit_rate", "window_occupancy_mean"))
        and section.get("requests") == SERVE_REQUESTS,
        "report_gate_self": gate_codes == [0, 0],
        "hot_swap": hot_swap["snapshot_swaps"] >= 1 and hot_swap["fingerprint_new"]
        and hot_swap["before_within_tol"] and hot_swap["after_within_tol_of_new"],
        "bench_point_hit_rate": bcode == 0 and bench_point["line"].get("hot_hit_rate", 0.0) >= SERVE_HIT_RATE_FLOOR
        and (bench_point["hits"], bench_point["misses"]) == (bench_point["replay"]["hits"],
                                                             bench_point["replay"]["misses"]),
    }
    return rec, gates


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
    start_forkserver()  # its import of this script runs beside the build
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    name, power_limit = [s.strip() for s in smi.split(",", 1)]
    emit("device", name=name, power_limit=power_limit, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ for the native library beside nvcc
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
    emit("main_lint", **run_lint(smi))

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

    # GAME: config D, config E at MovieLens-10M depth, config E's agreement
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
    # online serving of main_e's model, published and served on the card
    serve_rec, serve_gates = run_serve(dev, e_batch, e_model, smi)
    emit("main_serve", **serve_rec, gates=serve_gates)
    failed = [name for name, ok in serve_gates.items() if not ok]
    if failed:
        raise AssertionError(f"main_serve failed: {failed}")
    # main_serve's model, published for main_stream_executor's serving arm
    sx_work = tempfile.mkdtemp(prefix="_stream_executor-", dir=ROOT)
    publish_game_model(e_model, os.path.join(sx_work, "published"))
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
    e_multi_rs = run_e_multihost_re_shard(dev, e_multi, smi)
    emit("main_e_multihost_re_shard", **e_multi_rs)
    failed = [name for name, ok in (
        ("models_bitwise_equal_across_ranks", e_multi_rs["models_bitwise_equal_across_ranks"]),
        ("quality", e_multi_rs["quality"]["quality_ok"]),
        ("k1_launches", e_multi_rs["k1_launches_ok"]),
        ("owned_visit_bitwise", e_multi_rs["owned_visit_bitwise"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_e_multihost_re_shard failed: {failed}")
    e_re_split = run_e_multihost_re_split(dev, smi)
    emit("main_e_multihost_re_split", **e_re_split)
    failed = [name for name in ("ranks_bitwise", "bitwise_where_promised", "split_within_lane_tolerance",
                                "segments_fewer_bytes", "split_placed", "device_split_placed", "k1_launches_ok")
              if not e_re_split[name]]
    if failed:
        raise AssertionError(f"main_e_multihost_re_split failed: {failed}")
    del e_sharded_model
    agree_e = agreement_e(dev)
    emit("agreement_e", **agree_e)
    _check_game_launches("agreement_e", agree_e["fused"])
    if any(agree_e["unfused"]["launches"].values()):
        raise AssertionError(f"the vetoed GAME run launched a kernel: {agree_e['unfused']['launches']}")
    if not (agree_e["d_auc"] <= 0.005 and agree_e["rel_d_log_loss"] <= 1e-3):
        raise AssertionError("the GAME runs with and without K1 disagree")

    # config E at MovieLens-10M depth with the random effects on L-BFGS,
    # on main_e's batch; then the lane solvers' agreement at bench depth
    e_lbfgs, e_lbfgs_model = run_e_lbfgs(dev, e_batch, e_data, e_rec)
    emit("main_e_lbfgs", **e_lbfgs)
    _check_game_launches("main_e_lbfgs", e_lbfgs)
    if not (e_lbfgs["quality_ok"] and e_lbfgs["d_auc_vs_newton"] <= 0.005
            and e_lbfgs["rel_d_log_loss_vs_newton"] <= 1e-3):
        raise AssertionError(f"config E on L-BFGS: AUC {e_lbfgs['train_auc']} (Newton "
                             f"{e_rec['train_auc']}, generating {e_lbfgs['auc_generating_model']}), "
                             f"relative d log-loss {e_lbfgs['rel_d_log_loss_vs_newton']}")
    # the same fit with lane compaction and launch fusion: the same model, bit for bit
    e_compact = run_e_lbfgs_compact(dev, e_batch, e_data, e_lbfgs, e_lbfgs_model)
    del e_lbfgs_model
    emit("main_e_lbfgs_compact", **e_compact)
    _check_game_launches("main_e_lbfgs_compact", e_compact)
    if not (e_compact["models"]["within_lane_tolerance"] and e_compact["d_auc_vs_off"] <= 1e-4
            and e_compact["rel_d_log_loss_vs_off"] <= 1e-4):
        raise AssertionError(f"main_e_lbfgs_compact: knob on against off {e_compact['models']}, "
                             f"dAUC {e_compact['d_auc_vs_off']}")
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
    e_streamed = run_e_streamed(dev, e_host, e_mem, e_rec, smi)
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
    # two processes, each holding half of the rows (at bench depth), knob
    # off and with skew-aware placement and the overlapped exchanges
    one, one_model = e_streamed_one_process(dev)
    faults_work = tempfile.mkdtemp(prefix="_faults-", dir=ROOT)  # main_faults' anchor, written by 15e's children
    e_streamed_multi, e_streamed_rs, ring = run_e_streamed_multihost(dev, one, one_model, smi,
                                                                     os.path.join(faults_work, "anchor"))
    del one_model
    e_streamed_multi["one_process"] = one
    emit("main_e_streamed_multihost", **e_streamed_multi)
    failed = [name for name, ok in (
        ("models_bitwise_equal_across_ranks", e_streamed_multi["models_bitwise_equal_across_ranks"]),
        ("vs_one_process", e_streamed_multi["d_auc_vs_one_process"] <= 0.005
         and e_streamed_multi["rel_d_fixed_objective_vs_one_process"] <= 1e-3
         and e_streamed_multi["random_effects_within_lane_tolerance"]),
        ("k1_launches", e_streamed_multi["k1_launches_ok"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_e_streamed_multihost failed: {failed}")
    emit("main_e_streamed_multihost_re_shard", **e_streamed_rs)
    failed = [name for name, ok in (
        ("models_bitwise_equal_across_ranks", e_streamed_rs["models_bitwise_equal_across_ranks"]),
        ("vs_knob_off", e_streamed_rs["random_effects_within_knob_off_tolerance"]),
        ("placement", e_streamed_rs["placement_ok"]),
        ("vs_one_process", e_streamed_rs["d_auc_vs_one_process"] <= 0.005),
        ("k1_launches", e_streamed_rs["k1_launches_ok"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_e_streamed_multihost_re_shard failed: {failed}")
    e_streamed_re_split = run_e_streamed_multihost_re_split(dev, smi)
    emit("main_e_streamed_multihost_re_split", **e_streamed_re_split)
    failed = [name for name in ("ranks_bitwise", "split_within_tolerance", "placed", "k1_launches_ok")
              if not e_streamed_re_split[name]]
    if failed:
        raise AssertionError(f"main_e_streamed_multihost_re_split failed: {failed}")
    # peer loss: the ring on a healthy group, the streamed recovery, the descent's degrade in place
    try:
        faults_rec = run_faults(dev, smi, ring, os.path.join(faults_work, "anchor"))
    finally:
        shutil.rmtree(faults_work, ignore_errors=True)
    emit("main_faults", **faults_rec)
    kill, degrade, rejoin = faults_rec["streamed_kill"], faults_rec["descent_degrade"], faults_rec["rejoin"]
    failed = [name for name, ok in (
        ("ring_bitwise_armed_vs_unset", ring["bitwise_armed_vs_unset"] and ring["ranks_bitwise"]),
        ("ring_no_recovery", ring["no_recovery_counters"] and ring["anchor_written"]),
        ("ring_k1_launches", ring["k1_launches_ok"]),
        ("kill_resumed_from", kill["resumed_from"] == [1, 0] and kill["clean_resumed_from"] == [1, 0]),
        ("kill_counters", all(kill["counters"].get(k) == 1.0
                              for k in ("fleet.peer_lost", "fleet.recoveries", "p2p.giveups"))),
        ("kill_bitwise_vs_clean", all(kill["bitwise_vs_clean"].values())),
        ("kill_k1_launches", kill["k1_launches_ok"]),
        ("degrade_counters", degrade["counters"].get("fleet.degraded_descents") == 1.0
         and degrade["counters"].get("fleet.peer_lost") == 1.0 and "fleet.recoveries" not in degrade["counters"]),
        ("degrade_bitwise_vs_clean", all(degrade["bitwise_vs_clean"].values())),
        ("degrade_k1_launches", degrade["k1_launches_ok"]),
        ("rejoin_booted", rejoin["booted"] == [False, True]),
        ("rejoin_counters", rejoin["counters"][1].get("fleet.rejoins") == 1.0
         and all(rejoin["counters"][0].get(k) == 1.0
                 for k in ("fleet.peer_lost", "fleet.recoveries", "fleet.rejoins"))),
        ("rejoin_resumed_from", rejoin["resumed_from"] == [[1, 0], [1, 0]]),
        ("rejoin_bitwise_vs_uninterrupted", all(rejoin["bitwise_vs_uninterrupted"].values())),
        ("rejoin_k1_launches", rejoin["k1_launches_ok"]),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_faults failed: {failed}")
    # the GAME drivers' part files, written by four host processes beside
    # the in-process phases up to the drivers block (none of them times a
    # collective against a timeout, as main_faults does)
    work = tempfile.mkdtemp(prefix="_game_cli-", dir=ROOT)
    atexit.register(shutil.rmtree, work, ignore_errors=True)
    pending_cli = start_game_cli_data(dev, work)
    solvers, solver_models = agreement_e_solvers(dev, agree_e["fused"])
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
    # the schedule knobs: R_re_skew's sweep, OWL-QN and TRON at bench depth, E streamed
    re_skew = run_re_skew(dev)
    re_skew["bench_depth"] = run_e_solvers_compact(dev, solver_models)
    del solver_models
    emit("re_skew", **re_skew)
    if not (re_skew["within_lane_tolerance"]
            and all(r["models"]["within_lane_tolerance"] for r in re_skew["bench_depth"].values())):
        raise AssertionError("re_skew: a knob cell is outside the lane tolerance of the knob-off cell")
    for name, r in re_skew["bench_depth"].items():
        _check_game_launches(f"re_skew[{name}]", r)
    e_streamed_compact = run_e_streamed_compact(dev)
    emit("main_e_streamed_compact", **e_streamed_compact)
    if not (e_streamed_compact["models"]["within_lane_tolerance"] and e_streamed_compact["launches_ok"]):
        raise AssertionError(f"main_e_streamed_compact failed: {e_streamed_compact['models']}, "
                             f"launches {e_streamed_compact['launches']}")
    # capacity-class projection at MovieLens-20M's users
    re_project = run_re_project(dev)
    emit("main_re_project", **re_project)
    failed = [name for name, ok in re_project["gates"].items() if not ok]
    if failed:
        raise AssertionError(f"main_re_project failed: {failed}")

    # main path GAME CLI: the train and score drivers on Avro part files,
    # every read on the native decoder; then the drivers with every option
    try:
        data = finish_game_cli_data(pending_cli)
        # the native decoder against the Python codec, in a forked process
        # beside the drivers
        parity_kids = start_children("native_read_parity", os.path.join(work, "native_read"), {"data_work": work},
                                     dev, n=1)
        with recording_decoders() as decoders:
            cli = run_game_cli(dev, data)
        cli["decoders"] = decoders
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
        # the tools and the run report on those files and runs
        tools = run_tools(dev, data, smi)
        native = cli["native_read"] = join_children(parity_kids)[0]
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
    emit("main_tools", **tools)
    _check_game_launches("main_tools", tools)
    failed = [name for name, ok in tools["gates"].items() if not ok]
    if failed:
        raise AssertionError(f"main_tools failed: {failed}; exit codes {tools['exit_codes']}")

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
    # every streamed consumer with PHOTON_STREAM_EXECUTOR off, then on
    try:
        sx = run_stream_executor(dev, smi, os.path.join(sx_work, "published"))
    finally:
        shutil.rmtree(sx_work, ignore_errors=True)
    emit("main_stream_executor", **sx)
    failed = [name for name, ok in sx["gates"].items() if not ok]
    if failed:
        raise AssertionError(f"main_stream_executor failed: {failed}")
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
    a2_fe = run_a2_streamed_fe_shard(dev, smi)
    emit("main_a2_streamed_fe_shard", **a2_fe)
    on_arms = a2_fe["processes"]
    failed = [name for name, ok in (
        ("one_range_bitwise_unset", all(a2_fe["one_range_bitwise_unset"].values())),
        ("sharded", a2_fe["one_process"]["on1"]["fe_active"] and not a2_fe["one_process"]["off0"]["fe_active"]),
        ("tiled", all(r["tiled"] for r in a2_fe["one_process"].values())),
        ("k3_launches", all(r["launches_ok"] for r in [*a2_fe["one_process"].values(), *on_arms.values()])),
        ("k3_restricted_parity", all(r["ok"] for r in a2_fe["k3_restricted_parity"].values())),
        ("ranks_bitwise", all(r["ranks_bitwise"] for r in on_arms.values())),
        ("vs_one_process", all(r["d_auc_vs_one_process"] <= 0.005 and r["rel_d_objective_vs_one_process"] <= 1e-4
                               for r in on_arms.values())),
        ("cover", all(r["widths_cover_d"] and r["nnz_covers_data"] for r in on_arms.values())),
        ("nnz_balance", all(r["nnz_balance"] <= 1.15 for name, r in on_arms.items() if name.endswith("_nnz"))),
        ("variances", all(r["variances_finite"] for r in on_arms.values())),
    ) if not ok]
    if failed:
        raise AssertionError(f"main_a2_streamed_fe_shard failed: {failed}")
    streamed_paths = {"main_f": f_rec, "main_b_streamed": b_streamed, "main_a2_streamed": a2_streamed,
                      "main_glm_streamed_cli": glm_streamed, "main_e_streamed": e_streamed,
                      "main_game_cli_streamed": game_streamed, "main_stream_executor": sx}
    # out of core across processes
    parallel_streamed_paths = {"main_e_streamed_multihost": e_streamed_multi,
                               "main_e_streamed_multihost_re_shard": e_streamed_rs,
                               "main_e_streamed_multihost_re_split": e_streamed_re_split,
                               "main_game_cli_streamed_multihost": game_streamed_multi,
                               "main_a2_streamed_fe_shard": a2_fe, "main_faults": faults_rec}
    # the drivers with run telemetry on
    telemetry_paths = {"main_telemetry": telemetry, "main_tools": tools}
    # data parallel: row shards of the card, and two processes over gloo
    parallel_paths = {"main_a_sharded": a_sharded, "main_a2_sharded": a2_sharded,
                      "main_f_multihost": f_multi, "main_glm_multihost_cli": glm_multihost,
                      "main_e_sharded": e_sharded, "main_e_multihost": e_multi,
                      "main_e_multihost_re_shard": e_multi_rs, "main_e_multihost_re_split": e_re_split,
                      "main_game_multihost_cli": game_multihost}

    # launches over the main path: A, the sweep and B, then D, E, E on L-BFGS,
    # E projected and the GAME drivers (each path counted from 0 just before it ran)
    by_path = {
        k: {"main_a": a["launches"][k], "main_a_sweep": sweep["launches"][k],
            "main_b": b["launches"][k], "main_d": d_rec["launches"][k],
            "main_e": e_rec["launches"][k], "main_serve": serve_rec["launches"][k],
            "main_e_lbfgs": e_lbfgs["launches"][k],
            "main_e_lbfgs_compact": e_compact["launches"][k],
            "main_e_streamed_compact": e_streamed_compact["launches"][k],
            **{f"re_skew[{name}]": r["launches"][k] for name, r in re_skew["bench_depth"].items()},
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
