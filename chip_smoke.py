"""Smoke run of sntc_tpu_torch on one NVIDIA GPU: kernels, paths, numbers.

    python3 chip_smoke.py [--verbose-build] [--out-json PATH]
                          [--phases 2,3,11,...,24,25]

Run from the root of a checkout, on a machine with a CUDA card.  Phases,
each of which fails the run (non-zero exit, no result line):

1. print the card's name and power limit; build the CUDA kernels from
   ``sntc_tpu_torch/kernels/csrc`` (into ``sntc_tpu_torch/_build``);
2. hold every kernel against its plain PyTorch version on the card, at
   its path's full-width shapes: ``forest_traversal`` (unaligned 33 and
   4 097 rows, S=3 and S=15, f32 and f64, with NaN) and
   ``pad_assemble`` bitwise (they only compare and copy; ``pad_assemble``
   on row-major and column-major blocks, f32 and f64, N of 1, 33, 1 000,
   4 097, 50 000, 60 000 and 65 536 rows, each to its bucket and to
   itself, 78 and 13 columns); ``tree_hist``
   bitwise and equal to itself run twice on the fit's integer-valued
   stats (the chi-square contingency, a forest's root level, the widest
   node group of its deepest level), and within 1e-5 of each cell's sum
   of absolute contributions on GBT-like fractional stats;
3. serve the full-width config-3 random-forest pipeline (78 CICIDS2017
   features -> ChiSq top 40 -> 20 trees of depth 10, 15 classes ->
   IndexToString) built from a seed, over six CSV micro-batches, through
   ``python -m sntc_tpu_torch serve --device cuda`` in its default form
   (fused, pipelined, files WAL; phase 8 holds it against the staged,
   serial form).  The serving process
   starts with every launch count at 0 and reports its counts in its
   summary line; each kernel of the path must have launched.  Every input
   row must come back predicted, equal to the plain path on the same card;
4. train the same pipeline at full width, through ``python -m
   sntc_tpu_torch train --device cuda`` on 250 000 synthetic flows written
   as CSV: the process starts with every count at 0; ``tree_hist`` must
   launch once for the contingency plus once per node group of every
   level of the grower, ``forest_traversal`` at least once (the held-out
   evaluation), and the held-out macro-F1 must reach 0.76.  Then a
   reduced fit (20 000 rows, 20 trees of depth 6) runs on the card and
   on the CPU from one seed: the same features selected, the same trees;
5. time the fit in this process and take its device time from a
   profiler window, with each ``tree_hist`` launch's device time (taken
   again on its own inputs after the fit: a profiler window may drop
   one) in launch order, tagged with its level, node group and the plan
   the kernel's entry point took (regime, features per block, row blocks);
   hold ``tree_hist`` on the fit's own launches of levels 7 and 8 (the
   real, skewed node distribution) against its plain version as in 2;
   time each kernel at its path's shapes with CUDA events beside its
   plain version, a PyTorch library call where one computes the same
   function, and its bound (``forest_traversal`` at each serve
   micro-batch size and the held-out evaluation's, on a random and on
   the served forest, by CUDA events over whole calls (``ms``, as for
   the other kernels) and by its device time a launch, 100 launches
   queued back to back (``device_ms``); ``tree_hist`` at
   the widest level group, the contingency and the fit's levels 7 and
   8; config 4's own per-tree launches of levels 0-3 beside the same
   histogram as 15 launches of the shared form); print the kernels as
   one JSON line, then the card's line, then the result line;
6. bench config 4 (OneVsRest over 15 GBT classes, 10 rounds of depth 4,
   128 bins, on the 78 raw features) on its own 125 000 synthetic flows
   (bench.py's data seed 7, split 0.8/0.2 with seed 0):
   ``python -m sntc_tpu_torch train --estimator gbt --chisq-top 0``
   (``tree_hist`` exactly 10 x the grower's passes, ``forest_traversal``
   10 margin walks + 1 evaluation, held-out macro-F1 >= 0.91), then
   ``serve`` of the fitted pipeline in the default form (pipelined, no
   fused segment: nothing fusible precedes the one-vs-rest head) over
   three micro-batches (one padded), every prediction equal to the plain
   path's; a reduced fit
   (20 000 rows, 3 rounds) on the card, on the CPU and on the CPU with
   sibling subtraction, the card within the near-tie rule and the
   training log-loss tolerance set from the CPU's own gap; a depth-5
   decision tree identical on the card and the CPU; the fit profiled in
   this process, its round-1 ``tree_hist`` launches held against the
   plain version and, with equal integer stats rows, against the shared
   form bitwise; ``forest_traversal`` bitwise and timed at the margin
   walk and the 150-tree serve walk.  ``pad_assemble`` is also timed by
   its device time a launch at [50 000, 78] and [1 000, 78], each with
   phase 3's launches at that shape;
7. bench configs 2 and 1, the LBFGS fits, on bench.py's data seed 7
   (split 0.8/0.2 with seed 0): ``python -m sntc_tpu_torch train`` with
   the default estimator (MLP [78, 64, 15], 100 iterations, on 500 000
   generated flows: held-out macro-F1 >= 0.96) and with ``--estimator
   lr --binary --reg-param 1e-4`` (250 000 flows: held-out AUC >= 0.97
   by the port's ``BinaryClassificationEvaluator``), each reporting its
   LBFGS iterations, evaluations and host reads; ``serve`` of the MLP
   pipeline in the staged, serial form over micro-batches of 1 000
   (padded to 1 024: one ``pad_assemble`` launch, counted), 4 096 and
   65 536 rows, its
   probabilities within 1e-4 of the unpadded batch's on the card and the
   CPU's, predictions equal wherever the top two lie further apart; the
   MLP and LR pipelines on 20 000 rows fitted on the card and the CPU,
   their objective histories within the stated rule, and a card fit
   segmented by checkpoints bitwise equal to the uninterrupted one; the
   full-width MLP fit profiled (device busy, idle share, device ms by
   kernel and group) and one ``value_and_grad`` timed beside its bound;
8. the serve command's default form (the whole-pipeline fusion compiler,
   the pipelined engine with its 4-wide read pool, 2 prefetched batches
   and overlapped sink, the files-mode WAL) against the JAX command's
   ``--no-fuse --pipeline-depth 1 --wal-mode append``: phase 3's config-3
   pipeline over 12 CSV files of 30 000 rows, 2 files a batch (six
   batches of 60 000 rows, each padded to 65 536), each form
   ``FORM_RUNS`` times in turns.  Every run's batch files byte-identical; each
   form launches ``pad_assemble`` and ``forest_traversal`` once a batch,
   moves one upload and one download a batch (its transfer ledger), and
   the default form binds its one fused segment on every batch; each run's
   rows/s without its first batch and its mean read, predict and sink
   ms; and, in this process, the split of one ``pad_assemble`` call on
   the first batch (``scripts/pad_assemble_split.py``: the host's pack,
   column-major and, for comparison, row-major; the upload; the launch's
   device time; the whole call).  Config 2 at the defaults (the scaler
   folded into the MLP):
   probabilities within 1e-4 of the staged form's, predictions equal
   wherever the top two lie further apart; config 4 serves at the
   defaults in phase 6;
9. the last two train estimators, ``evaluate`` and the tree regressors:
   ``python -m sntc_tpu_torch train --estimator nb`` (gaussian naive
   Bayes on the 78 raw features) and ``--estimator svc`` (OneVsRest over
   LinearSVC behind the scaler, 100 LBFGS iterations per class at
   regParam 1e-4) on config 2's flows, each fit's time and held-out
   macro-F1 (svc: iterations and host reads per class); nb's float64
   raw scores on the card within 1e-12 of the CPU's, predictions equal,
   and a CPU fit's means and variances within 1e-4 of the card's; both
   saved pipelines served in the default form over micro-batches of
   1 000 (padded: one ``pad_assemble`` launch), 4 096 and 65 536 rows,
   every prediction equal to this process's; ``evaluate --device cuda``
   printing the CPU's value; then the decision-tree (depth 5, 128
   bins), random-forest (20 trees of depth 10, 32 bins) and GBT (10
   rounds of depth 4, step 0.1, 128 bins) regressors on config 4's
   flows with ``Flow IAT Mean`` taken out of the features and its log1p
   the target: each fit's ``tree_hist`` launches within max(1e-5, (n+1)·u)
   of their float64 sums, each held-out walk bitwise equal to the plain
   version, RMSE and R²; ``tree_hist``, ``forest_traversal`` and
   ``pad_assemble`` timed at these new shapes (variance stats,
   regression leaves, nb's padded batch);
10. LogisticRegression's lane fits and ``tuning/``, on the flows of
   phase 7: (a) OneVsRest over LR (100 iterations, regParam 1e-4) on
   config 2's scaled flows takes ``_fit_ovr_lanes``, 15 lanes in one
   LBFGS loop, each class held against the same binary fit run alone
   through the single-fit path, the lanes on the rows in their order
   and in ``len(REORDER_SEEDS)`` other orders (histories within
   ``LANE_PREFIX_TOL`` of the
   start over the first 10 iterations and 2e-3 at every common
   iteration, final objectives within ``LANE_END_TOL`` of it), reported
   beside the single fit's own gaps on the reordered rows and each
   class's fit through the lane program alone, and held-out macro-F1
   within 0.005; (b) CrossValidator over a bare LR
   on config 1's scaled flows, regParam {1e-4, 1e-3, 1e-2} x
   elasticNetParam {0, 0.5}, 3 folds: ``_fit_grid_folds``' two lane
   loops (9 L2 lanes, 9 OWLQN lanes) against the same sweep with
   ``SNTC_TUNING_BATCH=0``, areaUnderROC by point within 1e-4 and the
   same best point unless the top two lie within 1e-4; (c)
   CrossValidator over the whole config-2 Pipeline (head-only grid
   regParam {1e-4, 1e-2}, 2 folds) on 100 000 flows: the prefix fitted
   once per fold and once for the refit, the head's grid through
   ``_fit_grid``, macro-F1 within 1e-3 of the one-by-one search and the
   same best point; (d) TrainValidationSplit (trainRatio 0.8) over (c)'s
   pipeline and rows, round-tripped by ``save_model``/``load_model``,
   its best model saved and served by ``python -m sntc_tpu_torch serve``
   in the default form over 1 000 (padded: one ``pad_assemble``
   launch), 4 096 and 65 536 held-out rows, every prediction equal to
   this process's transform on the card.  Each part prints its wall-
   clock and host reads, lanes against one by one;
11. the serve command's failure handling on phase 3's config-3 model,
   over 8 CSV files of 30 000 rows, 2 a batch (60 000-row batches
   padded to 65 536): a clean run; ``SNTC_FAULTS=device.dispatch:
   device_oom:0.3:7`` (batch files byte-identical to the clean run's, at
   least one OOM split, one extra ``pad_assemble`` and
   ``forest_traversal`` launch per split, nothing quarantined); a real
   CUDA OOM in this process (the caching allocator capped at
   ``OOM_CAP_SHARE`` of one clean dispatch's reserved peak above the
   model's: the 65 536-row dispatch fails, its halves run, predictions
   equal the uncapped dispatch's, the split's error is CUDA's OOM); an
   injected transient ``device_lost`` (2 dispatches) through the
   supervised loop, every batch committed; the supervised loop at the
   default flags with a ragged file arriving alone in a batch (dead-
   lettered after 3 rounds and committed, the rows around it byte-
   identical to the clean run's), then SIGTERM (exit 0, drained, the
   drain marker); a persistent ``device_lost`` (exit non-zero after 3
   rounds, the intent in the WAL, the model UNHEALTHY) and a clean
   restart replaying it into the clean run's files.  One JSON line
   reports the phase;
12. the serve command's data plane on phase 3's config-3 model, every
   serve a ``serve --once`` process with its launch counts from 0 (the
   six of (a)-(c) started together, so that their start-ups overlap):
   (a) 6 uncleaned CSV files of 30 000 rows and a 7th holding 5 ragged
   lines, 2 files a batch, served with ``--row-policy salvage``: batch
   files byte-identical to serving the same rows pre-cleaned
   (``clean_flows`` drop, ragged lines removed) at ``strict``, the row
   dead letters naming exactly the non-finite rows (batch, row) and the
   ragged lines (file, line), ``pad_assemble`` and ``forest_traversal``
   once a batch, each ``pad_assemble`` launch at its batch's float32
   [rows, 78] block (the run's ``pad_launch_shapes``); (b) one file of exactly 65 536 rows with poison rows,
   alone in a batch: one zero-row ``pad_assemble`` launch, output equal
   to the pre-cleaned run; (c) ``--row-policy permissive`` equal to
   serving ``clean_flows(handle_invalid="zero")``; (d) ``pad_rows`` on
   the contract's float32 [60 000, 78] -> 65 536 and [65 536, 78] ->
   65 536 in the column-major layout the serve path launches, bitwise
   against the plain version, timed beside its bound and the one
   PyTorch call of the same function (``index_select``; at the zero-row
   pad ``contiguous()``), each with the launches its own run counted at
   that shape (the salvage run's full batches; the exact bucket's
   zero-row pad), and the split of one ``pad_assemble`` call on the
   first salvage batch's float32 block, as in phase 8; (e) the storage
   plane: an append-WAL serve
   killed at a commit (``SNTC_FAULTS=stream.commit:kill``), the torn
   tail a crash mid-append leaves written after it, ``python -m
   sntc_tpu_torch fsck`` repairing it (exit 0) and the restart resuming
   exactly once into the clean run's files; a forged compaction seal
   (``fsck`` exits 1); the supervised loop under ``storage.wal:enospc``
   and ``storage.dead_letter:io_error`` faults with ``--disk-budget-mb
   0.01`` (the batches retried and byte-identical to (a), the row dead
   letters degraded then recovered, ``disk_budget_exceeded`` and
   DEGRADED in ``--health-json``); a flipped byte in a saved model,
   which ``load_model`` answers with its ``.prev``.  One JSON line
   reports the phase;
13. the serve command's self-tuning plane on phase 3's config-3 model:
   (a) 16 cleaned CSV files of 30 000 rows (seed 14), 2 a batch, served
   by ``serve --once`` in this process with ``--read-workers 1
   --prefetch-batches 1 --autotune`` and at the corners (1, 1) and (4, 4)
   of bench config 10's grid of (read workers, prefetched batches), in
   turns: batch files
   byte-identical, one upload and one download a batch, each kernel once
   a batch, each run's rows/s without its first batch (not a claim) and
   the tuner's decisions and knobs; then bench config 10's own arm, a
   tuner of its policy sharing the cold source over
   ``1 + BENCH10_REPS`` passes; (b) the same files through the
   command's engine with ``FileStreamSource(columnar=True)``:
   ``pad_assemble`` on the float32 [60 000, 78] blocks, the files of (a),
   the split of one call; (c) a ``QuerySupervisor`` with ``slo_p99_ms``
   0.5 and ``ControlPolicy(confirm=1, cooldown=0)`` from the cold floor 0
   over 20 files of 40 to 30 000 rows published one a round: at least
   one ``shape_buckets`` raise in ``controller.jsonl``, every
   ``pad_assemble`` launch at a shape of the ladder, no
   ``controller_error`` or ``autotune_error``; SIGTERM drains it halfway
   and a restart on the same checkpoint writes the ``restart`` record and
   serves the rest, the files byte-identical to an uncontrolled serve's;
   (d) 12 of the files published at once under ``max_pending_batches=2``
   with the ``oldest`` policy, then ``sample``: ``shed.jsonl`` against the
   health dump's ``shed_total_offsets``, no shed offset in an intent,
   the served rows byte-identical to an unshed serve's.  Each
   ``pad_assemble`` shape of the phase is held bitwise against its plain
   version and timed beside its bound.  One JSON line reports the phase;
14. the model lifecycle: (a) bench config 7's arc (``bench.py:894-1060``:
   ``generate_drift_frames(18, rows_per_batch=3472, shift_at=8, seed=7,
   n_classes=8)`` written by ``write_drift_stream``, a gaussian NB
   pipeline fitted on the card on the cleaned first 8 batches,
   ``DriftMonitor(3, 0.04)``, ``ModelPromoter(window=4, margin=0.05,
   probation_batches=2)``, refitting by ``partial_fit`` armed at the
   first ``drift_detected``) in this process, at ``shape_buckets`` 0 and
   256: drift 1–2 batches after the shift, 1–2 promotions, 0 rollbacks,
   0 batches stalled, macro-F1 before the shift, just after it and
   recovered within 0.02 of the JAX package's 0.5849 / 0.1555 / 0.9721
   (``bench_runs.jsonl:92-93``), the two runs' batch files
   byte-identical, one ``pad_assemble`` launch per padded dispatch (the
   engine's float64 [3 472, 78] blocks and the shadow's float32 ones, to
   4 096); (b) ``serve --drift-window 3 --promote-from <candidate>
   --shadow-window 4 --shape-buckets 256 --pipeline-depth 1`` on config
   3 (a ChiSq top-40 prefix and two 20-tree depth-10 forests fitted here,
   the incumbent on permuted labels), the head unfused: the batches
   after the swap byte-identical to the candidate's alone,
   ``model_marker.json`` generation 1, the decision in
   ``promotion.jsonl``, a restart serving the promoted model; the same
   serve killed at ``model.swap`` (``SNTC_FAULTS``), ``fsck`` and a
   restart: every batch committed once, the files byte-identical to the
   uninterrupted run's; (c) ``LogisticRegression.partial_fit`` over
   config 1's scaled rows in 8 shards on the card and the CPU: held-out
   predictions agree with the batch fit on ≥ 95 % of rows, each shard's
   history on the card within ``PF_PREFIX_TOL`` / ``PF_END_TOL`` of the
   CPU's.  Each ``pad_assemble`` shape and the unfused head's
   ``forest_traversal`` are held bitwise against their plain versions
   and timed beside their bounds.  One JSON line reports the phase;
15. bench config 6 (``bench.py:702-876``): (a) StringIndexer ->
   VectorAssembler(78) -> MinMaxScaler -> DCT -> PCA(k=32) ->
   LogisticRegression(maxIter=20) fitted on the card on phase 7's config-1
   train rows, and on the CPU: MinMax extrema bitwise, the PCA components
   up to each column's sign within ``C6_PCA_TOL``, ``explainedVariance``
   within ``C6_EV_TOL``, the LR on the card pipeline's own feature rows
   within ``C6_LR_TOL`` of the card's and on their first 20 000 within
   phase 7's config-1 rule, the CPU pipeline's LR within ``C6_E2E_TOL``,
   held-out AUC beside config 1's; bench config 6's stream (two passes
   over the held-out rows, files of 2 048 / 1 024 / 512 rows,
   ``write_bench_stream``) served in this process by the staged and the
   fused form (serial engine, append WAL, shape buckets 256,
   ``SNTC_SERVE_HOST_ROWS=0``, ``SNTC_OBS_COST_ANALYSIS=1``), ``C6_REPS``
   reps each in turns: one fused segment of 4 stages, exactly one upload
   and one download a batch, no fallback, no new signature after warmup,
   the two forms' batch files byte-identical, one ``pad_assemble`` launch
   per padded dispatch; the median rows/s of both forms and the segment's
   roofline; (b) the fused pipeline at 1 000 and 3 000 rows (both pad);
   (c) the host-serve crossover: config 1's trained LR pipeline, unfused,
   at 2 048 / 1 024 / 512 rows with ``SNTC_SERVE_HOST_ROWS`` unset (no
   head dispatch, no copy, no launch) and at 0 (the card), predictions
   agreeing on ``CROSS_AGREE`` of the rows and probabilities within
   ``CROSS_PROB_TOL``, each size's latency in both placements, and the
   sweep each head's ``HOST_SERVE_ROWS`` is set from (``crossover_sweep``:
   the LR and MLP heads at ``CROSS_SWEEP_ROWS`` rows, host against
   card); (d)
   ``serve --once --metrics-out --trace-out --device-trace`` on (a)'s
   saved pipeline with ``SNTC_OBS_COST_ANALYSIS=1``: the Prometheus text
   holds ``sntc_mfu_ratio{segment="0"}``, the Chrome trace ``stream.read``,
   ``fuse.dispatch``, ``fuse.finalize``, ``sink.deliver`` and
   ``stream.commit`` once a batch, the directory a profiler trace.  Each
   ``pad_assemble`` shape is held bitwise against its plain version and
   timed beside its bound.  One JSON line reports the phase;
16. live capture serving: (a) bench config 9 (``bench.py:1378-1540``):
   StringIndexer -> VectorAssembler(78) -> StandardScaler(withMean) ->
   LogisticRegression(maxIter=20) fitted on the card on
   ``generate_frame(62 500, seed=7)`` (cleaned, benign/attack, split
   0.8/0.2), served as ``compile_pipeline`` gives it (the scaler folded
   into the head) through one ``BatchPredictor`` (buckets 256); the pcap
   stream of ``write_capture_stream`` (61 files of 256 flows x 6 packets,
   a 30 s file gap, a tenth of each file deferred, the flush file, seed
   7) through ``FlowCaptureSource(flow_timeout=5, allowed_lateness=35)``
   and the CSV stream of the same emitted rows, serial engine, append
   WAL, ``C9_REPS`` reps each in turns: the flow counts of
   ``bench_runs.jsonl:102``
   (23 296 rows, 93 696 packets, 15 616 flows, 8 503 out of order, 616
   late, 15 617 watermark evictions, 1 packet left, 62 snapshots), the
   native parsers, the sinks equal row for row, one upload and one
   download a padded batch, one ``pad_assemble`` launch per padded
   dispatch and each launch shape bitwise against its plain version;
   (b) ``serve --from-capture pcap`` in its default form on (a)'s saved
   pipeline and stream, its predictions equal to (a)'s serial capture
   pass; the same command killed at ``flow.emit`` on its 3rd read and
   restarted, its commits and batch files equal to the unkilled run's;
   ``--from-capture netflow`` over (c)'s stream, equal to the same flow
   operator in this process; (c) bench config 15 (``bench.py:2864-
   3080``): 60 NetFlow files of 192 flows x 4 records (seed 7) through
   ``NetFlowDirSource`` and through ``build_ingress(listen_udp=0,
   seal_every=4)`` with the bench's windowed loopback sender,
   ``C15_REPS`` reps in turns: nothing dropped, the sinks equal row for
   row; the kill leg:
   ``serve --listen-udp 0`` killed inside its 2nd seal at
   ``ingress.spool``, restarted and resent to (the JAX harness's
   ``run_ingress_kill_scenario``), ``payloads == committed + journaled
   drops``, ``received == spooled + dropped``, commits and batch files
   equal to an unkilled run's; ``serve --listen-tcp 0`` fed 2 000
   held-out rows as ``frame_rows`` payloads, equal to the same rows
   served from a CSV file; (d) ``pad_assemble`` timed at float32 [384,
   78] -> 512, [797, 78] -> 1 024 and [768, 78] -> 1 024 beside its
   bound and ``index_select``.  One JSON line reports the phase;
17. the multi-tenant serve daemon: (a) bench config 8 (``bench.py:
   1117-1355``) on config 9's data: StringIndexer -> VectorAssembler(78)
   -> StandardScaler(withMean) -> LR(maxIter=20), and the same with
   gaussian NB, fitted on the card, each served through one
   ``BatchPredictor(bucket_rows=256)`` shared by every tenant and leg;
   10 tenants (``lr00``-``lr07``, ``nb00``-``nb01``) each serving its own
   copy of the test split (files of 1 024 / 512 / 256 rows); leg S (one
   plain engine a pipeline over the combined streams), leg A (the clean
   daemon), leg B (with a noisy tenant: 3 passes, every 3rd file
   poisoned, backlog cap 16) and leg A again with
   ``SNTC_SERVE_HOST_ROWS=0``, every batch on the card: no new row shape
   after the warmup, the noisy tenant QUARANTINED after 1 episode with
   21 poisoned files and 47 shed offsets (``bench_runs.jsonl:96-97``),
   every well-behaved tenant OK and its batch files byte-identical across
   the four legs, one ``pad_assemble`` launch per padded dispatch and
   each launch shape bitwise against its plain version, where each batch
   ran (the transfer ledgers); (b) ``python -m sntc_tpu_torch serve-daemon
   --once`` over three of (a)'s tenants (two on the saved LR checkpoint,
   one on the NB one): every tenant OK, no new row shape, drained, the
   predictions equal to (a)'s, ``fsck --tenant-tree`` clean; the chaos
   harness's multi-tenant kill (at ``tenant/t1/stream.wal``, then a
   restart) and isolation (``tenant/t1/sink.write`` failing for good)
   legs in daemon processes, against an unkilled run; (c) bench config
   11's arm B (``bench.py:1981-2075``): the hand-tuned config-8 flags
   against cold defaults with ``ServeDaemon(controller=True)`` under its
   achievable SLOs, ``C11_REPS`` reps in turns, every tenant OK and the
   predictions
   equal; then three tenants at depth 2 on the card with one under an
   unreachable floor: ``controller.jsonl`` written and reconciled by a
   second daemon's ``restart`` record.  Every ``pad_assemble`` shape is
   timed beside its bound and ``index_select``.  One JSON line reports
   the phase.
18. warm-standby replication, bench config 18's disaster drill
   (``bench.py:3716-3900``) in the kernel form: config 9's LR pipeline
   (phase 17's fit), 12 files of 512 rows (``BENCH18_PHASE_FILES``) and
   one of 200 rows, every serve with ``--shape-buckets 256`` (the 200-row
   file pads ``[200, 78] f64 -> 256``; a 512-row file fills its bucket);
   (a) an unfailed ``serve --once`` beside a replicated ``serve
   --standby-root``, which is SIGKILLed once the barrier of the first
   batch past the pre-kill phase is sealed (the primary then idles, so
   the kill lands between ship passes), ``promote_standby``, and a
   ``serve --once`` resumed on the promoted tree: promotion ok, the loss
   law exact, nothing quarantined, the promoted and final sinks bitwise
   the reference's, the RPO counts 0 by construction (the kill waits for
   its batch's barrier); (b) the serve killed
   inside ``repl.ship`` / ``repl.apply`` / ``repl.barrier`` at the JAX
   chaos matrix's calls, the three beside each other and beside (a)'s
   processes: the torn standby
   promotes to its last sealed barrier with its strays quarantined (at
   ``repl.apply`` at least one) or refuses and leaves no tree, the clean
   restart converges bitwise to (a)'s reference and its standby then
   promotes with zero tail loss; ``fsck --standby`` on (a)'s primary and
   standby.  Each serving process that printed a line launched
   ``pad_assemble`` once, at the 200-row file; every launch shape is held
   against the plain version and timed beside its bound and
   ``index_select``;
19. the elastic serve fleet, bench config 14 (``bench.py:2562-2843``) in
   the kernel form: 10 tenants of 3 + 3 files of 512 rows and one of 200
   rows each, an in-process ``FleetCoordinator`` (lease TTL 1 s) over 3
   ``fleet-serve --fleet-worker-id`` processes on the card; an unkilled
   pass, then a pass that SIGKILLs the most-loaded worker once every
   tenant has committed a batch, waits for the dead-worker recovery and
   scales out a fourth worker before the second half is fed: the
   tenants' sinks byte-identical across the passes, no migration
   reverted, every tenant on exactly one worker's tree, the dead worker's
   trees retired (not deleted), ``fsck --fleet-root`` clean, and
   ``fleet-restore-retired`` of one retired tree verified by ``fsck``.
   The drained workers' ``pad_assemble`` launches sum to the 200-row
   files they served (the SIGKILLed worker prints no line and served
   none); the launch shape is held and timed as in 18;
20. the estimators of bench.py's families pass and ``stat/``: (a) the
   families' data (``bench.py:3959-4094``, ``default_rng(7)`` in its
   draw order at 200 000 rows) fitted on the card cold, warm and under a
   profiler window (the bench's four) — KMeans (200 000 x 78, k 8, 20
   iterations), BisectingKMeans (k 8) on the same rows and (k 5) on the
   GMM's rows, GaussianMixture (50 000 x 20, k 5, 30 iterations, tol
   1e-3), LDA (5 000 x 1 000, k 10, 20 minibatches of 0.1), implicit ALS
   (500 000 ratings, 20 000 x 2 000, rank 16, 5 iterations), PIC (4
   blocks of 750 vertices) — each held against the same fit on the CPU,
   made by ``--side family_fits`` in a process of its own started after
   phase 12, with the tests' tolerances (KMeans-like predictions equal
   except on near-tie rows; LDA's log perplexity within 1 % and one
   E-step at [5 000, 1 000] within 1e-4; BisectingKMeans on the
   structureless lognormal rows only to the same tree and a cost within
   ``FAM_BISECT_COST_RTOL``), ``ClusteringEvaluator`` on the KMeans
   predictions, the GMM's mean log-likelihood and the LDA log perplexity
   printed beside the JAX package's CPU records; (b) at config 3's width
   (phase 4's 199 800 training rows, 78 features, 15 classes, 32
   quantile bins): ``ChiSquareTest`` (one ``tree_hist`` launch [78, N]
   -> [78, 32, 15]), ``UnivariateFeatureSelector`` categorical (one more
   launch) and ANOVA top 40, ``ANOVATest``, ``FValueTest``,
   ``VarianceThresholdSelector``, pearson and spearman ``Correlation``,
   ``Summarizer``, ``KolmogorovSmirnovTest``, and a ``ChiSquareTest`` on
   a feature of 4 096 quantile bins (the kernel's rows regime): the
   chi-square tests, KS, the selections and the Summarizer's counts and
   extrema bitwise the CPU's, the moment statistics on the card and the
   CPU within ``ST_MOMENT_RTOL`` of their float64 sums; both
   contingencies bitwise against the plain version and timed beside
   their bound and ``index_add_``;
21. the fusible feature stages and the other supervised estimators: (a)
   on config 3's flows (phase 4's split, relabelled benign / attack) the
   pipeline StringIndexer -> VectorAssembler (78, keep) -> VectorSlicer
   onto the 40 features config 3's ChiSqSelector keeps ->
   PolynomialExpansion (degree 2: 860 float64 columns) -> binary LR (20
   iterations), fitted on the card, saved and served by ``python -m
   sntc_tpu_torch serve`` in its default form and in the staged, serial
   form (the two processes together) over micro-batches of 1 000, 4 096
   and 65 536 rows: one fused segment of the slicer, the expansion and
   the head, batch files byte-identical, ``pad_assemble`` once a padded
   batch; a small serve in this process of a 4-column slicer, the
   Bucketizer a QuantileDiscretizer (16 buckets, keep) fits on the flow
   duration and their Interaction, fused into one segment with its LR
   head, bitwise the staged stages; (b) on config 4's training flows:
   LinearRegression (normal; l-bfgs with elasticNet 0.5), the GLMs
   (gaussian/identity, poisson/log, gamma/log, binomial/logit, tweedie
   1.5), Weibull AFT censored at the 90th percentile of the duration,
   FMClassifier and FMRegressor (factor size 8, 100 steps), isotonic
   calibration of a head's probabilities and VectorIndexer (16
   categories) over the 78 features, each timed and profiled on the card
   and held against the same fit on the CPU, made by ``--side p21_fits``
   in a process of its own started after phase 12 with its summation
   order pinned, with the limits the ``P21_`` constants state (the
   degree-2 heads on their first iterations, end objective, AUC and
   agreement, beside the CPU's refits under other summation orders; the
   CPU's degree-2 fit served on the card against the CPU, and its
   calibration); both serves' ``pad_assemble`` shapes held against the
   plain version and timed beside their bound;
22. the object-column group and the long tail, in this process, on
   config 1's flows (phase 15's data, seed 7): each held-out flow as a
   flow document, one token ``"{j}:{bucket}"`` a feature (its bucket of
   ``QuantileDiscretizer(numBuckets=8)`` fitted on the training rows);
   (a) Tokenizer -> StopWordsRemover -> NGram(2) -> HashingTF(4096) over
   the 49 950 documents, IDF fitted on the card and on the CPU
   (``docFreq`` bitwise, the idf equal), CountVectorizer and
   FeatureHasher on the same frame; (b) Word2Vec at its defaults
   (``maxIter=1``) on the first 2 000 documents on the card, against the
   same fit (the same numpy uniforms) made by ``--side p22_fits`` on the
   CPU, and the fit's first 512 steps again on both, the card's in a
   profiler window (its device time and idle share); each card run held
   against the CPU's by how far its steps moved the vectors (the input
   vectors of the fit and the window, the window's output vectors),
   relative to how far they moved; (c) BRP (3
   tables) on the standard-scaled training rows, hashes card against CPU
   except within a few ulps of a bucket edge, 10 nearest neighbours of 5
   held-out keys, a join of 4 096 held-out against 20 000 training rows
   (pairs equal, distances within 1e-6 relative), MinHash (5 tables) on
   the held-out rows binarized at the training first quartile (hashes
   bitwise, a join at Jaccard distance 0.3 of 2 000 x 2 000 rows); (d)
   FPGrowth on the documents' token sets (its rules predicting a hidden
   feature's token, scored by MultilabelClassificationEvaluator),
   RFormula and SQLTransformer on the flows, RankingEvaluator on (c)'s
   neighbours (relevant: the training rows of the key's label);
23. bench config 17 (``bench.py:3316-3703``), the mesh substrate
   (``sntc_tpu_torch/parallel``) on the one card, whose meshes name
   ``cuda:0`` several times (virtual shards: no number here is a
   scaling), on config 17's 62 500 flows (seed 7, split 0.8/0.2): (a)
   config 6's pipeline fitted, its stream (phase 15's files, bucket
   floor 256, the serial engine) served direct, at serve mesh 1 and at
   serve mesh ``[cuda:0] * 4`` (each bucketed batch split into 4 row
   blocks), ``P23_REPS`` reps in rotated order: direct and mesh-1 sinks
   byte-identical, mesh-4 predictions equal and probabilities within
   1e-5 (rows not bitwise counted), the median rows/s and their ratios
   printed, ungated; (b) config 2's pipeline (scaler -> MLP [78, 64,
   15], 100 iterations) fitted cold and warm at mesh 1 and ``[cuda:0] *
   4``: macro-F1 within 0.02, one objective evaluation at the same
   weights within 1e-5 relative; (c) KMeans (k 8, 20 iterations) on
   (a)'s PCA features at mesh sizes 1, 2, 4, 8: centers within 1e-3 of
   mesh 1's, ``sntc_collective_bytes_moved_total`` 0 at mesh 1 and
   strictly increasing above, equal dispatch counts above 1; (d) ALS on
   the bench's 40 x 30 ratings at ``[cuda:0] * 8``, ``collective.
   dispatch`` armed ``device_lost`` after 3: one ``mesh_resize`` 8 -> 4,
   the gauge at 4, RMSE < 0.1 and within 0.02 of the unfaulted fit's,
   the domain not failed, no tenant strike; (e) the reduced config-3 fit
   (phase 4's first 20 000 rows, depth 6) at mesh 1 and ``[cuda:0] *
   4``: the forests equal node for node, 4 times the ``tree_hist``
   launches (one a shard), both served on the next 20 000 rows through
   ``forest_traversal`` with equal predictions, the device quantile
   edges bitwise the host path's; (f) two gloo rank processes on
   ``cuda:0`` and one nccl rank, started with the launcher environment
   after (a): StandardScaler's moments of integer-valued rows bitwise
   the one-process mesh's (``[cuda:0] * 2``, and mesh 1 for the nccl
   rank), (c)'s KMeans at 2 ranks within 1e-5;
24. ``mesh=`` on the classification path, in this process, on phase 4's
   199 800 training rows (78 features, 15 classes) at mesh 1 and at
   ``[cuda:0] * 4`` (virtual shards: no number here is a scaling): (a)
   gaussian NaiveBayes, its fit and ``partial_fit`` over 4 row blocks;
   (b) OneVsRest over LogisticRegression (20 iterations; 15 lanes in one
   loop); (c) CrossValidator over LR, regParam {1e-4, 1e-2} x 2 folds
   (one fold x grid lane loop); (d) a binary (benign/attack) LinearSVC,
   20 iterations; (e) the evaluator's macro-F1, f1 and accuracy of (b)'s
   training predictions, bitwise at both sizes; (f)
   UnivariateFeatureSelector (χ² at 32 bins, ANOVA),
   VarianceThresholdSelector, MaxAbsScaler, ChiSquareTest on the 32-bin
   features, Correlation, the Summarizer; (g) IDF over a ``[20 000, 1
   024]`` hashed count matrix of the flows' (feature, bin) tokens.  (b)
   to (d) fit the standard-scaled features at the train command's
   regParam 1e-4.  Each mesh-4 result against its mesh-1 twin at the
   CPU tests' tolerances: moments 1e-5, the CV's best model 5e-4, counts
   and selections bitwise; the lanes' and the hinge's objectives at the
   mesh-1 solution through both programs within 1e-5 of their start,
   their paths within 1e-3, predictions on the training rows equal on
   99.9 % (the hinge's on 99 %: its flat optimum parts at 20
   iterations); ``tree_hist``
   launched once a shard (4 against 1) for the selector's χ² and
   ChiSquareTest, every shard's launch bitwise its plain version; the NB
   and OneVsRest-LR models of both sizes served once each on a ``[1 000,
   78]`` float32 batch (one ``pad_assemble`` launch to 1 024 rows each),
   predictions equal (LR: 99.9 %); its budget ``P24_BUDGET_S`` printed;
25. ``mesh=`` on the regression fits and the families, in this process
   (virtual shards: no number here is a scaling): (a) phase 21's fits
   (LinearRegression normal and elastic-net, the five GLMs, AFT, both
   FMs) on its inputs at ``[cuda:0] * 4``, each against phase 21's own
   card fit (mesh 1, bitwise its path) at phase 21's limits: the normal
   solve's predictions, the GLMs' coefficients and deviance, the other
   fits' objective histories (and iterations); (b) phase 20's
   GaussianMixture, BisectingKMeans on the blobs (not on the lognormal
   rows: cut for the smoke's time), LDA and PIC on its data at
   ``[cuda:0] * 4`` against phase 20's card fits at its limits, LDA's
   E-step fed one γ₀ at both sizes;
   (c) the LinearRegression and GaussianMixture models of both sizes
   served once each on a ``[1 000, C]`` float32 batch (one
   ``pad_assemble`` launch to 1 024 rows each, 4 in all), predictions
   equal (LR within the normal solve's limit); each leg's seconds at
   both sizes and its budget ``P25_BUDGET_S`` printed.

The run keeps the bytecode of every Python process it starts under
``sntc_tpu_torch/_build/pycache`` (``cache_bytecode``): the card's
machine sets ``PYTHONDONTWRITEBYTECODE`` and ships torch without its
``__pycache__``, so each process otherwise compiles torch afresh.
Phase 3's and phase 12's serving processes print their way to the card
(``startup split``: interpreter and imports, CUDA context,
``library()``, the model's load, the first batch, the rest).

Phase 7's staged and default config-2 serves and phase 10d's tuned model
run with ``SNTC_SERVE_HOST_ROWS=0``, every batch on the card, so their
in-process comparisons hold the card's path (the MLP/LR heads'
host-serve crossover would serve a small host batch on the host); phase
8 serves config 2's default form once more with the variable unset, the
crossover's default placement (``serve_mlp_rule``).  Independent train and serve processes of
phases 4 and 6, 7 and 9 start together.  One ``phase_seconds`` line
before the kernels line gives each phase's wall-clock (``clock``), and a
``sides`` line before it each CPU side process's span and the seconds
of each phase it overlapped.
``--phases`` runs the named phases alone, each after what it needs
(``main_phases``).

Exits non-zero without CUDA, and in a directory that holds this script
and nothing else of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import Future, ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch
from scipy.special import psi

from sntc_tpu_torch.core.base import Estimator, Pipeline, PipelineModel
from sntc_tpu_torch.core.frame import Frame, object_column, to_host
from sntc_tpu_torch.data import (
    CICIDS2017_CONTRACT,
    CICIDS2017_FEATURES,
    CICIDS2017_LABELS,
    STREAM_SIZES,
    clean_flows,
    generate_frame,
    write_bench_stream,
    write_capture_stream,
    write_raw_csv,
)
from sntc_tpu_torch.feature import (
    DCT,
    PCA,
    ChiSqSelector,
    ChiSqSelectorModel,
    Interaction,
    MaxAbsScaler,
    MinMaxScaler,
    PolynomialExpansion,
    QuantileDiscretizer,
    StandardScaler,
    StringIndexer,
    StringIndexerModel,
    UnivariateFeatureSelector,
    VarianceThresholdSelector,
    VectorAssembler,
    VectorIndexer,
    VectorSlicer,
)
from sntc_tpu_torch.feature import (
    IDF,
    BucketedRandomProjectionLSH,
    CountVectorizer,
    FeatureHasher,
    HashingTF,
    MinHashLSH,
    NGram,
    RFormula,
    SQLTransformer,
    StopWordsRemover,
    Tokenizer,
    Word2Vec,
)
from sntc_tpu_torch.feature.expansion import _expansion_plan
from sntc_tpu_torch.feature.word2vec import (
    UNIFORM_CHUNK,
    numpy_uniforms,
    skipgram_inputs,
    train_epochs,
)
from sntc_tpu_torch.kernels import _build, histogram
from sntc_tpu_torch.kernels.assemble import (
    pad_launch_shape,
    pad_rows_cuda,
    pad_rows_reference,
)
from sntc_tpu_torch.kernels.forest import (
    forest_leaf_stats_cuda,
    forest_leaf_stats_reference,
)
from sntc_tpu_torch.kernels.histogram import (
    tree_hist_cuda,
    tree_hist_plan,
    tree_hist_reference,
)
from sntc_tpu_torch.models import (
    ALS,
    LDA,
    AFTSurvivalRegression,
    BisectingKMeans,
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    FMClassifier,
    FMRegressor,
    GaussianMixture,
    GBTClassifier,
    GBTRegressor,
    GeneralizedLinearRegression,
    IsotonicRegression,
    KMeans,
    LinearRegression,
    LinearSVC,
    LogisticRegression,
    MultilayerPerceptronClassifier,
    NaiveBayes,
    OneVsRest,
    FPGrowth,
    PowerIterationClustering,
    RandomForestClassifier,
    RandomForestRegressor,
)
from sntc_tpu_torch.models.kmeans import _sq_dists
from sntc_tpu_torch.models.summary import TrainingSummary
from sntc_tpu_torch.models.lda import e_step, gamma0
from sntc_tpu_torch.models import linear_svc as svc_module
from sntc_tpu_torch.models import logistic_regression as lr_module
from sntc_tpu_torch.models.one_vs_rest import OneVsRestModel, _build_fused_ovr
from sntc_tpu_torch.models.tree import gbt as gbt_module
from sntc_tpu_torch.ops.binning import bin_features, quantile_bin_edges
from sntc_tpu_torch.app import serving_form
from sntc_tpu_torch.data import load_csv
from sntc_tpu_torch.evaluation import (
    BinaryClassificationEvaluator,
    ClusteringEvaluator,
    MulticlassClassificationEvaluator,
    MultilabelClassificationEvaluator,
    RankingEvaluator,
    RegressionEvaluator,
)
from sntc_tpu_torch.kernels import LAUNCHES, PAD_LAUNCH_SHAPES, reset_launches
from sntc_tpu_torch.mlio import load_model, save_model
from sntc_tpu_torch.models import from_numpy_forest
from sntc_tpu_torch.models.tree.random_forest import _rf_serve
from sntc_tpu_torch.ops.lbfgs import LbfgsResult, full_f32
from sntc_tpu_torch.utils.profiling import upload
from sntc_tpu_torch.flow import FlowCaptureSource
from sntc_tpu_torch.fuse import compile_pipeline, fused_segments, fusion_stats
from sntc_tpu_torch.serve import (
    BatchPredictor,
    CsvDirSink,
    FileStreamSource,
    IngressSpool,
    NetFlowDirSource,
    StreamingQuery,
    build_ingress,
    bucket_rows_for,
    frame_rows,
    wire_committed_offset,
)
from sntc_tpu_torch.models.mlp import mlp_value_and_grad
from sntc_tpu_torch.obs.metrics import registry
from sntc_tpu_torch.parallel import (
    make_mesh,
    set_collective_domain,
    shard_batch,
    shard_weights,
)
from sntc_tpu_torch.parallel.context import reset_serve_mesh, set_serve_mesh
from sntc_tpu_torch.resilience.faults import KILL_EXIT_CODE
from sntc_tpu_torch.resilience.replicate import last_barrier, promote_standby
from sntc_tpu_torch.serve.fleet import FleetCoordinator
from sntc_tpu_torch.stat import (
    ANOVATest,
    ChiSquareTest,
    Correlation,
    FValueTest,
    KolmogorovSmirnovTest,
    Summarizer,
    factorize,
)
from sntc_tpu_torch.tuning import CrossValidator, TrainValidationSplit

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
TREES, DEPTH, TOP, CLASSES = 20, 10, 40, 15  # bench config 3
BATCHES = [512, 1000, 1024, 2048, 50000, 65536]  # rows per micro-batch
# forest_traversal's timed launch shapes: serve micro-batches (after
# padding) and the train phase's held-out evaluation
FOREST_ROWS = (512, 2048, 49950, 65536)
BUCKET_FLOOR = 256
PAD_ODD_COLUMNS = 13  # phase 2's pad_assemble width, not a multiple of 4
SPLIT_REPS = 5  # repetitions of each part of phases 8 and 12's pad split
BINS = 32  # maxBins of the forest and the selector
TRAIN_ROWS = 250_000  # generate_frame rows of the train phase, before cleaning
TEST_FRACTION = 0.2
F1_FLOOR = 0.76  # the JAX package reached 0.7718 on bench config 3
REDUCED_ROWS, REDUCED_DEPTH = 20_000, 6
GAIN_TIE_RTOL = 1e-6  # near-tie rule for trees grown by two devices
HIST_TOL = 1e-5  # tree_hist on fractional stats, per cell, of sum |contrib|
U_F32 = 2.0 ** -24  # float32's unit roundoff
GBT_BINS, GBT_NODES, GBT_STATS = 128, 8, 3  # bench config 4: depth 4, 128 bins
# bench config 4 (bench.py:399-424): OneVsRest over 15 GBT classes, 10
# rounds of depth 4, step 0.1, 128 bins, on the 78 raw features
GBT_ROWS = 125_000  # generate_frame rows, before cleaning (bench.py:238)
GBT_DATA_SEED = 7  # bench.py's own data seed (bench.py:225, :247)
GBT_ROUNDS, GBT_DEPTH, GBT_STEP = 10, 4, 0.1
GBT_F1_FLOOR = 0.91  # the JAX package reached 0.9307 on bench config 4
GBT_BATCHES = [1000, 4096, 16384]  # served micro-batches; 1000 pads
GBT_REDUCED_ROWS, GBT_REDUCED_ROUNDS = 20_000, 3
# the near-tie rule and the loss tolerance of the reduced config-4 fit,
# card against CPU.  The CPU's own gap between histograms with and
# without sibling subtraction (the card subtracts, the CPU does not) was
# 8.6e-7 of 4W in weighted gains and 3.3e-7 in log-loss; the card, which
# also sums in atomic order, measured 1.3e-5 and 9.7e-6 against a first
# rule of 3e-5 and 1e-5 (NVIDIA H100 80GB HBM3, 700 W): the rule keeps
# ~8x over the card's gaps, far below the f32 bound of a hot cell's sums
# (~50 000 rows, 3e-3)
GBT_TIE_TOL = 1e-4
GBT_LOSS_ATOL = 1e-4
DT_DEPTH = 5  # the decision tree of the config-4 phase, 128 bins
NODE_GROUP_BYTES = 2 ** 31  # the grower's level working-set budget
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, non-tensor-core fp32
# bench configs 2 and 1 (bench.py:348-369, :325-345): the MLP [78, 64,
# 15] and the binary LR (regParam 1e-4), 100 LBFGS iterations each, on
# bench.py's data seed 7, split 0.8/0.2 with seed 0
LBFGS_DATA_SEED = 7
MLP_ROWS, LR_ROWS = 500_000, 250_000  # generate_frame rows (bench.py:245-246)
MLP_LAYERS = [78, 64, 15]
LBFGS_ITERS = 100
LR_REG = 1e-4
MLP_F1_FLOOR = 0.96  # the JAX package reached 0.9737 (bench_runs.jsonl:5)
LR_AUC_FLOOR = 0.97  # the JAX package reached 0.9812 (bench_runs.jsonl:1)
MLP_BATCHES = [1000, 4096, 65536]  # served micro-batches; 1000 pads
# served probabilities: padded against unpadded on the card, and the card
# against the CPU (other cuBLAS kernels per shape; f32 sums in other
# orders); predictions equal where the top two lie further apart
MLP_SERVE_TOL = 1e-4
# reduced LBFGS fits, card against CPU, each gap as a share of the
# starting objective.  First set from two CPU fits that sum in other
# orders (1 and 8 threads) of the same 20 000 rows: the MLP 9.1e-7 over
# its first 29 iterations, then drifting to 5.6e-4 (a non-convex loss),
# the end objectives 1.3e-8 apart; the LR 6.0e-6 over its first 20
# iterations, 8.5e-5 over all, the end objectives 1.3e-6 apart.  The
# card's MLP fit parts from the CPU's sooner (8.6e-5 by iteration 20,
# 5.9e-4 at most, end 5.8e-10; NVIDIA H100 80GB HBM3, 700 W): the MLP's
# prefix is cut to its first 5 iterations, the LR's stays 20
REDUCED_LBFGS_ROWS = 20_000
LBFGS_PREFIX = {"mlp": 5, "lr": 20}
LBFGS_PREFIX_TOL = 1e-5
LBFGS_ALL_TOL, LBFGS_END_TOL = 2e-3, 1e-4
LBFGS_CKPT_EVERY = 25
# phase 8: the serve command's default form against its serial, staged
# form (the JAX command's --no-fuse --pipeline-depth 1 --wal-mode append)
FORM_FILES, FORM_FILE_ROWS, FORM_FILES_PER_BATCH = 12, 30_000, 2
# each form serves the stream this many times, in turns (once: the
# smoke's time holds no second run)
FORM_RUNS = 1
STAGED_FORM = ["--no-fuse", "--pipeline-depth", "1", "--wal-mode", "append"]
# phase 9: train --estimator nb|svc on config 2's flows, their serve and
# evaluate, and the tree regressors on config 4's flows
NB_SVC_BATCHES = [1000, 4096, 65536]  # served micro-batches; 1000 pads
# the JAX package's train command reached 0.5950 (nb) and 0.8847 (svc)
# on these flows, on the CPU
NB_SVC_F1_FLOOR = {"nb": 0.585, "svc": 0.86}
NB_RAW_RTOL = 1e-12  # float64 likelihoods, card against CPU
# the fit's f32 one-hot sums in two orders, card against CPU: classes of
# up to ~320 000 rows, whose sums may part by ~sqrt(n)·u ≈ 3e-5 of their
# mass; measured 5.4e-7 (means) and 1.64e-5 (variances) on an NVIDIA
# H100 80GB HBM3, 700 W
NB_MOMENT_RTOL = 1e-4
EVAL_ROWS = 20_000
REG_TARGET = "Flow IAT Mean"  # taken out of the 78 raw features; log1p
REGRESSORS = {
    "dt": (DecisionTreeRegressor, {"maxDepth": 5, "maxBins": 128}),
    "rf": (RandomForestRegressor, {"numTrees": 20, "maxDepth": 10,
                                   "maxBins": 32}),
    "gbt": (GBTRegressor, {"maxIter": 10, "maxDepth": 4, "stepSize": 0.1,
                           "maxBins": 128}),
}
# held-out R² of log1p(Flow IAT Mean): 0.396 / 0.457 / 0.419 on an
# NVIDIA H100 80GB HBM3, 700 W (the fractional sums' order may move a
# near-tie split between runs)
REG_R2_FLOOR = {"dt": 0.35, "rf": 0.4, "gbt": 0.37}
# phase 10: LogisticRegression's lane fits and tuning/.  10a holds each
# one-vs-rest lane, on the rows in their order and in the REORDER_SEEDS
# orders, against the single fit on the rows in their order: its
# objective history within LANE_PREFIX_TOL of the starting objective over
# the first LANE_PREFIX iterations and LBFGS_ALL_TOL over all, its final
# objective within LANE_END_TOL of it.  Set from 60 readings (15 classes
# x 4 orders) on an NVIDIA H100 80GB HBM3, 700 W: the lanes' early gap
# at most 1.03e-4 (the single fit on reordered rows against itself
# 3.84e-5), their end gap at most 8.21e-6 (reordered 2.72e-6; a fit
# through the lane program alone that stops 11 iterations early at the
# tol edge 1.91e-5).  The lane minimizer alone keeps within 2.53e-7
# early: the gap comes from the 15-lane product's rounding, which the
# rare classes' fits at tol 1e-6 amplify
LANE_PREFIX = 10
LANE_PREFIX_TOL, LANE_END_TOL = 3e-4, 1e-4
# one other order (3 before the smoke's time was cut)
REORDER_SEEDS = (SEED,)
LANE_F1_ATOL = 0.005  # held-out macro-F1, lanes against single fits
CV_GRID = [{"regParam": r, "elasticNetParam": a}
           for r in (1e-4, 1e-3, 1e-2) for a in (0.0, 0.5)]
CV_FOLDS = 3
CV_METRIC_ATOL = 1e-4
PIPE_ROWS = 100_000  # config 2's flows of the pipeline CV and TVS
PIPE_GRID = [{"regParam": 1e-4}, {"regParam": 1e-2}]
PIPE_FOLDS = 2
PIPE_METRIC_ATOL = 1e-3
TVS_RATIO = 0.8
TUNED_BATCHES = [1000, 4096, 65536]  # served micro-batches; 1000 pads
# phase 11: the serve command's failure handling on config 3
FAULT_FILES, FAULT_FILE_ROWS, FAULT_FILES_PER_BATCH = 8, 30_000, 2
OOM_FAULTS = "device.dispatch:device_oom:0.3:7"
# the allocator cap of the real OOM, as a share of one clean dispatch's
# reserved peak above the model's resident memory
OOM_CAP_SHARE = 0.8
FAULT_WAIT_S = 120.0  # the longest a phase-11 serving process is awaited
# phase 12: row admission and the storage plane on config 3
DP_FILES, DP_FILE_ROWS, DP_FILES_PER_BATCH = 6, 30_000, 2
DP_EXACT_ROWS = 65_536  # one file that fills its bucket exactly
DP_KILL = "stream.commit:kill:0.5:0"  # lets batch 0 commit, kills batch 1's
# storage.wal fails its 3rd and 10th write; the row dead letters' 2nd
# write fails and the 3rd recovers
DP_DISK_FAULTS = "storage.wal:enospc:0.2:1,storage.dead_letter:io_error:0.5:9"
DP_BUDGET_MB = 0.01
# phase 13: the self-tuning plane on config 3.  (a) and (b): 16 cleaned
# files of 30 000 rows (seed 14), 2 a batch; (a) the cold engine with
# --autotune against bench config 10's hand-tuned grid of (read workers,
# prefetched batches) (bench.py:1553); (d) their first 12 published at
# once under --max-pending-batches 2; (c) a stream of varying batch sizes
# (small ones too: the ladder's floors move only batches under 512 rows)
# under a p99 target no batch meets
ST_FILES = 16
ST_FILE_ROWS = 30_000
ST_FILES_PER_BATCH = 2
# bench.py:1548's grid less its two mixed corners, and one pass after
# the convergence pass where bench.py:1554 runs 3, to hold the smoke's
# time
BENCH10_GRID = ((1, 1), (4, 4))
BENCH10_REPS = 1
SHED_FILES = 12
SHED_PENDING = 2
CTL_SIZES = (1000, 30000, 300, 7000, 100, 15000, 40, 2000, 500, 24000,
             200, 9000, 3000, 30000, 64, 12000, 150, 5000, 20000, 400)
CTL_P99_MS = 0.5
# phase 14: the model lifecycle.  (a) is bench config 7 with its own
# constants (bench.py:885-890, rows 62 496 // 18 a batch, bench.py's SEED
# 7) and the JAX package's recorded arc (bench_runs.jsonl:92-93, JAX on
# the CPU), each macro-F1 to be met within LC_F1_ATOL
LC_BATCHES, LC_SHIFT, LC_ROWS, LC_CLASSES, LC_SEED = 18, 8, 3472, 8, 7
LC_DRIFT_WINDOW, LC_DRIFT_THRESHOLD = 3, 0.04
LC_SHADOW_WINDOW, LC_MARGIN, LC_PROBATION = 4, 0.05, 2
LC_F1_REF = {"f1_pre_shift": 0.5849, "f1_post_shift_degraded": 0.1555,
             "f1_recovered": 0.9721}
LC_F1_ATOL = 0.02
# (b): the serve command on config 3, 8 labelled files of 6 000 rows (one
# a batch, padded to 8 192); the first 6 served with the promotion armed,
# the last 2 after a restart
SWAP_FILES, SWAP_FIRST, SWAP_FILE_ROWS = 8, 6, 6000
SWAP_TRAIN_ROWS = 60_000  # the candidate forest's labelled rows
SWAP_FLAGS = ["--pipeline-depth", "1", "--drift-window", "3",
              "--shadow-window", "4"]
# (c): LR partial_fit over config 1's scaled rows in PF_SHARDS shards,
# held-out predictions against the batch fit (docs/RESILIENCE.md's
# contract) and each shard's history on the card against the CPU's
# (prefix over LANE_PREFIX iterations, end) as a share of its start.
# Set from the 8 shards' readings on an NVIDIA H100 80GB HBM3, 700 W:
# prefix gaps 2.8e-7 to 3.92e-4 (a shard starts from the previous
# shard's end, which the two devices reach after different iteration
# counts at the tol edge: 47 against 37 on shard 2), end gaps at most
# 3.07e-5; held-out agreement with the batch fit 0.9949
PF_SHARDS = 8
PF_AGREE = 0.95
PF_PREFIX_TOL, PF_END_TOL = 1e-3, 1e-4
# phase 15: bench config 6 (bench.py:702-876) on config 1's flows of
# phase 7, its stream two passes over the held-out rows in files of 2 048
# / 1 024 / 512 rows; 1 rep a form where the bench runs 5
# (BENCH6_REPS), to hold the smoke's time
C6_PCA_K, C6_LR_ITERS = 32, 20
C6_PASSES, C6_REPS = 2, 1
C6_PAD_ROWS = (1000, 3000)  # (b): both pad (to 1 024 and 4 096)
C6_OBS_FILES = 6  # (d): the stream's first files, one a batch
# the card's fit against the CPU's on the same rows, set from runs 1-2's
# readings (NVIDIA H100 80GB HBM3, 700 W): PCA components (up to sign)
# 3.26e-5 apart (the f32 moments' rounding over 199 800 rows, through
# the eigen-gaps), explained variance 1.02e-8; the LR on the card
# pipeline's own 199 800 feature rows 1.46e-5 of the start apart over its
# 20 iterations (C6_LR_TOL; phase 7's rule, LBFGS_PREFIX_TOL, was set on
# 20 000 rows and holds on the first 20 000 of them), and the CPU
# pipeline's LR on its own PCA features 1.19e-5 (C6_E2E_TOL).  Each LR
# limit lies below its TF32 control's reading (the same rows rounded to
# TF32: 7.50e-5; the pipeline with TF32 products: 6.24e-4), which the
# phase checks on every run
C6_PCA_TOL, C6_EV_TOL = 1e-4, 1e-7
C6_LR_TOL, C6_E2E_TOL = 5e-5, 1e-4
# (c): config 1's LR on the host (float32 numpy) against the card
# (float32): predictions and probabilities; each batch's latency is the
# median of CROSS_REPS calls
CROSS_AGREE, CROSS_PROB_TOL, CROSS_REPS = 0.999, 1e-5, 20
# (c)'s sweep, the readings each head's HOST_SERVE_ROWS is set from: the
# LR and MLP heads at full width on host rows of these sizes
CROSS_SWEEP_ROWS = (64, 256, 512, 1000, 2048, 4096, 8192, 16384, 65536)
SWEEP_REPS = 5  # each size's calls, the median kept


def together(*calls):
    """Run independent calls at once, each mostly the wait on a child
    process (a train or a serve command), in threads; their results in
    order.  A failure of any fails the phase."""
    with ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(fn, *args) for fn, *args in calls]
        return [f.result() for f in futures]


PHASE_SECONDS: dict = {}
PHASE_SPANS: list = []  # (phase, start, end) on time.time()
RUN_T0 = time.time()


@contextlib.contextmanager
def clock(name: str):
    """Add the block's wall-clock seconds to ``PHASE_SECONDS[name]``, and
    its span (``time.time()``) to ``PHASE_SPANS``."""
    t0, w0 = time.perf_counter(), time.time()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        PHASE_SECONDS[name] = round(PHASE_SECONDS.get(name, 0.0) + dt, 1)
        PHASE_SPANS.append((name, w0, time.time()))
        log(f"[clock] {name}: {dt:.1f} s")


def side_spans(sides: dict) -> dict:
    """Each side process's start and end in seconds from the run's
    start, and the seconds of each phase it overlapped."""
    t0 = RUN_T0
    out = {}
    for name, side in sides.items():
        over = {}
        for phase, a, b in PHASE_SPANS:
            dt = min(b, side.ended) - max(a, side.started)
            if dt > 0:
                over[phase] = round(over.get(phase, 0.0) + dt, 1)
        out[name] = {"start_s": round(side.started - t0, 1),
                     "end_s": round(side.ended - t0, 1),
                     "overlapped_s": over}
    return out


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def random_forest(rng, T, depth, F, S, dtype=np.float32, leaf_p=0.1,
                  quantiles=None):
    """Dense-heap forest: internal nodes split on a random feature (at a
    per-feature data quantile when ``quantiles [Q, F]`` is given), a
    ``leaf_p`` share of nodes above the last level end early as leaves
    (their subtrees stay absent, -2), leaves hold random class counts."""
    M = 2 ** (depth + 1) - 1
    feat = np.full((T, M), -2, np.int32)
    thr = np.zeros((T, M), dtype)
    leaf = np.zeros((T, M, S), dtype)
    for t in range(T):
        stack = [(0, 0)]
        while stack:
            node, d = stack.pop()
            if d < depth and rng.random() >= leaf_p:
                f = int(rng.integers(0, F))
                feat[t, node] = f
                thr[t, node] = (
                    rng.normal() if quantiles is None
                    else quantiles[rng.integers(0, len(quantiles)), f]
                )
                stack += [(2 * node + 1, d + 1), (2 * node + 2, d + 1)]
            else:
                feat[t, node] = -1
                leaf[t, node] = rng.integers(0, 50, S).astype(dtype)
    return feat, thr, leaf


def time_ms(fn, iters=20) -> float:
    """Mean time of ``fn`` on the card, by CUDA events over ``iters``
    calls after a warmup (one call where ``iters`` is 5 or fewer: the
    slow plain versions)."""
    for _ in range(3 if iters > 5 else 1):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, calls=100) -> float:
    """Device time of one call of ``fn``, whose device work is a few
    kernel launches: CUDA events around ``calls`` calls queued behind a
    spin kernel, so that the card runs them back to back without
    waiting for the host.  Unlike ``time_ms``, it leaves out the host's
    time to issue a call (the longer below ~20 000 rows for
    ``forest_traversal``); it keeps the card's gaps between launches.
    The spin is lengthened until the host has queued every call before
    the card reaches the first; the queued launches must fit the card's
    queue of pending work (a few hundred), or the host waits on it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 25  # ~17 ms at the H100's 1.98 GHz
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / calls
        cycles *= 4
    raise SystemExit(f"the card reached the first of {calls} calls of "
                     f"{getattr(fn, '__qualname__', fn)} before the host had "
                     "queued them all")


def _mmm(x: list) -> str:
    return " / ".join(f"{v:.3f}" for v in x)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise SystemExit(f"shape/dtype mismatch: {a.shape} {a.dtype} "
                         f"vs {b.shape} {b.dtype}")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# -- phase 2: kernels against their plain versions ---------------------------


def check_kernels(dev) -> dict:
    rng = np.random.default_rng(SEED)
    errs = {"forest_traversal": 0.0, "pad_assemble": 0.0}
    for n, dtype, S in ((65536, np.float32, CLASSES),
                        (4097, np.float64, CLASSES),
                        (1000, np.float32, CLASSES), (33, np.float32, CLASSES),
                        (4097, np.float32, 3)):
        feat, thr, leaf = random_forest(rng, TREES, DEPTH, TOP, S, dtype)
        X = rng.normal(size=(n, TOP)).astype(dtype)
        X[rng.random(X.shape) < 0.01] = np.nan  # NaN goes left
        args = [torch.from_numpy(a).to(dev) for a in (X, feat, thr, leaf)]
        out = forest_leaf_stats_cuda(*args, max_depth=DEPTH)
        ref = forest_leaf_stats_reference(*args, max_depth=DEPTH)
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        if not torch.equal(out, ref):
            raise SystemExit(f"forest_traversal N={n} S={S} "
                             f"{dtype.__name__}: differs from the plain "
                             f"version ({err})")
        errs["forest_traversal"] = max(errs["forest_traversal"], err)
        log(f"forest_traversal N={n} T={TREES} depth={DEPTH} F={TOP} "
            f"S={S} {dtype.__name__}: bitwise equal")
    # pad_assemble: both layouts (the serve path launches the column-major
    # one), every block height the path pads, a zero-row pad at each, and
    # a width that is not a multiple of 4
    for n in (1, 33, 1000, 4097, 50000, 60000, 65536):
        for target in sorted({n, bucket_rows_for(n, BUCKET_FLOOR)}):
            for c in (len(CICIDS2017_FEATURES), PAD_ODD_COLUMNS):
                for dtype in (torch.float32, torch.float64):
                    rows = torch.randn((n, c), dtype=dtype, device=dev)
                    for layout, a in (("row-major", rows),
                                      ("column-major",
                                       rows.t().contiguous().t())):
                        out = pad_rows_cuda(a, target)
                        ref = pad_rows_reference(a, target)
                        torch.cuda.synchronize()
                        if not torch.equal(out, ref) \
                                or not out.is_contiguous():
                            raise SystemExit(
                                f"pad_assemble {layout} [{n}, {c}] -> "
                                f"{target} {dtype}: differs from the plain "
                                "version")
                        errs["pad_assemble"] = max(errs["pad_assemble"],
                                                   max_abs_err(out, ref))
            log(f"pad_assemble [{n}, 78 and {PAD_ODD_COLUMNS}] -> "
                f"[{target}, .] f32 and f64, row-major and column-major: "
                "bitwise equal")
    return errs


# -- the fit path: data and tree_hist against its plain version ----------------


def fit_data(work: str) -> dict:
    """The train phase's flows: ``TRAIN_ROWS`` synthetic rows from the
    seed written as one raw CSV (what ``train --data`` reads), and the
    same rows cleaned and split here, as the command splits them."""
    t0 = time.perf_counter()
    raw = generate_frame(TRAIN_ROWS, seed=SEED, min_class_fraction=0.005)
    data_dir = os.path.join(work, "days")
    os.makedirs(data_dir)
    write_raw_csv(raw, os.path.join(data_dir, "day.csv"))
    train, test = clean_flows(raw).random_split(
        [1 - TEST_FRACTION, TEST_FRACTION], seed=SEED)
    log(f"train data: {TRAIN_ROWS} rows generated and written, "
        f"{train.num_rows} train / {test.num_rows} test after cleaning "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"dir": data_dir, "train": train, "test": test}


def hist_cases(train: Frame, dev) -> dict:
    """``tree_hist`` inputs at the fit path's shapes, from the train
    split's own binned features and labels: the chi-square contingency
    (78 features, 1 node, one-hot classes); a forest's root level and the
    widest node group of its deepest level (40 features, 20 trees of
    Poisson(1) bagging weights; the group of level 9's first 256 nodes,
    of which sibling subtraction histograms the 128 even ones); and
    GBT's shape (128 bins, signed fractional stats and weights)."""
    rng = np.random.default_rng(SEED + 3)
    X = np.stack([train[c] for c in CICIDS2017_FEATURES], axis=1)
    labels = StringIndexer(inputCol="Label", outputCol="label").fit(train)
    y = labels.transform(train)["label"].astype(np.int64)
    Xd = torch.from_numpy(X).to(dev)
    binned_t = bin_features(
        Xd, torch.from_numpy(quantile_bin_edges(X, BINS)).to(dev)).t()
    N = X.shape[0]
    stats = torch.nn.functional.one_hot(
        torch.from_numpy(y).to(dev), CLASSES).to(torch.float32).contiguous()
    poisson = torch.from_numpy(
        rng.poisson(1.0, (TREES, N)).astype(np.float32)).to(dev)
    heap = rng.integers(0, 512, (TREES, N))
    group = np.where((heap < 256) & (heap % 2 == 0), heap >> 1, -1)
    gbt_bins = bin_features(
        Xd, torch.from_numpy(quantile_bin_edges(X, GBT_BINS)).to(dev)).t()
    top = binned_t[:TOP].contiguous()
    return {
        "chisq": dict(binned_t=binned_t, stats=stats, weights=None,
                      node_idx=torch.zeros((1, N), dtype=torch.int32,
                                           device=dev),
                      n_nodes=1, n_bins=BINS, integer=True),
        "root level": dict(binned_t=top, stats=stats, weights=poisson,
                           node_idx=torch.zeros((TREES, N), dtype=torch.int32,
                                                device=dev),
                           n_nodes=1, n_bins=BINS, integer=True),
        "widest level group": dict(
            binned_t=top, stats=stats, weights=poisson,
            node_idx=torch.from_numpy(group.astype(np.int32)).to(dev),
            n_nodes=128, n_bins=BINS, integer=True),
        "gbt": dict(
            binned_t=gbt_bins,
            stats=torch.from_numpy(rng.normal(size=(N, GBT_STATS))
                                   .astype(np.float32)).to(dev),
            weights=torch.from_numpy(rng.random((1, N)).astype(np.float32))
            .to(dev),
            node_idx=torch.from_numpy(rng.integers(0, GBT_NODES, (1, N))
                                      .astype(np.int32)).to(dev),
            n_nodes=GBT_NODES, n_bins=GBT_BINS, integer=False),
    }


def _hist_args(c: dict):
    return ((c["binned_t"], c["node_idx"], c["stats"], c["weights"]),
            {"n_nodes": c["n_nodes"], "n_bins": c["n_bins"]})


def _shape(c: dict) -> str:
    F, N = c["binned_t"].shape
    return (f"[{F}, {N}] bins, T={c['node_idx'].shape[0]}, "
            f"{c['n_nodes']} nodes, B={c['n_bins']}, "
            f"S={c['stats'].shape[-1]}"
            + (" per tree" if c["stats"].ndim == 3 else ""))


def _plan(p: dict) -> str:
    return ", ".join(f"{k} {p[k]}" for k in histogram.PLAN_FIELDS)


def _profiled(x: dict) -> str:
    return ("not recorded" if x["profiled_ms"] is None
            else f"{x['profiled_ms']:.4f} ms")


def exact_and_bound(c: dict) -> tuple:
    """The float64 sums of ``c``'s weighted stats, and how far, per cell,
    an f32 histogram of them may lie from those: HIST_TOL of the cell's
    sum of absolute contributions, and no less than (n + 1)·u of it for
    a cell of n contributions — the bound of any f32 summation order
    (each weighted term rounded once, the running sum up to n times).
    Config 4's hot cells hold ~50 000 rows (a feature's mass in one bin),
    where that bound is 3e-3: no f32 order, the plain version's included,
    meets HIST_TOL there.  One call of the plain version sums the three
    (``stats·w``, ``|stats·w|`` and ``w ≠ 0`` as columns of one float64
    stats block, unweighted): a row of weight 0 adds exact zeros.
    Returns (exact, bound, scale)."""
    args, kw = _hist_args(c)
    bins, node, stats, w = args
    s = stats.double()
    if w is None:
        nz = torch.ones(s.shape[:-1] + (1,), dtype=torch.float64,
                        device=s.device)
    else:
        s = s * w.double()[..., None]  # [T, N, S]
        nz = (w != 0).double()[..., None]
    S = s.shape[-1]
    sums = tree_hist_reference(bins, node, torch.cat(
        [s, s.abs(), nz], -1).contiguous(), None, **kw)
    exact, scale, n = sums[..., :S], sums[..., S:2 * S], sums[..., 2 * S:]
    return exact, torch.clamp_min((n + 1) * U_F32, HIST_TOL) * scale, scale


def check_tree_hist(cases: dict) -> float:
    """Integer-valued stats: bitwise equal to the plain version and to a
    second run; fractional stats: each cell within HIST_TOL of its sum of
    absolute contributions, against the plain version in f32 — or, for
    the launches of a fit (``"hot": True``), within ``exact_and_bound``'s
    bound of the
    plain version summed in float64, with the plain f32 version's own
    distance from it reported beside.  Returns the largest absolute
    difference from the plain f32 version."""
    worst = 0.0
    for name, c in cases.items():
        args, kw = _hist_args(c)
        out = tree_hist_cuda(*args, **kw)
        again = tree_hist_cuda(*args, **kw)
        ref = tree_hist_reference(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        worst = max(worst, err)
        if c["integer"]:
            if not torch.equal(out, ref) or not torch.equal(out, again):
                raise SystemExit(f"tree_hist {name}: differs from the plain "
                                 f"version or from itself ({err})")
            log(f"tree_hist {name} {_shape(c)}: bitwise equal to the plain "
                "version and to a second run")
            continue
        bins, node, stats, w = args
        if c.get("hot"):
            exact, bound, scale = exact_and_bound(c)
            bad = int(((out - exact).abs() > bound).sum())
            if bad:
                raise SystemExit(f"tree_hist {name}: {bad} cells beyond "
                                 "the f32 bound of the exact sum")
            rel = float(((out - exact).abs() / scale.clamp_min(1e-30)).max())
            plain = float(((ref - exact).abs() / scale.clamp_min(1e-30)).max())
            log(f"tree_hist {name} {_shape(c)}: within max({HIST_TOL}, "
                f"(n+1)u) of each cell's absolute sum from the exact sum "
                f"(max rel {rel:.3g}; the plain f32 version's {plain:.3g}; "
                f"cells above {HIST_TOL}: kernel "
                f"{int(((out - exact).abs() > HIST_TOL * scale).sum())}, "
                f"plain {int(((ref - exact).abs() > HIST_TOL * scale).sum())}"
                f"; run-to-run bitwise: {torch.equal(out, again)})")
            continue
        scale = tree_hist_reference(bins, node, stats.abs(), w.abs(), **kw)
        bad = int(((out - ref).abs() > HIST_TOL * scale).sum())
        if bad:
            raise SystemExit(f"tree_hist {name}: {bad} cells beyond "
                             f"{HIST_TOL} of their absolute sums ({err})")
        rel = float(((out - ref).abs() / scale.clamp_min(1e-30)).max())
        log(f"tree_hist {name} {_shape(c)}: within {HIST_TOL} of each "
            f"cell's absolute sum (max abs {err:.3g}, max rel {rel:.3g}; "
            f"run-to-run bitwise: {torch.equal(out, again)})")
    return worst


# -- phase 3: the serve path -------------------------------------------------


def build_pipeline(traffic: Frame, dev):
    """Full-width config-3 pipeline from the seed: label indexer,
    assembler of the 78 features, a ChiSq top-40 select, and a 20-tree
    depth-10 forest whose thresholds are per-feature data quantiles."""
    rng = np.random.default_rng(SEED + 1)
    selected = sorted(rng.choice(len(CICIDS2017_FEATURES), TOP,
                                 replace=False).tolist())
    X = np.stack([traffic[CICIDS2017_FEATURES[j]] for j in selected], axis=1)
    quantiles = np.quantile(X, np.linspace(0.02, 0.98, 49), axis=0)
    feat, thr, leaf = random_forest(rng, TREES, DEPTH, TOP, CLASSES,
                                    leaf_p=0.0, quantiles=quantiles)
    indexer = StringIndexerModel(labels=CICIDS2017_LABELS)
    indexer.setParams(inputCol="Label", outputCol="label",
                      handleInvalid="skip")
    stages = [
        indexer,
        VectorAssembler(inputCols=CICIDS2017_FEATURES,
                        outputCol="rawFeatures", handleInvalid="skip"),
        ChiSqSelectorModel(selected_features=selected,
                           featuresCol="rawFeatures", labelCol="label",
                           outputCol="features", numTopFeatures=TOP),
        from_numpy_forest(feat, thr, leaf, DEPTH, CLASSES, device=dev,
                          n_features=TOP),
    ]
    return PipelineModel(stages=stages), selected


def plain_predictions(rf, selected, batch: Frame, dev) -> np.ndarray:
    """The same forest over the same rows, padded to the same bucket,
    with the plain traversal (same shapes, so the same summation order
    in the PyTorch reductions that follow the walk)."""
    n = batch.num_rows
    X = np.stack([batch[CICIDS2017_FEATURES[j]] for j in selected], axis=1)
    X = X[np.minimum(np.arange(bucket_rows_for(n, BUCKET_FLOOR)), n - 1)]
    mode, thr = rf._serve_args()
    packed = _rf_serve(
        rf._features_on_device(X), *rf._device_forest(), thr,
        max_depth=DEPTH, mode=mode, traverse=forest_leaf_stats_reference,
    )
    return packed[:n, 2 * CLASSES].cpu().numpy().astype(np.float64)


def serve_args(model_dir: str, watch: str, out: str, ckpt: str, dev,
               files_per_batch: int) -> list:
    return [sys.executable, "-m", "sntc_tpu_torch", "serve",
            "--model", model_dir, "--watch", watch, "--out", out,
            "--checkpoint", ckpt, "--shape-buckets", str(BUCKET_FLOOR),
            "--max-files-per-batch", str(files_per_batch),
            "--device", dev.type]


def serve_command(model_dir: str, watch: str, out: str, ckpt: str, dev,
                  extra: list, files_per_batch: int = 1,
                  env: dict = None) -> dict:
    """``python -m sntc_tpu_torch serve --once`` in its own process (every
    launch count starts at 0 there), in ``env`` (default: this process's
    environment); its summary line."""
    cmd = serve_args(model_dir, watch, out, ckpt, dev, files_per_batch) \
        + ["--once", *extra]
    spawned = time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600, env=env)
    if proc.returncode != 0:
        raise SystemExit(f"serve {' '.join(extra) or '(defaults)'} failed "
                         f"({proc.returncode}):\n{proc.stderr}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    summary["spawned_at"], summary["exited_at"] = spawned, time.time()
    return summary


def startup_split(summary: dict) -> dict:
    """A ``serve --once`` process's seconds from its start to its exit,
    from its summary's ``startup`` block and the times ``serve_command``
    (or ``dp_serves``) took around it: the interpreter and the imports,
    the CUDA context, ``library()``, the model's load, the first batch,
    and the rest (the other batches and the exit)."""
    st = summary["startup"]
    parts = {"imports_s": st["imported_at"] - summary["spawned_at"],
             "context_s": st.get("context_s", 0.0),
             "library_s": st.get("library_s", 0.0),
             "model_s": st["model_s"],
             "first_batch_s": st["first_batch_s"] or 0.0}
    total = summary["exited_at"] - summary["spawned_at"]
    first = summary["progress"][0] if summary["progress"] else {}
    return {**{k: round(v, 3) for k, v in parts.items()},
            "rest_s": round(total - sum(parts.values()), 3),
            "total_s": round(total, 3),
            "first_batch_ms": {k: round(first[k], 1) for k in (
                "readMs", "dispatchMs", "finalizeMs", "sinkMs",
                "durationMs") if k in first}}


def serve(dev, work: str) -> dict:
    import pyarrow.csv as pacsv

    t0 = time.perf_counter()
    traffic = clean_flows(generate_frame(sum(BATCHES) + 2000, seed=SEED))
    traffic = traffic.slice(0, sum(BATCHES)).drop("Label")
    pipeline, selected = build_pipeline(traffic, dev)
    model_dir = os.path.join(work, "model")
    save_model(pipeline, model_dir)
    watch = os.path.join(work, "in")
    os.makedirs(watch)
    batches, start = [], 0
    for i, n in enumerate(BATCHES):
        b = traffic.slice(start, start + n)
        write_raw_csv(b, os.path.join(watch, f"part_{i:04d}.csv"))
        batches.append(b)
        start += n
    log(f"traffic: {sum(BATCHES)} rows in micro-batches {BATCHES} "
        f"({time.perf_counter() - t0:.1f} s to generate and write)")

    out_dir = os.path.join(work, "out")
    t0 = time.perf_counter()
    summary = serve_command(model_dir, watch, out_dir,
                            os.path.join(work, "ckpt"), dev, [])
    wall = time.perf_counter() - t0
    log(f"serve: {summary['batches']} batches, {summary['rows']} rows in "
        f"{summary['seconds']:.3f} s of serving ({wall:.1f} s with process "
        "start)")
    log("serve startup split (the process alone, seconds): "
        + json.dumps(startup_split(summary)))
    if summary["batches"] != len(BATCHES) or summary["rows"] != sum(BATCHES):
        raise SystemExit(f"serve covered {summary}, expected {BATCHES}")

    rf = pipeline.getStages()[-1]
    for i, (b, n) in enumerate(zip(batches, BATCHES)):
        t = pacsv.read_csv(os.path.join(out_dir, f"batch_{i:06d}.csv"))
        pred = t.column("prediction").to_numpy()
        labels = t.column("predictedLabel").to_pylist()
        if len(pred) != n or len(labels) != n:
            raise SystemExit(f"batch {i}: {len(pred)} predictions for {n} rows")
        if not np.isfinite(pred).all() or pred.min() < 0 \
                or pred.max() >= CLASSES:
            raise SystemExit(f"batch {i}: predictions out of range")
        if labels != [CICIDS2017_LABELS[int(p)] for p in pred]:
            raise SystemExit(f"batch {i}: predictedLabel disagrees")
        plain = plain_predictions(rf, selected, b, dev)
        if not np.array_equal(pred, plain):
            bad = int((pred != plain).sum())
            raise SystemExit(f"batch {i}: {bad} predictions differ from "
                             "the plain path")
    log("serve: every row predicted; predictions equal the plain path")
    launches = summary["kernel_launches"]
    want = {
        "forest_traversal": len(BATCHES),
        "pad_assemble": sum(bucket_rows_for(n, BUCKET_FLOOR) != n
                            for n in BATCHES),
        "tree_hist": 0,  # the serve path fits nothing
    }
    if launches != want:
        raise SystemExit(f"launches {launches}, expected {want}")
    summary["batches_rows"] = BATCHES
    X = np.stack([traffic[CICIDS2017_FEATURES[j]] for j in selected], axis=1)
    served = {"forest": rf._device_forest(),
              "X": rf._features_on_device(X[:max(FOREST_ROWS)])}
    return summary, served


# -- phase 4: the train path -------------------------------------------------


def grower_passes(T: int, F: int, B: int, S: int, depth: int) -> tuple:
    """(histogram passes of a depth-``depth`` fit, node group): one pass
    per group of every level, groups being the largest power of two of
    nodes whose ~5x f32 working set fits the grower's 2 GiB budget."""
    per_node = 5 * T * F * B * S * 4
    group = 1 << (max(1, NODE_GROUP_BYTES // per_node).bit_length() - 1)
    return sum(-(-(1 << d) // group) for d in range(depth)), group


def train(dev, data: dict, work: str) -> dict:
    model_dir = os.path.join(work, "trained")
    cmd = [sys.executable, "-m", "sntc_tpu_torch", "train",
           "--data", data["dir"], "--estimator", "rf",
           "--chisq-top", str(TOP), "--num-trees", str(TREES),
           "--max-depth", str(DEPTH), "--test-fraction", str(TEST_FRACTION),
           "--seed", str(SEED), "--model-out", model_dir,
           "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"train failed ({proc.returncode}):\n{proc.stderr}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    summary["process_wall_s"] = wall
    passes, group = grower_passes(TREES, TOP, BINS, CLASSES, DEPTH)
    launches = summary["kernel_launches"]
    log(f"train: {summary['train_rows']} rows, fit "
        f"{summary['fit_wall_clock_s']} s ({wall:.1f} s with process start, "
        f"CSV read and evaluation), held-out macro-F1 {summary['macroF1']}, "
        f"launches {launches}")
    if summary["train_rows"] != data["train"].num_rows:
        raise SystemExit(f"train split {summary['train_rows']} rows, "
                         f"expected {data['train'].num_rows}")
    if launches["tree_hist"] != 1 + passes:
        raise SystemExit(
            f"tree_hist launched {launches['tree_hist']} times, expected 1 "
            f"(contingency) + {passes} (depth {DEPTH}, node group {group})")
    if launches["forest_traversal"] < 1:
        raise SystemExit("the held-out evaluation never launched "
                         "forest_traversal")
    if not summary["macroF1"] >= F1_FLOOR:
        raise SystemExit(f"held-out macro-F1 {summary['macroF1']} below "
                         f"{F1_FLOOR}")
    summary["expected_tree_hist"] = {"contingency": 1, "grower": passes,
                                     "node_group": group}
    return summary


def pipeline(device, depth: int, mesh=None) -> Pipeline:
    """The train command's pipeline, built in this process (the
    selector and the forest over ``mesh`` when one is given)."""
    return Pipeline(stages=[
        StringIndexer(inputCol="Label", outputCol="label",
                      handleInvalid="skip"),
        VectorAssembler(inputCols=CICIDS2017_FEATURES,
                        outputCol="rawFeatures", handleInvalid="skip"),
        ChiSqSelector(device=device, mesh=mesh, numTopFeatures=TOP,
                      featuresCol="rawFeatures", labelCol="label",
                      outputCol="features"),
        RandomForestClassifier(device=device, mesh=mesh, numTrees=TREES,
                               maxDepth=depth, seed=SEED),
    ])


def same_trees(a, b) -> int:
    """Two fits' heaps equal under the near-tie rule: a differing split
    only where the two best gains are within GAIN_TIE_RTOL relative (its
    subtrees are then not compared); elsewhere feature, threshold, gain,
    count and leaf stats equal.  Returns the near-ties seen."""
    ties = 0
    for t in range(a.feature.shape[0]):
        stack = [0]
        while stack:
            h = stack.pop()
            fa, fb = int(a.feature[t, h]), int(b.feature[t, h])
            ga, gb = float(a.gain[t, h]), float(b.gain[t, h])
            if fa != fb or (fa >= 0 and a.threshold[t, h] != b.threshold[t, h]):
                if fa < 0 or fb < 0 or abs(ga - gb) > GAIN_TIE_RTOL * max(
                        abs(ga), abs(gb)):
                    raise SystemExit(f"tree {t} slot {h}: split {fa} vs {fb}, "
                                     f"gain {ga} vs {gb}")
                ties += 1
                continue
            if fa >= 0:
                if ga != gb or a.count[t, h] != b.count[t, h]:
                    raise SystemExit(f"tree {t} slot {h}: gain {ga} vs {gb}, "
                                     f"count {a.count[t, h]} vs "
                                     f"{b.count[t, h]}")
                if 2 * h + 2 < a.feature.shape[1]:
                    stack += [2 * h + 1, 2 * h + 2]
            elif fa == -1 and not np.array_equal(a.leaf_stats[t, h],
                                                 b.leaf_stats[t, h]):
                raise SystemExit(f"tree {t} slot {h}: leaf stats differ")
    return ties


def reduced_fit(data: dict, dev, cpu: "CpuFits") -> dict:
    """The pipeline at depth 6 on the first 20 000 train rows, fitted on
    the card, against the CPU's fit from the same seed (``cpu_fits``)."""
    frame = data["train"].slice(0, REDUCED_ROWS)
    t0 = time.perf_counter()
    on_card = pipeline(dev, REDUCED_DEPTH).fit(frame)
    t1 = time.perf_counter()
    on_cpu = cpu.model("reduced")
    cpu_s = cpu.seconds()["reduced"]
    sel = [m.getStages()[2].selected_features for m in (on_card, on_cpu)]
    if sel[0] != sel[1]:
        raise SystemExit(f"selected features differ: {sel[0]} vs {sel[1]}")
    ties = same_trees(on_card.getStages()[3].forest,
                      on_cpu.getStages()[3].forest)
    internal = int((on_card.getStages()[3].forest.feature >= 0).sum())
    log(f"reduced fit ({REDUCED_ROWS} rows, {TREES} trees, depth "
        f"{REDUCED_DEPTH}): card {t1 - t0:.2f} s, CPU {cpu_s:.2f} s (in "
        f"its own process); same {len(sel[0])} features selected, same "
        f"trees ({internal} splits, {ties} near-ties)")
    return {"rows": REDUCED_ROWS, "card_s": t1 - t0, "cpu_s": cpu_s,
            "splits": internal, "near_ties": ties}


def fit_launches() -> list:
    """(level, nodes of the group) of each ``tree_hist`` launch of the
    full-width fit, in launch order: the contingency, then one pass per
    node group of every level."""
    _, group = grower_passes(TREES, TOP, BINS, CLASSES, DEPTH)
    out = [("contingency", 1)]
    for d in range(DEPTH):
        out += [(d, min(group, 1 << d))] * -(-(1 << d) // group)
    return out


@contextlib.contextmanager
def recording_tree_hist():
    """Record the inputs of every ``tree_hist`` launch inside the block
    (as :func:`hist_cases` gives them) in the list it yields.  Every
    launch goes through ``histogram.tree_hist_cuda``: the grower and the
    contingency call it through ``tree_hist``."""
    calls, launch = [], histogram.tree_hist_cuda

    def recording(binned_t, node_idx, stats, weights=None, **kw):
        calls.append(dict(binned_t=binned_t, node_idx=node_idx, stats=stats,
                          weights=weights, integer=True, **kw))
        return launch(binned_t, node_idx, stats, weights, **kw)

    histogram.tree_hist_cuda = recording
    try:
        yield calls
    finally:
        histogram.tree_hist_cuda = launch


def launch_device_ms(call: dict) -> float:
    """Device time (ms) of one recorded ``tree_hist`` launch, taken
    again after the fit on its own inputs as :func:`kernel_device_ms`
    takes it: the wrapper's zero-fill and kernel, 20 calls queued back
    to back.  A profiler window may drop a launch's record; this cannot."""
    args, kw = _hist_args(call)
    return kernel_device_ms(lambda: tree_hist_cuda(*args, **kw), 20)


def fit_breakdown(data: dict, dev) -> dict:
    """The full-width fit in this process: each stage on the host clock
    (ending in a synchronize), after one warm fit; then one fit under a
    profiler window, whose device-side events give the fit's device time
    and hence its idle share, and each ``tree_hist`` launch's device
    time (:func:`launch_device_ms`; the profiler's own record beside it
    where the window kept every launch: a window may drop one),
    tagged with its level, its node group and the plan its entry point
    took.  The launches of levels 7 and 8 are kept, inputs and
    all, as the fit's own node distribution for the checks and times of
    ``tree_hist`` that follow."""
    train_frame = data["train"]
    pipeline(dev, DEPTH).fit(train_frame)  # warm pass
    stages = pipeline(dev, DEPTH).getStages()
    times, frame = {}, train_frame
    t_all = time.perf_counter()
    for stage in stages:
        name = type(stage).__name__
        t0 = time.perf_counter()
        model = stage.fit(frame) if isinstance(stage, Estimator) else stage
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times[f"{name}.fit"] = (t1 - t0) * 1e3
        if stage is not stages[-1]:
            frame = model.transform(frame)
            times[f"{name}.transform"] = (time.perf_counter() - t1) * 1e3
    staged_ms = (time.perf_counter() - t_all) * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with recording_tree_hist() as calls:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            pipeline(dev, DEPTH).fit(train_frame)
            torch.cuda.synchronize()
            fit_ms = (time.perf_counter() - t0) * 1e3
    ops = _device_ms(prof)
    device_ms = sum(ops.values())
    kernels = sorted(
        (e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and "tree_hist" in e.name),
        key=lambda e: e.time_range.start)
    expect = fit_launches()
    if len(calls) != len(expect):
        raise SystemExit(f"{len(calls)} tree_hist calls in the profiled "
                         f"fit, expected {len(expect)}")
    launches, kept = [], {}
    for i, (c, (level, nodes)) in enumerate(zip(calls, expect)):
        F, N = c["binned_t"].shape
        T, S = c["node_idx"].shape[0], c["stats"].shape[1]
        launches.append({
            "launch": i, "level": level, "group_nodes": nodes,
            "hist_nodes": c["n_nodes"], "F": F, "N": N, "T": T,
            "device_ms": launch_device_ms(c),
            "profiled_ms": (kernels[i].time_range.elapsed_us() / 1e3
                            if len(kernels) == len(calls) else None),
            **tree_hist_plan(N, F, T, c["n_nodes"], c["n_bins"], S),
        })
        if level in (7, 8) and level not in kept:
            kept[level] = c
    return {"stages_ms": times, "staged_fit_ms": staged_ms,
            "profiled_fit_ms": fit_ms, "device_ms": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / fit_ms),
            "top_device_ops_ms": dict(list(ops.items())[:8]),
            "tree_hist_launches": launches,
            "tree_hist_ms": sum(x["device_ms"] for x in launches),
            "tree_hist_seen_by_profiler": len(kernels),
            "cases": {f"level {d} (the fit's own nodes)": kept[d]
                      for d in sorted(kept)}}


# -- phase 6: bench config 4, OneVsRest over gradient-boosted trees ----------


def gbt_data(work: str) -> dict:
    """Bench config 4's own flows: ``GBT_ROWS`` synthetic rows from
    bench.py's data seed written as one raw CSV, and the same rows
    cleaned and split here with seed 0, as the train command (and
    bench.py) splits them."""
    t0 = time.perf_counter()
    raw = generate_frame(GBT_ROWS, seed=GBT_DATA_SEED,
                         min_class_fraction=0.005)
    data_dir = os.path.join(work, "days4")
    os.makedirs(data_dir)
    write_raw_csv(raw, os.path.join(data_dir, "day.csv"))
    train, test = clean_flows(raw).random_split(
        [1 - TEST_FRACTION, TEST_FRACTION], seed=SEED)
    log(f"config-4 data: {GBT_ROWS} rows generated and written, "
        f"{train.num_rows} train / {test.num_rows} test after cleaning "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"dir": data_dir, "train": train, "test": test}


def raw_features(frame: Frame) -> np.ndarray:
    """The 78 assembled features of a cleaned frame, float32."""
    return np.stack([frame[c] for c in CICIDS2017_FEATURES],
                    axis=1).astype(np.float32)


def gbt_pipeline(device, rounds: int) -> Pipeline:
    """The train command's ``--estimator gbt --chisq-top 0`` pipeline,
    built in this process."""
    return Pipeline(stages=[
        StringIndexer(inputCol="Label", outputCol="label",
                      handleInvalid="skip"),
        VectorAssembler(inputCols=CICIDS2017_FEATURES,
                        outputCol="rawFeatures", handleInvalid="skip"),
        OneVsRest(classifier=GBTClassifier(
            device=device, maxIter=rounds, maxDepth=GBT_DEPTH,
            stepSize=GBT_STEP, seed=SEED, maxBins=GBT_BINS),
            featuresCol="rawFeatures"),
    ])


def train_gbt(dev, data: dict, work: str) -> dict:
    """Bench config 4 through ``python -m sntc_tpu_torch train``: one
    ``tree_hist`` launch per node group of every level of every round
    (the K class trees of a round share a launch), one
    ``forest_traversal`` launch per round for the margins and one for
    the held-out evaluation."""
    model_dir = os.path.join(work, "trained4")
    cmd = [sys.executable, "-m", "sntc_tpu_torch", "train",
           "--data", data["dir"], "--estimator", "gbt", "--chisq-top", "0",
           "--max-iter", str(GBT_ROUNDS), "--max-depth", str(GBT_DEPTH),
           "--step-size", str(GBT_STEP), "--max-bins", str(GBT_BINS),
           "--test-fraction", str(TEST_FRACTION), "--seed", str(SEED),
           "--model-out", model_dir, "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"config-4 train failed ({proc.returncode}):\n"
                         f"{proc.stderr}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    summary["process_wall_s"] = wall
    summary["model_dir"] = model_dir
    passes, group = grower_passes(CLASSES, len(CICIDS2017_FEATURES), GBT_BINS,
                                  GBT_STATS, GBT_DEPTH)
    want = {"forest_traversal": GBT_ROUNDS + 1, "pad_assemble": 0,
            "tree_hist": GBT_ROUNDS * passes}
    launches = summary["kernel_launches"]
    log(f"config-4 train: {summary['train_rows']} rows, fit "
        f"{summary['fit_wall_clock_s']} s ({wall:.1f} s with process start, "
        f"CSV read and evaluation), held-out macro-F1 {summary['macroF1']}, "
        f"launches {launches}")
    if summary["train_rows"] != data["train"].num_rows:
        raise SystemExit(f"config-4 train split {summary['train_rows']} "
                         f"rows, expected {data['train'].num_rows}")
    if launches != want:
        raise SystemExit(
            f"config-4 launches {launches}, expected {want} ({GBT_ROUNDS} "
            f"rounds x {passes} grower passes of node group {group}; "
            f"{GBT_ROUNDS} margin walks + 1 evaluation)")
    if not summary["macroF1"] >= GBT_F1_FLOOR:
        raise SystemExit(f"config-4 held-out macro-F1 {summary['macroF1']} "
                         f"below {GBT_F1_FLOOR}")
    summary["expected_launches"] = want
    return summary


def serve_gbt(dev, data: dict, trained: dict, work: str) -> dict:
    """The fitted config-4 pipeline served by ``python -m sntc_tpu_torch
    serve`` over ``GBT_BATCHES`` micro-batches of held-out flows; every
    prediction equal to the plain path's (the same trees walked by
    ``forest_leaf_stats_reference``, over the same padded rows)."""
    import pyarrow.csv as pacsv

    traffic = data["test"].slice(0, sum(GBT_BATCHES)).drop("Label")
    watch = os.path.join(work, "in4")
    os.makedirs(watch)
    batches, start = [], 0
    for i, n in enumerate(GBT_BATCHES):
        b = traffic.slice(start, start + n)
        write_raw_csv(b, os.path.join(watch, f"part_{i:04d}.csv"))
        batches.append(b)
        start += n
    out_dir = os.path.join(work, "out4")
    summary = serve_command(trained["model_dir"], watch, out_dir,
                            os.path.join(work, "ckpt4"), dev, [])
    if summary["fusion"] is not None or \
            not summary["pipeline_stats"]["overlap_sink"]:
        raise SystemExit("config-4 default serve: expected the pipelined "
                         f"engine and no fused segment, got {summary}")
    want = {"forest_traversal": len(GBT_BATCHES),
            "pad_assemble": sum(bucket_rows_for(n, BUCKET_FLOOR) != n
                                for n in GBT_BATCHES),
            "tree_hist": 0}
    if summary["batches"] != len(GBT_BATCHES) or \
            summary["rows"] != sum(GBT_BATCHES):
        raise SystemExit(f"config-4 serve covered {summary}, expected "
                         f"{GBT_BATCHES}")
    if summary["kernel_launches"] != want:
        raise SystemExit(f"config-4 serve launches "
                         f"{summary['kernel_launches']}, expected {want}")
    model = load_model(trained["model_dir"], device=dev)
    labels = model.getStages()[0].labels
    ovr = model.getStages()[-1]
    plain = _build_fused_ovr(ovr.models, traverse=forest_leaf_stats_reference)
    for i, (b, n) in enumerate(zip(batches, GBT_BATCHES)):
        t = pacsv.read_csv(os.path.join(out_dir, f"batch_{i:06d}.csv"))
        pred = t.column("prediction").to_numpy()
        X = raw_features(b)
        X = X[np.minimum(np.arange(bucket_rows_for(n, BUCKET_FLOOR)), n - 1)]
        want_pred = torch.argmax(plain(X), dim=1)[:n].cpu().numpy()
        if len(pred) != n or not np.array_equal(pred, want_pred):
            raise SystemExit(f"config-4 batch {i}: predictions differ from "
                             "the plain path")
        if t.column("predictedLabel").to_pylist() != \
                [labels[int(p)] for p in pred]:
            raise SystemExit(f"config-4 batch {i}: predictedLabel disagrees")
    log(f"config-4 serve: {summary['batches']} batches, {summary['rows']} "
        f"rows in {summary['seconds']:.3f} s; every prediction equals the "
        f"plain path; launches {summary['kernel_launches']}")
    summary["batches_rows"] = GBT_BATCHES
    return {"summary": summary, "ovr": ovr,
            "X": torch.from_numpy(raw_features(traffic)).to(dev)}


@contextlib.contextmanager
def sibling_subtraction():
    """Inside the block the boosting fits' grower subtracts sibling
    histograms on any device (by default only on the card)."""
    grow = gbt_module.grow_forest
    gbt_module.grow_forest = lambda *a, **kw: grow(*a, sibling=True, **kw)
    try:
        yield
    finally:
        gbt_module.grow_forest = grow


def same_boosted_trees(a, b, tie_tol: float) -> dict:
    """Two boosting fits' heaps under the near-tie rule.  Every gap is
    measured against ``4·W``, ``W`` the tree's root weight: with ``|r| <=
    2`` no cell of the tree's histograms sums more absolute mass, so its
    f32 rounding scales with it — and sibling subtraction carries a
    parent's rounding down to its smallest child.  A differing split is
    a near-tie where the two weighted best gains (gain × count) are
    within ``tie_tol·4W``, and so is a split against a leaf whose split
    would have gained no more than that (the subtrees below a near-tie
    are not compared); elsewhere
    the same feature, threshold and count.  Returns the near-ties and
    the largest gaps of weighted gains at them and at shared splits and
    of leaf stats, over 4W."""
    out = {"near_ties": 0, "tie_gap": 0.0, "gain_gap": 0.0, "leaf_gap": 0.0}
    for t in range(a.feature.shape[0]):
        scale = 4.0 * max(float(a.count[t, 0]), float(a.leaf_stats[t, 0, 0]),
                          1e-30)
        stack = [0]
        while stack:
            h = stack.pop()
            fa, fb = int(a.feature[t, h]), int(b.feature[t, h])
            wa = float(a.gain[t, h]) * float(a.count[t, h])
            wb = float(b.gain[t, h]) * float(b.count[t, h])
            if fa != fb or (fa >= 0 and a.threshold[t, h] != b.threshold[t, h]):
                if min(fa, fb) < -1 or abs(wa - wb) > tie_tol * scale:
                    raise SystemExit(
                        f"tree {t} slot {h}: split {fa} vs {fb}, weighted "
                        f"gain {wa} vs {wb} (4W {scale})")
                out["near_ties"] += 1
                out["tie_gap"] = max(out["tie_gap"], abs(wa - wb) / scale)
                continue
            if fa >= 0:
                if a.count[t, h] != b.count[t, h]:
                    raise SystemExit(f"tree {t} slot {h}: count "
                                     f"{a.count[t, h]} vs {b.count[t, h]}")
                out["gain_gap"] = max(out["gain_gap"], abs(wa - wb) / scale)
                if 2 * h + 2 < a.feature.shape[1]:
                    stack += [2 * h + 1, 2 * h + 2]
            elif fa == -1:
                gap = float(np.abs(a.leaf_stats[t, h].astype(np.float64)
                                   - b.leaf_stats[t, h]).max()) / scale
                if gap > tie_tol:
                    raise SystemExit(f"tree {t} slot {h}: leaf stats "
                                     f"{a.leaf_stats[t, h]} vs "
                                     f"{b.leaf_stats[t, h]}")
                out["leaf_gap"] = max(out["leaf_gap"], gap)
    return out


def staged_logloss(ovr, X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Training log-loss ``[K, rounds]`` of each class after each round:
    Spark's ``2·log(1 + exp(-2·y·F))`` averaged over the rows, the
    margins summed in float64 from the plain walk of each round's tree."""
    Xt = torch.from_numpy(X)
    out = []
    for c, m in enumerate(ovr.models):
        f = m.forest
        stats = forest_leaf_stats_reference(
            Xt, torch.from_numpy(f.feature), torch.from_numpy(f.threshold),
            torch.from_numpy(f.leaf_stats), max_depth=f.max_depth,
        ).double().numpy()
        values = stats[..., 1] / np.maximum(stats[..., 0], 1e-12)
        F = np.cumsum(m.treeWeights.astype(np.float64)[:, None] * values, 0)
        ys = np.where(y == c, 1.0, -1.0)
        out.append((2.0 * np.logaddexp(0.0, -2.0 * ys * F)).mean(axis=1))
    return np.stack(out)


def reduced_gbt_fit(data: dict, dev, cpu: "CpuFits") -> dict:
    """Config 4 on the first ``GBT_REDUCED_ROWS`` train rows for
    ``GBT_REDUCED_ROUNDS`` rounds, fitted on the card (sibling
    subtraction on), against the CPU's fits (``cpu_fits``: off, and on):
    the CPU's own gap between the two histogram forms is what fractional
    sums in another order cost, and the card must stay within the rule
    set from it (GBT_TIE_TOL, GBT_LOSS_ATOL)."""
    frame = data["train"].slice(0, GBT_REDUCED_ROWS)
    t0 = time.perf_counter()
    card = gbt_pipeline(dev, GBT_REDUCED_ROUNDS).fit(frame)
    card_s = time.perf_counter() - t0
    fits = {"card": card, "cpu": cpu.model("gbt_cpu"),
            "cpu, sibling": cpu.model("gbt_cpu_sibling")}
    secs = {"card": card_s,
            "cpu": cpu.seconds()["gbt_cpu"],
            "cpu, sibling": cpu.seconds()["gbt_cpu_sibling"]}
    X = raw_features(frame)
    y = to_host(fits["cpu"].getStages()[0].transform(frame)["label"])
    losses = {k: staged_logloss(m.getStages()[-1], X, y)
              for k, m in fits.items()}
    out = {"rows": GBT_REDUCED_ROWS, "rounds": GBT_REDUCED_ROUNDS,
           "seconds": secs, "tie_tol": GBT_TIE_TOL,
           "loss_atol": GBT_LOSS_ATOL,
           "cpu_logloss": losses["cpu"].tolist()}
    ref = fits["cpu"].getStages()[-1].models
    for name in ("cpu, sibling", "card"):
        gaps = {"near_ties": 0, "tie_gap": 0.0, "gain_gap": 0.0,
                "leaf_gap": 0.0}
        for ma, mb in zip(fits[name].getStages()[-1].models, ref):
            g = same_boosted_trees(ma.forest, mb.forest, GBT_TIE_TOL)
            gaps = {k: (gaps[k] + g[k] if k == "near_ties"
                        else max(gaps[k], g[k])) for k in gaps}
        gaps["logloss_abs"] = float(np.abs(losses[name] - losses["cpu"]).max())
        if gaps["logloss_abs"] > GBT_LOSS_ATOL:
            raise SystemExit(f"reduced config-4 fit, {name} against the CPU: "
                             f"training log-loss differs by "
                             f"{gaps['logloss_abs']} > {GBT_LOSS_ATOL}")
        out[name] = gaps
        log(f"reduced config-4 fit ({GBT_REDUCED_ROWS} rows, "
            f"{GBT_REDUCED_ROUNDS} rounds, {len(ref)} classes), {name} "
            f"against the CPU: {gaps['near_ties']} near-ties (weighted "
            f"gains {gaps['tie_gap']:.3g} of 4W apart at most); largest gap "
            f"of weighted gains at shared splits {gaps['gain_gap']:.3g} and "
            f"of leaf stats "
            f"{gaps['leaf_gap']:.3g} of 4W (rule {GBT_TIE_TOL}); per-round "
            f"per-class training log-loss within {gaps['logloss_abs']:.3g} "
            f"(limit {GBT_LOSS_ATOL}); {secs[name]:.2f} s (CPU "
            f"{secs['cpu']:.2f} s)")
    return out


def dt_pipeline(device) -> Pipeline:
    """The depth-5, 128-bin decision tree of the config-4 phase."""
    return Pipeline(stages=[
        StringIndexer(inputCol="Label", outputCol="label",
                      handleInvalid="skip"),
        VectorAssembler(inputCols=CICIDS2017_FEATURES,
                        outputCol="rawFeatures", handleInvalid="skip"),
        DecisionTreeClassifier(device=device, maxDepth=DT_DEPTH,
                               maxBins=GBT_BINS, seed=SEED,
                               featuresCol="rawFeatures"),
    ])


def dt_fit(data: dict, dev, cpu: "CpuFits") -> dict:
    """A depth-5, 128-bin decision tree on the config-4 train split,
    fitted on the card, against the CPU's (``cpu_fits``): integer class
    counts, so the two heaps are identical."""
    t0 = time.perf_counter()
    on_card = dt_pipeline(dev).fit(data["train"])
    t1 = time.perf_counter()
    on_cpu = cpu.model("dt")
    cpu_s = cpu.seconds()["dt"]
    a, b = on_card.getStages()[-1].forest, on_cpu.getStages()[-1].forest
    for name in ("feature", "threshold", "leaf_stats", "gain", "count"):
        if not np.array_equal(getattr(a, name), getattr(b, name)):
            raise SystemExit(f"decision tree: {name} differs between the "
                             "card and the CPU")
    f1 = MulticlassClassificationEvaluator(metricName="macroF1").evaluate(
        on_card.transform(data["test"]))
    splits = int((a.feature >= 0).sum())
    log(f"decision tree (depth {DT_DEPTH}, {GBT_BINS} bins, "
        f"{data['train'].num_rows} rows): the same heap on the card and the "
        f"CPU ({splits} splits); card {t1 - t0:.2f} s, CPU {cpu_s:.2f} s; "
        f"held-out macro-F1 {f1:.4f}")
    return {"splits": splits, "card_s": t1 - t0, "cpu_s": cpu_s,
            "macroF1": f1}


class CpuFits:
    """The CPU reference fits of phases 4 and 6 (the reduced config-3
    forest, the reduced config-4 boosting with sibling subtraction off
    and on, the decision tree), made by ``chip_smoke.py --side cpu_fits
    DIR`` in a process of their own that starts with the run and fits
    while the card works; the card's fits are compared with them later.
    ``started`` and ``ended`` are the process's wall-clock ends
    (``time.time()``), for the ``sides`` line."""

    SIDE = "cpu_fits"
    ENV = {}  # set in the side process's environment

    def __init__(self, out: str):
        self.out = out
        self.started, self.ended = time.time(), None
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--side", self.SIDE,
             out], cwd=REPO, env=env_with(CUDA_VISIBLE_DEVICES="",
                                          **self.ENV),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._secs = None

    def seconds(self) -> dict:
        if self._secs is None:
            out, err = self.proc.communicate(timeout=1200)
            if self.proc.returncode != 0:
                raise SystemExit(f"--side {self.SIDE} exited "
                                 f"{self.proc.returncode}:\n{err[-3000:]}")
            self._secs = json.loads(out.strip().splitlines()[-1])
            self.ended = self._secs.pop("ended_at")
        return self._secs

    def model(self, name: str):
        self.seconds()
        return load_model(os.path.join(self.out, name), device="cpu")

    def arrays(self, name: str) -> dict:
        self.seconds()
        with np.load(os.path.join(self.out, name + ".npz")) as z:
            return {k: z[k] for k in z.files}

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def side_done(secs: dict) -> int:
    """A side process's last line: its parts' seconds and its end."""
    print(json.dumps({**secs, "ended_at": time.time()}))
    return 0


def cpu_fits_main(out: str) -> int:
    """``--side cpu_fits DIR``: the CPU fits ``CpuFits`` compares the card's
    with, on the phases' own data (regenerated from their seeds), saved
    under DIR; prints their seconds as one JSON line."""
    # a lower scheduling priority (its thread count, which sets the
    # order of its sums, unchanged): the serving processes of the phases
    # it overlaps keep the host first
    os.nice(10)
    cpu = torch.device("cpu")
    secs = {}

    def fit(name, make, frame, sib=False):
        t0 = time.perf_counter()
        with sibling_subtraction() if sib else contextlib.nullcontext():
            model = make().fit(frame)
        secs[name] = time.perf_counter() - t0
        save_model(model, os.path.join(out, name))

    fit("reduced", lambda: pipeline(cpu, REDUCED_DEPTH),
        config3_train().slice(0, REDUCED_ROWS))
    raw4 = generate_frame(GBT_ROWS, seed=GBT_DATA_SEED,
                          min_class_fraction=0.005)
    train4, _ = clean_flows(raw4).random_split(
        [1 - TEST_FRACTION, TEST_FRACTION], seed=SEED)
    frame4 = train4.slice(0, GBT_REDUCED_ROWS)
    fit("gbt_cpu", lambda: gbt_pipeline(cpu, GBT_REDUCED_ROUNDS), frame4)
    fit("gbt_cpu_sibling", lambda: gbt_pipeline(cpu, GBT_REDUCED_ROUNDS),
        frame4, sib=True)
    fit("dt", lambda: dt_pipeline(cpu), train4)
    return side_done(secs)


def gbt_fit_breakdown(data: dict, dev) -> dict:
    """The full config-4 fit in this process: one warm fit, then one
    under a profiler window (the fit's device time, its idle share, the
    device time by kernel, and each ``tree_hist`` launch's device time,
    as for config 3, with its round, level and plan).  Round 1's launches (the first
    fractional residual stats) are kept, inputs and all, one level at
    each depth, for the checks and times that follow."""
    train_frame = data["train"]
    gbt_pipeline(dev, GBT_ROUNDS).fit(train_frame)  # warm pass
    passes, _ = grower_passes(CLASSES, len(CICIDS2017_FEATURES), GBT_BINS,
                              GBT_STATS, GBT_DEPTH)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with recording_tree_hist() as calls:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            gbt_pipeline(dev, GBT_ROUNDS).fit(train_frame)
            torch.cuda.synchronize()
            fit_ms = (time.perf_counter() - t0) * 1e3
    if len(calls) != GBT_ROUNDS * passes:
        raise SystemExit(f"{len(calls)} tree_hist calls in the config-4 "
                         f"fit, expected {GBT_ROUNDS * passes}")
    ops = _device_ms(prof)
    device_ms = sum(ops.values())
    seen = sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "tree_hist" in e.name),
                  key=lambda e: e.time_range.start)
    launches = []
    for i, c in enumerate(calls):
        F, N = c["binned_t"].shape
        T, S = c["node_idx"].shape[0], c["stats"].shape[-1]
        launches.append({
            "launch": i, "round": i // passes, "level": i % passes,
            "hist_nodes": c["n_nodes"], "F": F, "N": N, "T": T,
            "device_ms": launch_device_ms(c),
            # the profiler's own record, where it kept every launch
            "profiled_ms": (seen[i].time_range.elapsed_us() / 1e3
                            if len(seen) == len(calls) else None),
            **tree_hist_plan(N, F, T, c["n_nodes"], c["n_bins"], S),
        })
    kept = {}
    for i in range(passes, 2 * passes):
        kept[f"config 4 level {i - passes} (round 1 of the fit)"] = dict(
            calls[i], integer=False, hot=True)
    calls.clear()
    return {"profiled_fit_ms": fit_ms, "device_ms": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / fit_ms),
            "top_device_ops_ms": dict(list(ops.items())[:8]),
            "tree_hist_launches": launches,
            "tree_hist_seen_by_profiler": len(seen),
            "cases": kept}


def check_per_tree_forms(cases: dict) -> None:
    """Per-tree stats whose T rows are all equal and integer-valued give
    the shared form's histogram bitwise, at each recorded launch's
    shape and node ids."""
    rng = np.random.default_rng(SEED + 4)
    for name, c in cases.items():
        bins, node, w = c["binned_t"], c["node_idx"], c["weights"]
        T, N = node.shape
        shared = torch.from_numpy(
            rng.integers(-3, 4, (N, GBT_STATS)).astype(np.float32)).to(
                bins.device)
        kw = {"n_nodes": c["n_nodes"], "n_bins": c["n_bins"]}
        per_tree = tree_hist_cuda(
            bins, node, shared[None].expand(T, N, GBT_STATS).contiguous(),
            w, **kw)
        one = tree_hist_cuda(bins, node, shared, w, **kw)
        torch.cuda.synchronize()
        if not torch.equal(per_tree, one):
            raise SystemExit(f"tree_hist {name}: per-tree stats with equal "
                             "integer rows differ from the shared form")
        log(f"tree_hist {name}: per-tree stats with equal integer rows give "
            "the shared form bitwise")


def per_class_launches(c: dict):
    """The same histogram as ``K`` launches of the shared form, one per
    class tree: ``[1, N]`` node ids, the tree's own ``[N, S]`` stats."""
    bins, node, stats, w = (c["binned_t"], c["node_idx"], c["stats"],
                            c["weights"])
    kw = {"n_nodes": c["n_nodes"], "n_bins": c["n_bins"]}
    return lambda: [tree_hist_cuda(bins, node[t:t + 1], stats[t],
                                   None if w is None else w[t:t + 1], **kw)
                    for t in range(node.shape[0])]


def measure_forest_gbt(dev, data: dict, trained: dict, served: dict,
                       launches: dict) -> list:
    """``forest_traversal`` at bench config 4's shapes, held bitwise
    against its plain version first: the margin walk of a round (the 15
    class trees of round 0 over the train split's rows) and the fused
    serve walk (all 150 trees over the largest served micro-batch and
    over a padded 1 000-row one)."""
    ovr = served["ovr"]
    M = 2 ** (GBT_DEPTH + 1) - 1
    cat = [np.concatenate([getattr(m.forest, k) for m in ovr.models])
           for k in ("feature", "threshold", "leaf_stats")]
    first = [np.stack([getattr(m.forest, k)[0] for m in ovr.models])
             for k in ("feature", "threshold", "leaf_stats")]
    X_train = torch.from_numpy(raw_features(data["train"])).to(dev)
    shapes = [
        ("margin walk of a round", X_train, first, launches["fit"]),
        ("fused serve walk", served["X"][-GBT_BATCHES[-1]:].contiguous(), cat,
         launches["serve"]),
        ("fused serve walk", served["X"][:1024].contiguous(), cat,
         launches["serve"]),
    ]
    out = []
    for name, X, forest, n_launch in shapes:
        args = [X] + [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in forest]
        got = forest_leaf_stats_cuda(*args, max_depth=GBT_DEPTH)
        ref = forest_leaf_stats_reference(*args, max_depth=GBT_DEPTH)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise SystemExit(f"forest_traversal config 4 {name}: differs "
                             "from the plain version")
        nbytes, ops = forest_work(*args, depth=GBT_DEPTH)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops / FP32_OPS_PER_S * 1e3
        T = args[1].shape[0]
        out.append({
            "name": "forest_traversal", "route": "cuda",
            "source": "sntc_tpu_torch/kernels/csrc/forest_traversal.cu",
            "replaces": "sntc_tpu/kernels/forest.py:92",
            "launches": n_launch, "max_abs_err": 0.0,
            "ms": time_ms(lambda: forest_leaf_stats_cuda(
                *args, max_depth=GBT_DEPTH)),
            "device_ms": kernel_device_ms(lambda: forest_leaf_stats_cuda(
                *args, max_depth=GBT_DEPTH)),
            "plain_ms": time_ms(lambda: forest_leaf_stats_reference(
                *args, max_depth=GBT_DEPTH)),
            "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None,
            "shape": f"config 4 {name}: X [{X.shape[0]}, {X.shape[1]}] f32, "
                     f"T={T}, M={M}, S={GBT_STATS}; needs {nbytes} B, {ops} "
                     "comparisons",
            "rows": X.shape[0], "forest": name,
        })
    return out


# -- phase 7: bench configs 2 and 1, the LBFGS fits ----------------------------


def lbfgs_split(raw: Frame, binary: bool) -> tuple:
    """(train, test) of ``raw`` flows as the train command makes them:
    cleaned, relabelled benign/attack when ``binary``, split 0.8/0.2 with
    seed 0."""
    clean = clean_flows(raw)
    if binary:
        clean = clean.with_column("Label", np.where(
            clean["Label"].astype(str) == "BENIGN", "benign", "attack",
        ).astype(object))
    return tuple(clean.random_split([1 - TEST_FRACTION, TEST_FRACTION],
                                    seed=SEED))


def lbfgs_data(work: str, rows: int, binary: bool, tag: str) -> dict:
    """Bench config 2's (``binary=False``) or config 1's flows:
    ``rows`` synthetic rows from bench.py's data seed written as one raw
    CSV, and the same rows cleaned (relabeled benign/attack for config
    1) and split here with seed 0, as the train command splits them.
    The CSV is written by a thread of its own (pyarrow's writer releases
    the GIL) while this one splits and the caller goes on:
    :func:`data_dir` waits for it."""
    t0 = time.perf_counter()
    raw = generate_frame(rows, seed=LBFGS_DATA_SEED, min_class_fraction=0.005)
    path = os.path.join(work, f"days{tag}")
    os.makedirs(path)
    writer = ThreadPoolExecutor(1)
    written = writer.submit(write_raw_csv, raw, os.path.join(path, "day.csv"))
    writer.shutdown(wait=False)
    train, test = lbfgs_split(raw, binary)
    log(f"config-{tag} data: {rows} rows generated, {train.num_rows} "
        f"train / {test.num_rows} test after cleaning "
        f"({time.perf_counter() - t0:.1f} s; the CSV written beside)")
    return {"dir": path, "written": written, "train": train, "test": test,
            "tag": tag}


def data_dir(data: dict) -> str:
    """``data``'s directory of CSVs, once its writer (if any) is done."""
    if "written" in data:
        data["written"].result()
    return data["dir"]


def train_lbfgs(dev, data: dict, work: str, args: list) -> dict:
    """One LBFGS bench config through ``python -m sntc_tpu_torch train``
    (``--max-iter`` LBFGS iterations): the process starts with every
    launch count at 0 and the fit launches no kernel of its own (its
    products are ``torch.matmul``); its JSON line reports the LBFGS
    iterations, evaluations and host reads."""
    tag = data["tag"]
    model_dir = os.path.join(work, f"trained{tag}")
    cmd = [sys.executable, "-m", "sntc_tpu_torch", "train",
           "--data", data_dir(data), "--max-iter", str(LBFGS_ITERS),
           "--test-fraction", str(TEST_FRACTION), "--seed", str(SEED),
           "--model-out", model_dir, "--device", dev.type] + args
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"config-{tag} train failed ({proc.returncode}):\n"
                         f"{proc.stderr}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    summary["process_wall_s"] = wall
    summary["model_dir"] = model_dir
    if summary["train_rows"] != data["train"].num_rows:
        raise SystemExit(f"config-{tag} train split {summary['train_rows']} "
                         f"rows, expected {data['train'].num_rows}")
    stats = summary["lbfgs"]
    if not 0 < stats["iterations"] <= LBFGS_ITERS:
        raise SystemExit(f"config-{tag}: {stats['iterations']} LBFGS "
                         "iterations")
    log(f"config-{tag} train ({' '.join(args) or 'default estimator'}): "
        f"{summary['train_rows']} rows, fit {summary['fit_wall_clock_s']} s "
        f"({wall:.1f} s with process start, CSV read and evaluation), "
        f"held-out macro-F1 {summary['macroF1']}; LBFGS "
        f"{stats['iterations']} iterations, {stats['evaluations']} "
        f"value_and_grad evaluations, {stats['host_syncs']} host reads "
        f"({stats['host_syncs'] / max(stats['iterations'], 1):.2f} an "
        f"iteration); launches {summary['kernel_launches']}")
    return summary


def check_config2(summary: dict) -> None:
    if summary["estimator"] != "mlp":
        raise SystemExit(f"the default estimator was {summary['estimator']}")
    if not summary["macroF1"] >= MLP_F1_FLOOR:
        raise SystemExit(f"config-2 held-out macro-F1 {summary['macroF1']} "
                         f"below {MLP_F1_FLOOR}")


def check_config1(dev, data: dict, summary: dict) -> float:
    """Held-out AUC of the saved config-1 model, by the port's
    ``BinaryClassificationEvaluator`` over the same split."""
    model = load_model(summary["model_dir"], device=dev)
    head = model.getStages()[-1]
    if not head.is_binomial:
        raise SystemExit("config 1 fitted a multinomial model")
    auc = BinaryClassificationEvaluator().evaluate(
        model.transform(data["test"]))
    log(f"config-1 held-out areaUnderROC {auc:.6f} (floor {LR_AUC_FLOOR})")
    if not auc >= LR_AUC_FLOOR:
        raise SystemExit(f"config-1 held-out AUC {auc} below {LR_AUC_FLOOR}")
    summary["areaUnderROC"] = auc
    return auc


def _clear_rows(prob: np.ndarray, tol: float) -> np.ndarray:
    """Rows whose top two probabilities lie more than ``tol`` apart."""
    s = np.sort(prob, axis=1)
    return s[:, -1] - s[:, -2] > tol


def serve_mlp(dev, data: dict, trained: dict, work: str) -> dict:
    """The fitted config-2 pipeline served by ``python -m sntc_tpu_torch
    serve`` over ``MLP_BATCHES`` micro-batches of held-out flows: the
    1 000-row batch pads to 1 024 (one ``pad_assemble`` launch).  In this
    process, each batch's probabilities unpadded on the card and on the
    CPU: within ``MLP_SERVE_TOL`` of the padded card run's, and its
    predictions equal to theirs wherever their top two probabilities lie
    further apart than that."""
    import pyarrow.csv as pacsv

    traffic = data["test"].slice(0, sum(MLP_BATCHES)).drop("Label")
    watch = os.path.join(work, "in2")
    os.makedirs(watch)
    batches, start = [], 0
    for i, n in enumerate(MLP_BATCHES):
        b = traffic.slice(start, start + n)
        write_raw_csv(b, os.path.join(watch, f"part_{i:04d}.csv"))
        batches.append(b)
        start += n
    out_dir = os.path.join(work, "out2")
    # both forms' serving processes start together (their start-ups
    # overlap), and the default form's once more with the host-serve
    # crossover left to its default (the variable unset); the default
    # form's are checked by serve_mlp_default and serve_mlp_rule
    unset = {k: v for k, v in os.environ.items()
             if k != "SNTC_SERVE_HOST_ROWS"}
    summary, default_summary, rule_summary = together(
        (serve_command, trained["model_dir"], watch, out_dir,
         os.path.join(work, "ckpt2"), dev, STAGED_FORM),
        (serve_command, trained["model_dir"], watch,
         os.path.join(work, "out2_default"),
         os.path.join(work, "ckpt2_default"), dev, []),
        (serve_command, trained["model_dir"], watch,
         os.path.join(work, "out2_rule"), os.path.join(work, "ckpt2_rule"),
         dev, [], 1, unset))
    want = {"forest_traversal": 0, "tree_hist": 0,
            "pad_assemble": sum(bucket_rows_for(n, BUCKET_FLOOR) != n
                                for n in MLP_BATCHES)}
    if summary["batches"] != len(MLP_BATCHES) or \
            summary["rows"] != sum(MLP_BATCHES):
        raise SystemExit(f"config-2 serve covered {summary}, expected "
                         f"{MLP_BATCHES}")
    if summary["kernel_launches"] != want or want["pad_assemble"] < 1:
        raise SystemExit(f"config-2 serve launches "
                         f"{summary['kernel_launches']}, expected {want}")
    on_card, labels, _ = serving_form(load_model(trained["model_dir"],
                                                 device=dev))
    on_cpu, _, _ = serving_form(load_model(trained["model_dir"],
                                           device="cpu"))
    padded = BatchPredictor(on_card, bucket_rows=BUCKET_FLOOR, device=dev)
    errs = {"padded_vs_unpadded": 0.0, "card_vs_cpu": 0.0}
    for i, (b, n) in enumerate(zip(batches, MLP_BATCHES)):
        t = pacsv.read_csv(os.path.join(out_dir, f"batch_{i:06d}.csv"))
        pred = t.column("prediction").to_numpy()
        if len(pred) != n or t.column("predictedLabel").to_pylist() != \
                [labels[int(p)] for p in pred]:
            raise SystemExit(f"config-2 batch {i}: rows or labels differ")
        ref = to_host(padded.predict_frame(b)["probability"])
        if not np.array_equal(to_host(padded.predict_frame(b)["prediction"]),
                              pred):
            raise SystemExit(f"config-2 batch {i}: the serve command's "
                             "predictions differ from this process's")
        for key, model in (("padded_vs_unpadded", on_card),
                           ("card_vs_cpu", on_cpu)):
            out = model.transform(b)
            prob = to_host(out["probability"])
            err = float(np.abs(prob - ref).max())
            errs[key] = max(errs[key], err)
            clear = _clear_rows(prob, MLP_SERVE_TOL) & \
                _clear_rows(ref, MLP_SERVE_TOL)
            if err > MLP_SERVE_TOL or not np.array_equal(
                    to_host(out["prediction"])[clear], pred[clear]):
                raise SystemExit(f"config-2 batch {i} ({key}): probability "
                                 f"{err} off, or a clear prediction differs")
    default = serve_mlp_default(dev, trained, batches, work,
                                default_summary, padded)
    default["rule"] = serve_mlp_rule(dev, trained, batches, work,
                                     rule_summary, default_summary, padded)
    log(f"config-2 serve (staged): {summary['batches']} batches, "
        f"{summary['rows']} rows in {summary['seconds']:.3f} s "
        f"({summary['rows'] / summary['seconds']:.0f} rows/s); "
        + ", ".join(f"{p['numInputRows']} rows in {p['durationMs']:.2f} ms"
                    for p in summary["progress"])
        + f"; probabilities padded vs unpadded {errs['padded_vs_unpadded']}, "
        f"card vs CPU {errs['card_vs_cpu']} (tolerance {MLP_SERVE_TOL}); "
        f"launches {summary['kernel_launches']}")
    summary["max_prob_err"] = errs
    summary["batches_rows"] = MLP_BATCHES
    summary["default_form"] = default
    return summary


def serve_mlp_default(dev, trained: dict, batches: list, work: str,
                      summary: dict, staged) -> dict:
    """Phase 8, config 2: the serve command's default form (the scaler
    folded into the MLP's first layer, so no fused segment remains; the
    pipelined engine) over the same micro-batches.  Its predictions equal
    this process's fused form on the card, whose probabilities lie within
    MLP_SERVE_TOL of the staged form's (``staged``, padded alike), and
    its predictions equal the staged ones wherever the top two lie
    further apart than that."""
    import pyarrow.csv as pacsv

    out_dir = os.path.join(work, "out2_default")
    want = {"forest_traversal": 0, "tree_hist": 0,
            "pad_assemble": sum(bucket_rows_for(n, BUCKET_FLOOR) != n
                                for n in MLP_BATCHES)}
    stats = summary["pipeline_stats"]
    if summary["kernel_launches"] != want or summary["fusion"] is not None \
            or not stats["overlap_sink"] or summary["rows"] != sum(MLP_BATCHES):
        raise SystemExit(f"config-2 default serve {summary}")
    fused, _, _ = serving_form(load_model(trained["model_dir"], device=dev),
                               "label", True)
    if [type(x).__name__ for x in fused.getStages()] != [
            "VectorAssembler", "MultilayerPerceptronClassificationModel",
            "IndexToString"]:
        raise SystemExit(f"config-2 fused form {fused.getStages()}")
    fused = BatchPredictor(fused, bucket_rows=BUCKET_FLOOR, device=dev)
    err = 0.0
    for i, b in enumerate(batches):
        t = pacsv.read_csv(os.path.join(out_dir, f"batch_{i:06d}.csv"))
        pred = t.column("prediction").to_numpy()
        out = fused.predict_frame(b)
        ref = staged.predict_frame(b)
        prob = to_host(out["probability"])
        ref_prob = to_host(ref["probability"])
        err = max(err, float(np.abs(prob - ref_prob).max()))
        clear = _clear_rows(prob, MLP_SERVE_TOL) & \
            _clear_rows(ref_prob, MLP_SERVE_TOL)
        if not np.array_equal(to_host(out["prediction"]), pred) or \
                err > MLP_SERVE_TOL or not np.array_equal(
                    pred[clear], to_host(ref["prediction"])[clear]):
            raise SystemExit(f"config-2 default batch {i}: predictions "
                             f"differ, or probability {err} off the staged "
                             "form's")
    log(f"config-2 serve (defaults): {summary['batches']} batches, "
        f"{summary['rows']} rows in {summary['seconds']:.3f} s; "
        f"probabilities within {err} of the staged form's (tolerance "
        f"{MLP_SERVE_TOL}); transfers {stats['transfers']}; launches "
        f"{summary['kernel_launches']}")
    summary["max_prob_err_vs_staged"] = err
    return summary


def serve_mlp_rule(dev, trained: dict, batches: list, work: str,
                   summary: dict, pinned: dict, staged) -> dict:
    """Phase 8, config 2: the serve command's default form with the
    host-serve crossover at its default (``SNTC_SERVE_HOST_ROWS`` unset).
    Placement: a batch that pads to its bucket stays on the card, a host
    batch that fills it runs on the host when it has at most the MLP's
    ``HOST_SERVE_ROWS`` rows, so the copies back are the card's batches
    only; ``pad_assemble`` once a padded batch.  Its predictions equal
    this process's fused form under the same rule, its probabilities lie
    within MLP_SERVE_TOL of the staged form's (``staged``, on the card);
    each batch's latency beside the pinned run's (``pinned``, every
    batch on the card)."""
    import pyarrow.csv as pacsv

    from sntc_tpu_torch.models.mlp import (
        MultilayerPerceptronClassificationModel as Mlp,
    )

    out_dir = os.path.join(work, "out2_rule")
    placed = ["card" if bucket_rows_for(n, BUCKET_FLOOR) != n
              or n > Mlp.HOST_SERVE_ROWS else "host" for n in MLP_BATCHES]
    want = {"forest_traversal": 0, "tree_hist": 0,
            "pad_assemble": sum(bucket_rows_for(n, BUCKET_FLOOR) != n
                                for n in MLP_BATCHES)}
    transfers = summary["pipeline_stats"]["transfers"]
    if summary["kernel_launches"] != want or \
            summary["rows"] != sum(MLP_BATCHES) or \
            transfers["downloads"] != placed.count("card"):
        raise SystemExit(f"config-2 default serve, crossover unset: "
                         f"placement {placed}, {summary}")
    fused, _, _ = serving_form(load_model(trained["model_dir"], device=dev),
                               "label", True)
    fused = BatchPredictor(fused, bucket_rows=BUCKET_FLOOR, device=dev)
    refs = [to_host(staged.predict_frame(b)["probability"])
            for b in batches]
    err = 0.0
    with environ(SNTC_SERVE_HOST_ROWS=None):
        for i, (b, ref_prob) in enumerate(zip(batches, refs)):
            t = pacsv.read_csv(os.path.join(out_dir, f"batch_{i:06d}.csv"))
            pred = t.column("prediction").to_numpy()
            out = fused.predict_frame(b)
            prob = to_host(out["probability"])
            err = max(err, float(np.abs(prob - ref_prob).max()))
            if not np.array_equal(to_host(out["prediction"]), pred) or \
                    err > MLP_SERVE_TOL:
                raise SystemExit(f"config-2 default batch {i}, crossover "
                                 f"unset: predictions differ, or "
                                 f"probability {err} off the staged form's")
    ms = [p["durationMs"] for p in summary["progress"]]
    pinned_ms = [p["durationMs"] for p in pinned["progress"]]
    log(f"config-2 serve (defaults, crossover unset, MLP HOST_SERVE_ROWS "
        f"{Mlp.HOST_SERVE_ROWS}): batches {MLP_BATCHES} placed {placed}; "
        f"transfers {transfers}; launches {summary['kernel_launches']}; "
        f"probabilities within {err} of the staged form's (tolerance "
        f"{MLP_SERVE_TOL}); batch ms {[round(x, 3) for x in ms]}, every "
        f"batch on the card {[round(x, 3) for x in pinned_ms]}")
    return {"placed": placed, "transfers": transfers, "batch_ms": ms,
            "pinned_batch_ms": pinned_ms, "max_prob_err_vs_staged": err}


def lbfgs_pipeline(device, estimator, **kw) -> Pipeline:
    """The train command's ``mlp``/``lr`` pipeline, built in this
    process: label indexing, assembly, the scaler (withMean), the head."""
    head = (MultilayerPerceptronClassifier(
        device=device, layers=MLP_LAYERS, maxIter=LBFGS_ITERS, seed=SEED,
        **kw) if estimator == "mlp" else LogisticRegression(
        device=device, maxIter=LBFGS_ITERS, regParam=LR_REG, **kw))
    return Pipeline(stages=[
        StringIndexer(inputCol="Label", outputCol="label",
                      handleInvalid="skip"),
        VectorAssembler(inputCols=CICIDS2017_FEATURES,
                        outputCol="rawFeatures", handleInvalid="skip"),
        StandardScaler(device=device, inputCol="rawFeatures",
                       outputCol="features", withMean=True),
        head,
    ])


def _history(model) -> np.ndarray:
    return np.asarray(model.getStages()[-1].summary.objectiveHistory)


def reduced_lbfgs_fits(dev, data2: dict, data1: dict, work: str) -> dict:
    """The MLP (config 2) and binary LR (config 1) pipelines on the first
    ``REDUCED_LBFGS_ROWS`` train rows, fitted on the card and on the CPU
    from one seed: the objective histories within ``LBFGS_PREFIX_TOL`` of
    the starting objective over the estimator's first ``LBFGS_PREFIX``
    iterations and within ``LBFGS_ALL_TOL`` over all, the end objectives
    within
    ``LBFGS_END_TOL`` of it; then a card fit segmented by checkpoints
    every ``LBFGS_CKPT_EVERY`` iterations equal bitwise to the
    uninterrupted card fit."""
    out = {}
    for tag, est, data in (("2", "mlp", data2), ("1", "lr", data1)):
        frame = data["train"].slice(0, REDUCED_LBFGS_ROWS)
        t0 = time.perf_counter()
        card = lbfgs_pipeline(dev, est).fit(frame)
        t1 = time.perf_counter()
        cpu = lbfgs_pipeline(torch.device("cpu"), est).fit(frame)
        t2 = time.perf_counter()
        seg = lbfgs_pipeline(
            dev, est, checkpointInterval=LBFGS_CKPT_EVERY,
            checkpointDir=os.path.join(work, f"lbfgs_ckpt{tag}")).fit(frame)
        h_card, h_cpu = _history(card), _history(cpu)
        n = min(len(h_card), len(h_cpu))
        gap = np.abs(h_card[:n] - h_cpu[:n]) / h_cpu[0]
        end_gap = abs(h_card[-1] - h_cpu[-1]) / h_cpu[0]
        heads = [m.getStages()[-1] for m in (card, seg)]
        params = [h.weights if est == "mlp" else h.coefficientMatrix
                  for h in heads]
        bitwise = np.array_equal(params[0], params[1]) and \
            np.array_equal(h_card, _history(seg))
        rec = {
            "rows": frame.num_rows, "card_s": t1 - t0, "cpu_s": t2 - t1,
            "iterations": {"card": len(h_card) - 1, "cpu": len(h_cpu) - 1},
            "prefix": LBFGS_PREFIX[est],
            "prefix_gap": float(gap[: LBFGS_PREFIX[est] + 1].max()),
            "gaps": [float(f"{g:.2g}") for g in gap],
            "max_gap": float(gap.max()), "end_gap": float(end_gap),
            "end_objective": {"card": float(h_card[-1]),
                              "cpu": float(h_cpu[-1])},
            "segmented_bitwise": bool(bitwise),
            "card_stats": heads[0].optimizer_stats,
        }
        log(f"reduced config-{tag} fit ({rec['rows']} rows, {est}): card "
            f"{rec['card_s']:.2f} s, CPU {rec['cpu_s']:.2f} s; iterations "
            f"{rec['iterations']}; history gap over the first "
            f"{rec['prefix']} iterations {rec['prefix_gap']:.3g}, over all "
            f"{rec['max_gap']:.3g}"
            f", end objective {rec['end_objective']} gap "
            f"{rec['end_gap']:.3g} (of the start); segmented card fit "
            f"bitwise: {bitwise}; gap by iteration {rec['gaps']}")
        if rec["prefix_gap"] > LBFGS_PREFIX_TOL or \
                rec["max_gap"] > LBFGS_ALL_TOL or \
                rec["end_gap"] > LBFGS_END_TOL:
            raise SystemExit(f"reduced config-{tag} fit: card and CPU "
                             f"histories part beyond the rule: {rec}")
        if not bitwise:
            raise SystemExit(f"reduced config-{tag} fit: the segmented card "
                             "fit differs from the uninterrupted one")
        out[tag] = rec
    return out


def _op_group(name: str) -> str:
    n = name.lower()
    if "memcpy" in n or "memset" in n:
        return "copies"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "dot_kernel" in n:
        return "products"
    if "reduce" in n:
        return "reductions"
    return "elementwise and other"


def mlp_fit_profile(dev, data: dict) -> dict:
    """The config-2 pipeline fitted at full width in this process under
    a profiler window, stage by stage as ``Pipeline.fit`` runs them: the
    fit's host-clock time and each stage's (the head's fit is the LBFGS
    loop, with the rows' upload), the device time the window saw (hence
    its idle share), the device time by kernel and by group (products,
    reductions, elementwise, copies); then one
    ``value_and_grad`` of the full-width loss timed by its device time a
    call (CUDA events around calls queued behind a spin) beside its
    bound: FLOPs of the forward and backward products over the card's
    fp32 rate, against X, labels and weights read once."""
    from sntc_tpu_torch.models.mlp import _forward, value_and_grad_fn

    train = data["train"]
    stages = lbfgs_pipeline(dev, "mlp").getStages()
    times, scaled = {}, train
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t_all = time.perf_counter()
        for stage in stages:
            name = type(stage).__name__
            t0 = time.perf_counter()
            head = stage.fit(scaled) if isinstance(stage, Estimator) else stage
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            times[f"{name}.fit"] = (t1 - t0) * 1e3
            if stage is not stages[-1]:
                scaled = head.transform(scaled)
                times[f"{name}.transform"] = (time.perf_counter() - t1) * 1e3
        fit_ms = (time.perf_counter() - t_all) * 1e3
    ops = _device_ms(prof)
    device_ms = sum(ops.values())
    groups = {}
    for name, ms in ops.items():
        g = _op_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    stats = head.optimizer_stats

    # one value_and_grad at the fit's full width
    X = torch.from_numpy(np.require(scaled["features"], np.float32,
                                    ["C", "W"])).to(dev)
    y = torch.from_numpy(to_host(scaled["label"]).astype(np.int64)).to(dev)
    w = torch.ones(X.shape[0], device=dev)
    layers = tuple(head.getLayers())
    theta = torch.from_numpy(head.weights.copy()).to(dev)

    def loss(t):
        logp = torch.log_softmax(_forward(t, X, layers), dim=1)
        return -torch.sum(w * torch.gather(logp, 1, y[:, None])[:, 0]) \
            / torch.sum(w)

    vg = value_and_grad_fn(loss)
    with full_f32():
        vg_ms = time_ms(lambda: vg(theta), iters=10)
        vg_device_ms = kernel_device_ms(lambda: vg(theta), calls=8)
    # forward and weight-gradient products of every layer, and the
    # input-gradient products of every layer but the first
    pairs = list(zip(layers[:-1], layers[1:]))
    macs = 2 * pairs[0][0] * pairs[0][1] + 3 * sum(a * b for a, b in pairs[1:])
    n = X.shape[0]
    flops = 2 * n * macs
    nbytes = n * (layers[0] * 4 + 8 + 4) + theta.numel() * 8
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / FP32_OPS_PER_S * 1e3
    rec = {
        "train_rows": train.num_rows, "profiled_fit_ms": fit_ms,
        "stages_ms": times,
        "device_ms": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / fit_ms),
        "top_device_ops_ms": dict(list(ops.items())[:10]),
        "device_ms_by_group": groups, "lbfgs": stats,
        "value_and_grad": {
            "ms": vg_ms, "device_ms": vg_device_ms, "flops": flops,
            "bytes": nbytes, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
        },
    }
    return rec


# -- phase 8: the serve command's default form --------------------------------


def steady(summary: dict) -> dict:
    """A served run without its first batch (which pays the lazy CUDA
    loading): rows/s between the first and the last commit, and the mean
    read, predict and sink ms of the other batches."""
    prog = summary["progress"]
    rest = prog[1:]
    rows = sum(p["numInputRows"] for p in rest)
    span_ms = prog[-1]["commitMs"] - prog[0]["commitMs"]
    return {
        "rows_per_s": rows / span_ms * 1e3,
        **{f"{k}_ms": float(np.mean([p[f"{k}Ms"] for p in rest]))
           for k in ("read", "dispatch", "finalize", "predict", "sink")},
    }


def read_probe(path: str) -> list:
    """Host ms of three ``load_csv`` calls of one file in a fresh
    process: whether the first batch's read pays a per-process start."""
    code = ("import json, sys, time\n"
            "from sntc_tpu_torch.data import load_csv\n"
            "ms = []\n"
            "for _ in range(3):\n"
            "    t0 = time.perf_counter(); load_csv(sys.argv[1])\n"
            "    ms.append((time.perf_counter() - t0) * 1e3)\n"
            "print(json.dumps(ms))\n")
    proc = subprocess.run([sys.executable, "-c", code, path], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise SystemExit(f"read probe failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def sink_files(out: str) -> dict:
    return {f: open(os.path.join(out, f), "rb").read()
            for f in sorted(os.listdir(out))}


def skip_copies(bad: np.ndarray) -> dict:
    """The copies the engine's ledger must show for one batch whose rows
    ``bad`` (Inf/NaN features) the ``skip`` assembler drops on the card:
    the padded block's upload and the outputs' download; the read of the
    validity verdict; with rows to drop, the read of the row mask and,
    unless the kept rows of the padded batch are a leading run (only a
    tail to cut), the upload of their indices."""
    n = len(bad)
    padded = np.concatenate(
        [bad, np.repeat(bad[-1:], bucket_rows_for(n, BUCKET_FLOOR) - n)])
    kept = ~padded
    gather = bool(padded.any()) and not kept[:int(kept.sum())].all()
    return {"uploads": 1 + gather, "downloads": 1,
            "syncs": 1 + bool(padded.any())}


def check_form_run(form: str, s: dict, copies: dict) -> None:
    """One run of a form: every batch served, each kernel of the path
    launched once a batch, the engine's transfer ledger showing
    ``copies`` (one upload and one download a batch, and the skip
    path's mask and index copies); the default form through one fused
    segment bound on every batch, the staged one through none."""
    n_batches = FORM_FILES // FORM_FILES_PER_BATCH
    if s["batches"] != n_batches or s["rows"] != FORM_FILES * FORM_FILE_ROWS:
        raise SystemExit(f"{form} form covered {s['batches']} batches, "
                         f"{s['rows']} rows")
    want = {"forest_traversal": n_batches, "pad_assemble": n_batches,
            "tree_hist": 0}
    if s["kernel_launches"] != want:
        raise SystemExit(f"{form} form launches {s['kernel_launches']}, "
                         f"expected {want}")
    stats = s["pipeline_stats"]
    moved = stats["transfers"]
    if {k: moved[k] for k in copies} != copies:
        raise SystemExit(f"{form} form transfers {moved}, expected "
                         f"{copies}")
    fusion = s["fusion"]
    if form == "staged":
        if fusion is not None or stats["overlap_sink"] \
                or stats["storage"]["wal_mode"] != "append":
            raise SystemExit(f"staged form ran {stats}, fusion {fusion}")
        return
    if not stats["overlap_sink"] or stats["pipeline_depth"] != 2 \
            or stats["storage"]["wal_mode"] != "files":
        raise SystemExit(f"default form ran {stats}")
    if fusion is None or fusion["segments"] != 1 \
            or fusion["invocations"] != n_batches or fusion["fallbacks"] \
            or fusion["downloads"] != n_batches \
            or fusion["uploads"] + fusion["device_binds"] != n_batches:
        raise SystemExit(f"default form fusion {fusion}: expected one "
                         f"segment bound on each of {n_batches} batches")


def serve_forms(dev, work: str) -> list:
    """Phase 8: the config-3 pipeline of phase 3 serves FORM_FILES CSV
    files of FORM_FILE_ROWS rows, FORM_FILES_PER_BATCH files a batch
    (each batch padded to 65 536 rows), in the command's default form
    (fused, pipelined, files WAL) and its staged, serial, append-WAL
    form, FORM_RUNS times each in turns.  The flows are not cleaned: as
    live flows do, 0.1 % of them carry Inf/NaN rates, which the
    ``skip`` assembler drops on the card.  Every run's batch files must
    be byte-identical."""
    import pyarrow as pa
    import pyarrow.csv as pacsv

    n = FORM_FILES * FORM_FILE_ROWS
    t0 = time.perf_counter()
    traffic = generate_frame(n, seed=SEED + 8).drop("Label")
    X = np.stack([traffic[c] for c in CICIDS2017_FEATURES], axis=1)
    bad = ~np.isfinite(X).all(axis=1)
    rows = FORM_FILES_PER_BATCH * FORM_FILE_ROWS
    batch_bad = [bad[b:b + rows] for b in range(0, n, rows)]
    per_batch = [skip_copies(x) for x in batch_bad]
    copies = {k: sum(c[k] for c in per_batch) for k in per_batch[0]}
    watch = os.path.join(work, "in8")
    os.makedirs(watch)
    # the read probe's process runs beside the writes of the other files
    with ThreadPoolExecutor(1) as pool:
        for i in range(FORM_FILES):
            write_raw_csv(traffic.slice(i * FORM_FILE_ROWS,
                                        (i + 1) * FORM_FILE_ROWS),
                          os.path.join(watch, f"part_{i:04d}.csv"))
            if i == 0:
                probe = pool.submit(read_probe,
                                    os.path.join(watch, "part_0000.csv"))
        written_s = time.perf_counter() - t0
        log(f"phase 8 traffic: {FORM_FILES} files of {FORM_FILE_ROWS} "
            f"rows, {int(bad.sum())} with Inf/NaN features "
            f"({[int(x.sum()) for x in batch_bad]} a batch; expected "
            f"copies {copies}; {written_s:.1f} s to generate and write); "
            "load_csv of one file three times in a fresh process (beside "
            f"the other files' writes): {probe.result()} ms")
    runs = []
    for r in range(FORM_RUNS):
        for form, extra in (("default", []), ("staged", STAGED_FORM)):
            out = os.path.join(work, f"out8_{form}_{r}")
            s = serve_command(os.path.join(work, "model"), watch, out,
                              os.path.join(work, f"ckpt8_{form}_{r}"), dev,
                              extra, FORM_FILES_PER_BATCH)
            check_form_run(form, s, copies)
            runs.append({"form": form, "run": r, "summary": s,
                         "files": sink_files(out), **steady(s)})
    ref = runs[0]["files"]
    for x in runs:
        if x["files"] != ref:
            raise SystemExit(f"{x['form']} run {x['run']}: batch files "
                             "differ from the default form's first run")
    if len(ref) != len(batch_bad):
        raise SystemExit(f"phase 8 wrote {len(ref)} batch files")
    for (name, data), x in zip(sorted(ref.items()), batch_bad):
        t = pacsv.read_csv(pa.BufferReader(data))
        pred = t.column("prediction").to_numpy()
        if len(pred) != rows - int(x.sum()) or pred.min() < 0 \
                or pred.max() >= CLASSES:
            raise SystemExit(f"phase 8 {name}: {len(pred)} rows or "
                             "predictions out of range")
    for x in runs:
        del x["files"]
    return runs


def dispatch_split(dev, paths: list, admit: bool) -> dict:
    """The in-process split of one ``pad_assemble`` call
    (``scripts/pad_assemble_split.py``: the host's pack, the upload, the
    launch's device time, the whole call) on the batch of ``paths`` as
    the serve command reads it, padded to its bucket; with ``admit``,
    after the admission contract's float32 cast (the salvage block);
    ``seconds`` is what the measurement took."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from pad_assemble_split import split

    t0 = time.perf_counter()
    frame = Frame.concat_all([load_csv(p) for p in paths])
    n = frame.num_rows
    target = bucket_rows_for(n, BUCKET_FLOOR)
    valid = np.zeros(target, bool)
    valid[:n] = True
    if admit:
        admitted = CICIDS2017_CONTRACT.admit(frame)
        frame, valid[:n] = admitted.frame, admitted.valid
    out = split(frame, target, valid, dev, reps=SPLIT_REPS)
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phase 9: naive Bayes, LinearSVC, evaluate and the tree regressors ------


def train_estimator(dev, data: dict, est: str, work: str) -> dict:
    """``python -m sntc_tpu_torch train --estimator nb|svc`` at the
    command's defaults (svc: 100 LBFGS iterations per class at regParam
    1e-4) on config 2's flows.  Their fits and the held-out evaluation
    launch no kernel of the port (their products are ``torch.matmul``);
    the serve path's ``pad_assemble`` is counted in ``serve_nb_svc``."""
    model_dir = os.path.join(work, f"trained_{est}")
    cmd = [sys.executable, "-m", "sntc_tpu_torch", "train",
           "--data", data_dir(data), "--estimator", est,
           "--test-fraction", str(TEST_FRACTION), "--seed", str(SEED),
           "--model-out", model_dir, "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"{est} train failed ({proc.returncode}):\n"
                         f"{proc.stderr}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    summary["process_wall_s"] = wall
    summary["model_dir"] = model_dir
    if summary["train_rows"] != data["train"].num_rows:
        raise SystemExit(f"{est} train split {summary['train_rows']} rows, "
                         f"expected {data['train'].num_rows}")
    if any(summary["kernel_launches"].values()):
        raise SystemExit(f"{est} train launched {summary['kernel_launches']}")
    if not summary["macroF1"] >= NB_SVC_F1_FLOOR[est]:
        raise SystemExit(f"{est} held-out macro-F1 {summary['macroF1']} "
                         f"below {NB_SVC_F1_FLOOR[est]}")
    per_class = ""
    if est == "svc":
        stats = summary["lbfgs"]
        if len(stats) != CLASSES or not all(
                0 < s["iterations"] <= LBFGS_ITERS for s in stats):
            raise SystemExit(f"svc LBFGS per class {stats}")
        per_class = "; LBFGS per class (iterations/host reads) " + ", ".join(
            f"{s['iterations']}/{s['host_syncs']}" for s in stats)
    log(f"{est} train: {summary['train_rows']} rows, fit "
        f"{summary['fit_wall_clock_s']} s ({wall:.1f} s with process start, "
        f"CSV read and evaluation), held-out macro-F1 {summary['macroF1']}"
        f"{per_class}")
    return summary


def check_nb_card_vs_cpu(dev, data: dict, trained: dict) -> dict:
    """The saved gaussian model on the card and on the CPU over the
    held-out rows: float64 raw scores within NB_RAW_RTOL of each other
    (relative to max(|raw|, 1)), predictions equal; and the same model
    fitted on the CPU in this process: class priors equal, means within
    NB_MOMENT_RTOL of max(|mean|, |pilot|) and variances within it of
    the card's fit."""
    on_card = load_model(trained["model_dir"], device=dev)
    on_cpu = load_model(trained["model_dir"], device="cpu")
    a, b = on_card.transform(data["test"]), on_cpu.transform(data["test"])
    ra, rb = to_host(a["rawPrediction"]), to_host(b["rawPrediction"])
    rel = float((np.abs(ra - rb) / np.maximum(np.abs(rb), 1.0)).max())
    if rel > NB_RAW_RTOL or not np.array_equal(to_host(a["prediction"]),
                                               to_host(b["prediction"])):
        raise SystemExit(f"nb: card raw scores {rel} off the CPU's, or a "
                         "prediction differs")
    head = on_card.getStages()[-1]
    feats = PipelineModel(stages=on_cpu.getStages()[:2]).transform(
        data["train"])
    t0 = time.perf_counter()
    cpu_fit = NaiveBayes(device="cpu", modelType="gaussian",
                         featuresCol="rawFeatures").fit(feats)
    cpu_s = time.perf_counter() - t0
    # the means come from f32 sums about a pilot row (the first): their
    # rounding scales with max(|mean|, |pilot|), not with the mean
    pilot = np.abs(to_host(feats["rawFeatures"])[0]).astype(np.float64)
    mu = float((np.abs(cpu_fit.gaussian_mu - head.gaussian_mu) / np.maximum(
        np.maximum(np.abs(head.gaussian_mu), pilot[None, :]), 1e-30)).max())
    var = float(np.abs((cpu_fit.gaussian_var - head.gaussian_var)
                       / head.gaussian_var).max())
    if not np.array_equal(cpu_fit.pi, head.pi) or max(mu, var) > \
            NB_MOMENT_RTOL:
        raise SystemExit(f"nb: the CPU fit's priors differ, or its means "
                         f"({mu}) or variances ({var}) are off the card's")
    log(f"nb on the card against the CPU: raw scores within {rel:.3g} "
        f"(max(|raw|, 1)-relative, tolerance {NB_RAW_RTOL}) over "
        f"{len(ra)} held-out rows, predictions equal; a CPU fit's means "
        f"within {mu:.3g}, variances within {var:.3g} of the card's "
        f"(tolerance {NB_MOMENT_RTOL}; CPU fit {cpu_s:.2f} s)")
    return {"raw_rel": rel, "mu_rel": mu, "var_rel": var}


def serve_nb_svc(dev, data: dict, trained: dict, work: str) -> dict:
    """Both saved pipelines served by ``python -m sntc_tpu_torch serve``
    in the default form over ``NB_SVC_BATCHES`` micro-batches of
    held-out flows: the 1 000-row batch pads to 1 024 (one
    ``pad_assemble`` launch).  Every prediction equals this process's
    padded serving form on the card; nb's equal the unpadded rows' too,
    svc's wherever the top two raw scores lie more than 1e-4 apart."""
    import pyarrow.csv as pacsv

    traffic = data["test"].slice(0, sum(NB_SVC_BATCHES)).drop("Label")
    watch = os.path.join(work, "in9")
    os.makedirs(watch)
    batches, start = [], 0
    for i, n in enumerate(NB_SVC_BATCHES):
        b = traffic.slice(start, start + n)
        write_raw_csv(b, os.path.join(watch, f"part_{i:04d}.csv"))
        batches.append(b)
        start += n
    want = {"forest_traversal": 0, "tree_hist": 0,
            "pad_assemble": sum(bucket_rows_for(n, BUCKET_FLOOR) != n
                                for n in NB_SVC_BATCHES)}
    out = {}
    # the two serving processes start together (their start-ups overlap)
    summaries = dict(zip(("nb", "svc"), together(*[
        (serve_command, trained[est]["model_dir"], watch,
         os.path.join(work, f"out9_{est}"), os.path.join(work, f"ckpt9_{est}"),
         dev, []) for est in ("nb", "svc")])))
    for est in ("nb", "svc"):
        model_dir = trained[est]["model_dir"]
        out_dir = os.path.join(work, f"out9_{est}")
        summary = summaries[est]
        if summary["batches"] != len(NB_SVC_BATCHES) or \
                summary["rows"] != sum(NB_SVC_BATCHES) or \
                summary["kernel_launches"] != want or \
                want["pad_assemble"] < 1:
            raise SystemExit(f"{est} serve {summary['batches']} batches, "
                             f"{summary['rows']} rows, launches "
                             f"{summary['kernel_launches']}; expected "
                             f"{NB_SVC_BATCHES}, {want}")
        fused, labels, _ = serving_form(load_model(model_dir, device=dev),
                                        "label", True)
        padded = BatchPredictor(fused, bucket_rows=BUCKET_FLOOR, device=dev)
        unpadded, _, _ = serving_form(load_model(model_dir, device=dev))
        clear_rows = 0
        for i, b in enumerate(batches):
            t = pacsv.read_csv(os.path.join(out_dir, f"batch_{i:06d}.csv"))
            pred = t.column("prediction").to_numpy()
            if not np.array_equal(
                    to_host(padded.predict_frame(b)["prediction"]), pred) \
                    or t.column("predictedLabel").to_pylist() != \
                    [labels[int(p)] for p in pred]:
                raise SystemExit(f"{est} batch {i}: the serve command's "
                                 "predictions differ from this process's")
            ref = unpadded.transform(b)
            keep = np.ones(len(pred), bool)
            if est == "svc":
                raw = np.sort(to_host(ref["rawPrediction"]), axis=1)
                keep = raw[:, -1] - raw[:, -2] > 1e-4
            clear_rows += int(keep.sum())
            if not np.array_equal(to_host(ref["prediction"])[keep],
                                  pred[keep]):
                raise SystemExit(f"{est} batch {i}: padded and unpadded "
                                 "predictions differ")
        log(f"{est} serve (defaults): {summary['batches']} batches, "
            f"{summary['rows']} rows in {summary['seconds']:.3f} s; "
            + ", ".join(f"{p['numInputRows']} rows in "
                        f"{p['durationMs']:.2f} ms"
                        for p in summary["progress"])
            + f"; fusion {summary['fusion']}; predictions equal to this "
            f"process's, padded and unpadded ({clear_rows} clear rows); "
            f"launches {summary['kernel_launches']}")
        out[est] = summary
    return out


def evaluate_commands(dev, data: dict, trained: dict, work: str) -> dict:
    """``evaluate`` of both saved pipelines on ``EVAL_ROWS`` held-out
    flows written as CSV, through the command's entry point in this
    process, with ``--device cuda`` and ``--device cpu``: nb prints the
    CPU's value (float64 likelihoods), svc within 1e-3 of it (one f32
    product in two libraries may flip a near-tie)."""
    import io
    from contextlib import redirect_stdout

    from sntc_tpu_torch.app import main as app_main

    eval_dir = os.path.join(work, "eval9")
    os.makedirs(eval_dir)
    write_raw_csv(data["test"].slice(0, EVAL_ROWS),
                  os.path.join(eval_dir, "day.csv"))
    out = {}
    for est in ("nb", "svc"):
        vals = {}
        for device in (dev.type, "cpu"):
            buf = io.StringIO()
            with redirect_stdout(buf):
                rc = app_main(["evaluate", "--data", eval_dir, "--model",
                               trained[est]["model_dir"], "--device", device])
            line = json.loads(buf.getvalue().strip().splitlines()[-1])
            if rc != 0 or line["rows"] != EVAL_ROWS:
                raise SystemExit(f"{est} evaluate --device {device}: {line}")
            vals[device] = line["macroF1"]
        gap = abs(vals[dev.type] - vals["cpu"])
        if gap > (0.0 if est == "nb" else 1e-3):
            raise SystemExit(f"{est} evaluate: {vals}")
        log(f"{est} evaluate --device {dev.type}: macro-F1 "
            f"{vals[dev.type]} on {EVAL_ROWS} rows; --device cpu "
            f"{vals['cpu']}")
        out[est] = vals
    return out


def regression_data(data: dict) -> dict:
    """Config 4's flows as a regression problem: ``REG_TARGET`` taken out
    of the 78 raw features, its log1p the target (the column is
    lognormal: on its raw scale a few tail rows outweigh the rest), the
    other 77 the features."""
    j = CICIDS2017_FEATURES.index(REG_TARGET)
    out = {}
    for split in ("train", "test"):
        X = raw_features(data[split])
        out[split] = Frame({
            "features": np.ascontiguousarray(np.delete(X, j, axis=1)),
            "label": np.log1p(X[:, j].astype(np.float64)).astype(np.float32),
        })
    return out


def fit_regressors(dev, data: dict) -> dict:
    """The three regressors fitted and evaluated on the card, each with
    every launch count at 0 before its fit and read after its held-out
    predict: ``tree_hist`` once per node group of every level (and
    round), ``forest_traversal`` once for the predict (and once a round
    for GBT's margins).  Each recorded ``tree_hist`` launch held to
    max(HIST_TOL, (n + 1)·u) of its float64 sums; the predict's walk
    taken again and held bitwise against the plain version; RMSE and R²
    of the held-out rows."""
    reg = regression_data(data)
    X_test = torch.from_numpy(reg["test"]["features"]).to(dev)
    y_test = reg["test"]["label"]
    out, kept = {}, {}
    for name, (cls, params) in REGRESSORS.items():
        reset_launches()
        with recording_tree_hist() as calls:
            t0 = time.perf_counter()
            model = cls(device=dev, seed=SEED, **params).fit(reg["train"])
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = model.transform(Frame({"features": X_test}))
        predict_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        walks = 1 + (params["maxIter"] if name == "gbt" else 0)
        if launches != {"forest_traversal": walks, "pad_assemble": 0,
                        "tree_hist": len(calls)} or not calls:
            raise SystemExit(f"{name} regressor launches {launches}, "
                             f"{len(calls)} tree_hist calls recorded, "
                             f"{walks} walks expected")
        err = check_tree_hist({
            f"{name}-reg launch {i}": dict(c, integer=False, hot=True)
            for i, c in enumerate(calls)})
        walk = [X_test, *model._device_forest()]
        depth = model.forest.max_depth
        got = forest_leaf_stats_cuda(*walk, max_depth=depth)
        if not torch.equal(got, forest_leaf_stats_reference(
                *walk, max_depth=depth)):
            raise SystemExit(f"{name} regressor: the walk differs from the "
                             "plain version")
        frame = Frame({"label": y_test, "prediction": pred["prediction"]})
        rmse = RegressionEvaluator(metricName="rmse").evaluate(frame)
        r2 = RegressionEvaluator(metricName="r2").evaluate(frame)
        if not (np.isfinite(rmse) and r2 > REG_R2_FLOOR[name]):
            raise SystemExit(f"{name} regressor: RMSE {rmse}, R² {r2}")
        log(f"{name} regressor {params}: fit {fit_s:.3f} s, predict "
            f"{predict_s * 1e3:.2f} ms over {len(y_test)} rows; held-out "
            f"RMSE {rmse:.6g}, R² {r2:.6f}; launches {launches}; the walk "
            "bitwise equal to the plain version")
        out[name] = {"fit_s": fit_s, "predict_ms": predict_s * 1e3,
                     "rmse": rmse, "r2": r2, "launches": launches,
                     "tree_hist_err": err}
        # the widest launch of the fit, timed after the phase
        big = max(calls, key=lambda c: c["node_idx"].shape[0]
                  * c["n_nodes"] * c["binned_t"].shape[1])
        kept[name] = (dict(big, integer=False, hot=True), walk, depth)
        calls.clear()
    return {"fits": out, "kept": kept}


def measure_phase9(dev, regs: dict, served: dict) -> list:
    """The new shapes of phase 9: ``tree_hist`` on each regressor's
    widest launch (shared variance stats for DT and GBT, times bagging
    counts for RF) beside one ``index_add_`` of the same function;
    ``forest_traversal`` on each regressor's held-out walk (S=3
    regression leaves); ``pad_assemble`` at nb's padded [1 000, 78]
    batch.  Each entry's ``launches`` is its own path's count."""
    out = []
    fits = regs["fits"]
    hist = measure_tree_hist(
        {f"{n}-reg widest launch": regs["kept"][n][0] for n in REGRESSORS},
        max(f["tree_hist_err"] for f in fits.values()), 0)
    for h, n in zip(hist, REGRESSORS):
        h["launches"] = fits[n]["launches"]["tree_hist"]
    out += hist
    for n in REGRESSORS:
        _, walk, depth = regs["kept"][n]
        nbytes, ops = forest_work(*walk, depth=depth)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = ops / FP32_OPS_PER_S * 1e3
        T, M = walk[1].shape
        out.append({
            "name": "forest_traversal", "route": "cuda",
            "source": "sntc_tpu_torch/kernels/csrc/forest_traversal.cu",
            "replaces": "sntc_tpu/kernels/forest.py:92",
            "launches": fits[n]["launches"]["forest_traversal"],
            "max_abs_err": 0.0,
            "ms": time_ms(lambda: forest_leaf_stats_cuda(*walk,
                                                         max_depth=depth)),
            "device_ms": kernel_device_ms(
                lambda: forest_leaf_stats_cuda(*walk, max_depth=depth)),
            "plain_ms": time_ms(lambda: forest_leaf_stats_reference(
                *walk, max_depth=depth)),
            "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None,  # no single PyTorch call walks a tree
            "shape": f"{n}-reg held-out walk: X [{walk[0].shape[0]}, "
                     f"{walk[0].shape[1]}] f32, T={T}, M={M}, S=3; needs "
                     f"{nbytes} B, {ops} comparisons",
        })
    pad = measure_pad_at(dev, NB_SVC_BATCHES[0],
                         served["nb"]["pad_launch_shapes"])
    pad["shape"] = "nb serve: " + pad["shape"]
    out.append(pad)
    return out


# -- phase 10: LogisticRegression's lane fits and tuning/ ---------------------


@contextlib.contextmanager
def lbfgs_runs():
    """Records every LBFGS loop of LogisticRegression's fits while the
    block runs: its lanes (1 for a single fit), iterations of its longest
    lane, ``value_and_grad`` calls and host reads."""
    runs = []
    single, lanes = lr_module.minimize_lbfgs, lr_module.minimize_lbfgs_lanes

    def record(r: LbfgsResult, n: int):
        runs.append({"lanes": n, "iterations": int(torch.as_tensor(
            r.n_iters).max()), "evaluations": r.n_evals,
            "host_syncs": r.n_syncs})

    def single_run(*a, **kw):
        out = single(*a, **kw)
        record(out if isinstance(out, LbfgsResult) else out[0], 1)
        return out

    def lane_run(*a, **kw):
        out = lanes(*a, **kw)
        record(out, int(out.x.shape[0]))
        return out

    lr_module.minimize_lbfgs = single_run
    lr_module.minimize_lbfgs_lanes = lane_run
    try:
        yield runs
    finally:
        lr_module.minimize_lbfgs, lr_module.minimize_lbfgs_lanes = single, lanes


@contextlib.contextmanager
def counted(cls, name: str):
    """Counts the calls of ``cls.name`` while the block runs."""
    calls = []
    orig = getattr(cls, name)

    def spy(obj, *a, **kw):
        calls.append(1)
        return orig(obj, *a, **kw)

    setattr(cls, name, spy)
    try:
        yield calls
    finally:
        setattr(cls, name, orig)


@contextlib.contextmanager
def lane_programs():
    """Records the arguments and end points of LogisticRegression's lane
    programs while the block runs."""
    progs = []
    orig = lr_module._lr_lane_program

    def spy(*a, **kw):
        res = orig(*a, **kw)
        progs.append((a, res.x))
        return res

    lr_module._lr_lane_program = spy
    try:
        yield progs
    finally:
        lr_module._lr_lane_program = orig


def ovr_gradient_errors(prog) -> dict:
    """Each one-vs-rest lane's gradient at its end point, from the lane
    program's product over all lanes and from the lane alone (one lane:
    the single fit's product), its distance from the float64 gradient as
    a share of that gradient's norm."""
    ((xs, ys_l, ws_l), inv_std, l2, pen_l2, _, _), x_end = prog
    n_coef = xs.shape[1]

    def grads(lanes, dtype):
        t = x_end[lanes].to(dtype).requires_grad_(True)
        ws = ws_l.to(dtype)
        with torch.enable_grad():
            loss = lr_module._lr_lane_losses(
                t, xs.to(dtype), ys_l[lanes].to(dtype), ws,
                inv_std[lanes].to(dtype), l2[lanes].to(dtype),
                pen_l2[lanes].to(dtype), torch.sum(ws, dim=1),
                binomial=True, fit_intercept=True, k=2, n_coef=n_coef)
            (g,) = torch.autograd.grad(loss.sum(), t)
        return g.double()

    every = list(range(x_end.shape[0]))
    with full_f32():
        exact = grads(every, torch.float64)
        lanes = grads(every, torch.float32)
        alone = torch.cat([grads([c], torch.float32) for c in every])

    def share(g):
        return ((g - exact).norm(dim=1) / exact.norm(dim=1)).tolist()

    return {"lanes": share(lanes), "alone": share(alone)}


def timed(fn):
    """``fn()`` and its wall-clock seconds, the card drained on both
    sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fit_gaps(a, b) -> dict:
    """How far two fits of one problem lie apart: their iterations, and
    their histories' largest gap over the first ``LANE_PREFIX``
    iterations, over all common iterations and at the end, each as a
    share of the starting objective.  A fit is a model with a summary or
    the summary's ``objectiveHistory`` and ``totalIterations`` as a
    mapping (a side process's record)."""
    def of(f):
        if isinstance(f, dict):
            return f["objectiveHistory"], int(f["totalIterations"])
        return f.summary.objectiveHistory, f.summary.totalIterations

    (ha, ia), (hb, ib) = of(a), of(b)
    ha, hb = np.asarray(ha, np.float64), np.asarray(hb, np.float64)
    n = min(len(ha), len(hb))
    gap = np.abs(ha[:n] - hb[:n]) / abs(hb[0])
    return {
        "iterations": [ia, ib],
        "prefix_gap": float(gap[: LANE_PREFIX + 1].max()),
        "max_gap": float(gap.max()),
        "end_gap": float(abs(ha[-1] - hb[-1]) / abs(hb[0])),
    }


def scaled_features(dev, data: dict) -> tuple:
    """The train and test flows of a bench config through its fitted
    prefix (label indexing, assembly, the scaler withMean) on the card,
    as host columns ``features`` and ``label``."""
    prefix = Pipeline(stages=lbfgs_pipeline(dev, "lr").getStages()[:-1])
    fitted = prefix.fit(data["train"])

    def host(frame):
        out = fitted.transform(frame)
        return Frame({"features": to_host(out["features"]),
                      "label": to_host(out["label"])})

    return host(data["train"]), host(data["test"])


def ovr_lanes(dev, data: dict) -> dict:
    """10a: OneVsRest over LR on config 2's flows takes
    ``_fit_ovr_lanes`` (15 lanes in one loop), held class by class
    against the same binary fits run one by one through the single-fit
    path, on the rows in their order and in ``len(REORDER_SEEDS)`` other
    orders, and on held-out macro-F1.  Beside the lanes' gaps it reports
    the single fits' own spread on reordered rows and, to part the two
    minimizers from the batched products, each class's fit through the
    lane program alone (one lane: the single fit's objective, the lane
    minimizer) against the single fit and against its lane of 15."""
    train, test = scaled_features(dev, data)
    base = LogisticRegression(device=dev, maxIter=LBFGS_ITERS,
                              regParam=LR_REG)
    binary = base.copy({"labelCol": "bin"})
    y = to_host(train["label"]).astype(int)

    def bin_frame(frame, labels, c):
        return frame.with_column("bin", (labels == c).astype(np.float64))

    def one_by_one(frame, labels):
        return [binary.fit(bin_frame(frame, labels, c))
                for c in range(CLASSES)]

    with counted(LogisticRegression, "_fit_ovr_lanes") as calls, \
            lbfgs_runs() as runs, lane_programs() as progs:
        lanes, lanes_s = timed(lambda: OneVsRest(classifier=base).fit(train))
    if len(calls) != 1 or [r["lanes"] for r in runs] != [CLASSES]:
        raise SystemExit(f"OneVsRest(LR) took {len(calls)} lane fits, "
                         f"loops {runs}; expected one of {CLASSES} lanes")
    with lbfgs_runs() as seq_runs:
        single, single_s = timed(lambda: one_by_one(train, y))
    alone = [binary._fit_grid(bin_frame(train, y, c), [{}])[0]
             for c in range(CLASSES)]
    per_class = [{
        "lanes": [fit_gaps(lanes.models[c], single[c])],
        "alone": fit_gaps(alone[c], single[c]),
        "lanes_alone": fit_gaps(lanes.models[c], alone[c]),
        "reordered": [],
    } for c in range(CLASSES)]
    # the lanes and the single fits on the rows in other orders, each
    # against the single fit on the rows in theirs
    for seed in REORDER_SEEDS:
        perm = np.random.default_rng(seed).permutation(train.num_rows)
        shuffled = train.take(perm)
        lanes_p = OneVsRest(classifier=base).fit(shuffled)
        single_p = one_by_one(shuffled, y[perm])
        for c, rec in enumerate(per_class):
            rec["lanes"].append(fit_gaps(lanes_p.models[c], single[c]))
            rec["reordered"].append(fit_gaps(single_p[c], single[c]))
    grad_err = ovr_gradient_errors(progs[0])
    ev = MulticlassClassificationEvaluator(metricName="macroF1")
    f1 = {"lanes": ev.evaluate(lanes.transform(test)),
          "single": ev.evaluate(OneVsRestModel(models=single).transform(test))}
    rec = {
        "train_rows": train.num_rows, "lanes_s": lanes_s,
        "single_s": single_s, "lanes_loop": runs[0],
        "single_host_syncs": sum(r["host_syncs"] for r in seq_runs),
        "single_evaluations": sum(r["evaluations"] for r in seq_runs),
        "reorder_seeds": list(REORDER_SEEDS),
        "per_class": per_class, "gradient_error": grad_err,
        "macroF1": f1,
    }

    def worst(key, kind):
        return max(g[key] for c in per_class
                   for g in (c[kind] if isinstance(c[kind], list)
                             else [c[kind]]))

    kinds = ("lanes", "reordered", "alone", "lanes_alone")

    def worsts(key):
        return " / ".join(f"{worst(key, k):.3g}" for k in kinds)

    log(f"phase 10a OneVsRest(LR) on {train.num_rows} config-2 rows, "
        f"{CLASSES} classes: lanes {lanes_s:.3f} s ({runs[0]['iterations']}"
        f" iterations, {runs[0]['evaluations']} evaluations, "
        f"{runs[0]['host_syncs']} host reads); one by one {single_s:.3f} s "
        f"({rec['single_evaluations']} evaluations, "
        f"{rec['single_host_syncs']} host reads); iterations by class, "
        f"lane / single / alone / single on the rows in "
        f"{len(REORDER_SEEDS)} other orders "
        f"{[c['lanes'][0]['iterations'] + [c['alone']['iterations'][0]] + [g['iterations'][0] for g in c['reordered']] for c in per_class]}; "
        f"worst history gaps (of the start), {' / '.join(kinds)} (lanes "
        f"on {1 + len(REORDER_SEEDS)} orders, the single fit on "
        f"{len(REORDER_SEEDS)}): over {LANE_PREFIX} iterations "
        f"{worsts('prefix_gap')}, over all {worsts('max_gap')}, at the end "
        f"{worsts('end_gap')}; gradient at the lanes' end points against "
        f"float64 (of its norm), lanes / alone: largest "
        f"{max(grad_err['lanes']):.3g} / {max(grad_err['alone']):.3g}, "
        f"median {np.median(grad_err['lanes']):.3g} / "
        f"{np.median(grad_err['alone']):.3g}; held-out macro-F1 "
        f"{f1['lanes']:.6f} lanes, {f1['single']:.6f} one by one")
    bad = [c for c, r in enumerate(per_class)
           if any(g["prefix_gap"] > LANE_PREFIX_TOL
                  or g["max_gap"] > LBFGS_ALL_TOL
                  or g["end_gap"] > LANE_END_TOL for g in r["lanes"])]
    if bad or abs(f1["lanes"] - f1["single"]) > LANE_F1_ATOL:
        rec["failed"] = (f"10a: classes {bad} part beyond the rule, or "
                         f"macro-F1 {f1}: {[per_class[c] for c in bad]}")
    return rec


def best_index_agrees(a, b, larger: bool, tol: float) -> bool:
    """Equal best indices, unless the top two averages lie within
    ``tol`` (then either may win)."""
    if a.bestIndex == b.bestIndex:
        return True
    m = np.sort(np.asarray(a.avgMetrics))
    return (m[-1] - m[-2] if larger else m[1] - m[0]) <= tol


@contextlib.contextmanager
def sequential_tuning():
    """``SNTC_TUNING_BATCH=0`` while the block runs: every cell fits on
    its own."""
    os.environ["SNTC_TUNING_BATCH"] = "0"
    try:
        yield
    finally:
        del os.environ["SNTC_TUNING_BATCH"]


def cv_lanes(dev, data: dict) -> dict:
    """10b: CrossValidator over a bare LR on config 1's scaled flows, the
    3-fold × 6-point grid as ``_fit_grid_folds``' two lane loops (9 L2
    lanes, 9 OWLQN lanes), against the same sweep cell by cell."""
    train, _ = scaled_features(dev, data)

    def run():
        return CrossValidator(
            estimator=LogisticRegression(device=dev, maxIter=LBFGS_ITERS),
            estimatorParamMaps=CV_GRID,
            evaluator=BinaryClassificationEvaluator(), numFolds=CV_FOLDS,
            seed=0,
        ).fit(train)

    with counted(LogisticRegression, "_fit_grid_folds") as calls, \
            lbfgs_runs() as runs:
        bat, bat_s = timed(run)
    lane_loops = sorted(r["lanes"] for r in runs if r["lanes"] > 1)
    half = CV_FOLDS * len(CV_GRID) // 2
    if len(calls) != 1 or lane_loops != [half, half]:
        raise SystemExit(f"10b: {len(calls)} fold sweeps, loops {runs}")
    with sequential_tuning(), lbfgs_runs() as seq_runs:
        seq, seq_s = timed(run)
    if any(r["lanes"] != 1 for r in seq_runs) or \
            len(seq_runs) != CV_FOLDS * len(CV_GRID) + 1:
        raise SystemExit(f"10b sequential: loops {seq_runs}")
    gap = float(np.abs(np.subtract(bat.avgMetrics, seq.avgMetrics)).max())
    rec = {
        "train_rows": train.num_rows, "lanes_s": bat_s, "sequential_s": seq_s,
        "lanes_loops": runs, "lanes_host_syncs": sum(
            r["host_syncs"] for r in runs),
        "sequential_host_syncs": sum(r["host_syncs"] for r in seq_runs),
        "avgMetrics": {"lanes": bat.avgMetrics, "sequential": seq.avgMetrics},
        "bestIndex": [bat.bestIndex, seq.bestIndex], "max_gap": gap,
    }
    log(f"phase 10b CrossValidator(LR) on {train.num_rows} config-1 rows, "
        f"{CV_FOLDS} folds x {len(CV_GRID)} points: lanes {bat_s:.3f} s "
        f"({rec['lanes_host_syncs']} host reads; loops "
        f"{[(r['lanes'], r['iterations'], r['host_syncs']) for r in runs]}"
        f"), cell by cell {seq_s:.3f} s ({rec['sequential_host_syncs']} host "
        f"reads in {len(seq_runs)} fits); areaUnderROC by point "
        f"{[round(m, 6) for m in bat.avgMetrics]}, at most {gap:.3g} from "
        f"the cells'; best {bat.bestIndex} / {seq.bestIndex}")
    if gap > CV_METRIC_ATOL or not best_index_agrees(
            bat, seq, True, CV_METRIC_ATOL):
        rec["failed"] = f"10b: lanes and cells part: {rec}"
    return rec


def pipeline_cv(dev, frame: Frame) -> dict:
    """10c: CrossValidator over the whole config-2 Pipeline with a
    head-only grid: per fold the prefix fits once (and once for the
    refit), the head's grid runs through ``_fit_grid``; against the same
    search with ``SNTC_TUNING_BATCH=0``."""

    def run():
        return CrossValidator(
            estimator=lbfgs_pipeline(dev, "lr"), estimatorParamMaps=PIPE_GRID,
            evaluator=MulticlassClassificationEvaluator(metricName="macroF1"),
            numFolds=PIPE_FOLDS, seed=0,
        ).fit(frame)

    with counted(StandardScaler, "_fit") as prefix_fits, \
            counted(LogisticRegression, "_fit_grid") as grid_fits, \
            lbfgs_runs() as runs:
        bat, bat_s = timed(run)
    if len(prefix_fits) != PIPE_FOLDS + 1 or len(grid_fits) != PIPE_FOLDS:
        raise SystemExit(f"10c: the prefix fitted {len(prefix_fits)} times, "
                         f"the head's grid {len(grid_fits)} times")
    with sequential_tuning(), lbfgs_runs() as seq_runs:
        seq, seq_s = timed(run)
    gap = float(np.abs(np.subtract(bat.avgMetrics, seq.avgMetrics)).max())
    rec = {
        "rows": frame.num_rows, "lanes_s": bat_s, "sequential_s": seq_s,
        "prefix_fits": len(prefix_fits), "grid_fits": len(grid_fits),
        "lanes_host_syncs": sum(r["host_syncs"] for r in runs),
        "sequential_host_syncs": sum(r["host_syncs"] for r in seq_runs),
        "avgMetrics": {"lanes": bat.avgMetrics, "sequential": seq.avgMetrics},
        "bestIndex": [bat.bestIndex, seq.bestIndex], "max_gap": gap,
    }
    log(f"phase 10c CrossValidator(config-2 Pipeline) on {frame.num_rows} "
        f"rows, {PIPE_FOLDS} folds x {len(PIPE_GRID)} points: prefix fitted "
        f"{len(prefix_fits)} times, head grid {len(grid_fits)} lane fits; "
        f"lanes {bat_s:.3f} s ({rec['lanes_host_syncs']} host reads), one "
        f"by one {seq_s:.3f} s ({rec['sequential_host_syncs']} host reads); "
        f"macro-F1 by point {[round(m, 6) for m in bat.avgMetrics]}, at most "
        f"{gap:.3g} apart; best {bat.bestIndex} / {seq.bestIndex}")
    if gap > PIPE_METRIC_ATOL or bat.bestIndex != seq.bestIndex:
        rec["failed"] = f"10c: lanes and one by one part: {rec}"
    return rec


def tvs_start(dev, frame: Frame, test: Frame, work: str,
              pool: ThreadPoolExecutor) -> dict:
    """10d: TrainValidationSplit over 10c's pipeline and rows; the model
    round-trips ``save_model``/``load_model`` with its metrics, best index
    and grid; its best model, saved, serves through ``python -m
    sntc_tpu_torch serve`` in the default form over ``TUNED_BATCHES``
    (the 1 000-row batch pads: ``pad_assemble``), in ``pool``'s thread,
    with this process's ``SNTC_SERVE_HOST_ROWS``; :func:`tvs_check` then
    holds every prediction equal to this process's transform on the
    card."""
    tvs, tvs_s = timed(lambda: TrainValidationSplit(
        estimator=lbfgs_pipeline(dev, "lr"), estimatorParamMaps=PIPE_GRID,
        evaluator=MulticlassClassificationEvaluator(metricName="macroF1"),
        trainRatio=TVS_RATIO, seed=0,
    ).fit(frame))
    loaded = load_model(save_model(tvs, os.path.join(work, "tvs")),
                        device=dev)
    if loaded.validationMetrics != tvs.validationMetrics or \
            loaded.bestIndex != tvs.bestIndex or \
            loaded.estimatorParamMaps != PIPE_GRID:
        raise SystemExit("10d: the saved TrainValidationSplitModel differs")
    model_dir = save_model(tvs.bestModel, os.path.join(work, "best"))
    traffic = test.slice(0, sum(TUNED_BATCHES)).drop("Label")
    watch = os.path.join(work, "in10")
    os.makedirs(watch)
    batches, start = [], 0
    for i, n in enumerate(TUNED_BATCHES):
        b = traffic.slice(start, start + n)
        write_raw_csv(b, os.path.join(watch, f"part_{i:04d}.csv"))
        batches.append(b)
        start += n
    out_dir = os.path.join(work, "out10")
    served = pool.submit(serve_command, model_dir, watch, out_dir,
                         os.path.join(work, "ckpt10"), dev, [], 1,
                         dict(os.environ))
    return {"tvs": tvs, "tvs_s": tvs_s, "rows": frame.num_rows,
            "model_dir": model_dir, "batches": batches, "out_dir": out_dir,
            "served": served}


def tvs_check(dev, st: dict) -> dict:
    """10d's serve (``st``, from :func:`tvs_start`), once done: its
    launches, and its predictions against this process's transform on
    the card."""
    import pyarrow.csv as pacsv

    tvs, tvs_s, out_dir = st["tvs"], st["tvs_s"], st["out_dir"]
    summary = st["served"].result()
    launches = summary["kernel_launches"]
    want_pad = sum(bucket_rows_for(n, BUCKET_FLOOR) != n
                   for n in TUNED_BATCHES)
    if summary["rows"] != sum(TUNED_BATCHES) or \
            launches["pad_assemble"] != want_pad or want_pad < 1:
        raise SystemExit(f"10d serve: {summary['rows']} rows, launches "
                         f"{launches}")
    in_process, _, _ = serving_form(load_model(st["model_dir"], device=dev))
    for i, b in enumerate(st["batches"]):
        t = pacsv.read_csv(os.path.join(out_dir, f"batch_{i:06d}.csv"))
        if not np.array_equal(t.column("prediction").to_numpy(),
                              to_host(in_process.transform(b)["prediction"])):
            raise SystemExit(f"10d batch {i}: the serve command's "
                             "predictions differ from this process's")
    log(f"phase 10d TrainValidationSplit (trainRatio {TVS_RATIO}) on "
        f"{st['rows']} rows: {tvs_s:.3f} s, macro-F1 by point "
        f"{[round(m, 6) for m in tvs.validationMetrics]}, best "
        f"{tvs.bestIndex}; saved and loaded equal; best model served "
        f"(defaults): {summary['batches']} batches, {summary['rows']} rows "
        f"in {summary['seconds']:.3f} s, fusion {summary['fusion']}, "
        f"launches {launches}; predictions equal to this process's")
    return {"tvs_s": tvs_s, "validationMetrics": tvs.validationMetrics,
            "bestIndex": tvs.bestIndex, "serve": summary}


def lane_fits(dev, data2: dict, data1: dict, work: str):
    """Phase 10, 10a-10d; its ``pad_assemble`` entry at 10d's padded
    [1 000, 78] batch, with 10d's serve count.  A tolerance missed in
    10a-10c fails the phase after all four have run."""
    frame = data2["train"].slice(0, PIPE_ROWS)
    # the tuned LR model served on the card, in the command and in this
    # process alike: the host-serve crossover is pinned off, as bench
    # config 6 pins it; the command's process runs beside 10a-10c
    with ThreadPoolExecutor(1) as pool:
        with environ(SNTC_SERVE_HOST_ROWS=0):
            tvs = tvs_start(dev, frame, data2["test"], work, pool)
        out = {"ovr": ovr_lanes(dev, data2), "cv": cv_lanes(dev, data1)}
        out["pipeline_cv"] = pipeline_cv(dev, frame)
        with environ(SNTC_SERVE_HOST_ROWS=0):
            out["tvs"] = tvs_check(dev, tvs)
    failed = [out[k]["failed"] for k in ("ovr", "cv", "pipeline_cv")
              if "failed" in out[k]]
    if failed:
        raise SystemExit("\n".join(failed))
    pad = measure_pad_at(dev, TUNED_BATCHES[0],
                         out["tvs"]["serve"]["pad_launch_shapes"])
    pad["shape"] = "tuned best model's serve: " + pad["shape"]
    out["pad"] = pad
    return out


# -- phase 11: the serve command's failure handling --------------------------


def env_with(**kw) -> dict:
    """This process's environment with ``kw`` set (SNTC_FAULTS cleared
    unless given); ``faulthandler`` is on, so a SIGABRT dumps every
    thread's stack (``finished`` sends one to a process that hangs)."""
    env = dict(os.environ, SNTC_FAULTS="", PYTHONFAULTHANDLER="1")
    env.update(kw)
    return env


def serve_in_process(model_dir: str, watch: str, out: str, ckpt: str, dev,
                     faults: str = "") -> dict:
    """``serve --once`` through the command's entry point in this process
    (no process start to pay), under ``SNTC_FAULTS=faults``, every launch
    count set to 0 just before; its summary line."""
    import io

    from sntc_tpu_torch.app import main as serve_main
    from sntc_tpu_torch.resilience import clear

    argv = serve_args(model_dir, watch, out, ckpt, dev,
                      FAULT_FILES_PER_BATCH)[3:] + ["--once"]
    before = os.environ.get("SNTC_FAULTS")
    os.environ["SNTC_FAULTS"] = faults
    buf = io.StringIO()
    reset_launches()
    try:
        with contextlib.redirect_stdout(buf):
            rc = serve_main(argv)
    finally:
        if before is None:
            del os.environ["SNTC_FAULTS"]
        else:
            os.environ["SNTC_FAULTS"] = before
        clear()
    if rc != 0:
        raise SystemExit(f"phase 11: serve {faults or '(no faults)'} "
                         f"exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def commit_count(ckpt: str) -> int:
    d = os.path.join(ckpt, "commits")
    return len([n for n in os.listdir(d) if n.endswith(".json")]) \
        if os.path.isdir(d) else 0


def wait_for(pred, what: str, proc, limit: float = FAULT_WAIT_S) -> None:
    """Poll ``pred`` until it holds; fail if ``proc`` exits first or the
    limit passes."""
    deadline = time.time() + limit
    while not pred():
        if proc.poll() is not None:
            raise SystemExit(f"phase 11: serve exited ({proc.returncode}) "
                             f"before {what}:\n{proc.stderr.read()}")
        if time.time() > deadline:
            proc.kill()
            raise SystemExit(f"phase 11: no {what} within {limit} s")
        time.sleep(0.1)


def publish_csv(frame: Frame, path: str) -> None:
    """Write a CSV beside ``path`` and rename it in: the serving loop
    never lists a half-written file."""
    tmp = path + ".part"
    write_raw_csv(frame, tmp)
    os.replace(tmp, path)


def ragged_csv(columns: int, path: str, like: Frame) -> None:
    """A flow file with one ragged line (one field too many): the read
    fails on the host."""
    publish_csv(like, path)
    with open(path, "a") as f:
        f.write("1," * columns + "1\n")


def split_launches(s: dict, clean: dict, splits: int) -> None:
    """An OOM split's extra launches: each split of a dispatch (the
    injected fault fires before its launch) adds one dispatch, so one
    ``pad_assemble`` and one ``forest_traversal`` launch."""
    want = {k: v + (splits if k != "tree_hist" else 0)
            for k, v in clean.items()}
    if s != want:
        raise SystemExit(f"phase 11: launches {s} after {splits} splits, "
                         f"expected {want}")


def real_oom(dev, model_dir: str, batch: Frame) -> dict:
    """A real CUDA OOM, in this process: cap the caching allocator from
    one clean dispatch's peak so that the full batch fails and its halves
    fit, then serve it through a ``BatchPredictor`` with the fault
    domain.  The predictions must equal the uncapped dispatch's and the
    split's error must be CUDA's OOM."""
    from sntc_tpu_torch.resilience import DeviceFaultDomain, recent_events

    # the allocator's calls take a device with its index
    dev = torch.device(dev.type, torch.cuda.current_device())
    model = serving_form(load_model(model_dir, device=dev), "label", True)[0]
    dom = DeviceFaultDomain()
    pred = BatchPredictor(model, bucket_rows=BUCKET_FLOOR, device=dev,
                          device_domain=dom)

    def served(frame: Frame) -> dict:
        # host copies only: the served frame also holds the padded
        # features on the card, which would count against the cap
        out = pred.predict_frame(frame)
        return {c: to_host(out[c])
                for c in ("prediction", "predictedLabel")}

    served(batch)  # warm: the lazy CUDA loading
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    clean = served(batch)
    torch.cuda.synchronize()
    clean_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_reserved(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    cap = base + OOM_CAP_SHARE * (peak - base)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    torch.cuda.set_per_process_memory_fraction(cap / total, dev)
    try:
        t0 = time.perf_counter()
        split = served(batch)
        torch.cuda.synchronize()
        split_ms = (time.perf_counter() - t0) * 1e3
        split_peak = torch.cuda.max_memory_reserved(dev)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        torch.cuda.empty_cache()
    launches = dict(LAUNCHES)
    events = recent_events(event="device_oom_split")
    stats = dom.stats()
    if stats["oom_splits"] < 1 or not events:
        raise SystemExit(f"phase 11: no OOM split under a cap of "
                         f"{cap / 2**20:.1f} MiB (peak {peak / 2**20:.1f})")
    if "CUDA out of memory" not in events[-1]["error"]:
        raise SystemExit(f"phase 11: the split's error {events[-1]}")
    for c in ("prediction", "predictedLabel"):
        if not np.array_equal(split[c], clean[c]):
            raise SystemExit(f"phase 11: {c} after a real OOM split "
                             "differs from the uncapped dispatch")
    if launches["pad_assemble"] < 2 or launches["forest_traversal"] < 2:
        raise SystemExit(f"phase 11: real OOM split launches {launches}")
    return {"splits": stats["oom_splits"], "state": stats["state"],
            "error": events[-1]["error"][:160],
            "launches": launches, "base_mib": base / 2**20,
            "peak_mib": peak / 2**20, "cap_mib": cap / 2**20,
            "split_peak_mib": split_peak / 2**20,
            "clean_dispatch_ms": clean_ms, "split_dispatch_ms": split_ms}


def transient_device_lost(dev, model_dir: str, watch: str, work: str,
                          clean: dict) -> dict:
    """Injected ``device_lost`` on 2 dispatches (under ``degrade_after``
    3), in this process, through the supervised loop of the default
    form: every batch commits on the card, nothing is quarantined."""
    from sntc_tpu_torch.resilience import (
        DeviceFaultDomain,
        QuerySupervisor,
        RetryPolicy,
        arm,
        clear,
        default_breakers,
    )
    from sntc_tpu_torch.serve import FileStreamSource, StreamingQuery

    model, _, out_cols = serving_form(load_model(model_dir, device=dev),
                                      "label", True)
    dom = DeviceFaultDomain()
    source = FileStreamSource(watch, prefetch_batches=2, read_workers=4)
    out = os.path.join(work, "out11_lost_transient")
    q = StreamingQuery(
        BatchPredictor(model, bucket_rows=BUCKET_FLOOR, device=dev,
                       device_domain=dom),
        source, CsvDirSink(out, columns=out_cols),
        os.path.join(work, "ckpt11_lost_transient"),
        max_batch_offsets=FAULT_FILES_PER_BATCH, device=dev,
        breakers=default_breakers(), max_batch_failures=3,
        retry_policy=RetryPolicy(max_attempts=2, base_delay_s=0.2,
                                 jitter=0.1))
    sup = QuerySupervisor(q)
    arm("device.dispatch", "device_lost", times=2)
    reset_launches()
    deadline = time.time() + FAULT_WAIT_S
    try:
        while q.last_committed() < len(clean) - 1 \
                and time.time() < deadline:
            if sup.tick() == 0:
                time.sleep(0.01)
    finally:
        clear()
        sup.close()
        q.stop()
        source.close()
    launches = dict(LAUNCHES)
    stats = dom.stats()
    if sink_files(out) != clean or q.quarantined_batches \
            or stats["faults"] != {"device_lost": 2} or dom.failed:
        raise SystemExit(f"phase 11: transient device_lost: "
                         f"{q.last_committed() + 1} batches, quarantined "
                         f"{q.quarantined_batches}, domain {stats}")
    want = {"forest_traversal": len(clean), "pad_assemble": len(clean),
            "tree_hist": 0}
    check_launches("transient device_lost", launches, want)
    return {"faults": stats["faults"], "launches": launches}


def check_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise SystemExit(f"phase 11 {what}: launches {got}, expected {want}")


def corrupt_file_drain(dev, model_dir: str, traffic: Frame, work: str,
                       clean: dict) -> dict:
    """The supervised loop at the default flags, on the card: two good
    batches, then a ragged file alone in a batch, then two more good
    batches.  The ragged batch is dead-lettered after 3 rounds and
    committed, the stream moves past it, the good batches are
    byte-identical to the clean run's, and SIGTERM drains: exit 0,
    ``drain_marker.json``, ``"drained": true``."""
    watch = os.path.join(work, "in11_corrupt")
    out = os.path.join(work, "out11_corrupt")
    ckpt = os.path.join(work, "ckpt11_corrupt")
    health = os.path.join(work, "health11.json")
    os.makedirs(watch)
    rows = FAULT_FILE_ROWS

    def publish(i):
        publish_csv(traffic.slice(i * rows, (i + 1) * rows),
                    os.path.join(watch, f"part_{i:04d}.csv"))

    for i in range(FAULT_FILES // 2):
        publish(i)
    cmd = serve_args(model_dir, watch, out, ckpt, dev,
                     FAULT_FILES_PER_BATCH) + [
        "--poll-interval", "0.2", "--health-json", health]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env_with(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        half = FAULT_FILES // 2 // FAULT_FILES_PER_BATCH
        wait_for(lambda: commit_count(ckpt) >= half, "the first batches",
                 proc)
        # sorts after part_0003.csv and before part_0004.csv
        ragged_csv(len(traffic.columns),
                   os.path.join(watch, f"part_{FAULT_FILES // 2 - 1:04d}"
                                "_x.csv"), traffic.slice(0, 100))
        wait_for(lambda: commit_count(ckpt) >= half + 1,
                 "the quarantine", proc)
        # written beside, renamed in together: a poll tick rarely lists
        # the later files half-published (csv_rows holds either way)
        later = range(FAULT_FILES // 2, FAULT_FILES)
        for i in later:
            write_raw_csv(traffic.slice(i * rows, (i + 1) * rows),
                          os.path.join(watch, f"part_{i:04d}.csv.part"))
        for i in later:
            os.replace(os.path.join(watch, f"part_{i:04d}.csv.part"),
                       os.path.join(watch, f"part_{i:04d}.csv"))
        wait_for(lambda: commit_count(ckpt) >= len(clean) + 1,
                 "the last batches", proc)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=FAULT_WAIT_S)
    except BaseException:
        proc.kill()
        raise
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"phase 11: SIGTERM drain exited "
                         f"{proc.returncode}:\n{stderr}")
    last = json.loads(stdout.strip().splitlines()[-1])
    marker = json.load(open(os.path.join(ckpt, "drain_marker.json")))
    dl = os.path.join(ckpt, "dead_letter")
    records = [json.loads(x) for x in open(os.path.join(
        dl, "dead_letter.jsonl"))]
    q_id = half
    if not last["drained"] or last["batches"] != len(clean) + 1 \
            or marker["reason"] != "SIGTERM" \
            or marker["last_committed"] != len(clean):
        raise SystemExit(f"phase 11: drain {last}, marker {marker}")
    if [r["batch_id"] for r in records] != [q_id] \
            or records[0]["failures"] != 3 \
            or records[0]["rows_file"] is not None \
            or "_x.csv" not in records[0]["error"]:
        raise SystemExit(f"phase 11: dead letters {records}")
    files = sink_files(out)
    if f"batch_{q_id:06d}.csv" in files:
        raise SystemExit("phase 11: the dead-lettered batch has a file")
    # the good rows, in order, are byte-identical to the clean run's
    # (each row's prediction is bitwise independent of its batch); when
    # no poll tick listed the later files between their renames, each
    # batch file is too
    same_files = files == {
        f"batch_{(i if i < q_id else i + 1):06d}.csv": clean[name]
        for i, name in enumerate(sorted(clean))}
    if csv_rows(files) != csv_rows(clean):
        raise SystemExit("phase 11: the rows served around the dead "
                         "letter differ from the clean run's")
    status = json.load(open(health))
    return {"quarantined": q_id, "rounds": records[0]["failures"],
            "batch_files_identical": same_files,
            "health": last["health"], "drained": last["drained"],
            "device": status.get("device", {}).get("state"),
            "seconds": seconds}


def csv_rows(files: dict) -> bytes:
    """The data lines of batch files in batch order (headers dropped)."""
    return b"".join(files[name].split(b"\n", 1)[1]
                    for name in sorted(files))


def persistent_device_lost(dev, model_dir: str, watch: str, work: str,
                           clean: dict, failed=None) -> dict:
    """Every dispatch fails with ``device_lost``: the supervised loop
    stops after 3 rounds, non-zero, the batch's intent in the WAL and no
    commit, the model UNHEALTHY (:func:`device_lost_process`, or its
    result ``failed``); a clean restart, in this process, replays it into
    files identical to the clean run's."""
    out = os.path.join(work, "out11_lost")
    ckpt = os.path.join(work, "ckpt11_lost")
    proc = failed or device_lost_process(dev, model_dir, watch, work)
    restart = serve_in_process(model_dir, watch, out, ckpt, dev)
    if sink_files(out) != clean or restart["batches"] != len(clean):
        raise SystemExit(f"phase 11: the restart after a failed device "
                         f"served {restart['batches']} batches, files "
                         "differ from the clean run's")
    return {"rc": proc.returncode,
            "last_line": json.loads(proc.stdout.strip().splitlines()[-1]),
            "restart_batches": restart["batches"]}


def device_lost_process(dev, model_dir: str, watch: str, work: str):
    """The serving process of :func:`persistent_device_lost` under
    ``device_lost`` on every dispatch, and its checks; the finished
    process."""
    out = os.path.join(work, "out11_lost")
    ckpt = os.path.join(work, "ckpt11_lost")
    health = os.path.join(work, "health11_lost.json")
    cmd = serve_args(model_dir, watch, out, ckpt, dev,
                     FAULT_FILES_PER_BATCH) + [
        "--poll-interval", "0.2", "--health-json", health]
    proc = subprocess.run(
        cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
        env=env_with(SNTC_FAULTS="device.dispatch:device_lost"))
    status = json.load(open(health))
    if proc.returncode == 0 or commit_count(ckpt) \
            or not os.path.exists(os.path.join(ckpt, "offsets", "0.json")) \
            or status["health"]["components"]["model"]["state"] \
            != "UNHEALTHY" or status["device"]["state"] != "DEVICE_FAILED" \
            or status["device"]["faults"] != {"device_lost": 3}:
        raise SystemExit(f"phase 11: persistent device_lost exited "
                         f"{proc.returncode}, {commit_count(ckpt)} commits, "
                         f"status {status}:\n{proc.stderr[-2000:]}")
    return proc


def failure_paths(dev, work: str) -> dict:
    """Phase 11: the serve command's default failure handling, on the
    config-3 model of phase 3, over FAULT_FILES CSV files of
    FAULT_FILE_ROWS rows, FAULT_FILES_PER_BATCH a batch (each batch of
    60 000 rows padded to 65 536): a clean run; an injected OOM schedule;
    a real CUDA OOM; a ragged file under the supervised loop, then its
    SIGTERM drain; a transient and a persistent ``device_lost``."""
    t_phase = time.perf_counter()
    model_dir = os.path.join(work, "model")
    n = FAULT_FILES * FAULT_FILE_ROWS
    traffic = clean_flows(generate_frame(n + 2000, seed=SEED + 11))
    traffic = traffic.slice(0, n).drop("Label")
    watch = os.path.join(work, "in11")
    os.makedirs(watch)
    for i in range(FAULT_FILES):
        publish_csv(traffic.slice(i * FAULT_FILE_ROWS,
                                  (i + 1) * FAULT_FILE_ROWS),
                    os.path.join(watch, f"part_{i:04d}.csv"))
    batches = FAULT_FILES // FAULT_FILES_PER_BATCH

    clean_out = os.path.join(work, "out11_clean")
    clean_s = serve_in_process(model_dir, watch, clean_out,
                               os.path.join(work, "ckpt11_clean"), dev)
    clean = sink_files(clean_out)
    check_launches("clean run", clean_s["kernel_launches"],
                   {"forest_traversal": batches, "pad_assemble": batches,
                    "tree_hist": 0})
    if len(clean) != batches or clean_s["quarantined"]:
        raise SystemExit(f"phase 11 clean run: {clean_s['batches']} "
                         "batches")
    clean_ms = [p["dispatchMs"] for p in clean_s["progress"]]
    # the SIGTERM drain and the failing device's serve are processes of
    # their own: they run beside the in-process steps below (whose launch
    # counts are this process's)
    pool = ThreadPoolExecutor(2)
    drain = pool.submit(corrupt_file_drain, dev, model_dir, traffic, work,
                        clean)
    lost_proc = pool.submit(device_lost_process, dev, model_dir, watch,
                            work)

    oom_out = os.path.join(work, "out11_oom")
    oom_s = serve_in_process(model_dir, watch, oom_out,
                             os.path.join(work, "ckpt11_oom"), dev,
                             OOM_FAULTS)
    splits = oom_s["device_faults"]["oom_splits"]
    if sink_files(oom_out) != clean or splits < 1 or oom_s["quarantined"] \
            or oom_s["device_faults"]["faults"]:
        raise SystemExit(f"phase 11 injected OOM: {splits} splits, "
                         f"quarantined {oom_s['quarantined']}, domain "
                         f"{oom_s['device_faults']}; files equal: "
                         f"{sink_files(oom_out) == clean}")
    split_launches(oom_s["kernel_launches"], clean_s["kernel_launches"],
                   splits)
    log(f"phase 11 injected OOM: {splits} splits, launches "
        f"{oom_s['kernel_launches']} against {clean_s['kernel_launches']} "
        "clean, batch files identical")

    first = Frame.concat_all([
        load_csv(os.path.join(watch, f"part_{i:04d}.csv"))
        for i in range(FAULT_FILES_PER_BATCH)])
    real = real_oom(dev, model_dir, first)
    log(f"phase 11 real OOM: {real}")
    lost = transient_device_lost(dev, model_dir, watch, work, clean)
    log(f"phase 11 transient device_lost: {lost}")
    corrupt = drain.result()
    pool.shutdown()
    log(f"phase 11 ragged file and drain: {corrupt}")
    stopped = persistent_device_lost(dev, model_dir, watch, work, clean,
                                     lost_proc.result())
    log(f"phase 11 persistent device_lost: {stopped}")
    return {
        "batches": batches, "batch_rows": FAULT_FILES_PER_BATCH
        * FAULT_FILE_ROWS,
        "injected_oom": {"faults": OOM_FAULTS, "splits": splits,
                         "launches": oom_s["kernel_launches"],
                         "clean_launches": clean_s["kernel_launches"],
                         "dispatch_ms": [p["dispatchMs"]
                                         for p in oom_s["progress"]],
                         "clean_dispatch_ms": clean_ms},
        "real_oom": real, "transient_device_lost": lost,
        "corrupt_file": corrupt, "persistent_device_lost": stopped,
        "seconds": time.perf_counter() - t_phase,
    }


# -- phase 12: the data plane (row admission, the storage plane) ------------


def dp_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise SystemExit(f"phase 12 {what}: launches {got}, expected {want}")


def ragged_lines(columns: int) -> list:
    """The hand-made ragged lines of phase 12: each has the wrong field
    count (one too many, one too few, three, one, 80)."""
    return ["1," * columns + "1", "1," * (columns - 2) + "1", "not,a,flow",
            "garbage", ",".join(["2"] * 80)]


def bad_rows(frame: Frame) -> np.ndarray:
    """Rows with a non-finite feature (the contract's poison)."""
    X = np.stack([np.asarray(frame[c], np.float64)
                  for c in CICIDS2017_FEATURES], axis=1)
    return ~np.isfinite(X).all(axis=1)


def dp_streams(work: str) -> dict:
    """Phase 12's inputs: DP_FILES uncleaned files of DP_FILE_ROWS rows
    and one more holding the ragged lines (2 files a batch), the same
    rows pre-cleaned (``clean_flows`` drop, the ragged lines gone) and
    zero-filled (``handle_invalid="zero"``); one file of DP_EXACT_ROWS
    uncleaned rows and its pre-cleaned copy; ``seconds`` is what that
    took."""
    t0 = time.perf_counter()
    n = (DP_FILES + 1) * DP_FILE_ROWS
    traffic = generate_frame(n, seed=SEED + 12).drop("Label")
    dirs = {k: os.path.join(work, f"in12_{k}")
            for k in ("raw", "clean", "zero", "exact", "exact_clean")}
    for d in dirs.values():
        os.makedirs(d)
    parts = [(f"part_{i:04d}.csv",
              traffic.slice(i * DP_FILE_ROWS, (i + 1) * DP_FILE_ROWS))
             for i in range(DP_FILES + 1)]

    def write(item):  # pyarrow's writer releases the GIL: 4 at once
        name, part = item
        write_raw_csv(part, os.path.join(dirs["raw"], name))
        write_raw_csv(clean_flows(part), os.path.join(dirs["clean"], name))
        write_raw_csv(clean_flows(part, handle_invalid="zero"),
                      os.path.join(dirs["zero"], name))

    with ThreadPoolExecutor(4) as pool:
        list(pool.map(write, parts))
    name, part = parts[-1]
    path = os.path.join(dirs["raw"], name)
    lines = open(path).read().splitlines(True)
    lines_ragged = ragged_lines(len(traffic.columns))
    step = DP_FILE_ROWS // (len(lines_ragged) + 1)
    for k, text in reversed(list(enumerate(lines_ragged))):
        at = 1 + (k + 1) * step  # after the header and (k+1)·step rows
        lines.insert(at, text + "\n")
    with open(path, "w") as f:
        f.writelines(lines)
    ragged = sorted((name, 1 + (k + 1) * step + k + 1)
                    for k in range(len(lines_ragged)))
    exact = generate_frame(DP_EXACT_ROWS, seed=SEED + 13).drop("Label")
    write_raw_csv(exact, os.path.join(dirs["exact"], "part_0000.csv"))
    write_raw_csv(clean_flows(exact),
                  os.path.join(dirs["exact_clean"], "part_0000.csv"))
    # the poison rows by batch: (batch id, row in the batch)
    poison = []
    for b in range(0, len(parts), DP_FILES_PER_BATCH):
        rows = Frame.concat_all([p for _, p in
                                 parts[b:b + DP_FILES_PER_BATCH]])
        poison += [(b // DP_FILES_PER_BATCH, int(r))
                   for r in np.flatnonzero(bad_rows(rows))]
    exact_poison = int(bad_rows(exact).sum())
    if not exact_poison:
        raise SystemExit("phase 12: the exact-bucket file has no poison row")
    return {"dirs": dirs, "ragged": ragged, "poison": sorted(poison),
            "batches": -(-len(parts) // DP_FILES_PER_BATCH),
            "exact_poison": exact_poison,
            "seconds": time.perf_counter() - t0}


def row_dead_letters(ckpt: str) -> list:
    out = []
    d = os.path.join(ckpt, "dead_letter_rows")
    for name in sorted(os.listdir(d)) if os.path.isdir(d) else []:
        out += [json.loads(x) for x in open(os.path.join(d, name))]
    return out


def dp_serves(model_dir: str, dev, work: str, jobs: list) -> dict:
    """Each ``(tag, watch, extra, files_per_batch)`` of ``jobs`` as a
    ``serve --once`` process of its own (its launch counts from 0), all
    started together so that their start-ups overlap; tag -> (summary
    line, batch files, checkpoint dir)."""
    procs, spawned = {}, {}
    try:
        for tag, watch, extra, files_per_batch in jobs:
            out = os.path.join(work, f"out12_{tag}")
            ckpt = os.path.join(work, f"ckpt12_{tag}")
            cmd = serve_args(model_dir, watch, out, ckpt, dev,
                             files_per_batch) + ["--once", *extra]
            spawned[tag] = time.time()
            procs[tag] = (subprocess.Popen(
                cmd, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True), out, ckpt)
        done = {}
        for tag, (proc, out, ckpt) in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise SystemExit(f"phase 12 {tag} serve failed "
                                 f"({proc.returncode}):\n{stderr}")
            summary = json.loads(stdout.strip().splitlines()[-1])
            # the exit is read in turn: a later process's may be late
            summary["spawned_at"], summary["exited_at"] = (spawned[tag],
                                                           time.time())
            done[tag] = (summary, sink_files(out), ckpt)
        return done
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def pad_shapes_of(summary: dict) -> dict:
    """The ``pad_launch_shapes`` a serve run should report: one launch of
    the contract's float32 [rows, 78] block to its bucket a batch."""
    want: dict = {}
    for p in summary["progress"]:
        n = p["numInputRows"]
        key = pad_launch_shape(n, len(CICIDS2017_FEATURES), torch.float32,
                               bucket_rows_for(n, BUCKET_FLOOR))
        want[key] = want.get(key, 0) + 1
    return want


def admission_runs(dev, model_dir: str, streams: dict, work: str) -> dict:
    """(a) salvage against the pre-cleaned rows, (b) the exact bucket,
    (c) permissive against the zero-filled rows: the six serves side by
    side, then their checks."""
    dirs, batches = streams["dirs"], streams["batches"]
    want = {"forest_traversal": batches, "pad_assemble": batches,
            "tree_hist": 0}
    t0 = time.perf_counter()
    served = dp_serves(model_dir, dev, work, [
        ("clean", dirs["clean"], [], DP_FILES_PER_BATCH),
        ("salvage", dirs["raw"], ["--row-policy", "salvage"],
         DP_FILES_PER_BATCH),
        ("exact_clean", dirs["exact_clean"], [], 1),
        ("exact", dirs["exact"], ["--row-policy", "salvage"], 1),
        ("zero", dirs["zero"], [], DP_FILES_PER_BATCH),
        ("permissive", dirs["raw"], ["--row-policy", "permissive"],
         DP_FILES_PER_BATCH)])
    log(f"phase 12: six serves side by side in "
        f"{time.perf_counter() - t0:.1f} s with their process start-ups")
    ref_s, ref, _ = served["clean"]
    sal_s, sal, sal_ckpt = served["salvage"]
    if sal != ref or len(sal) != batches or sal_s["quarantined"]:
        raise SystemExit(f"phase 12 salvage: {len(sal)} batch files, "
                         f"identical to the pre-cleaned run's: {sal == ref}")
    dp_launches("salvage", sal_s["kernel_launches"], want)
    if sal_s["pad_launch_shapes"] != pad_shapes_of(sal_s):
        raise SystemExit(f"phase 12 salvage: pad_assemble launched at "
                         f"{sal_s['pad_launch_shapes']}, expected "
                         f"{pad_shapes_of(sal_s)}")
    records = row_dead_letters(sal_ckpt)
    got_poison = sorted((r["batch_id"], r["row"]) for r in records
                        if r["reason"] == "non_finite")
    got_ragged = sorted((os.path.basename(r["file"]), r["line"])
                        for r in records if r["reason"] == "ragged_row")
    if got_poison != streams["poison"] or got_ragged != streams["ragged"] \
            or len(records) != len(got_poison) + len(got_ragged):
        raise SystemExit(f"phase 12 row dead letters: {len(got_poison)} "
                         f"non-finite rows (expected "
                         f"{len(streams['poison'])}), ragged {got_ragged} "
                         f"(expected {streams['ragged']})")
    admission = sal_s["pipeline_stats"]["admission"]
    if admission["rows_rejected"] != len(records) \
            or admission["batches_salvaged"] != batches:
        raise SystemExit(f"phase 12 admission stats {admission}")
    log(f"phase 12 salvage: {batches} batches byte-identical to the "
        f"pre-cleaned run, {len(got_poison)} non-finite rows and "
        f"{len(got_ragged)} ragged lines dead-lettered, launches "
        f"{sal_s['kernel_launches']}")

    ex_ref_s, ex_ref, _ = served["exact_clean"]
    ex_s, ex, _ = served["exact"]
    stats = ex_s["pipeline_stats"]
    if ex != ex_ref or ex_s["rows"] != DP_EXACT_ROWS \
            or stats["padded_rows_total"] != 0 \
            or stats["compile_events"] != 1:
        raise SystemExit(f"phase 12 exact bucket: identical {ex == ex_ref}, "
                         f"rows {ex_s['rows']}, stats {stats}")
    dp_launches("exact bucket", ex_s["kernel_launches"],
                {"forest_traversal": 1, "pad_assemble": 1, "tree_hist": 0})
    if ex_s["pad_launch_shapes"] != pad_shapes_of(ex_s):
        raise SystemExit(f"phase 12 exact bucket: pad_assemble launched at "
                         f"{ex_s['pad_launch_shapes']}")

    zero_s, zero, _ = served["zero"]
    perm_s, perm, perm_ckpt = served["permissive"]
    perm_records = row_dead_letters(perm_ckpt)
    if perm != zero or {r["reason"] for r in perm_records} \
            != {"ragged_row"} or len(perm_records) != len(got_ragged) \
            or perm_s["pipeline_stats"]["admission"]["rows_coerced"] == 0:
        raise SystemExit(f"phase 12 permissive: identical to the zero-filled "
                         f"run's {perm == zero}, dead letters "
                         f"{len(perm_records)}, admission "
                         f"{perm_s['pipeline_stats']['admission']}")
    dp_launches("permissive", perm_s["kernel_launches"], want)
    return {"batches": batches, "salvage": sal_s, "clean": ref_s,
            "exact": ex_s, "exact_clean": ex_ref_s, "permissive": perm_s,
            "zero": zero_s, "dead_letters": len(records),
            "salvage_files": sal, "clean_files": ref}


def events_of(path: str) -> list:
    return [json.loads(x) for x in open(path)] if os.path.exists(path) \
        else []


def kill_chain(dev, model_dir: str, streams: dict, admitted,
               work: str) -> dict:
    """(e)'s kill at commit, fsck and the restart, then a forged
    compaction seal: each a process of its own, one after the other;
    ``admitted`` is the future of :func:`admission_runs`, whose clean
    run's files the restart's must equal."""
    dirs = streams["dirs"]
    out, ckpt = os.path.join(work, "out12_kill"), \
        os.path.join(work, "ckpt12_kill")
    cmd = serve_args(model_dir, dirs["clean"], out, ckpt, dev,
                     DP_FILES_PER_BATCH) + [
        "--once", "--wal-mode", "append", "--wal-compact-every", "2"]
    killed = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                            timeout=600, env=env_with(SNTC_FAULTS=DP_KILL))
    commits = [json.loads(x) for x in open(os.path.join(ckpt,
                                                        "commits.log"))]
    if killed.returncode != 137 or \
            not 0 < len(commits) < streams["batches"]:
        raise SystemExit(f"phase 12 kill: exit {killed.returncode}, "
                         f"{len(commits)} commits:\n{killed.stderr[-2000:]}")
    # what a crash in the middle of the next commit's append leaves
    with open(os.path.join(ckpt, "commits.log"), "a") as f:
        f.write('{"batch_id": %d, "start": ' % len(commits))
    doctor = subprocess.run(
        [sys.executable, "-m", "sntc_tpu_torch", "fsck", ckpt], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    report = json.loads(doctor.stdout)
    if doctor.returncode != 0 or [r["action"] for r in report["repaired"]] \
            != ["truncate_torn_tail"]:
        raise SystemExit(f"phase 12 fsck after the kill: exit "
                         f"{doctor.returncode}, {report}")
    restart = serve_command(model_dir, dirs["clean"], out, ckpt, dev,
                            ["--wal-mode", "append", "--wal-compact-every",
                             "2"], DP_FILES_PER_BATCH)
    committed = [json.loads(x)["batch_id"] for x in open(
        os.path.join(ckpt, "commits.log"))]
    runs = admitted.result()
    if sink_files(out) != runs["clean_files"] \
            or restart["batches"] != runs["batches"] - len(commits) \
            or not os.path.exists(os.path.join(ckpt, "wal_checkpoint.json")):
        raise SystemExit(f"phase 12 restart: {restart['batches']} batches "
                         f"after {len(commits)} commits; files identical to "
                         "the clean run's "
                         f"{sink_files(out) == runs['clean_files']}")
    log(f"phase 12 kill at commit {len(commits)}: fsck repaired the torn "
        f"tail, the restart committed {restart['batches']} batches, files "
        f"byte-identical (commits.log after compaction: {committed})")
    path = os.path.join(ckpt, "wal_checkpoint.json")
    sealed = json.load(open(path))
    sealed["end"] += 1  # forged without resealing
    with open(path, "w") as f:
        json.dump(sealed, f)
    forged = subprocess.run(
        [sys.executable, "-m", "sntc_tpu_torch", "fsck", ckpt], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    if forged.returncode != 1 or "sha256 mismatch" not in forged.stdout:
        raise SystemExit(f"phase 12 forged seal: fsck exited "
                         f"{forged.returncode}")
    return {"killed_after": len(commits), "restart": restart["batches"],
            "fsck_repaired": report["repaired"][0]["torn_bytes"],
            "forged_rc": forged.returncode, "restart_summary": restart}


def disk_faults(dev, model_dir: str, streams: dict, admitted,
                work: str) -> dict:
    """(e)'s supervised loop under disk faults at the WAL and the row
    dead letters, with a disk budget; ``admitted`` is the future of
    :func:`admission_runs`, whose salvage run's files its must equal."""
    dirs = streams["dirs"]
    out = os.path.join(work, "out12_disk")
    ckpt = os.path.join(work, "ckpt12_disk")
    health = os.path.join(work, "health12.json")
    events = os.path.join(work, "events12.jsonl")
    cmd = serve_args(model_dir, dirs["raw"], out, ckpt, dev,
                     DP_FILES_PER_BATCH) + [
        "--row-policy", "salvage", "--poll-interval", "0.2",
        "--health-json", health, "--disk-budget-mb", str(DP_BUDGET_MB)]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=env_with(SNTC_FAULTS=DP_DISK_FAULTS,
                                         SNTC_RESILIENCE_LOG=events))
    def over_budget() -> bool:
        # the disk is measured at most every 5 s (StoragePlane's
        # throttle): the breach shows in the dump within a few ticks
        if not os.path.exists(health):
            return False
        st = json.load(open(health))
        return st["storage"]["disk"]["over_budget"] and st["health"][
            "components"].get("storage.budget", {}).get("state") \
            == "DEGRADED"

    try:
        wait_for(lambda: commit_count(ckpt) >= streams["batches"],
                 "every batch under disk faults", proc)
        wait_for(over_budget, "the disk budget's breach", proc, limit=30.0)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=FAULT_WAIT_S)
    except BaseException:
        proc.kill()
        raise
    runs = admitted.result()
    status = json.load(open(health))
    ev = events_of(events)
    wal_faults = [e for e in ev if e.get("event") == "fault_injected"
                  and e.get("site") == "storage.wal"]
    episodes = [e["event"] for e in ev
                if e.get("artifact") == "dead_letter_rows"
                and e.get("event") in ("storage_degraded",
                                       "storage_recovered")]
    budget = status["health"]["components"].get("storage.budget", {})
    if proc.returncode != 0 or sink_files(out) != runs["salvage_files"] \
            or not wal_faults or episodes[:2] != ["storage_degraded",
                                                   "storage_recovered"] \
            or not status["storage"]["disk"]["over_budget"] \
            or budget.get("state") != "DEGRADED" \
            or status["health"]["overall"] == "OK":
        raise SystemExit(f"phase 12 disk faults: exit {proc.returncode}, "
                         "files identical "
                         f"{sink_files(out) == runs['salvage_files']}, "
                         f"{len(wal_faults)} WAL faults, dead-letter "
                         f"episodes {episodes}, budget {budget}, storage "
                         f"{status['storage']}:\n{stderr[-2000:]}")
    log(f"phase 12 disk faults: {len(wal_faults)} storage.wal faults "
        f"retried, dead letters {episodes}, disk "
        f"{status['storage']['disk']['total_bytes']} B over the "
        f"{DP_BUDGET_MB} MB budget, health {status['health']['overall']}")
    return {"wal_faults": len(wal_faults), "dead_letter_episodes": episodes,
            "disk_total_bytes": status["storage"]["disk"]["total_bytes"],
            "health": status["health"]["overall"]}


def storage_runs(dev, model_dir: str, streams: dict, admitted,
                 work: str) -> dict:
    """(e): the kill at commit, fsck and the restart and a forged
    compaction seal (:func:`kill_chain`), beside disk faults at the WAL
    and the row dead letters with a disk budget under the supervised
    loop (:func:`disk_faults`); then a flipped checkpoint byte."""
    from sntc_tpu_torch.resilience import clear_events, recent_events

    # the two chains of serving processes start together, beside the
    # admission runs' (``admitted``, a future of :func:`admission_runs`)
    kill, disk = together(
        (kill_chain, dev, model_dir, streams, admitted, work),
        (disk_faults, dev, model_dir, streams, admitted, work))

    # a flipped byte in the model checkpoint: load_model takes .prev
    dirs = streams["dirs"]
    path = os.path.join(work, "model12")
    for _ in range(2):
        save_model(load_model(model_dir, device=dev), path)
    npz = sorted(os.path.join(d, n) for d, _, names in os.walk(path)
                 for n in names if n == "data.npz")[-1]
    with open(npz, "r+b") as f:
        f.seek(200)
        b = f.read(1)
        f.seek(200)
        f.write(bytes([b[0] ^ 0xFF]))
    clear_events()
    loaded = load_model(path, device=dev)
    fell_back = recent_events(event="ckpt_fallback")
    sample = load_csv(os.path.join(dirs["clean"], "part_0000.csv"))
    served = serving_form(loaded, "label")[0].transform(sample)
    want = serving_form(load_model(model_dir, device=dev),
                        "label")[0].transform(sample)
    if len(fell_back) != 1 or not np.array_equal(
            to_host(served["prediction"]), to_host(want["prediction"])):
        raise SystemExit(f"phase 12 checkpoint fallback: {fell_back}")
    return {**kill, **disk, "ckpt_fallback": fell_back[0]["fallback_path"]}


def data_plane(dev, work: str, inputs=None) -> dict:
    """Phase 12: row admission and the storage plane on phase 3's
    config-3 model (see the module docs); ``inputs``, a future of
    :func:`dp_streams` started earlier, or None to make them here."""
    t0 = time.perf_counter()
    model_dir = os.path.join(work, "model")
    streams = dp_streams(work) if inputs is None else inputs.result()
    log(f"phase 12 traffic: {DP_FILES + 1} files of {DP_FILE_ROWS} rows "
        f"({len(streams['poison'])} poison rows, {len(streams['ragged'])} "
        f"ragged lines), {DP_EXACT_ROWS} rows with "
        f"{streams['exact_poison']} poison rows "
        f"({streams['seconds']:.1f} s to generate and write; "
        f"{time.perf_counter() - t0:.1f} s waited for them)")
    # the six admission serves and the storage plane's two chains of
    # processes run together
    with ThreadPoolExecutor(1) as pool:
        admitted = pool.submit(admission_runs, dev, model_dir, streams, work)
        try:
            storage = storage_runs(dev, model_dir, streams, admitted, work)
        finally:
            runs = admitted.result()
    # the contract's float32 block: each shape with the count of the run
    # that padded it (the salvage run's full batches, the exact bucket's
    # zero-row pad)
    pads = [measure_pad_at(dev, DP_FILES_PER_BATCH * DP_FILE_ROWS,
                           runs["salvage"]["pad_launch_shapes"],
                           torch.float32),
            measure_pad_at(dev, DP_EXACT_ROWS,
                           runs["exact"]["pad_launch_shapes"],
                           torch.float32, DP_EXACT_ROWS)]
    split = dispatch_split(dev, [os.path.join(streams["dirs"]["raw"], f)
                                 for f in ("part_0000.csv", "part_0001.csv")],
                           admit=True)
    for x in ("salvage_files", "clean_files"):
        del runs[x]
    for tag in ("clean", "salvage", "exact_clean", "exact", "zero",
                "permissive"):
        log(f"phase 12 startup split, {tag} (six processes together, "
            "seconds): " + json.dumps(startup_split(runs[tag])))
    log("phase 12 startup split, the restart (beside the disk-fault "
        "chain, seconds): "
        + json.dumps(startup_split(storage.pop("restart_summary"))))
    return {"runs": runs, "storage": storage, "pads": pads, "split": split,
            "seconds": time.perf_counter() - t0}


# -- phase 13: the serve command's self-tuning plane --------------------------


def serve_here(model_dir: str, watch: str, out: str, ckpt: str, dev,
               files_per_batch: int, extra: list,
               shape_buckets: int = BUCKET_FLOOR) -> dict:
    """``serve --once`` through the command's entry point in this process,
    every launch count set to 0 just before; its summary line."""
    import io

    from sntc_tpu_torch.app import main as serve_main

    argv = serve_args(model_dir, watch, out, ckpt, dev, files_per_batch)[3:]
    argv[argv.index("--shape-buckets") + 1] = str(shape_buckets)
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = serve_main(argv + ["--once", *extra])
    if rc != 0:
        raise SystemExit(f"serve {extra} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def st_streams(work: str) -> dict:
    """Phase 13's inputs: ST_FILES cleaned files of ST_FILE_ROWS rows
    (seed 14) for (a) and (b); their first SHED_FILES, published at once,
    for (d); and (c)'s files of CTL_SIZES rows, staged apart to be
    published one a round."""
    t0 = time.perf_counter()
    n = ST_FILES * ST_FILE_ROWS
    traffic = clean_flows(generate_frame(n + n // 50, seed=SEED + 14))
    traffic = traffic.slice(0, n).drop("Label")
    ctl_rows = clean_flows(generate_frame(sum(CTL_SIZES) * 51 // 50,
                                          seed=SEED + 15)).drop("Label")
    dirs = {k: os.path.join(work, f"in13_{k}")
            for k in ("st", "shed", "ctl", "ctl_stage")}
    for d in dirs.values():
        os.makedirs(d)
    jobs = [(traffic.slice(i * ST_FILE_ROWS, (i + 1) * ST_FILE_ROWS),
             os.path.join(dirs["st"], f"part_{i:04d}.csv"))
            for i in range(ST_FILES)]
    start = 0
    for i, m in enumerate(CTL_SIZES):
        jobs.append((ctl_rows.slice(start, start + m),
                     os.path.join(dirs["ctl_stage"], f"part_{i:04d}.csv")))
        start += m
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda job: write_raw_csv(*job), jobs))
    for i in range(SHED_FILES):
        name = f"part_{i:04d}.csv"
        os.link(os.path.join(dirs["st"], name),
                os.path.join(dirs["shed"], name))
    log(f"phase 13 traffic: {ST_FILES} cleaned files of {ST_FILE_ROWS} "
        f"rows, (c) {len(CTL_SIZES)} files of {min(CTL_SIZES)}-"
        f"{max(CTL_SIZES)} rows ({time.perf_counter() - t0:.1f} s to "
        "generate and write)")
    return dirs


def st_check_run(tag: str, s: dict, n_batches: int, shape: str) -> None:
    """A run of (a) or (b): every batch served, each kernel of the path
    launched once a batch at the batch's block, one numeric upload and
    one download a batch (cleaned flows: nothing to drop or gather)."""
    want = {"forest_traversal": n_batches, "pad_assemble": n_batches,
            "tree_hist": 0}
    moved = s["pipeline_stats"]["transfers"]
    if s["batches"] != n_batches or s["kernel_launches"] != want \
            or s["pad_launch_shapes"] != {shape: n_batches} \
            or moved["uploads"] != n_batches \
            or moved["downloads"] != n_batches:
        raise SystemExit(f"phase 13 {tag}: {s['batches']} batches, "
                         f"launches {s['kernel_launches']}, shapes "
                         f"{s['pad_launch_shapes']}, transfers {moved}")


def autotune_grid(dev, model_dir: str, dirs: dict, work: str) -> dict:
    """(a): the cold engine with ``--autotune`` against each point of
    BENCH10_GRID, in turns, every run's files byte-identical."""
    n_batches = ST_FILES // ST_FILES_PER_BATCH
    block = pad_launch_shape(ST_FILES_PER_BATCH * ST_FILE_ROWS,
                             len(CICIDS2017_FEATURES), torch.float64,
                             bucket_rows_for(ST_FILES_PER_BATCH
                                             * ST_FILE_ROWS, BUCKET_FLOOR))
    runs = []
    for tag, rw, pf, extra in [("autotune", 1, 1, ["--autotune"])] + [
            (f"grid {rw}x{pf}", rw, pf, []) for rw, pf in BENCH10_GRID]:
        out = os.path.join(work, f"out13_{tag.replace(' ', '_')}")
        s = serve_here(model_dir, dirs["st"], out, out + "_ckpt", dev,
                       ST_FILES_PER_BATCH, ["--read-workers", str(rw),
                                            "--prefetch-batches", str(pf),
                                            *extra])
        st_check_run(tag, s, n_batches, block)
        runs.append({"tag": tag, "summary": s, "files": sink_files(out),
                     **steady(s)})
    # bench config 10's own arm (bench.py:1676-1683): the cold source and
    # a tuner of its policy shared by a convergence pass and
    # BENCH10_REPS more, so the knobs it learned carry over (a --once
    # drain of 8 batches takes a few engine rounds: the command's tuner,
    # 4 rounds a window, may close none)
    from sntc_tpu_torch.data.autotune import AutotunePolicy, IngestAutotuner

    tuner = IngestAutotuner(policy=AutotunePolicy(interval_ticks=2,
                                                  confirm=2, cooldown=1))
    shared = None
    for rep in range(1 + BENCH10_REPS):
        out = os.path.join(work, f"out13_bench10_{rep}")
        q, src = st_query(dev, model_dir, dirs["st"], out, out + "_ckpt",
                          source=shared, autotuner=tuner)
        shared = src
        reset_launches()
        t0 = time.perf_counter()
        try:
            q.process_available()
        finally:
            q.stop()
        s = {"batches": q.last_committed() + 1, "rows": q.rows_served,
             "seconds": time.perf_counter() - t0,
             "kernel_launches": dict(LAUNCHES),
             "pad_launch_shapes": dict(PAD_LAUNCH_SHAPES),
             "pipeline_stats": q.pipeline_stats(),
             "progress": q.recentProgress}
        st_check_run(f"bench-10 tuner pass {rep}", s, n_batches, block)
        runs.append({"tag": f"bench-10 tuner pass {rep}", "summary": s,
                     "files": sink_files(out), **steady(s)})
    shared.close()
    ref = runs[0]["files"]
    if len(ref) != n_batches or any(x["files"] != ref for x in runs):
        raise SystemExit("phase 13 (a): batch files differ between the "
                         "autotuned runs and the grid")
    for name, data in ref.items():
        import pyarrow as pa
        import pyarrow.csv as pacsv

        pred = pacsv.read_csv(pa.BufferReader(data)).column(
            "prediction").to_numpy()
        if len(pred) != ST_FILES_PER_BATCH * ST_FILE_ROWS \
                or pred.min() < 0 or pred.max() >= CLASSES:
            raise SystemExit(f"phase 13 (a) {name}: rows or predictions "
                             "out of range")
    return {"runs": runs, "files": ref,
            "autotune": runs[0]["summary"]["pipeline_stats"]["autotune"],
            "bench10": tuner.stats()}


def st_query(dev, model_dir: str, watch: str, out: str, ckpt: str, *,
             columnar: bool = False, shape_buckets: int = BUCKET_FLOOR,
             files_per_batch: int = ST_FILES_PER_BATCH, source=None,
             autotuner=None):
    """The serve command's default engine (``cmd_serve``: fused, the
    device domain, pipelined, files WAL, the failure handling), built in
    this process for what the command has no flag for: the columnar
    source, and a supervisor over it."""
    from sntc_tpu_torch.resilience import (
        DeviceFaultDomain,
        RetryPolicy,
        default_breakers,
    )
    from sntc_tpu_torch.serve import FileStreamSource, StreamingQuery

    model, _labels, out_cols = serving_form(load_model(model_dir, device=dev),
                                            "label", True)
    predictor = BatchPredictor(model, bucket_rows=shape_buckets, device=dev,
                               device_domain=DeviceFaultDomain())
    if source is None:
        source = (FileStreamSource(watch, prefetch_batches=1,
                                   read_workers=1, columnar=columnar)
                  if autotuner is not None else
                  FileStreamSource(watch, prefetch_batches=2,
                                   read_workers=4, columnar=columnar))
    q = StreamingQuery(
        predictor, source, CsvDirSink(out, columns=out_cols), ckpt,
        max_batch_offsets=files_per_batch, pipeline_depth=2,
        overlap_sink=True, device=dev, breakers=default_breakers(),
        retry_policy=RetryPolicy(max_attempts=2, base_delay_s=0.2,
                                 jitter=0.1),
        max_batch_failures=3, autotuner=autotuner)
    return q, source


def columnar_run(dev, model_dir: str, dirs: dict, work: str,
                 files: dict) -> dict:
    """(b): the columnar source's float32 blocks through the same engine:
    ``pad_assemble`` at [60 000, 78] f32, the files of (a)."""
    from sntc_tpu_torch.data.pipeline import read_flows_columnar

    n_batches = ST_FILES // ST_FILES_PER_BATCH
    rows = ST_FILES_PER_BATCH * ST_FILE_ROWS
    out = os.path.join(work, "out13_columnar")
    q, src = st_query(dev, model_dir, dirs["st"], out, out + "_ckpt",
                      columnar=True)
    reset_launches()
    t0 = time.perf_counter()
    try:
        q.process_available()
    finally:
        q.stop()
        src.close()
    seconds = time.perf_counter() - t0
    s = {"batches": q.last_committed() + 1, "rows": q.rows_served,
         "seconds": seconds, "kernel_launches": dict(LAUNCHES),
         "pad_launch_shapes": dict(PAD_LAUNCH_SHAPES),
         "pipeline_stats": q.pipeline_stats(), "progress": q.recentProgress}
    st_check_run("(b) columnar", s, n_batches, pad_launch_shape(
        rows, len(CICIDS2017_FEATURES), torch.float32,
        bucket_rows_for(rows, BUCKET_FLOOR)))
    if sink_files(out) != files:
        raise SystemExit("phase 13 (b): the columnar source's batch files "
                         "differ from (a)'s")
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from pad_assemble_split import split

    frame = Frame.concat_all([
        read_flows_columnar(os.path.join(dirs["st"], f"part_{i:04d}.csv"),
                            handle_invalid=None)
        for i in range(ST_FILES_PER_BATCH)])
    target = bucket_rows_for(rows, BUCKET_FLOOR)
    valid = np.zeros(target, bool)
    valid[:rows] = True
    t1 = time.perf_counter()
    cut = split(frame, target, valid, dev, reps=SPLIT_REPS)
    cut["seconds"] = time.perf_counter() - t1
    return {"summary": s, "split": cut, **steady(s)}


def controlled_serve(dev, model_dir: str, dirs: dict, work: str) -> dict:
    """(c): a QuerySupervisor with a p99 target the card cannot meet over
    a stream of varying batch sizes published one file a round, from the
    cold floor 0: the controller climbs the shape-bucket ladder; SIGTERM
    drains it halfway and a restart on the same checkpoint serves the
    rest; the files equal an uncontrolled serve's."""
    from sntc_tpu_torch.resilience import QuerySupervisor, recent_events
    from sntc_tpu_torch.resilience.control import ControlPolicy
    from sntc_tpu_torch.serve import SloPolicy

    names = sorted(os.listdir(dirs["ctl_stage"]))
    out = os.path.join(work, "out13_ctl")
    ckpt = os.path.join(work, "ckpt13_ctl")
    half = len(names) // 2
    reset_launches()
    published = 0
    phases = []
    previous = signal.getsignal(signal.SIGTERM)
    try:
        for part in ("first", "restart"):
            q, src = st_query(dev, model_dir, dirs["ctl"], out, ckpt,
                              shape_buckets=0, files_per_batch=1)
            sup = QuerySupervisor(
                q, slo=SloPolicy(slo_p99_ms=CTL_P99_MS),
                controller_policy=ControlPolicy(confirm=1, cooldown=0))
            stop_at = half if part == "first" else len(names)
            try:
                while q.last_committed() + 1 < stop_at:
                    if published < stop_at:
                        os.replace(os.path.join(dirs["ctl_stage"],
                                                names[published]),
                                   os.path.join(dirs["ctl"],
                                                names[published]))
                        published += 1
                    sup.tick()
                if part == "first":
                    # the operator's SIGTERM: the loop drains and returns
                    sup.install_signal_handlers()
                    os.kill(os.getpid(), signal.SIGTERM)
                    status = sup.run(poll_interval=0.01)
                    if not status["drained"]:
                        raise SystemExit(f"phase 13 (c): no drain {status}")
                else:
                    status = sup.drain_now("done")
                phases.append({"status": status,
                               "knobs": sup.controller.knob_values(),
                               "stats": sup.controller.stats()})
            finally:
                signal.signal(signal.SIGTERM, previous)
                q.stop()
                src.close()
                sup.close()
    finally:
        signal.signal(signal.SIGTERM, previous)
    journal = [json.loads(x) for x in open(os.path.join(ckpt,
                                                        "controller.jsonl"))]
    raises = [r for r in journal if r.get("action") == "applied"
              and r.get("knob") == "shape_buckets" and r["direction"] == "up"]
    restarts = [r for r in journal if r.get("action") == "restart"]
    if not raises or len(restarts) != 1 \
            or restarts[0]["journal_knobs"] is None:
        raise SystemExit(f"phase 13 (c): journal {journal}")
    errors = recent_events(event="controller_error") + \
        recent_events(event="autotune_error")
    if errors:
        raise SystemExit(f"phase 13 (c): {errors}")
    shapes = dict(PAD_LAUNCH_SHAPES)
    launches = dict(LAUNCHES)
    marker = json.load(open(os.path.join(ckpt, "drain_marker.json")))
    ref_out = os.path.join(work, "out13_ctl_ref")
    ref = serve_here(model_dir, dirs["ctl"], ref_out, ref_out + "_ckpt",
                     dev, 1, [], shape_buckets=0)
    if sink_files(out) != sink_files(ref_out) \
            or ref["batches"] != len(names):
        raise SystemExit("phase 13 (c): the controlled serve's files differ "
                         "from the uncontrolled serve's")
    floors = {0, 64, 128, 256, 512}
    for key in shapes:  # each a shape the ladder gives its block
        n, target = int(key.split(",")[0][1:]), int(key.split("-> ")[1])
        if not any(bucket_rows_for(n, f) == target for f in floors):
            raise SystemExit(f"phase 13 (c): pad_assemble at {key}, not a "
                             "ladder shape")
    if launches["forest_traversal"] != len(names) \
            or launches["pad_assemble"] != sum(shapes.values()) \
            or not shapes:
        raise SystemExit(f"phase 13 (c): launches {launches}, {shapes}")
    return {"journal": journal, "raises": len(raises),
            "restart": restarts[0], "phases": phases, "shapes": shapes,
            "launches": launches, "marker_knobs": marker["controller_knobs"]}


def shed_runs(dev, model_dir: str, dirs: dict, work: str) -> dict:
    """(d): the supervised loop with ``max_pending_batches`` under the
    ``oldest`` and then the ``sample`` policy over SHED_FILES files
    published at once, and the unshed ``serve --once`` of the same files:
    the shed journal against the health dump, no shed offset in an intent
    or a batch file, the served rows byte-identical to the unshed
    serve's."""
    import pyarrow as pa
    import pyarrow.csv as pacsv

    from sntc_tpu_torch.resilience import QuerySupervisor

    unshed_out = os.path.join(work, "out13_unshed")
    unshed = serve_here(model_dir, dirs["shed"], unshed_out,
                        unshed_out + "_ckpt", dev, ST_FILES_PER_BATCH, [])
    ref = sink_files(unshed_out)
    ref_rows = []  # the unshed serve's output rows, in file order
    for name in sorted(ref):
        ref_rows += pacsv.read_csv(pa.BufferReader(ref[name])).to_pylist()
    keep = SHED_PENDING * ST_FILES_PER_BATCH
    out = {"unshed": unshed}
    for policy in ("oldest", "sample"):
        dest = os.path.join(work, f"out13_{policy}")
        ckpt = os.path.join(work, f"ckpt13_{policy}")
        health_path = os.path.join(work, f"health13_{policy}.json")
        q, src = st_query(dev, model_dir, dirs["shed"], dest, ckpt)
        sup = QuerySupervisor(q, max_pending_batches=SHED_PENDING,
                              shed_policy=policy, health_json=health_path)
        reset_launches()
        try:
            for _ in range(200):
                sup.tick()
                if not (q.backlog_offsets() or q.in_flight_count()):
                    break
            status = sup.drain_now("done")
        finally:
            q.stop()
            src.close()
            sup.close()
        launches, shapes = dict(LAUNCHES), dict(PAD_LAUNCH_SHAPES)
        health = json.load(open(health_path))
        shed = [json.loads(x) for x in open(os.path.join(ckpt,
                                                         "shed.jsonl"))]
        total = sum(r["offsets_shed"] for r in shed)
        intents = [json.load(open(os.path.join(ckpt, "offsets", f)))
                   for f in sorted(os.listdir(os.path.join(ckpt,
                                                           "offsets")))]
        if health["shed_total_offsets"] != total or len(shed) != 1 \
                or status["shed_total_offsets"] != total:
            raise SystemExit(f"phase 13 (d) {policy}: shed {shed}, health "
                             f"{health['shed_total_offsets']}")
        files = sink_files(dest)
        rows = []
        for name in sorted(files):
            rows += pacsv.read_csv(pa.BufferReader(files[name])).to_pylist()
        if policy == "oldest":
            cut = shed[0]["end"]
            if total != SHED_FILES - keep or any(i["start"] < cut
                                                 for i in intents):
                raise SystemExit(f"phase 13 (d) oldest: intents {intents}, "
                                 f"shed {shed}")
            expect = ref_rows[cut * ST_FILE_ROWS:]
        else:
            stride = shed[0]["sample_stride"]
            if total != 0 or len(intents) != 1 \
                    or intents[0].get("sample_stride") != stride:
                raise SystemExit(f"phase 13 (d) sample: intents {intents}")
            expect = ref_rows[::stride]
        if rows != expect:
            raise SystemExit(f"phase 13 (d) {policy}: {len(rows)} served "
                             f"rows, not the unshed serve's {len(expect)}")
        if launches["forest_traversal"] != len(files) \
                or launches["pad_assemble"] != len(files):
            raise SystemExit(f"phase 13 (d) {policy}: launches {launches} "
                             f"for {len(files)} batches")
        out[policy] = {"shed": shed, "intents": intents, "rows": len(rows),
                       "batches": len(files), "launches": launches,
                       "shapes": shapes, "health": health["health"][
                           "overall"]}
    return out


def sample_shape() -> tuple:
    """The sample shed's one batch: every stride-th row of the backlog."""
    keep = SHED_PENDING * ST_FILES_PER_BATCH
    stride = -(-SHED_FILES // keep)
    n = len(range(0, SHED_FILES * ST_FILE_ROWS, stride))
    return n, bucket_rows_for(n, BUCKET_FLOOR)


def self_tuning(dev, work: str, inputs=None) -> dict:
    """Phase 13: the serve command's self-tuning plane on phase 3's
    config-3 model (see the module docs); ``inputs``, a future of
    :func:`st_streams` started earlier, or None to make them here."""
    t0 = time.perf_counter()
    model_dir = os.path.join(work, "model")
    dirs = st_streams(work) if inputs is None else inputs.result()
    grid = autotune_grid(dev, model_dir, dirs, work)
    columnar = columnar_run(dev, model_dir, dirs, work, grid["files"])
    ctl = controlled_serve(dev, model_dir, dirs, work)
    shed = shed_runs(dev, model_dir, dirs, work)
    rows = ST_FILES_PER_BATCH * ST_FILE_ROWS
    n_sample, t_sample = sample_shape()
    # each shape with the launches its own run counted there
    pads = [measure_pad_at(dev, rows, columnar["summary"][
                "pad_launch_shapes"], torch.float32),
            measure_pad_at(dev, rows, grid["runs"][0]["summary"][
                "pad_launch_shapes"], torch.float64),
            measure_pad_at(dev, n_sample, shed["sample"]["shapes"],
                           torch.float64, t_sample)]
    for key in sorted(ctl["shapes"], key=lambda k: int(k.split(",")[0][1:])):
        n, target = int(key.split(",")[0][1:]), int(key.split("-> ")[1])
        pads.append(measure_pad_at(dev, n, ctl["shapes"], torch.float64,
                                   target))
    del grid["files"]
    for x in grid["runs"]:
        del x["files"]
    return {"grid": grid, "columnar": columnar, "controller": ctl,
            "shed": shed, "pads": pads,
            "seconds": time.perf_counter() - t0}


def report_phase13(p13: dict, card: str) -> None:
    """Phase 13's lines: each run of (a), the tuners, (b) and its split,
    (c)'s decisions, each ``pad_assemble`` shape, one JSON line."""
    for x in p13["grid"]["runs"]:
        s = x["summary"]
        log(f"phase 13 (a) {x['tag']}: {x['rows_per_s']:.0f} rows/s without "
            f"the first batch ({s['rows']} rows in {s['seconds']:.3f} s in "
            f"all, not a claim); mean read {x['read_ms']:.2f} ms, dispatch "
            f"{x['dispatch_ms']:.2f} ms, sink {x['sink_ms']:.2f} ms; "
            f"prefetch {s['pipeline_stats'].get('prefetch')}, transfers "
            f"{s['pipeline_stats']['transfers']} [{card}]")
    tuned = p13["grid"]["autotune"]
    for tag, t in (("the command's --autotune", tuned),
                   (f"bench config 10's policy, {1 + BENCH10_REPS} "
                    "passes",
                    p13["grid"]["bench10"])):
        log(f"phase 13 (a) autotuner, {tag}: {t['windows']} windows, "
            f"{t['applied']} applied of {t['decisions']} decisions "
            f"{[(d['action'], d['knob'], d['from'], d['to']) for d in t['recent']]}"
            f", final knobs {t['knobs']}, frozen {t['frozen']}")
    col = p13["columnar"]
    log(f"phase 13 (b) columnar source: {col['rows_per_s']:.0f} rows/s "
        f"without the first batch, mean read {col['read_ms']:.2f} ms, "
        f"dispatch {col['dispatch_ms']:.2f} ms; launches "
        f"{col['summary']['kernel_launches']} at "
        f"{col['summary']['pad_launch_shapes']} [{card}]")
    x = col["split"]
    log(f"phase 13 (b) pad_assemble split, in process, of a {x['block']} "
        "columnar batch (ms, min / median / max): column-major pack "
        f"{_mmm(x['pack_column_major_ms'])}, upload {_mmm(x['upload_ms'])} "
        f"({x['upload_bytes']} B), launch "
        f"{x['launch_column_major_device_ms']:.4f} device ms, the whole "
        f"call {_mmm(x['call_ms'])} [{card}]")
    ctl = p13["controller"]
    log(f"phase 13 (c) controller: {ctl['raises']} shape_buckets raises, "
        f"decisions {[(r['action'], r.get('knob'), r.get('from'), r.get('to')) for r in ctl['journal'] if r.get('action') != 'restart']}; "
        f"restart delta {ctl['restart']['delta']}; pad_assemble at "
        f"{ctl['shapes']}; launches {ctl['launches']}")
    for k in p13["pads"]:
        log(f"phase 13 {k['name']} {k['shape']}: {k['ms']:.4f} ms a call, "
            f"{k['device_ms']:.4f} ms of device time a launch (plain "
            f"{k['plain_ms']:.4f} ms; {k['library_call']} "
            f"{k['library_ms']:.4f} ms a call; bound {k['bound_ms']:.4f} ms "
            f"by {k['bound_by']}); {k['launches']} launches at this shape "
            f"in its run, max abs error {k['max_abs_err']} [{card}]")
    log("phase 13 " + json.dumps({
        "phase": 13, "card": card, "seconds": round(p13["seconds"], 3),
        "autotune_applied": tuned["applied"],
        "autotune_knobs": tuned["knobs"],
        "bench10_applied": p13["grid"]["bench10"]["applied"],
        "bench10_knobs": p13["grid"]["bench10"]["knobs"],
        "controller_raises": ctl["raises"],
        "controller_knobs": ctl["marker_knobs"],
        "ladder_shapes": ctl["shapes"],
        "shed": {k: {"offsets_shed": sum(r["offsets_shed"]
                                         for r in v["shed"]),
                     "batches": v["batches"], "rows": v["rows"],
                     "health": v["health"]}
                 for k, v in p13["shed"].items() if k != "unshed"}}))


# -- phase 14: the model lifecycle -------------------------------------------


def lc_streams(work: str) -> dict:
    """(a)'s drifting stream, written once with ``write_drift_stream``,
    and its gaussian NB incumbent fitted on the cleaned first LC_SHIFT
    batches on the card (the label indexer comes off for serving: the
    lifecycle reads the stream's ``Label`` through the promoter)."""
    from sntc_tpu_torch.data import generate_drift_frames, write_drift_stream

    t0 = time.perf_counter()
    frames = generate_drift_frames(LC_BATCHES, rows_per_batch=LC_ROWS,
                                   shift_at=LC_SHIFT, seed=LC_SEED,
                                   n_classes=LC_CLASSES)
    in_dir = os.path.join(work, "in14_drift")
    write_drift_stream(in_dir, LC_BATCHES, frames=frames)
    return {"frames": frames, "in": in_dir,
            "seconds": time.perf_counter() - t0}


def arc_model(dev, frames: list):
    train = clean_flows(Frame.concat_all(frames[:LC_SHIFT]))
    feat_cols = [c for c in train.columns if c != "Label"]
    fitted = Pipeline(stages=[
        StringIndexer(inputCol="Label", outputCol="label"),
        VectorAssembler(inputCols=feat_cols, outputCol="features"),
        NaiveBayes(device=dev, modelType="gaussian"),
    ]).fit(train)
    return (PipelineModel(stages=fitted.getStages()[1:]),
            fitted.getStages()[0].labels)


def promotion_journal(ckpt: str) -> list:
    path = os.path.join(ckpt, "promotion.jsonl")
    return [json.loads(x) for x in open(path)] if os.path.exists(path) \
        else []


def arc_run(dev, streams: dict, serving, labels, work: str,
            shape_buckets: int) -> dict:
    """One run of bench config 7's arc in this process, as
    ``bench.py:894-1060`` drives it: the drift monitor, the promoter and
    the manager on the command's engine, refitting armed by the first
    ``drift_detected``; every launch count set to 0 just before the
    engine runs and read just after."""
    import pyarrow.csv as pacsv

    from sntc_tpu_torch.lifecycle import (
        DriftMonitor,
        LifecycleManager,
        ModelPromoter,
        macro_f1,
    )
    from sntc_tpu_torch.resilience import (
        add_event_observer,
        remove_event_observer,
    )
    from sntc_tpu_torch.serve import FileStreamSource, StreamingQuery

    tag = f"14_arc{shape_buckets}"
    serving_path = os.path.join(work, f"model{tag}")
    ckpt, out_dir = (os.path.join(work, f"ckpt{tag}"),
                     os.path.join(work, f"out{tag}"))
    save_model(serving, serving_path)
    serving = load_model(serving_path, device=dev)
    drift = DriftMonitor(window=LC_DRIFT_WINDOW,
                         threshold=LC_DRIFT_THRESHOLD).attach()
    promoter = ModelPromoter(
        serving, incumbent_raw=serving, serving_path=serving_path,
        checkpoint_dir=ckpt, window=LC_SHADOW_WINDOW, margin=LC_MARGIN,
        label_col="Label", labels=labels, probation_batches=LC_PROBATION,
        bucket_rows=shape_buckets, device=dev)
    mgr = LifecycleManager(drift=drift, promoter=promoter,
                           n_classes=LC_CLASSES, device=dev)
    drift_event = {}

    def arm_refit(rec):
        if rec.get("event") == "drift_detected" and not drift_event:
            drift_event.update(rec)
            mgr.partial_fit = True

    add_event_observer(arm_refit)
    q = StreamingQuery(serving, FileStreamSource(streams["in"]),
                       CsvDirSink(out_dir, columns=["prediction"],
                                  durable=False),
                       ckpt, max_batch_offsets=1, shape_buckets=shape_buckets,
                       overlap_sink=False, device=dev, lifecycle=mgr)
    try:
        reset_launches()
        t0 = time.perf_counter()
        n_done = q.process_available()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, shapes = dict(LAUNCHES), dict(PAD_LAUNCH_SHAPES)
        stats = q.pipeline_stats()
    finally:
        remove_event_observer(arm_refit)
        drift.detach()
        q.stop()
    index = {str(v): i for i, v in enumerate(labels)}
    f1 = []
    for i, f in enumerate(streams["frames"]):
        t = pacsv.read_csv(os.path.join(out_dir, f"batch_{i:06d}.csv"))
        y = np.asarray([index.get(str(v), -1) for v in f["Label"]],
                       np.int64)
        known = y >= 0
        f1.append(round(macro_f1(
            y[known], t.column("prediction").to_numpy()[known]), 4))
    journal = promotion_journal(ckpt)
    lc = stats["lifecycle"]
    detected = drift_event.get("batch_id")
    return {
        "shape_buckets": shape_buckets, "batches": n_done,
        "seconds": seconds,
        "batches_stalled": LC_BATCHES - stats["delivered_batches"],
        "drift_detected_batch": detected,
        "detection_latency_batches": (None if detected is None
                                      else detected - LC_SHIFT),
        "drift_divergence": drift_event.get("divergence"),
        "promoted_at_batch": next((r["batch_id"] for r in journal
                                   if r.get("decision") == "promote"), None),
        "shadow_scores": sum(r["action"] == "shadow_score"
                             for r in journal),
        "partial_fit_batches": lc["partial_fit_batches"],
        "promotions": lc["promoter"]["promotions"],
        "rollbacks": lc["promoter"]["rollbacks"],
        "models_swapped": lc["models_swapped"],
        "generation": lc["promoter"]["generation"],
        "f1_pre_shift": round(float(np.mean(f1[:LC_SHIFT])), 4),
        "f1_post_shift_degraded": f1[LC_SHIFT],
        "f1_recovered": round(float(np.mean(f1[-2:])), 4),
        "f1_by_batch": f1,
        "padded_rows": stats["padded_rows_total"],
        "launches": launches, "pad_launch_shapes": shapes,
        "files": sink_files(out_dir),
    }


def check_arc(run: dict) -> None:
    """Bench config 7's contract on one run, and its launches: each
    padded dispatch (every batch's, every shadow score's with buckets)
    one ``pad_assemble`` launch at its block."""
    tag = f"phase 14 (a) shape_buckets={run['shape_buckets']}"
    bad = [k for k, ref in LC_F1_REF.items()
           if abs(run[k] - ref) > LC_F1_ATOL]
    if run["batches"] != LC_BATCHES or run["batches_stalled"] \
            or run["rollbacks"] or not 1 <= run["promotions"] <= 2 \
            or run["detection_latency_batches"] not in (1, 2) or bad:
        raise SystemExit(f"{tag}: {dict(run, files=len(run['files']))}")
    padded = bucket_rows_for(LC_ROWS, run["shape_buckets"] or 0)
    want_pads = 0 if padded == LC_ROWS else LC_BATCHES + run["shadow_scores"]
    want = {"forest_traversal": 0, "tree_hist": 0, "pad_assemble": want_pads}
    if run["launches"] != want or sum(run["pad_launch_shapes"].values()) \
            != want_pads or run["padded_rows"] != LC_BATCHES * (
                padded - LC_ROWS):
        raise SystemExit(f"{tag}: launches {run['launches']} at "
                         f"{run['pad_launch_shapes']}, expected {want}")


def swap_streams(work: str) -> dict:
    """(b)'s inputs: SWAP_FILES labelled, cleaned files of SWAP_FILE_ROWS
    rows (every class present), the first SWAP_FIRST of them in the watch
    directory of the promotion run, all of them in the kill run's."""
    t0 = time.perf_counter()
    n = SWAP_FILES * SWAP_FILE_ROWS
    traffic = clean_flows(generate_frame(n + n // 50, seed=SEED + 16,
                                         min_class_fraction=0.005))
    dirs = {k: os.path.join(work, f"in14_{k}") for k in ("all", "first")}
    for d in dirs.values():
        os.makedirs(d)
    jobs = [(traffic.slice(i * SWAP_FILE_ROWS, (i + 1) * SWAP_FILE_ROWS),
             os.path.join(dirs["all"], f"part_{i:04d}.csv"))
            for i in range(SWAP_FILES)]
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda job: write_raw_csv(*job), jobs))
    for i in range(SWAP_FIRST):
        name = f"part_{i:04d}.csv"
        os.link(os.path.join(dirs["all"], name),
                os.path.join(dirs["first"], name))
    return {"dirs": dirs, "traffic": traffic.slice(0, n),
            "seconds": time.perf_counter() - t0}


def swap_models(dev, work: str) -> dict:
    """(b)'s two config-3 fits, made here on the card from
    SWAP_TRAIN_ROWS labelled rows: one fitted prefix (the label indexer,
    the 78 features, a ChiSq top-40 select) and two forests of 20 trees
    of depth 10 behind it, the incumbent fitted to the rows' labels
    permuted, the candidate to the labels themselves.  The gate promotes
    the candidate: the incumbent's leaves carry no signal (its macro-F1
    stays near the share of the benign class's F1 among 15 classes), the
    candidate reads the class signatures the select keeps, a lead far
    beyond the 0.05 margin; and both heads read the one prefix's
    columns, so the candidate grafts onto the incumbent's prefix."""
    t0 = time.perf_counter()
    rows = clean_flows(generate_frame(SWAP_TRAIN_ROWS, seed=SEED + 17,
                                      min_class_fraction=0.005))
    prefix = Pipeline(stages=[
        StringIndexer(inputCol="Label", outputCol="label",
                      handleInvalid="skip"),
        VectorAssembler(inputCols=CICIDS2017_FEATURES,
                        outputCol="rawFeatures", handleInvalid="skip"),
        ChiSqSelector(device=dev, numTopFeatures=TOP, maxBins=BINS,
                      featuresCol="rawFeatures", labelCol="label",
                      outputCol="features"),
    ]).fit(rows)
    feats = prefix.transform(rows)
    permuted = feats.with_column("label", np.random.default_rng(
        SEED + 18).permutation(to_host(feats["label"])))
    paths = {}
    for name, frame in (("incumbent", permuted), ("candidate", feats)):
        rf = RandomForestClassifier(device=dev, numTrees=TREES,
                                    maxDepth=DEPTH, maxBins=BINS,
                                    seed=SEED).fit(frame)
        paths[name] = os.path.join(work, f"{name}14")
        save_model(PipelineModel(stages=prefix.getStages() + [rf]),
                   paths[name])
    paths["seconds"] = time.perf_counter() - t0
    return paths


def swap_serve(dev, work: str, streams: dict, models: dict) -> dict:
    """(b): ``serve --drift-window 3 --promote-from <candidate>
    --shadow-window 4 --shape-buckets 256 --pipeline-depth 1`` on a copy
    of the incumbent over the first SWAP_FIRST files (the head unfused:
    ``forest_traversal`` walks it as a plain stage, for the incumbent and
    the shadow); the candidate alone over all files; a restart over all
    files with the drift monitor alone; then the same serve killed at
    ``model.swap`` (published, not swapped), ``fsck`` and the restart.
    Depth 1 keeps the batch after the promoting one on the promoted
    model in both runs, so the two are comparable file for file."""
    import shutil

    dirs, cand = streams["dirs"], models["candidate"]
    # the kill at model.swap's first call (published, not swapped), fsck
    # and the restart: processes of their own, beside the in-process runs
    model14k = os.path.join(work, "model14k")
    shutil.copytree(models["incumbent"], model14k)
    out_k, ckpt_k = os.path.join(work, "out14k"), os.path.join(work,
                                                                "ckpt14k")

    def kill_leg():
        killed = subprocess.run(
            serve_args(model14k, dirs["all"], out_k, ckpt_k, dev, 1)
            + ["--once", *SWAP_FLAGS, "--promote-from", cand], cwd=REPO,
            capture_output=True, text=True, timeout=600,
            env=env_with(SNTC_FAULTS="model.swap:kill"))
        committed = len(os.listdir(os.path.join(ckpt_k, "commits")))
        if killed.returncode != 137:
            raise SystemExit(f"phase 14 (b) kill: exit {killed.returncode}, "
                             f"{committed} commits:\n{killed.stderr[-2000:]}")
        doctor = subprocess.run(
            [sys.executable, "-m", "sntc_tpu_torch", "fsck", ckpt_k],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        marker_k = json.load(open(os.path.join(ckpt_k, "model_marker.json")))
        recovered = serve_command(model14k, dirs["all"], out_k, ckpt_k, dev,
                                  SWAP_FLAGS)
        return committed, doctor, marker_k, recovered

    # a failure here leaves the leg's thread to end with its processes
    pool = ThreadPoolExecutor(1)
    leg = pool.submit(kill_leg)
    model14 = os.path.join(work, "model14")
    shutil.copytree(models["incumbent"], model14)
    out, ckpt = os.path.join(work, "out14"), os.path.join(work, "ckpt14")
    promo = serve_here(model14, dirs["first"], out, ckpt, dev, 1,
                       SWAP_FLAGS + ["--promote-from", cand])
    journal = promotion_journal(ckpt)
    marker = json.load(open(os.path.join(ckpt, "model_marker.json")))
    at = next((r["batch_id"] for r in journal
               if r.get("decision") == "promote"), None)
    shadow = sum(r["action"] == "shadow_score" for r in journal)
    lc = promo["pipeline_stats"]["lifecycle"]
    want = {"forest_traversal": SWAP_FIRST + shadow, "tree_hist": 0,
            "pad_assemble": SWAP_FIRST + shadow}
    if at is None or marker["generation"] != 1 \
            or marker["action"] != "promoted" or lc["models_swapped"] != 1 \
            or promo["kernel_launches"] != want or promo["fusion"] is None:
        raise SystemExit(f"phase 14 (b): promoted at {at}, marker {marker}, "
                         f"lifecycle {lc}, launches "
                         f"{promo['kernel_launches']} (expected {want}), "
                         f"fusion {promo['fusion']}")
    alone_out = os.path.join(work, "out14_alone")
    alone = serve_here(cand, dirs["all"], alone_out, alone_out + "_ckpt",
                       dev, 1, ["--pipeline-depth", "1"])
    ref = sink_files(alone_out)
    # the restart: the rest of the stream, the promoted model from disk
    for i in range(SWAP_FIRST, SWAP_FILES):
        name = f"part_{i:04d}.csv"
        os.link(os.path.join(dirs["all"], name),
                os.path.join(dirs["first"], name))
    restart = serve_here(model14, dirs["first"], out, ckpt, dev, 1,
                         SWAP_FLAGS)
    files = sink_files(out)
    after = [f"batch_{i:06d}.csv" for i in range(at + 1, SWAP_FILES)]
    if len(files) != SWAP_FILES or restart["batches"] != \
            SWAP_FILES - SWAP_FIRST or any(files[f] != ref[f] for f in after) \
            or files["batch_000000.csv"] == ref["batch_000000.csv"]:
        raise SystemExit(f"phase 14 (b): {len(files)} files; the batches "
                         "after the swap equal the candidate's alone "
                         f"{all(files[f] == ref[f] for f in after)}")
    committed, doctor, marker_k, recovered = leg.result()
    pool.shutdown()
    commits = sorted(os.listdir(os.path.join(ckpt_k, "commits")))
    if committed != at + 1:
        raise SystemExit(f"phase 14 (b) kill: {committed} commits before "
                         f"the kill, the promotion at batch {at}")
    if doctor.returncode != 0 or marker_k["generation"] != 1 \
            or recovered["batches"] != SWAP_FILES - committed \
            or commits != [f"{i}.json" for i in range(SWAP_FILES)] \
            or sink_files(out_k) != files:
        raise SystemExit(f"phase 14 (b) restart after the kill: fsck exit "
                         f"{doctor.returncode}, marker {marker_k}, "
                         f"{recovered['batches']} batches, commits "
                         f"{commits}, files identical to the uninterrupted "
                         f"run's {sink_files(out_k) == files}")
    return {"promoted_at": at, "shadow_scores": shadow, "marker": marker,
            "journal_actions": [r["action"] for r in journal],
            "summary": promo, "alone": alone, "restart": restart,
            "killed_after_commits": committed,
            "recovered_batches": recovered["batches"],
            "fsck": json.loads(doctor.stdout)["ok"]}


def swap_forest_at(dev, streams: dict, cand: str, launches: int) -> dict:
    """``forest_traversal`` at (b)'s unfused walk: the candidate forest
    over a padded batch's selected columns ([8 192, 40] f32), bitwise
    against its plain version, timed beside its bound."""
    stages = load_model(cand, device=dev).getStages()
    rf, selected = stages[-1], stages[2].selected_features
    batch = streams["traffic"].slice(0, SWAP_FILE_ROWS)
    target = bucket_rows_for(SWAP_FILE_ROWS, BUCKET_FLOOR)
    X = np.stack([batch[CICIDS2017_FEATURES[j]] for j in selected], axis=1)
    X = X[np.minimum(np.arange(target), SWAP_FILE_ROWS - 1)]
    args = [rf._features_on_device(X), *rf._device_forest()]
    depth = rf.getMaxDepth()
    out = forest_leaf_stats_cuda(*args, max_depth=depth)
    ref = forest_leaf_stats_reference(*args, max_depth=depth)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise SystemExit("phase 14 forest_traversal: differs from its "
                         "plain version")
    nbytes, ops = forest_work(*args, depth=depth)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / FP32_OPS_PER_S * 1e3
    T, M = args[1].shape
    return {
        "name": "forest_traversal", "route": "cuda",
        "source": "sntc_tpu_torch/kernels/csrc/forest_traversal.cu",
        "replaces": "sntc_tpu/kernels/forest.py:92",
        "launches": launches,
        "max_abs_err": (out - ref).abs().max().item(),
        "ms": time_ms(lambda: forest_leaf_stats_cuda(*args,
                                                     max_depth=depth)),
        "device_ms": kernel_device_ms(
            lambda: forest_leaf_stats_cuda(*args, max_depth=depth)),
        "plain_ms": time_ms(lambda: forest_leaf_stats_reference(
            *args, max_depth=depth)),
        "bound_ms": max(b_ms, o_ms),
        "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "library_ms": None,  # no single PyTorch call walks a tree
        "shape": f"phase 14 unfused config-3 head (incumbent, shadow, "
                 f"candidate): X [{target}, {TOP}] f32, T={T}, M={M}, "
                 f"S={args[3].shape[2]}; needs {nbytes} B, {ops} "
                 "comparisons",
    }


def pads_of(dev, shapes: dict, f32_row_major: bool = True) -> list:
    """Each ``pad_assemble`` shape of a run, measured in the layout its
    dispatch launched: a batch's 1-D columns column-major; in phase 14
    the shadow's head input, a float32 2-D column, row-major (phase 15's
    float32 blocks are 1-D columns: ``f32_row_major=False``)."""
    out = []
    for key in sorted(shapes):
        n, c = (int(v) for v in key.split("]")[0][1:].split(", "))
        dtype = torch.float64 if " f64 " in key else torch.float32
        target = int(key.split("-> ")[1])
        out.append(measure_pad_at(
            dev, n, shapes, dtype, target, columns=c,
            row_major=f32_row_major and dtype == torch.float32))
    return out


def lifecycle(dev, work: str) -> dict:
    """Phase 14 (a) and (b): the model lifecycle on the card (see the
    module docs)."""
    t0 = time.perf_counter()
    streams = lc_streams(work)
    serving, labels = arc_model(dev, streams["frames"])
    arcs = [arc_run(dev, streams, serving, labels, work, b)
            for b in (0, BUCKET_FLOOR)]
    for run in arcs:
        check_arc(run)
    if arcs[0]["files"] != arcs[1]["files"]:
        raise SystemExit("phase 14 (a): the batch files differ between "
                         "shape_buckets 0 and 256")
    swap_in = swap_streams(work)
    models = swap_models(dev, work)
    swap = swap_serve(dev, work, swap_in, models)
    kernels = pads_of(dev, arcs[1]["pad_launch_shapes"])
    kernels += pads_of(dev, swap["summary"]["pad_launch_shapes"])
    kernels.append(swap_forest_at(
        dev, swap_in, models["candidate"],
        swap["summary"]["kernel_launches"]["forest_traversal"]))
    for run in arcs:
        del run["files"]
    return {"arcs": arcs, "swap": swap, "kernels": kernels,
            "models_fit_s": models["seconds"],
            "seconds": time.perf_counter() - t0}


def lr_partial_fit(dev, data: dict) -> dict:
    """(c): LogisticRegression.partial_fit (config 1: regParam 1e-4, 100
    iterations) over config 1's scaled train rows in PF_SHARDS shards, on
    the card and on the CPU, and the batch fit on the card: held-out
    predictions of the last partial model against the batch fit's, and
    each shard's history on the card against the CPU's."""
    train, test = scaled_features(dev, data)
    per = train.num_rows // PF_SHARDS
    shards = [train.slice(i * per, (i + 1) * per) for i in range(PF_SHARDS)]

    def run(device):
        est = LogisticRegression(device=device, regParam=LR_REG,
                                 maxIter=LBFGS_ITERS)
        state, fits = None, []
        for s in shards:
            m, state = est.partial_fit(s, state)
            fits.append(m)
        return fits

    card, card_s = timed(lambda: run(dev))
    t0 = time.perf_counter()
    cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    batch, batch_s = timed(lambda: LogisticRegression(
        device=dev, regParam=LR_REG, maxIter=LBFGS_ITERS).fit(train))
    pred = {k: to_host(m.transform(test)["prediction"])
            for k, m in (("partial", card[-1]), ("batch", batch))}
    agree = float(np.mean(pred["partial"] == pred["batch"]))
    gaps = [fit_gaps(a, b) for a, b in zip(card, cpu)]
    out = {"rows": train.num_rows, "shards": PF_SHARDS, "agreement": agree,
           "gaps": gaps, "card_s": card_s, "cpu_s": cpu_s,
           "batch_fit_s": batch_s}
    if agree < PF_AGREE or any(g["prefix_gap"] > PF_PREFIX_TOL
                               or g["end_gap"] > PF_END_TOL for g in gaps):
        raise SystemExit(f"phase 14 (c): {out}")
    return out


def report_phase14(p14: dict, card: str) -> None:
    """Phase 14's lines: each arc, (b)'s promotion, kill and restart, (c),
    each kernel shape, one JSON line."""
    for run in p14["arcs"]:
        log(f"phase 14 (a) bench config 7 arc, shape_buckets "
            f"{run['shape_buckets']}: drift at batch "
            f"{run['drift_detected_batch']} (latency "
            f"{run['detection_latency_batches']}, divergence "
            f"{run['drift_divergence']}), promoted at batch "
            f"{run['promoted_at_batch']}, {run['promotions']} promotions, "
            f"{run['rollbacks']} rollbacks, {run['batches_stalled']} "
            f"stalled; macro-F1 {run['f1_pre_shift']} / "
            f"{run['f1_post_shift_degraded']} / {run['f1_recovered']} "
            f"(JAX on the CPU {LC_F1_REF['f1_pre_shift']} / "
            f"{LC_F1_REF['f1_post_shift_degraded']} / "
            f"{LC_F1_REF['f1_recovered']}); by batch {run['f1_by_batch']}; "
            f"{run['batches']} batches of {LC_ROWS} rows in "
            f"{run['seconds']:.3f} s; launches {run['launches']} at "
            f"{run['pad_launch_shapes']} [{card}]")
    sw = p14["swap"]
    log(f"phase 14 (b) serve --promote-from on config 3: promoted at batch "
        f"{sw['promoted_at']} after {sw['shadow_scores']} shadow scores, "
        f"marker {sw['marker']['generation']} {sw['marker']['action']}, "
        f"journal {sw['journal_actions']}; launches "
        f"{sw['summary']['kernel_launches']} at "
        f"{sw['summary']['pad_launch_shapes']}; {sw['summary']['rows']} rows "
        f"in {sw['summary']['seconds']:.3f} s of serving; the restart "
        f"served {sw['restart']['batches']} batches of the promoted model; "
        f"killed at model.swap after {sw['killed_after_commits']} commits, "
        f"fsck ok {sw['fsck']}, the restart committed "
        f"{sw['recovered_batches']} batches, files byte-identical "
        f"[{card}]")
    if "lr" in p14:
        lr = p14["lr"]
        prefix = ", ".join(f"{g['prefix_gap']:.2e}" for g in lr["gaps"])
        end = ", ".join(f"{g['end_gap']:.2e}" for g in lr["gaps"])
        log(f"phase 14 (c) LR partial_fit over {lr['rows']} config-1 rows in "
            f"{lr['shards']} shards: held-out agreement with the batch fit "
            f"{lr['agreement']:.4f}; card against CPU by shard: prefix gaps "
            f"[{prefix}], end gaps [{end}], iterations "
            f"{[g['iterations'] for g in lr['gaps']]}; card "
            f"{lr['card_s']:.3f} s, CPU {lr['cpu_s']:.3f} s, batch fit "
            f"{lr['batch_fit_s']:.3f} s [{card}]")
    for k in p14["kernels"]:
        lib = ("" if k["library_ms"] is None else
               f"; {k['library_call']} {k['library_ms']:.4f} ms a call")
        log(f"phase 14 {k['name']} {k['shape']}: {k['ms']:.4f} ms a call, "
            f"{k['device_ms']:.4f} ms of device time a launch (plain "
            f"{k['plain_ms']:.4f} ms{lib}; bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}); {k['launches']} launches at this shape in "
            f"its run, max abs error {k['max_abs_err']} [{card}]")
    log("phase 14 " + json.dumps({
        "phase": 14, "card": card, "seconds": round(p14["seconds"], 3),
        "arcs": [{k: r[k] for k in (
            "shape_buckets", "drift_detected_batch", "promoted_at_batch",
            "promotions", "rollbacks", "batches_stalled", "f1_pre_shift",
            "f1_post_shift_degraded", "f1_recovered", "launches")}
            for r in p14["arcs"]],
        "swap": {k: p14["swap"][k] for k in (
            "promoted_at", "shadow_scores", "killed_after_commits",
            "recovered_batches")},
        "lr": ({k: p14["lr"][k] for k in ("agreement",)}
               | {"max_prefix_gap": max(g["prefix_gap"]
                                        for g in p14["lr"]["gaps"]),
                  "max_end_gap": max(g["end_gap"]
                                     for g in p14["lr"]["gaps"])}
               if "lr" in p14 else None)}))


# -- phase 15: bench config 6's fused serve, the host crossover, obs ---------


def c6_pipeline(device) -> Pipeline:
    """Bench config 6's pipeline (``bench.py:742-748``): StringIndexer
    (skip) -> VectorAssembler(78) -> MinMaxScaler -> DCT -> PCA(k=32) ->
    LogisticRegression(maxIter=20), every stage on ``device``."""
    return Pipeline(stages=[
        StringIndexer(inputCol="Label", outputCol="label",
                      handleInvalid="skip"),
        VectorAssembler(inputCols=CICIDS2017_FEATURES,
                        outputCol="rawFeatures"),
        MinMaxScaler(device=device, inputCol="rawFeatures", outputCol="mm"),
        DCT(device=device, inputCol="mm", outputCol="dct"),
        PCA(device=device, inputCol="dct", outputCol="features",
            k=C6_PCA_K),
        LogisticRegression(device=device, maxIter=C6_LR_ITERS),
    ])


def _set_env(values: dict) -> None:
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)


@contextlib.contextmanager
def environ(**kw):
    """The environment variables ``kw`` set (a None value unset) inside
    the block, for this process and the processes it starts."""
    before = {k: os.environ.get(k) for k in kw}
    _set_env(kw)
    try:
        yield
    finally:
        _set_env(before)


def tf32_round(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest),
    the rounding a TF32 product gives its inputs."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000))
            & np.uint32(0xFFFFE000)).view(np.float32)


@contextlib.contextmanager
def tf32_products():
    """The pipeline control's precision: the float32 products of the LR
    fit and of the PCA and DCT stages in TF32 (their ``full_f32`` blocks
    swapped for a TF32 one), to show that (a)'s tolerance parts a
    lower-precision fit from a full-f32 one."""
    from sntc_tpu_torch.feature import dct as dct_module
    from sntc_tpu_torch.feature import pca as pca_module

    @contextlib.contextmanager
    def tf32():
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prev)

    mods = (lr_module, pca_module, dct_module)
    saved = [m.full_f32 for m in mods]
    for m in mods:
        m.full_f32 = tf32
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.full_f32 = f


def c6_compare(card, card_s: float, data1: dict, auc1: float) -> dict:
    """(a)'s fits: config 6's pipeline fitted on the card (``card``) and,
    here, on the CPU on config 1's train rows: MinMax extrema bitwise,
    the PCA components up to each column's sign within ``C6_PCA_TOL`` and
    ``explainedVariance`` within ``C6_EV_TOL``; the LR fitted on the CPU
    on the card pipeline's feature rows within ``C6_LR_TOL`` of the start
    and, on their first ``REDUCED_LBFGS_ROWS``, both fits within phase
    7's config-1 rule (``LBFGS_PREFIX_TOL`` over the first 20
    iterations, all of them here); the CPU pipeline's LR, on its own
    features, within ``C6_E2E_TOL``; held-out AUC beside config 1's.
    The TF32 controls must lie beyond those two tolerances (checked by
    :func:`fused_serve` after the phase): the LR fitted on the card on
    the same feature rows rounded to TF32 (``tf32_round``: the binary
    LR's products are matrix-vector, which TF32 mode leaves in full
    f32), and the card pipeline fitted with TF32 products in the DCT,
    the PCA and the LR (``tf32_products``)."""
    train, test = data1["train"], data1["test"]
    t0 = time.perf_counter()
    cpu = c6_pipeline(torch.device("cpu")).fit(train)
    cpu_s = time.perf_counter() - t0
    mm = [m.getStages()[2] for m in (card, cpu)]
    pca = [m.getStages()[4] for m in (card, cpu)]
    if not (np.array_equal(mm[0].originalMin, mm[1].originalMin)
            and np.array_equal(mm[0].originalMax, mm[1].originalMax)):
        raise SystemExit("phase 15 (a): the MinMax extrema differ between "
                         "the card and the CPU")
    # a component's sign is arbitrary (Spark, sklearn): align each column
    sign = np.sign(np.sum(pca[0].pc * pca[1].pc, axis=0))
    pc_err = float(np.abs(pca[0].pc - pca[1].pc * sign).max())
    ev_err = float(np.abs(pca[0].explainedVariance
                          - pca[1].explainedVariance).max())
    # the LR on the card pipeline's own feature rows (the prefix's
    # transform of the train rows, as the card's fit produced them): all
    # of them, and phase 7's reduced fit's first 20 000
    feats = PipelineModel(stages=card.getStages()[:5]).transform(train)
    rows = Frame({"features": to_host(feats["features"]),
                  "label": to_host(feats["label"])})
    lr_cpu = LogisticRegression(device="cpu", maxIter=C6_LR_ITERS).fit(rows)
    small = rows.slice(0, REDUCED_LBFGS_ROWS)
    small_gap = fit_gaps(
        LogisticRegression(device=card.getStages()[-1].device,
                           maxIter=C6_LR_ITERS).fit(small),
        LogisticRegression(device="cpu", maxIter=C6_LR_ITERS).fit(small),
    )["max_gap"]
    head = card.getStages()[-1]
    same, e2e = fit_gaps(head, lr_cpu), fit_gaps(head, cpu.getStages()[-1])
    lr_ctl = LogisticRegression(device=head.device,
                                maxIter=C6_LR_ITERS).fit(Frame({
                                    "features": tf32_round(rows["features"]),
                                    "label": rows["label"]}))
    with tf32_products():
        pipe_ctl = c6_pipeline(head.device).fit(train)
    control = {"history_gap": fit_gaps(lr_ctl, lr_cpu)["max_gap"],
               "pipeline_history_gap": fit_gaps(
                   pipe_ctl.getStages()[-1], cpu.getStages()[-1])["max_gap"]}
    auc = BinaryClassificationEvaluator().evaluate(card.transform(test))
    rec = {"card_fit_s": card_s, "cpu_fit_s": cpu_s,
           "pc_max_err_up_to_sign": pc_err, "sign_flips": int((sign < 0).sum()),
           "explained_variance_max_err": ev_err,
           "explained_variance_kept": float(
               pca[0].explainedVariance.sum()),
           "iterations": {"card": same["iterations"][0],
                          "cpu": same["iterations"][1],
                          "cpu_pipeline": e2e["iterations"][1]},
           "history_gap": same["max_gap"],
           "reduced_history_gap": small_gap,
           "pipeline_history_gap": e2e["max_gap"],
           "tf32_control": control,
           "auc": auc, "config1_auc": auc1}
    log(f"phase 15 (a) config-6 fit on {train.num_rows} rows: card "
        f"{card_s:.2f} s, CPU {cpu_s:.2f} s; MinMax extrema bitwise; PCA "
        f"k={C6_PCA_K} components within {pc_err:.3g} up to sign "
        f"({rec['sign_flips']} flipped; tolerance {C6_PCA_TOL}), "
        f"explainedVariance within {ev_err:.3g} (tolerance {C6_EV_TOL}; "
        f"kept {rec['explained_variance_kept']:.6f}); LR iterations "
        f"{rec['iterations']}, history gap on the same feature rows "
        f"{rec['history_gap']:.3g} of the start (tolerance {C6_LR_TOL}), on "
        f"their first {REDUCED_LBFGS_ROWS} {small_gap:.3g} (tolerance "
        f"{LBFGS_PREFIX_TOL}), the CPU pipeline's on its own features "
        f"{rec['pipeline_history_gap']:.3g} (tolerance {C6_E2E_TOL}); "
        f"the TF32 controls {control['history_gap']:.3g} and "
        f"{control['pipeline_history_gap']:.3g}; "
        f"held-out AUC {auc:.6f} (config 1: {auc1:.6f})")
    if pc_err > C6_PCA_TOL or ev_err > C6_EV_TOL or \
            rec["history_gap"] > C6_LR_TOL or \
            small_gap > LBFGS_PREFIX_TOL or \
            rec["pipeline_history_gap"] > C6_E2E_TOL:
        raise SystemExit(f"phase 15 (a): card and CPU fits part beyond the "
                         f"stated tolerances: {rec}")
    if min(rec["iterations"].values()) < 1:
        raise SystemExit(f"phase 15 (a): LR histories {rec['iterations']}")
    return rec


def c6_engine(dev, tmp: str, name: str, in_dir: str, sizes: list,
              model, test: Frame) -> dict:
    """One form's predictor, warmed as ``bench.py``'s ``make_engine``
    warms it: one throwaway engine batch, then every distinct file size
    straight through the predictor."""
    predictor = BatchPredictor(model, bucket_rows=BUCKET_FLOOR, device=dev)
    warm = StreamingQuery(
        predictor, FileStreamSource(in_dir),
        CsvDirSink(os.path.join(tmp, f"warm_{name}"), durable=False),
        os.path.join(tmp, f"warmckpt_{name}"), max_batch_offsets=1,
        wal_mode="append", pipeline_depth=1, device=dev)
    warm._run_one_batch()
    warm.stop()
    for c in sorted(set(sizes)):
        predictor.predict_frame(test.slice(0, c))
    return {"name": name, "predictor": predictor, "reps": []}


def c6_run(dev, tmp: str, eng: dict, in_dir: str, rep: int,
           stream_rows: int, n_files: int) -> None:
    """One timed serve of the whole stream by one form (serial engine,
    append WAL, one file a batch), as ``bench.py``'s ``run_once``."""
    name = eng["name"]
    out_dir = os.path.join(tmp, f"out_{name}_{rep}")
    q = StreamingQuery(
        eng["predictor"], FileStreamSource(in_dir),
        CsvDirSink(out_dir, durable=False),
        os.path.join(tmp, f"ckpt_{name}_{rep}"), max_batch_offsets=1,
        wal_mode="append", pipeline_depth=1, device=dev)
    t0 = time.perf_counter()
    n_done = q.process_available()
    dt = time.perf_counter() - t0
    rows = stream_rows if n_done == n_files else sum(
        p["numInputRows"] for p in q.recentProgress)
    transfers = q.pipeline_stats()["transfers"]
    q.stop()
    eng["reps"].append({"out_dir": out_dir, "batches": n_done, "rows": rows,
                        "dt": dt, "rows_per_s": rows / dt,
                        "transfers": transfers})


def c6_serve(dev, fitted, test: Frame, in_dir: str, sizes: list,
             work: str) -> dict:
    """(a)'s serve: bench config 6's stream (two passes over the held-out
    rows, files of 2 048 / 1 024 / 512 rows) through the staged and the
    fused form, ``C6_REPS`` reps each in turns, ``SNTC_SERVE_HOST_ROWS=0``
    (the staged head runs the device program the fused one embeds) and
    the roofline plane armed; see the module docs for the checks."""
    import pyarrow as pa

    tmp = os.path.join(work, "c6")
    stream_rows, n_files = sum(sizes), len(sizes)
    staged = PipelineModel(stages=fitted.getStages()[1:])
    fused = compile_pipeline(staged)
    segments = fused_segments(fused)
    if len(segments) != 1 or len(segments[0].fused_stages) != 4:
        raise SystemExit(f"phase 15 (a): fused form {fused.getStages()}")
    arrow_cpus = pa.cpu_count()
    pa.set_cpu_count(1)  # bench.py's intra-op pinning
    try:
        engines = [c6_engine(dev, tmp, "staged", in_dir, sizes, staged, test),
                   c6_engine(dev, tmp, "fused", in_dir, sizes, fused, test)]
        seg = segments[0]
        before = {k: getattr(seg, k) for k in (
            "compile_events", "uploads", "device_binds", "downloads",
            "fallbacks", "invocations")}
        reset_launches()
        for rep in range(C6_REPS):
            for eng in engines:
                c6_run(dev, tmp, eng, in_dir, rep, stream_rows, n_files)
        launches = dict(LAUNCHES)
        shapes = dict(PAD_LAUNCH_SHAPES)
    finally:
        pa.set_cpu_count(arrow_cpus)
    delta = {k: getattr(seg, k) - v for k, v in before.items()}
    fused_batches = sum(r["batches"] for r in engines[1]["reps"])
    padded = sum(bucket_rows_for(n, BUCKET_FLOOR) != n for n in sizes)
    want_pad = padded * C6_REPS * len(engines)
    ledger = {k: sum(r["transfers"][k] for r in engines[1]["reps"])
              for k in ("uploads", "downloads")}
    evidence = {
        "fused_segments": len(segments),
        "fused_stages": len(seg.fused_stages),
        "segment_uploads_per_batch":
            (delta["uploads"] + delta["device_binds"]) / fused_batches,
        "uploads_per_batch": ledger["uploads"] / fused_batches,
        "downloads_per_batch": ledger["downloads"] / fused_batches,
        "segment_downloads_per_batch": delta["downloads"] / fused_batches,
        "fallbacks": seg.fallbacks,
        "recompiles_after_warmup": delta["compile_events"],
        "pad_assemble": launches["pad_assemble"],
        "padded_dispatches": want_pad,
    }
    files = [sink_files(r["out_dir"]) for e in engines for r in e["reps"]]
    evidence["sink_match"] = all(f == files[0] for f in files[1:])
    if any(r["batches"] != n_files for e in engines for r in e["reps"]) or \
            evidence["uploads_per_batch"] != 1.0 or \
            evidence["downloads_per_batch"] != 1.0 or \
            evidence["segment_uploads_per_batch"] != 1.0 or \
            evidence["segment_downloads_per_batch"] != 1.0 or \
            evidence["fallbacks"] != 0 or \
            evidence["recompiles_after_warmup"] != 0 or \
            not evidence["sink_match"] or want_pad < 1 or \
            launches != {"forest_traversal": 0, "tree_hist": 0,
                         "pad_assemble": want_pad}:
        raise SystemExit(f"phase 15 (a): {evidence}, launches {launches}")

    def median(eng):
        reps = sorted(eng["reps"], key=lambda r: r["rows_per_s"])
        return reps[len(reps) // 2]["rows_per_s"]

    roof = fusion_stats(fused).get("roofline") or {}
    return {"files": n_files, "stream_rows": stream_rows, "sizes": sizes,
            "evidence": evidence,
            "rows_per_s": {e["name"]: median(e) for e in engines},
            "reps": {e["name"]: [round(r["rows_per_s"], 1)
                                 for r in e["reps"]] for e in engines},
            "roofline": roof, "pad_launch_shapes": shapes,
            "fused": fused}


def c6_pads(dev, fused, test: Frame) -> dict:
    """(b): config 6's fused pipeline served in this process at
    ``C6_PAD_ROWS`` rows (both pad: 1 000 -> 1 024, 3 000 -> 4 096), the
    launches counted from 0; each launch's shape is then measured by
    ``pads_of``."""
    predictor = BatchPredictor(fused, bucket_rows=BUCKET_FLOOR, device=dev)
    reset_launches()
    for n in C6_PAD_ROWS:
        out = predictor.predict_frame(test.slice(0, n))
        if out.num_rows != n:
            raise SystemExit(f"phase 15 (b): {out.num_rows} rows of {n}")
    launches, shapes = dict(LAUNCHES), dict(PAD_LAUNCH_SHAPES)
    if launches["pad_assemble"] != len(C6_PAD_ROWS):
        raise SystemExit(f"phase 15 (b): launches {launches}")
    return {"launches": launches, "pad_launch_shapes": shapes}


def crossover(dev, trained1: dict, test: Frame) -> dict:
    """(c): config 1's trained LR pipeline as a plain head (unfused) at
    bench config 5's sizes, with ``SNTC_SERVE_HOST_ROWS`` unset (no head
    dispatch, no copy, no launch: the host path) and at 0 (the card):
    predictions agree on at least ``CROSS_AGREE`` of the rows and the
    probabilities within ``CROSS_PROB_TOL``; each size's batch latency in
    both placements (median of ``CROSS_REPS`` calls)."""
    from sntc_tpu_torch.utils.profiling import TransferLedger, ledger_scope

    model, _, _ = serving_form(load_model(trained1["model_dir"], device=dev),
                               "label", False)
    head = model.getStages()[-2]
    dispatches = [0]
    dev_fn = head._predict_all_dev

    def counting(X):
        dispatches[0] += 1
        return dev_fn(X)

    head._predict_all_dev = counting
    predictor = BatchPredictor(model, bucket_rows=BUCKET_FLOOR, device=dev)
    batches = [test.slice(0, n) for n in STREAM_SIZES]
    out = {"sizes": list(STREAM_SIZES)}
    for tag, value in (("host", None), ("card", 0)):
        with environ(SNTC_SERVE_HOST_ROWS=value):
            led = TransferLedger()
            dispatches[0] = 0
            reset_launches()
            with ledger_scope(led):
                outs = [predictor.predict_frame(b) for b in batches]
            out[tag] = {"dispatches": dispatches[0],
                        "launches": dict(LAUNCHES),
                        "transfers": led.snapshot(),
                        "outs": outs}
            lat = []
            for b in batches:
                ms = []
                for _ in range(CROSS_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    predictor.predict_frame(b)
                    ms.append((time.perf_counter() - t0) * 1e3)
                lat.append(float(np.median(ms)))
            out[tag]["latency_ms"] = lat
    head._predict_all_dev = dev_fn
    host, card = out["host"], out["card"]
    if host["dispatches"] != 0 or any(host["launches"].values()) or \
            host["transfers"]["uploads"] or host["transfers"]["downloads"]:
        raise SystemExit(f"phase 15 (c): the host placement dispatched or "
                         f"copied: {host}")
    if card["dispatches"] != len(batches):
        raise SystemExit(f"phase 15 (c): the card placement dispatched "
                         f"{card['dispatches']} times")
    agree, err = [], 0.0
    for a, b in zip(host.pop("outs"), card.pop("outs")):
        pa_, pb = to_host(a["prediction"]), to_host(b["prediction"])
        agree.append(float((pa_ == pb).mean()))
        err = max(err, float(np.abs(to_host(a["probability"]).astype(
            np.float64) - to_host(b["probability"])).max()))
    out["agreement"], out["prob_max_err"] = min(agree), err
    if out["agreement"] < CROSS_AGREE or err > CROSS_PROB_TOL:
        raise SystemExit(f"phase 15 (c): host and card agree on "
                         f"{out['agreement']} of the rows, probabilities "
                         f"{err} apart")
    return out


def crossover_sweep(dev) -> dict:
    """(c)'s sweep: config 1's LR head (78 features, binary) and config
    2's MLP head (``MLP_LAYERS``), weights from ``SEED``, each served by
    ``transform`` on host float32 rows at every ``CROSS_SWEEP_ROWS`` size
    on the host (``SNTC_SERVE_HOST_ROWS`` at the size) and on the card
    (0, upload and copy back included): the median ms of ``SWEEP_REPS``
    calls after one warm call, and where the default rule (the variable
    unset: the head's ``HOST_SERVE_ROWS``) places the batch."""
    from sntc_tpu_torch.models.logistic_regression import (
        LogisticRegressionModel,
    )
    from sntc_tpu_torch.models.mlp import (
        MultilayerPerceptronClassificationModel,
        _n_weights,
    )

    rng = np.random.default_rng(SEED)
    d = MLP_LAYERS[0]
    heads = {
        "lr": LogisticRegressionModel(
            rng.normal(0, 0.1, (2, d)).astype(np.float32),
            np.zeros(2, np.float32), True, device=dev),
        "mlp": MultilayerPerceptronClassificationModel(
            rng.normal(0, 0.1, _n_weights(tuple(MLP_LAYERS))), MLP_LAYERS,
            device=dev),
    }
    X = rng.standard_normal((max(CROSS_SWEEP_ROWS), d)).astype(np.float32)
    out = {}
    for name, head in heads.items():
        rec = {"default_rows": head.HOST_SERVE_ROWS, "host_ms": [],
               "card_ms": [], "rule": []}
        for n in CROSS_SWEEP_ROWS:
            frame = Frame({"features": X[:n]})
            for tag, value in (("host", n), ("card", 0)):
                with environ(SNTC_SERVE_HOST_ROWS=value):
                    head.transform(frame)
                    ms = []
                    for _ in range(SWEEP_REPS):
                        t0 = time.perf_counter()
                        head.transform(frame)
                        ms.append((time.perf_counter() - t0) * 1e3)
                rec[f"{tag}_ms"].append(float(np.median(ms)))
            rec["rule"].append("host" if n <= head.HOST_SERVE_ROWS
                               else "card")
        out[name] = rec
        log(f"phase 15 (c) crossover sweep, {name} head at "
            f"{list(CROSS_SWEEP_ROWS)} rows: host ms "
            f"{[round(x, 4) for x in rec['host_ms']]}, card ms "
            f"{[round(x, 4) for x in rec['card_ms']]} (median of "
            f"{SWEEP_REPS}); the default rule (HOST_SERVE_ROWS "
            f"{rec['default_rows']}) places {rec['rule']} "
            f"[{gpu_line()}]")
    out["sizes"] = list(CROSS_SWEEP_ROWS)
    return out


def obs_command(dev, model_dir: str, in_dir: str, work: str):
    """(d): ``serve --once --metrics-out M --trace-out T --device-trace D``
    in its own process on (a)'s saved pipeline over the stream's first
    ``C6_OBS_FILES`` files, ``SNTC_OBS_COST_ANALYSIS=1``; started here and
    checked by :func:`check_obs_command`."""
    watch = os.path.join(work, "in15d")
    os.makedirs(watch)
    for name in sorted(os.listdir(in_dir))[:C6_OBS_FILES]:
        shutil.copyfile(os.path.join(in_dir, name), os.path.join(watch, name))
    paths = {k: os.path.join(work, f"obs15.{k}")
             for k in ("prom", "trace.json")}
    paths["device"] = os.path.join(work, "obs15_device")
    cmd = serve_args(model_dir, watch, os.path.join(work, "out15d"),
                     os.path.join(work, "ckpt15d"), dev, 1) + [
        "--once", "--metrics-out", paths["prom"],
        "--trace-out", paths["trace.json"],
        "--device-trace", paths["device"]]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=env_with(SNTC_OBS_COST_ANALYSIS="1"))
    return proc, paths


def check_obs_command(proc, paths: dict) -> dict:
    """(d)'s checks: the command exits 0; ``M`` parses as Prometheus text
    and holds ``sntc_mfu_ratio{segment="0"}``; ``T`` is Chrome-trace JSON
    with ``stream.read``, ``fuse.dispatch``, ``fuse.finalize``,
    ``sink.deliver`` and ``stream.commit`` once a batch; ``D`` holds a
    profiler trace with events."""
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"phase 15 (d): serve exited {proc.returncode}:\n"
                         f"{err}")
    summary = json.loads(out.strip().splitlines()[-1])
    batches = summary["batches"]
    series = {}
    with open(paths["prom"]) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            name, value = line.rsplit(" ", 1)
            series[name] = float(value)  # every sample line parses
    mfu = series.get('sntc_mfu_ratio{segment="0"}')
    with open(paths["trace.json"]) as f:
        trace = json.load(f)
    names = [e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"]
    counts = {n: names.count(n) for n in (
        "stream.read", "fuse.dispatch", "fuse.finalize", "sink.deliver",
        "stream.commit")}
    dfile = os.path.join(paths["device"], "device_trace.json")
    with open(dfile) as f:
        dev_events = len(json.load(f).get("traceEvents", []))
    rec = {"batches": batches, "mfu_ratio": mfu,
           "mfu_bw_ratio": series.get('sntc_mfu_bw_ratio{segment="0"}'),
           "metric_samples": len(series), "span_counts": counts,
           "device_trace_events": dev_events,
           "roofline": (summary["fusion"] or {}).get("roofline")}
    if batches != C6_OBS_FILES or mfu is None or \
            any(c != batches for c in counts.values()) or dev_events < 1:
        raise SystemExit(f"phase 15 (d): {rec}")
    return rec


def fused_serve(dev, data1: dict, trained1: dict, work: str) -> dict:
    """Phase 15: bench config 6 on the card (see the module docs).  (d)'s
    process runs beside the CPU fit of (a), before anything is timed."""
    t0 = time.perf_counter()
    train, test = data1["train"], data1["test"]
    with environ(SNTC_SERVE_HOST_ROWS=0, SNTC_OBS_COST_ANALYSIS=1):
        card, card_s = timed(lambda: c6_pipeline(dev).fit(train))
        model_dir = save_model(card, os.path.join(work, "model15"))
        in_dir = os.path.join(work, "c6", "in")
        sizes = write_bench_stream(in_dir, test, passes=C6_PASSES)
        proc, paths = obs_command(dev, model_dir, in_dir, work)
        try:
            fit = c6_compare(card, card_s, data1, trained1["areaUnderROC"])
        finally:
            obs = check_obs_command(proc, paths)
        served = c6_serve(dev, card, test, in_dir, sizes, work)
        pads = c6_pads(dev, served.pop("fused"), test)
    cross = crossover(dev, trained1, test)
    cross["sweep"] = crossover_sweep(dev)
    control = fit["tf32_control"]
    if control["history_gap"] <= C6_LR_TOL or \
            control["pipeline_history_gap"] <= C6_E2E_TOL:
        raise SystemExit(f"phase 15 (a): the TF32 controls {control} lie "
                         f"within C6_LR_TOL {C6_LR_TOL} / C6_E2E_TOL "
                         f"{C6_E2E_TOL}: the tolerances do not part them "
                         f"from a full-f32 fit")
    kernels = pads_of(dev, served["pad_launch_shapes"], False)
    kernels += pads_of(dev, pads["pad_launch_shapes"], False)
    return {"fit": fit, "serve": served, "pads": pads,
            "crossover": cross, "obs": obs, "kernels": kernels,
            "seconds": time.perf_counter() - t0}


def report_phase15(p15: dict, card: str) -> None:
    """Phase 15's lines: the forms' rows/s and transfers, the segment's
    roofline, (b)'s and (c)'s numbers, (d)'s files, each kernel shape, one
    JSON line."""
    s = p15["serve"]
    ev = s["evidence"]
    log(f"phase 15 (a) bench config 6 stream: {s['files']} files, "
        f"{s['stream_rows']} rows, {C6_REPS} reps a form in turns: median "
        f"rows/s staged {s['rows_per_s']['staged']:.1f}, fused "
        f"{s['rows_per_s']['fused']:.1f} (reps {s['reps']}); fused "
        f"{ev['fused_segments']} segment of {ev['fused_stages']} stages, "
        f"{ev['uploads_per_batch']} upload / {ev['downloads_per_batch']} "
        f"download a batch, {ev['fallbacks']} fallbacks, "
        f"{ev['recompiles_after_warmup']} new signatures after warmup, "
        f"sinks byte-identical {ev['sink_match']}; pad_assemble "
        f"{ev['pad_assemble']} launches for {ev['padded_dispatches']} "
        f"padded dispatches at {s['pad_launch_shapes']} [{card}]")
    for sig, r in sorted(s["roofline"].items()):
        log(f"phase 15 (a) segment roofline {sig}: {r['flops']:.0f} FLOP, "
            f"{r['bytes_accessed']:.0f} B, {r['invocations']} dispatches in "
            f"{r['seconds']:.4f} s: {r.get('achieved_bw', 0.0):.4g} B/s "
            f"(bw_util {r.get('bw_util')}), {r.get('achieved_flops', 0.0):.4g}"
            f" FLOP/s (mfu {r.get('mfu')} of bf16, {r.get('mfu_f32')} of "
            f"f32), peak_source {r['peak_source']} [{card}]")
    c = p15["crossover"]
    log(f"phase 15 (c) the host-serve crossover, config 1's LR at "
        f"{c['sizes']} rows: unset {c['host']['dispatches']} dispatches, "
        f"launches {c['host']['launches']}, transfers "
        f"{c['host']['transfers']}; at 0 {c['card']['dispatches']} "
        f"dispatches; predictions agree on {c['agreement']:.6f} (floor "
        f"{CROSS_AGREE}), probabilities within {c['prob_max_err']:.3g} "
        f"(tolerance {CROSS_PROB_TOL}); batch ms (median of {CROSS_REPS}) "
        f"host {[round(x, 4) for x in c['host']['latency_ms']]}, card "
        f"{[round(x, 4) for x in c['card']['latency_ms']]} [{card}]")
    o = p15["obs"]
    log(f"phase 15 (d) serve --once with --metrics-out, --trace-out, "
        f"--device-trace: {o['batches']} batches, sntc_mfu_ratio "
        f"{o['mfu_ratio']}, sntc_mfu_bw_ratio {o['mfu_bw_ratio']}, "
        f"{o['metric_samples']} samples; spans {o['span_counts']}; "
        f"{o['device_trace_events']} profiler events [{card}]")
    for k in p15["kernels"]:
        log(f"phase 15 {k['name']} {k['shape']}: {k['ms']:.4f} ms a call, "
            f"{k['device_ms']:.4f} ms of device time a launch (plain "
            f"{k['plain_ms']:.4f} ms; {k['library_call']} "
            f"{k['library_ms']:.4f} ms a call; bound {k['bound_ms']:.4f} ms "
            f"by {k['bound_by']}); {k['launches']} launches at this shape "
            f"in its run, max abs error {k['max_abs_err']} [{card}]")
    log("phase 15 " + json.dumps({
        "phase": 15, "card": card, "seconds": round(p15["seconds"], 3),
        "fit": p15["fit"], "rows_per_s": s["rows_per_s"], "evidence": ev,
        "crossover": {k: c[k] for k in ("agreement", "prob_max_err",
                                        "sweep")},
        "obs": {k: o[k] for k in ("mfu_ratio", "span_counts")}},
        default=str))


# -- phase 16: live capture serving ------------------------------------------

C9_ROWS = 62_500  # bench.py:252's rows; n_flows = rows // 4 (bench.py:1417)
C9_SEED = 7  # bench.py's SEED
C9_FILES = 61  # max(2, n_flows // 256)
C9_FLOWS_PER_FILE = 256
C9_PACKETS_PER_FLOW = 6
C9_FILE_GAP_S = 30.0
C9_DEFER = 0.1
C9_FLOW_TIMEOUT = 5.0
C9_LATENESS = 35.0
C9_REPS = 1  # bench.py:1369 runs 3: cut to hold the smoke's time
C9_LR_ITERS = 20
#: the flow block of bench_runs.jsonl:102 (the JAX package's bench run)
C9_RECORD = {"feature_rows": 23_296, "packets": 93_696, "flows": 15_616,
             "out_of_order": 8_503, "late_records": 616,
             "evictions": {"watermark": 15_617}, "state_packets_final": 1,
             "snapshots_published": 62}
C9_KILL_AFTER = 2  # flow.emit on the 3rd get_batch (chaos matrix :95-100)
C15_FILES = 60  # min(64, rows // 1024) less its remainder by 4
C15_FLOWS_PER_FILE = 192
C15_RECORDS_PER_FLOW = 4
C15_SEAL_EVERY = 4
C15_REPS = 1  # bench.py runs 3: cut to hold the smoke's time
C15_FEATURE_ROWS = 46_080  # bench_runs.jsonl:113
C15_KILL_SITE = "ingress.spool"
C15_KILL_AFTER = 1  # the 2nd seal dies before its atomic write
TCP_ROWS = 2_000  # rows framed over the TCP listener
P16_PAD_ROWS = ((384, 512), (797, 1024), (768, 1024))  # f32 [n, 78] -> target
P16_WAIT_S = 180.0


def c9_data() -> dict:
    """Bench config 9's flows: the port's ``generate_frame(62 500,
    seed=7)`` cleaned, relabelled benign/attack and split 0.8/0.2 with
    seed 0 (``bench.py:265-280``)."""
    raw = generate_frame(C9_ROWS, seed=C9_SEED, min_class_fraction=0.005)
    clean = clean_flows(raw)
    clean = clean.with_column("Label", np.where(
        clean["Label"].astype(str) == "BENIGN", "benign", "attack",
    ).astype(object))
    train, test = clean.random_split([0.8, 0.2], seed=0)
    return {"train": train, "test": test}


def c9_pipeline(device) -> Pipeline:
    """StringIndexer (skip) -> VectorAssembler(78) -> StandardScaler
    (withMean) -> LogisticRegression(maxIter=20), as ``bench.py:1405``
    builds configs 9 and 15."""
    return Pipeline(stages=[
        StringIndexer(inputCol="Label", outputCol="label",
                      handleInvalid="skip"),
        VectorAssembler(inputCols=CICIDS2017_FEATURES,
                        outputCol="rawFeatures"),
        StandardScaler(device=device, inputCol="rawFeatures",
                       outputCol="features", withMean=True),
        LogisticRegression(device=device, maxIter=C9_LR_ITERS),
    ])


def sink_predictions(out_dir: str) -> np.ndarray:
    """The ``prediction`` column of every batch file of a sink, in batch
    order (header-only files add nothing)."""
    import pyarrow.csv as pacsv

    parts = []
    for p in sorted(glob.glob(os.path.join(out_dir, "batch_*.csv"))):
        t = pacsv.read_csv(p)
        if t.num_rows:
            parts.append(np.asarray(t.column("prediction").to_numpy(),
                                    np.float64))
    return np.concatenate(parts) if parts else np.zeros(0)


def committed_ranges(ckpt: str) -> dict:
    """Committed batch ids and their offset ranges, from a files WAL."""
    out = {}
    for p in sorted(glob.glob(os.path.join(ckpt, "commits", "*.json"))):
        with open(p) as f:
            rec = json.load(f)
        out[int(os.path.basename(p)[:-5])] = (rec["start"], rec["end"])
    return out


def check_pad_shapes(dev, shapes: dict, what: str) -> float:
    """Every ``pad_assemble`` launch shape of a run, the launch taken
    again on random float32 columns (the column-major block the dispatch
    uploads) and held bitwise against its plain version; the largest
    error (0)."""
    worst = 0.0
    for key in sorted(shapes):
        n, c = (int(v) for v in key.split("]")[0][1:].split(", "))
        dtype = torch.float64 if " f64 " in key else torch.float32
        target = int(key.split("-> ")[1])
        a = torch.randn((c, n), dtype=dtype, device=dev).t()
        out, ref = pad_rows_cuda(a, target), pad_rows_reference(a, target)
        if not torch.equal(out, ref):
            raise SystemExit(f"{what}: pad_assemble {key} differs from its "
                             "plain version")
        worst = max(worst, (out - ref).abs().max().item())
    return worst


def c16_passes(dev, predictor, make_source, tmp: str, name: str,
               n_pass: int) -> list:
    """``n_pass`` timed serves of a stream by the serial engine (append
    WAL, one file a batch, a non-durable prediction sink), as
    ``bench.py``'s ``timed_pass``; each pass's seconds, sink and source."""
    out = []
    for rep in range(n_pass):
        source = make_source(rep)
        out_dir = os.path.join(tmp, f"out_{name}_{rep}")
        q = StreamingQuery(
            predictor, source,
            CsvDirSink(out_dir, columns=["prediction"], durable=False),
            os.path.join(tmp, f"ckpt_{name}_{rep}"), max_batch_offsets=1,
            wal_mode="append", pipeline_depth=1, device=dev)
        t0 = time.perf_counter()
        batches = q.process_available()
        dt = time.perf_counter() - t0
        transfers = q.pipeline_stats()["transfers"]
        sizes = [p["numInputRows"] for p in q.recentProgress]
        q.stop()
        source.close()
        out.append({"seconds": dt, "out_dir": out_dir, "source": source,
                    "batches": batches, "transfers": transfers,
                    "sizes": sizes})
    return out


def one_round_trip(evidence: dict) -> bool:
    """One upload and one download a padded batch, by the transfer
    ledger (the CPU keeps no ledger)."""
    return (evidence["uploads_per_padded_batch"] == 1.0
            and evidence["downloads_per_padded_batch"] == 1.0)


def c9_serve(dev, data: dict, work: str) -> dict:
    """(a): bench config 9 in this process (``bench.py:1378-1540``)."""
    import pyarrow as pa
    import pyarrow.csv as pacsv

    tmp = os.path.join(work, "c9")
    fitted = c9_pipeline(dev).fit(data["train"])
    model_dir = save_model(fitted, os.path.join(work, "model16"))
    # compile_serving folds the scaler into the head, as the JAX
    # compiler does (bench.py:1408): the assembler and the head's device
    # program remain, no fused segment
    served = compile_pipeline(PipelineModel(stages=fitted.getStages()[1:]))
    form = [type(st).__name__ for st in served.getStages()]
    if form != ["VectorAssembler", "LogisticRegressionModel"] or \
            fused_segments(served):
        raise SystemExit(f"phase 16 (a): serving form {form}")
    predictor = BatchPredictor(served, bucket_rows=BUCKET_FLOOR, device=dev)
    cap_dir = os.path.join(tmp, "in_cap")
    info = write_capture_stream(
        cap_dir, n_files=C9_FILES, flows_per_file=C9_FLOWS_PER_FILE,
        packets_per_flow=C9_PACKETS_PER_FLOW, seed=C9_SEED,
        file_gap_s=C9_FILE_GAP_S, defer_fraction=C9_DEFER, flush=True)

    def flow_source(rep, state=True):
        return FlowCaptureSource(
            cap_dir, format="pcap", flow_timeout=C9_FLOW_TIMEOUT,
            allowed_lateness=C9_LATENESS,
            state_dir=(os.path.join(tmp, f"ckpt_cap_{rep}", "flow_state")
                       if state else None))

    arrow_cpus = pa.cpu_count()
    pa.set_cpu_count(1)  # bench.py's intra-op pinning
    try:
        # the untimed reference pass: the frames the CSV stream serves,
        # every bucket warmed through the shared predictor
        ref = flow_source("ref", state=False)
        emitted = []
        for i in range(ref.latest_offset()):
            f = ref.get_batch(i, i + 1)
            if f.num_rows:
                emitted.append(f)
                predictor.predict_frame(f)
        ref_stats = ref.flow_stats()
        ref.close()
        csv_dir = os.path.join(tmp, "in_csv")
        os.makedirs(csv_dir)
        for k, f in enumerate(emitted):
            pacsv.write_csv(f.select(CICIDS2017_FEATURES).to_arrow(),
                            os.path.join(csv_dir, f"part_{k:05d}.csv"))
        c16_passes(dev, predictor, lambda r: FileStreamSource(csv_dir),
                   tmp, "csvwarm", 1)
        events = predictor.compile_events
        reset_launches()
        cap, csv = [], []
        for rep in range(C9_REPS):  # interleaved, as the bench does
            cap += c16_passes(dev, predictor, lambda r, rep=rep:
                              flow_source(rep), tmp, f"cap{rep}", 1)
            csv += c16_passes(dev, predictor, lambda r: FileStreamSource(
                csv_dir), tmp, f"csv{rep}", 1)
        launches, shapes = dict(LAUNCHES), dict(PAD_LAUNCH_SHAPES)
    finally:
        pa.set_cpu_count(arrow_cpus)
    sizes = [f.num_rows for f in emitted]
    rows = sum(sizes)
    padded = sum(bucket_rows_for(n, BUCKET_FLOOR) != n for n in sizes)
    want_pad = padded * 2 * C9_REPS
    ledger = {k: sum(p["transfers"][k] for p in cap + csv)
              for k in ("uploads", "downloads", "dispatches")}
    flow_stats = cap[-1]["source"].flow_stats()
    sinks = [sink_predictions(p["out_dir"]) for p in cap + csv]
    evidence = {
        "capture_files": len(info["files"]),
        "packets": int(info["packets"].shape[0]),
        "flows": info["n_flows"],
        "feature_rows": rows,
        "nonempty_batches": len(sizes),
        "batch_rows": [min(sizes), int(np.median(sizes)), max(sizes)],
        "out_of_order": ref_stats["out_of_order"],
        "late_records": ref_stats["late_records"],
        "evictions": ref_stats["evictions"],
        "state_packets_final": flow_stats["packets"],
        "snapshots_published": [p["source"].flow_stats()[
            "snapshots_published"] for p in cap],
        "parser": flow_stats["parser"],
        "sink_match": all(s.shape == sinks[0].shape
                          and np.array_equal(s, sinks[0])
                          for s in sinks[1:]) and len(sinks[0]) == rows,
        "serving_form": form,
        "transfers": ledger,
        # a padded batch (a tensor) dispatches the head's device program
        # with one upload and one download; an unpadded one is host
        # features, served on the host under the LR's crossover
        "uploads_per_padded_batch": ledger["uploads"] / max(want_pad, 1),
        "downloads_per_padded_batch":
            ledger["downloads"] / max(want_pad, 1),
        # the empty batches' shape (no frame of the warmup is empty)
        "new_shapes_after_warmup": predictor.compile_events - events,
        "pad_assemble": launches["pad_assemble"],
        "padded_dispatches": want_pad,
        "pad_max_abs_err": check_pad_shapes(dev, shapes, "phase 16 (a)"),
    }
    got = {k: evidence[k] for k in C9_RECORD if k != "snapshots_published"}
    want = {k: v for k, v in C9_RECORD.items()
            if k != "snapshots_published"}
    if got != want or evidence["snapshots_published"] != [
            C9_RECORD["snapshots_published"]] * C9_REPS or \
            evidence["parser"] != "native" or not evidence["sink_match"] \
            or evidence["nonempty_batches"] != C9_FILES \
            or not one_round_trip(evidence) or want_pad < 1 \
            or launches != {"forest_traversal": 0, "tree_hist": 0,
                            "pad_assemble": want_pad}:
        raise SystemExit(f"phase 16 (a): {evidence}, launches {launches}, "
                         f"want {C9_RECORD}")

    def median(passes):
        return sorted(p["seconds"] for p in passes)[len(passes) // 2]

    t_cap, t_csv = median(cap), median(csv)
    return {"model_dir": model_dir, "cap_dir": cap_dir, "predictor":
            predictor, "evidence": evidence, "pad_launch_shapes": shapes,
            "launches": launches, "cap_sink": sinks[0],
            "rows_per_s": {"capture": rows / t_cap, "csv": rows / t_csv},
            "packets_per_s": evidence["packets"] / t_cap,
            "capture_vs_csv": t_csv / t_cap,
            "reps_s": {"capture": [round(p["seconds"], 4) for p in cap],
                       "csv": [round(p["seconds"], 4) for p in csv]}}


def c15_serve(dev, predictor, work: str) -> dict:
    """(c): bench config 15 in this process (``bench.py:2864-3080``): the
    directory pass and the socket pass over the same NetFlow payloads,
    interleaved, through (a)'s predictor, beside the kill leg's and the
    TCP run's processes (its rates are printed, ungated)."""
    import socket as socketlib

    tmp = os.path.join(work, "c15")
    cap_dir = os.path.join(tmp, "in_cap")
    info = write_capture_stream(
        cap_dir, n_files=C15_FILES, flows_per_file=C15_FLOWS_PER_FILE,
        packets_per_flow=C15_RECORDS_PER_FLOW, seed=C9_SEED,
        format="netflow", flush=False)
    payloads = [open(p, "rb").read() for p in info["files"]]
    if any(len(p) > 60_000 for p in payloads):
        raise SystemExit("phase 16 (c): a capture file exceeds a datagram")
    ref = NetFlowDirSource(cap_dir)
    sizes = []
    for i in range(ref.latest_offset()):
        f = ref.get_batch(i, i + 1)
        sizes.append(f.num_rows)
        predictor.predict_frame(f)
    ref.close()
    c16_passes(dev, predictor, lambda r: NetFlowDirSource(cap_dir), tmp,
               "dirwarm", 1)

    def socket_pass(rep):
        spool_dir = os.path.join(tmp, f"spool_{rep}")
        out_dir = os.path.join(tmp, f"out_sock_{rep}")
        source, listeners = build_ingress(
            spool_dir, listen_udp=0, seal_every=C15_SEAL_EVERY,
            seal_idle_s=0.05, ring=max(64, 2 * len(payloads)),
            keep_files=10 ** 6)
        q = StreamingQuery(
            predictor, source,
            CsvDirSink(out_dir, columns=["prediction"], durable=False),
            os.path.join(tmp, f"ckpt_sock_{rep}"), max_batch_offsets=1,
            wal_mode="append", pipeline_depth=1, device=dev)
        wire_committed_offset(source, q.committed_end)
        lst = listeners[0].start()
        spool = lst.spool
        tx = socketlib.socket(socketlib.AF_INET, socketlib.SOCK_DGRAM)
        t0 = time.perf_counter()
        try:
            for i, payload in enumerate(payloads):
                tx.sendto(payload, ("127.0.0.1", lst.port))
                limit = time.time() + 60.0
                while spool.stats.received < i - 3:
                    if time.time() > limit:
                        raise SystemExit(f"phase 16 (c): receiver stalled "
                                         f"at {i}: {spool.stats.snapshot()}")
                    time.sleep(0.0002)
            n_sealed = len(payloads) // C15_SEAL_EVERY
            limit = time.time() + 300.0
            while q.committed_end() < n_sealed:
                if q.process_available() == 0:
                    time.sleep(0.0005)
                if time.time() > limit:
                    raise SystemExit("phase 16 (c): socket pass never "
                                     f"committed: {spool.stats.snapshot()}")
            dt = time.perf_counter() - t0
            transfers = q.pipeline_stats()["transfers"]
            batch_rows = [p["numInputRows"] for p in q.recentProgress]
        finally:
            tx.close()
            lst.drain(timeout_s=10.0)
            q.stop()
            source.close()
        return {"seconds": dt, "out_dir": out_dir, "sizes": batch_rows,
                "stats": spool.stats.snapshot(), "transfers": transfers}

    reset_launches()
    sock, dirs = [], []
    for rep in range(C15_REPS):
        sock.append(socket_pass(rep))
        dirs += c16_passes(dev, predictor, lambda r: NetFlowDirSource(
            cap_dir), tmp, f"dir{rep}", 1)
    launches, shapes = dict(LAUNCHES), dict(PAD_LAUNCH_SHAPES)
    rows = sum(sizes)
    sinks = [sink_predictions(p["out_dir"]) for p in sock + dirs]
    # the directory pass serves a file a batch, the socket pass a spool
    # file (C15_SEAL_EVERY datagrams) a batch
    want_pad = sum(bucket_rows_for(n, BUCKET_FLOOR) != n
                   for p in sock + dirs for n in p["sizes"])
    evidence = {
        "capture_files": len(payloads), "records":
            int(info["records"].shape[0]), "feature_rows": rows,
        "file_rows": [min(sizes), max(sizes)],
        "socket_batch_rows": sorted(set(sock[0]["sizes"])),
        "received": [p["stats"]["received"] for p in sock],
        "spooled": [p["stats"]["spooled"] for p in sock],
        "dropped": [p["stats"]["dropped"] for p in sock],
        "sink_match": all(np.array_equal(s, sinks[0]) for s in sinks[1:])
        and len(sinks[0]) == rows,
        "pad_assemble": launches["pad_assemble"],
        "padded_dispatches": want_pad,
        "pad_max_abs_err": check_pad_shapes(dev, shapes, "phase 16 (c)"),
    }
    if rows != C15_FEATURE_ROWS or not evidence["sink_match"] \
            or evidence["received"] != [len(payloads)] * C15_REPS \
            or evidence["spooled"] != [len(payloads)] * C15_REPS \
            or any(evidence["dropped"]) or want_pad < 1 \
            or launches != {"forest_traversal": 0, "tree_hist": 0,
                            "pad_assemble": want_pad}:
        raise SystemExit(f"phase 16 (c): {evidence}, launches {launches}")

    def median(passes):
        return sorted(p["seconds"] for p in passes)[len(passes) // 2]

    t_sock, t_dir = median(sock), median(dirs)
    return {"cap_dir": cap_dir, "evidence": evidence,
            "pad_launch_shapes": shapes, "dir_sink": sinks[-1],
            "rows_per_s": {"socket": rows / t_sock, "directory": rows / t_dir},
            "socket_vs_dir": t_dir / t_sock,
            "reps_s": {"socket": [round(p["seconds"], 4) for p in sock],
                       "directory": [round(p["seconds"], 4) for p in dirs]}}


#: the serve command with a fault armed after N calls of its site (the
#: SNTC_FAULTS grammar fires on the first call), as the JAX chaos
#: harness arms its workers
ARMED_SERVE = ("import sys; from sntc_tpu_torch.resilience import arm; "
               "from sntc_tpu_torch.app import main; "
               "arm(sys.argv[1], kind='kill', after=int(sys.argv[2]), "
               "times=1); sys.exit(main(sys.argv[3:]))")


def serve_cli(args: list, armed: tuple = ()) -> subprocess.Popen:
    """The port's ``serve`` in its own process, optionally with a kill
    armed at ``armed = (site, after)``."""
    head = ([sys.executable, "-c", ARMED_SERVE, armed[0], str(armed[1])]
            if armed else [sys.executable, "-m", "sntc_tpu_torch"])
    return subprocess.Popen(head + ["serve", *args], cwd=REPO,
                            env=env_with(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finished(proc: subprocess.Popen, what: str, rc: int = 0,
             phase: str = "16") -> str:
    """Wait for ``proc``; fail unless it exited with ``rc``; its stdout."""
    try:
        out, err = proc.communicate(timeout=P16_WAIT_S)
    except subprocess.TimeoutExpired:
        # its threads' stacks first (faulthandler, ``env_with``)
        proc.send_signal(signal.SIGABRT)
        try:
            out, err = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        raise SystemExit(f"phase {phase}: {what} still running after "
                         f"{P16_WAIT_S} s:\n{err[-6000:]}")
    if proc.returncode != rc:
        raise SystemExit(f"phase {phase}: {what} exited {proc.returncode} "
                         f"(want {rc}):\n{err[-3000:]}")
    return out


def padded_dispatches(summary: dict, what: str) -> int:
    """The batches of a serving process's ``--once`` summary that
    ``pad_assemble`` pads: each non-empty batch whose rows are not a
    bucket already, from the progress records, which must cover every
    batch the process served."""
    progress = summary["progress"]
    if len(progress) != summary["batches"]:
        raise SystemExit(f"phase 16 (b): {what} kept {len(progress)} "
                         f"progress records of {summary['batches']} batches")
    return sum(1 for p in progress if p["numInputRows"] and bucket_rows_for(
        p["numInputRows"], BUCKET_FLOOR) != p["numInputRows"])


def launches_match(summary: dict, what: str) -> bool:
    """A serving process launched ``pad_assemble`` once for each batch it
    padded, and at least once."""
    want = padded_dispatches(summary, what)
    return want >= 1 and summary["kernel_launches"]["pad_assemble"] == want


def capture_commands(dev, a: dict, c: dict, work: str) -> dict:
    """(b): ``serve --from-capture`` in its default form (pipelined,
    fused, files WAL) over (a)'s stream, the same command killed at
    ``flow.emit`` on its 3rd read and restarted, and ``--from-capture
    netflow`` over (c)'s stream; the three processes start together."""
    d = os.path.join(work, "c16b")
    flags = ["--model", a["model_dir"], "--shape-buckets",
             str(BUCKET_FLOOR), "--max-files-per-batch", "1",
             "--flow-timeout", str(C9_FLOW_TIMEOUT), "--flow-lateness",
             str(C9_LATENESS), "--device", dev.type, "--once"]

    def args(name, fmt, watch):
        return flags + ["--from-capture", fmt, "--watch", watch, "--out",
                        os.path.join(d, name, "out"), "--checkpoint",
                        os.path.join(d, name, "ckpt")]

    procs = [serve_cli(args("pcap", "pcap", a["cap_dir"])),
             serve_cli(args("killed", "pcap", a["cap_dir"]),
                       armed=("flow.emit", C9_KILL_AFTER)),
             serve_cli(args("netflow", "netflow", c["cap_dir"]))]
    try:
        pcap, killed, nf = procs
        finished(killed, "the serve killed at flow.emit", rc=137)
        procs.append(serve_cli(args("killed", "pcap", a["cap_dir"])))
        summary = json.loads(finished(pcap, "serve --from-capture pcap")
                             .strip().splitlines()[-1])
        nf_summary = json.loads(finished(nf, "serve --from-capture netflow")
                                .strip().splitlines()[-1])
        re_summary = json.loads(finished(procs[3], "the restarted serve")
                                .strip().splitlines()[-1])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    pcap_out, kill_out = (os.path.join(d, n, "out")
                          for n in ("pcap", "killed"))
    got = sink_predictions(pcap_out)
    # the NetFlow reference: the same flow operator over (c)'s stream in
    # this process, serial, through (a)'s predictor
    ref_src = FlowCaptureSource(c["cap_dir"], format="netflow",
                                flow_timeout=C9_FLOW_TIMEOUT,
                                allowed_lateness=C9_LATENESS)
    ref = c16_passes(dev, a["predictor"], lambda r: ref_src,
                     os.path.join(d, "nfref"), "nf", 1)[0]
    evidence = {
        "batches": summary["batches"], "rows": summary["rows"],
        "flow": summary["flow"], "fusion_segments":
            (summary["fusion"] or {}).get("segments"),
        "launches": summary["kernel_launches"],
        "pipeline_depth": summary["pipeline_stats"]["pipeline_depth"],
        "sink_equals_serial": bool(np.array_equal(got, a["cap_sink"])),
        "killed_commits_equal": committed_ranges(os.path.join(
            d, "killed", "ckpt")) == committed_ranges(os.path.join(
                d, "pcap", "ckpt")),
        "killed_sink_bitwise": sink_files(kill_out) == sink_files(pcap_out),
        "padded_dispatches": padded_dispatches(summary, "the pcap serve"),
        "serial_padded_dispatches": a["evidence"]["padded_dispatches"]
        // (2 * C9_REPS),
        "restart_batches": re_summary["batches"],
        "restart_launches": re_summary["kernel_launches"],
        "restart_padded_dispatches": padded_dispatches(
            re_summary, "the restarted serve"),
        "netflow_rows": nf_summary["rows"],
        "netflow_launches": nf_summary["kernel_launches"],
        "netflow_padded_dispatches": padded_dispatches(
            nf_summary, "the netflow serve"),
        "netflow_parser": nf_summary["flow"]["parser"],
        "netflow_sink_equals_reference": bool(np.array_equal(
            sink_predictions(os.path.join(d, "netflow", "out")),
            sink_predictions(ref["out_dir"]))),
    }
    if not evidence["sink_equals_serial"] \
            or not evidence["killed_commits_equal"] \
            or not evidence["killed_sink_bitwise"] \
            or evidence["flow"]["parser"] != "native" \
            or evidence["netflow_parser"] != "native" \
            or evidence["pipeline_depth"] < 2 \
            or not evidence["netflow_sink_equals_reference"] \
            or evidence["padded_dispatches"] \
            != evidence["serial_padded_dispatches"] \
            or not launches_match(summary, "the pcap serve") \
            or not launches_match(re_summary, "the restarted serve") \
            or not launches_match(nf_summary, "the netflow serve"):
        raise SystemExit(f"phase 16 (b): {evidence}")
    return evidence


def ingress_kill_payloads(work: str) -> list:
    """The JAX harness's kill-leg payloads (``scripts/chaos_crash_matrix
    .py`` ``setup_ingress_inputs_main``): 6 NetFlow files, seed 23."""
    info = write_capture_stream(
        os.path.join(work, "c16k", "payloads"), n_files=6, flows_per_file=3,
        packets_per_flow=4, seed=23, format="netflow", flush=False)
    return [open(p, "rb").read() for p in info["files"]]


def ingress_pass(dev, model_dir: str, d: str, payloads: list,
                 kill: bool) -> dict:
    """One socket-fed ``serve --listen-udp 0`` pass: each payload is one
    datagram, resent only after the process died, so the sealed file is
    the ack; a process killed by the armed fault (137) restarts without
    it.  Once every payload is sealed and committed, SIGTERM drains (the
    listener first, then the engine).  The JAX harness's
    ``_drive_ingress_pass``, kept here."""
    import socket as socketlib

    spool = os.path.join(d, "spool")
    args = ["--model", model_dir, "--watch", spool, "--out",
            os.path.join(d, "out"), "--checkpoint", os.path.join(d, "ckpt"),
            "--listen-udp", "0", "--max-files-per-batch", "1",
            "--shape-buckets", str(BUCKET_FLOOR), "--poll-interval", "0.05",
            "--device", dev.type]

    def stats():
        return IngressSpool.read_stats(spool) or {}

    def start(armed):
        proc = serve_cli(args, armed)
        limit = time.time() + P16_WAIT_S
        while not stats().get("port"):
            if proc.poll() is not None or time.time() > limit:
                finished(proc, "serve --listen-udp before its port")
            time.sleep(0.05)
        return proc, stats()["port"]

    def sealed():
        return len(glob.glob(os.path.join(spool, "capture_*.nf5")))

    proc, port = start((C15_KILL_SITE, C15_KILL_AFTER) if kill else ())
    kills, sent = [], 0
    sock = socketlib.socket(socketlib.AF_INET, socketlib.SOCK_DGRAM)
    limit = time.time() + P16_WAIT_S
    try:
        k, pending = 0, False
        while k < len(payloads):
            if time.time() > limit:
                raise SystemExit(f"phase 16 (c) kill leg: {k} of "
                                 f"{len(payloads)} sealed, kills {kills}")
            if proc.poll() is not None:
                finished(proc, "the serve killed at ingress.spool", rc=137)
                kills.append(proc.returncode)
                os.unlink(os.path.join(spool, "ingress_stats.json"))
                proc, port = start(())
                pending = False
            if not pending:
                sock.sendto(payloads[k], ("127.0.0.1", port))
                sent, pending = sent + 1, True
            if sealed() > k:
                k, pending = sealed(), False
                continue
            time.sleep(0.02)
        while len(committed_ranges(os.path.join(d, "ckpt"))) < len(payloads):
            if proc.poll() is not None or time.time() > limit:
                finished(proc, "serve --listen-udp before its commits")
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        drained = json.loads(finished(proc, "the drained serve")
                             .strip().splitlines()[-1])
    finally:
        sock.close()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {"kills": kills, "sent": sent, "sealed": sealed(),
            "drained": drained, "stats": stats(),
            "commits": committed_ranges(os.path.join(d, "ckpt")),
            "sink": sink_files(os.path.join(d, "out"))}


def ingress_kill_leg(dev, model_dir: str, work: str) -> dict:
    """(c)'s kill leg: the unkilled reference and the pass killed inside
    its 2nd seal at ``ingress.spool`` run together; the JAX harness's
    ``run_ingress_kill_scenario`` checks."""
    payloads = ingress_kill_payloads(work)
    ref, got = together(
        (ingress_pass, dev, model_dir, os.path.join(work, "c16k", "ref"),
         payloads, False),
        (ingress_pass, dev, model_dir, os.path.join(work, "c16k", "kill"),
         payloads, True))
    st = got["stats"]
    drops = sum(st.get("dropped", {}).values())
    verdict = {
        "site": C15_KILL_SITE, "kills": got["kills"],
        "datagrams_sent": got["sent"], "payloads": len(payloads),
        "sealed": got["sealed"], "committed": len(got["commits"]),
        "journaled_drops": drops,
        "law_exact": st.get("received") == st.get("spooled", -1) + drops,
        "drained": st.get("drained") is True
        and got["drained"]["drained"] is True,
        "commits_equal": got["commits"] == ref["commits"],
        "sink_bitwise": got["sink"] == ref["sink"],
    }
    if verdict["kills"] != [137] or verdict["sealed"] != len(payloads) \
            or len(payloads) != verdict["committed"] + drops \
            or not verdict["law_exact"] or not verdict["drained"] \
            or ref["kills"] or len(ref["commits"]) != len(payloads) \
            or not verdict["commits_equal"] or not verdict["sink_bitwise"]:
        raise SystemExit(f"phase 16 (c) kill leg: {verdict}")
    return verdict


def tcp_command(dev, model_dir: str, test: Frame, work: str) -> dict:
    """(c)'s TCP run: ``serve --listen-tcp 0`` fed ``TCP_ROWS`` held-out
    rows as ``frame_rows`` payloads, against ``serve --once`` of the same
    rows as one CSV file; the two processes run together."""
    import socket as socketlib

    d = os.path.join(work, "c16t")
    rows = test.slice(0, TCP_ROWS)
    lines = [",".join(repr(float(rows[c][i])) for c in CICIDS2017_FEATURES)
             for i in range(rows.num_rows)]
    os.makedirs(os.path.join(d, "csv"))
    with open(os.path.join(d, "csv", "rows.csv"), "w") as f:
        f.write(",".join(CICIDS2017_FEATURES) + "\n" + "\n".join(lines)
                + "\n")
    common = ["--model", model_dir, "--pipeline-depth", "1",
              "--shape-buckets", str(BUCKET_FLOOR), "--device", dev.type]
    csv = serve_cli(common + ["--watch", os.path.join(d, "csv"), "--out",
                              os.path.join(d, "o_csv"), "--checkpoint",
                              os.path.join(d, "c_csv"), "--once"])
    spool = os.path.join(d, "spool")
    proc = serve_cli(common + ["--watch", spool, "--out",
                               os.path.join(d, "o_tcp"), "--checkpoint",
                               os.path.join(d, "c_tcp"), "--listen-tcp",
                               "0", "--poll-interval", "0.05"])
    limit = time.time() + P16_WAIT_S

    def stats():
        return IngressSpool.read_stats(spool) or {}

    try:
        csv_summary = json.loads(finished(csv, "serve --once of the CSV "
                                          "rows").strip().splitlines()[-1])
        while not stats().get("tcp_port"):
            if proc.poll() is not None or time.time() > limit:
                finished(proc, "serve --listen-tcp before its port")
            time.sleep(0.05)
        c = socketlib.create_connection(("127.0.0.1", stats()["tcp_port"]),
                                        timeout=30.0)
        c.sendall(frame_rows(lines))
        c.close()
        while len(sink_predictions(os.path.join(d, "o_tcp"))) < len(lines):
            if proc.poll() is not None or time.time() > limit:
                finished(proc, "serve --listen-tcp before its rows")
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        finished(proc, "the drained serve --listen-tcp")
    finally:
        for p in (proc, csv):
            if p.poll() is None:
                p.kill()
                p.communicate()
    st = stats()
    got = sink_predictions(os.path.join(d, "o_tcp"))
    want = sink_predictions(os.path.join(d, "o_csv"))
    evidence = {"rows": len(lines), "received": st.get("received"),
                "spooled": st.get("spooled"), "dropped": st.get("dropped"),
                "sink_equals_csv": bool(np.array_equal(got, want)),
                "csv_launches": csv_summary["kernel_launches"]}
    if not evidence["sink_equals_csv"] or st.get("received") != len(lines) \
            or st.get("spooled") != len(lines) or st.get("dropped"):
        raise SystemExit(f"phase 16 (c) TCP run: {evidence}")
    return evidence


def live_capture(dev, work: str) -> dict:
    """Phase 16: live capture serving on the card (see the module docs)."""
    t0 = time.perf_counter()
    data = c9_data()
    a = c9_serve(dev, data, work)
    # the command legs are processes: the kill leg's and the TCP run's
    # start once (a)'s model is saved, beside (c) in this process; the
    # capture commands need (c)'s stream
    with ThreadPoolExecutor(2) as pool:
        legs = [pool.submit(ingress_kill_leg, dev, a["model_dir"], work),
                pool.submit(tcp_command, dev, a["model_dir"], data["test"],
                            work)]
        c = c15_serve(dev, a["predictor"], work)
        b = capture_commands(dev, a, c, work)
        kill_leg, tcp = (f.result() for f in legs)
    c["kill_leg"], c["tcp"] = kill_leg, tcp
    shapes = {**a["pad_launch_shapes"]}
    for k, v in c["pad_launch_shapes"].items():
        shapes[k] = shapes.get(k, 0) + v
    kernels = [measure_pad_at(dev, n, shapes, torch.float32, target)
               for n, target in P16_PAD_ROWS]
    for x in (a, c):
        x.pop("predictor", None)
    return {"a": a, "b": b, "c": c, "kernels": kernels,
            "seconds": time.perf_counter() - t0}


def report_phase16(p16: dict, card: str) -> None:
    """Phase 16's lines: config 9's and config 15's rates and evidence,
    the command legs, each timed kernel shape, one JSON line."""
    a, b, c = p16["a"], p16["b"], p16["c"]
    log(f"phase 16 (a) bench config 9: {a['evidence']['capture_files']} "
        f"capture files, {a['evidence']['packets']} packets, "
        f"{a['evidence']['feature_rows']} feature rows in "
        f"{a['evidence']['nonempty_batches']} batches of "
        f"{a['evidence']['batch_rows']} rows (min, median, max); median of "
        f"{C9_REPS} reps in turns: capture {a['rows_per_s']['capture']:.1f} "
        f"rows/s ({a['packets_per_s']:.1f} packets/s), CSV "
        f"{a['rows_per_s']['csv']:.1f} rows/s, capture_vs_csv "
        f"{a['capture_vs_csv']:.4f} (reps {a['reps_s']} s) [{card}]")
    c15 = c["evidence"]
    log(f"phase 16 (c) bench config 15: {c15['capture_files']} files, "
        f"{c15['feature_rows']} rows; median of {C15_REPS} reps in turns: "
        f"socket {c['rows_per_s']['socket']:.1f} rows/s, directory "
        f"{c['rows_per_s']['directory']:.1f} rows/s, socket_vs_dir "
        f"{c['socket_vs_dir']:.4f} (reps {c['reps_s']} s); kill leg "
        f"{c['kill_leg']}; TCP {c['tcp']} [{card}]")
    log(f"phase 16 (b) serve --from-capture: {b} [{card}]")
    for k in p16["kernels"]:
        log(f"phase 16 {k['name']} {k['shape']}: {k['ms']:.4f} ms a call, "
            f"{k['device_ms']:.4f} ms of device time a launch (plain "
            f"{k['plain_ms']:.4f} ms; {k['library_call']} "
            f"{k['library_ms']:.4f} ms a call, {k['library_device_ms']:.4f} "
            f"ms of device time; bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}); {k['launches']} launches at this shape in "
            f"(a) and (c), max abs error {k['max_abs_err']} [{card}]")
    log("phase 16 " + json.dumps({
        "phase": 16, "card": card, "seconds": round(p16["seconds"], 3),
        "config9": {**a["evidence"], "rows_per_s": a["rows_per_s"],
                    "packets_per_s": a["packets_per_s"],
                    "capture_vs_csv": a["capture_vs_csv"]},
        "config15": {**c15, "rows_per_s": c["rows_per_s"],
                     "socket_vs_dir": c["socket_vs_dir"],
                     "kill_leg": c["kill_leg"], "tcp": c["tcp"]},
        "commands": b}, default=str))


# -- phase 17: the multi-tenant serve daemon ---------------------------------

C8_TENANTS = 10  # bench.py:1094-1100: 8 LR tenants, 2 gaussian NB
C8_LR_TENANTS = 8
C8_SIZES = (1024, 512, 256)  # each tenant's micro-batch row cycle
C8_BUCKETS = 256
C8_NOISY_PASSES = 3  # the flood: the noisy stream is 3x a tenant's
C8_NOISY_CORRUPT_EVERY = 3  # every 3rd noisy file is poison
# the noisy tenant's end (bench_runs.jsonl:96-97, both reproduced by the
# JAX package on the CPU at this data and width)
C8_NOISY_RECORD = {"state": "QUARANTINED", "poisoned_files": 21,
                   "quarantine_episodes": 1, "shed_total_offsets": 47}
C11_REPS = 1  # reps of config 11's arm B (the bench runs 3)
C11_SLO = {"slo_p99_ms": 250.0, "slo_min_rows_per_sec": 500.0}
# the journal leg: one tenant under a floor it cannot reach, as the JAX
# bench's smoke journal for config 11 shows its controller's arc
C11_UNREACHABLE = 1e9
MT_TENANTS = ("t0", "t1", "t2")  # scripts/chaos_crash_matrix.py:113
MT_FILES, MT_ROWS = 4, 6
MT_WORKER = """
import json, os, sys
from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.serve import ServeDaemon, TenantSpec

class Identity(Transformer):
    def transform(self, frame):
        return frame

watch, out, ckpt, device = sys.argv[1:5]
specs = [TenantSpec(tenant_id=tid, model=Identity(),
                    watch=os.path.join(watch, tid),
                    out=os.path.join(out, tid), out_columns=["x"],
                    max_batch_offsets=1, max_batch_failures=2,
                    quarantine_after=2, stop_after=99)
         for tid in ("t0", "t1", "t2")]
daemon = ServeDaemon(specs, ckpt, device=device)
try:
    n = daemon.process_available()
    daemon.drain()
    status = daemon.status()
finally:
    daemon.close()
print(json.dumps({"batches": n, "tenants": {
    tid: row["state"] for tid, row in status["tenants"].items()}}))
"""


def c8_pipelines(dev, data: dict, work: str) -> dict:
    """Bench config 8's two pipelines (``bench.py:1143-1152``), fitted on
    the card and saved: StringIndexer -> VectorAssembler(78) ->
    StandardScaler(withMean) -> LR(maxIter=20), and the same with
    gaussian NB; each served as ``compile_serving`` gives it through one
    ``BatchPredictor(bucket_rows=256)``, shared by every tenant and
    leg."""
    from sntc_tpu_torch.serve import compile_serving

    out = {}
    for name, head in (("lr", LogisticRegression(device=dev,
                                                 maxIter=C9_LR_ITERS)),
                       ("nb", NaiveBayes(device=dev,
                                         modelType="gaussian"))):
        pipe = c9_pipeline(dev)
        pipe = Pipeline(stages=pipe.getStages()[:-1] + [head])
        fitted = pipe.fit(data["train"])
        served = compile_serving(PipelineModel(stages=fitted.getStages()[1:]))
        out[name] = {
            "model_dir": save_model(fitted, os.path.join(work, f"model17{name}")),
            "served": served,
            "pred": BatchPredictor(served, bucket_rows=C8_BUCKETS, device=dev),
        }
    return out


def c8_streams(test: Frame, tmp: str) -> dict:
    """Each tenant's copy of the test split (``write_bench_stream``, the
    1 024 / 512 / 256 cycle: written once, each tenant's directory of
    hard links to it, the bytes the bench writes each tenant), one
    combined directory a pipeline for leg S (hard links too), and the
    noisy stream: 3 passes, every 3rd file poisoned with a ragged line
    (``bench.py:1103-1114``)."""
    tenants = [f"lr{i:02d}" for i in range(C8_LR_TENANTS)] + [
        f"nb{i:02d}" for i in range(C8_TENANTS - C8_LR_TENANTS)]
    first = os.path.join(tmp, "in", tenants[0])
    one = write_bench_stream(first, test, chunk_cycle=C8_SIZES)
    for tid in tenants[1:]:
        os.makedirs(os.path.join(tmp, "in", tid))
        for k in range(len(one)):
            name = f"part_{k:05d}.csv"
            os.link(os.path.join(first, name),
                    os.path.join(tmp, "in", tid, name))
    sizes = {tid: list(one) for tid in tenants}
    for pipe in ("lr", "nb"):
        combined = os.path.join(tmp, "in", f"single_{pipe}")
        os.makedirs(combined)
        n = 0
        for tid in (t for t in tenants if t.startswith(pipe)):
            for src in sorted(glob.glob(os.path.join(tmp, "in", tid,
                                                     "part_*.csv"))):
                os.link(src, os.path.join(combined, f"part_{n:05d}.csv"))
                n += 1
    noisy_dir = os.path.join(tmp, "in", "noisy")
    noisy = write_bench_stream(noisy_dir, test, passes=C8_NOISY_PASSES,
                               chunk_cycle=C8_SIZES)
    poisoned = 0
    for i, path in enumerate(sorted(glob.glob(os.path.join(noisy_dir,
                                                           "part_*.csv")))):
        if i % C8_NOISY_CORRUPT_EVERY == 0:
            with open(path, "a") as f:
                f.write("garbage,not,a,flow,row\n")
            poisoned += 1
    return {"tenants": tenants, "sizes": sizes, "noisy": noisy,
            "poisoned": poisoned}


def c8_specs(preds: dict, tenants: list, tmp: str, leg: str, **kw) -> list:
    """Leg ``leg``'s well-behaved tenant specs: a shared predictor each,
    a non-durable prediction sink, one file a batch (``bench.py:1180``)."""
    from sntc_tpu_torch.serve import TenantSpec

    return [TenantSpec(
        tenant_id=tid, model=preds[tid[:2]],
        watch=os.path.join(tmp, "in", tid),
        sink=CsvDirSink(os.path.join(tmp, "out", leg, tid),
                        columns=["prediction"], durable=False),
        max_batch_offsets=1, max_batch_failures=2, **kw) for tid in tenants]


def round_trips(pred, test: Frame) -> dict:
    """The copies one batch of ``pred``'s pipeline makes on the card (a
    1 024-row dispatch with the host path off), by a transfer ledger:
    the LR head one upload and one download, the NB pipeline two of each
    (its scaler segment's output comes back to the host before the NB
    head)."""
    from sntc_tpu_torch.utils.profiling import TransferLedger, ledger_scope

    led = TransferLedger()
    with environ(SNTC_SERVE_HOST_ROWS=0), ledger_scope(led):
        pred.predict_frame(test.slice(0, C8_SIZES[0]))
    return led.snapshot()


def tenant_placement(daemon, trips: dict) -> dict:
    """Where each tenant's committed batches ran, from its engine's
    transfer ledger and its pipeline's copies a card batch (``trips``):
    a batch served on the host copies nothing."""
    out = {}
    for t in daemon.tenants:
        led = t.query.transfer.snapshot()
        per = trips["nb" if t.spec.tenant_id.startswith("nb") else "lr"]
        card, rest = divmod(led["downloads"], per["downloads"])
        out[t.spec.tenant_id] = {
            "batches": t.batches_done, "card": card,
            "host": t.batches_done - card,
            "copies_match": rest == 0
            and led["uploads"] == card * per["uploads"]}
    return out


def c8_daemon(dev, specs: list, root: str, trips: dict, **kw) -> dict:
    """One daemon leg (``bench.py:1192-1230``): serve what is there,
    timed; each tenant's snapshot and placement, the status."""
    from sntc_tpu_torch.serve import ServeDaemon

    daemon = ServeDaemon(specs, root, shape_buckets=C8_BUCKETS, device=dev,
                         **kw)
    try:
        t0 = time.perf_counter()
        daemon.process_available()
        dt = time.perf_counter() - t0
        snap = {t.spec.tenant_id: t.snapshot() for t in daemon.tenants}
        progress = {t.spec.tenant_id: list(t.query.recentProgress)
                    for t in daemon.tenants}
        return {"dt": dt, "tenants": snap, "progress": progress,
                "placement": tenant_placement(daemon, trips),
                "status": daemon.status()}
    finally:
        daemon.close()


def batch_file_bytes(out_dir: str) -> list:
    """A sink's batch files' bytes, in batch order."""
    out = []
    for p in sorted(glob.glob(os.path.join(out_dir, "batch_*.csv"))):
        with open(p, "rb") as f:
            out.append(f.read())
    return out


def padded_of(sizes) -> int:
    """The batches of these row counts that ``pad_assemble`` pads."""
    return sum(1 for n in sizes if n and bucket_rows_for(n, C8_BUCKETS) != n)


def c8_serve(dev, data: dict, models: dict, streams: dict,
             tmp: str) -> dict:
    """(a): bench config 8 in this process (``bench.py:1117-1355``): the
    warmup, leg S (one plain engine a pipeline over the combined
    streams), leg A (the clean daemon), leg B (with the noisy tenant)
    and leg A again with every batch on the card."""
    import pyarrow as pa

    from sntc_tpu_torch.serve import TenantSpec

    test = data["test"]
    tenants, sizes = streams["tenants"], streams["sizes"]
    preds = {name: m["pred"] for name, m in models.items()}
    arrow_cpus = pa.cpu_count()
    pa.set_cpu_count(1)  # bench.py's intra-op pinning
    try:
        # every chunk shape through both shared predictors once
        chunks = sorted(set(sum(sizes.values(), [])) | set(streams["noisy"]))
        for pred in preds.values():
            for c in chunks:
                pred.predict_frame(test.slice(0, c))
        trips = {name: round_trips(pred, test) for name, pred in preds.items()}
        compiles_warm = sum(p.compile_events for p in preds.values())
        reset_launches()
        single_dt, single_out = 0.0, {}
        for pipe, pred in preds.items():
            src = FileStreamSource(os.path.join(tmp, "in", f"single_{pipe}"))
            out_dir = os.path.join(tmp, "out", "single", pipe)
            q = StreamingQuery(
                pred, src, CsvDirSink(out_dir, columns=["prediction"],
                                      durable=False),
                os.path.join(tmp, f"ckpt_single_{pipe}"),
                max_batch_offsets=1, wal_mode="append", overlap_sink=False,
                device=dev)
            t0 = time.perf_counter()
            q.process_available()
            single_dt += time.perf_counter() - t0
            q.stop()
            src.close()
            single_out[pipe] = batch_file_bytes(out_dir)
        single_rows = sum(sum(v) for v in sizes.values())
        clean = c8_daemon(dev, c8_specs(preds, tenants, tmp, "clean"),
                          os.path.join(tmp, "root_clean"), trips)
        noisy_spec = TenantSpec(
            tenant_id="noisy", model=preds["lr"],
            watch=os.path.join(tmp, "in", "noisy"),
            sink=CsvDirSink(os.path.join(tmp, "out", "noisy", "noisy"),
                            columns=["prediction"], durable=False),
            max_batch_offsets=1, max_batch_failures=2,
            max_pending_batches=16, shed_policy="oldest",
            quarantine_after=3, stop_after=99, quarantine_cooldown_s=1e9)
        noisy = c8_daemon(dev, c8_specs(preds, tenants, tmp, "noisy")
                          + [noisy_spec], os.path.join(tmp, "root_noisy"),
                          trips)
        launches_host, shapes = dict(LAUNCHES), dict(PAD_LAUNCH_SHAPES)
        with environ(SNTC_SERVE_HOST_ROWS=0):
            card = c8_daemon(dev, c8_specs(preds, tenants, tmp, "card"),
                             os.path.join(tmp, "root_card"), trips)
        launches = dict(LAUNCHES)
        for k, v in PAD_LAUNCH_SHAPES.items():
            shapes[k] = v
    finally:
        pa.set_cpu_count(arrow_cpus)
    compiles_after = sum(p.compile_events for p in preds.values())
    # leg S's combined batch k is tenant k // files's file k % files
    by_tenant_single = {}
    for pipe, files in single_out.items():
        members = [t for t in tenants if t.startswith(pipe)]
        k = 0
        for tid in members:
            by_tenant_single[tid] = files[k:k + len(sizes[tid])]
            k += len(sizes[tid])
    sinks_equal = all(
        by_tenant_single[tid]
        == batch_file_bytes(os.path.join(tmp, "out", "clean", tid))
        == batch_file_bytes(os.path.join(tmp, "out", "noisy", tid))
        == batch_file_bytes(os.path.join(tmp, "out", "card", tid))
        and len(by_tenant_single[tid]) == len(sizes[tid])
        for tid in tenants)
    # each leg's padded dispatches, from the committed batches' rows
    noisy_rows = [p["numInputRows"] for p in noisy["progress"]["noisy"]]
    want_pad = {
        "single+clean": 2 * padded_of(sum(sizes.values(), [])),
        "noisy": padded_of(sum(sizes.values(), [])) + padded_of(noisy_rows),
        "card": padded_of(sum(sizes.values(), [])),
    }
    if len(noisy_rows) != noisy["tenants"]["noisy"]["batches_done"]:
        raise SystemExit("phase 17 (a): the noisy tenant's progress ring "
                         "dropped records")
    noisy_row = noisy["tenants"]["noisy"]
    noisy_got = {"state": noisy_row["state"],
                 "poisoned_files": streams["poisoned"],
                 "quarantine_episodes": noisy_row["quarantine_episodes"],
                 "shed_total_offsets": noisy_row["shed_total_offsets"]}
    card_all = all(p["host"] == 0 and p["card"] == p["batches"]
                   for p in card["placement"].values())
    copies_match = all(p["copies_match"] for leg in (clean, noisy, card)
                       for p in leg["placement"].values())
    well_ok = all(s["state"] == "OK" for leg in (clean, noisy, card)
                  for tid, s in leg["tenants"].items() if tid != "noisy")
    p99_base = {tid: s["p99_ms"] for tid, s in clean["tenants"].items()}
    ratios = [noisy["tenants"][tid]["p99_ms"] / p99_base[tid]
              for tid in tenants
              if p99_base.get(tid) and noisy["tenants"][tid]["p99_ms"]]
    clean_rows = sum(s["rows_done"] for s in clean["tenants"].values())
    placement = {leg: {"host": sum(p["host"] for p in x["placement"].values()),
                       "card": sum(p["card"] for p in x["placement"].values())}
                 for leg, x in (("clean", clean), ("noisy", noisy),
                                ("card", card))}
    evidence = {
        "tenants": len(tenants), "rows": clean_rows,
        "single_rows": single_rows,
        "recompiles_after_warmup": compiles_after - compiles_warm,
        "noisy": noisy_got,
        "daemon_survived": True,
        "sinks_equal": sinks_equal,
        "card_leg_all_on_card": card_all,
        "copies_match": copies_match,
        "copies_per_card_batch": trips,
        "well_behaved_ok": well_ok,
        "placement": placement,
        "pad_assemble": {"host_legs": launches_host["pad_assemble"],
                         "card_leg": launches["pad_assemble"]
                         - launches_host["pad_assemble"]},
        "padded_dispatches": {"host_legs": want_pad["single+clean"]
                              + want_pad["noisy"],
                              "card_leg": want_pad["card"]},
        "other_launches": {k: v for k, v in launches.items()
                           if k != "pad_assemble"},
        "pad_max_abs_err": check_pad_shapes(dev, shapes, "phase 17 (a)"),
        "events_dropped_by_tenant": noisy["status"][
            "events_dropped_by_tenant"],
    }
    if evidence["recompiles_after_warmup"] != 0 \
            or noisy_got != C8_NOISY_RECORD or not sinks_equal \
            or not card_all or not well_ok or not copies_match \
            or evidence["pad_assemble"] != evidence["padded_dispatches"] \
            or evidence["padded_dispatches"]["card_leg"] < 1 \
            or any(evidence["other_launches"].values()) \
            or clean_rows != single_rows:
        raise SystemExit(f"phase 17 (a): {evidence}")
    agg = clean_rows / clean["dt"]
    single = single_rows / single_dt
    return {
        "evidence": evidence, "streams": streams, "pad_launch_shapes": shapes,
        "rows_per_s": {"aggregate": agg, "single": single,
                       "card_leg": clean_rows / card["dt"]},
        "aggregate_vs_single": agg / single,
        "latency_ms": {tid: {"p50": s["p50_ms"], "p99": s["p99_ms"]}
                       for tid, s in clean["tenants"].items()},
        "well_behaved_p99_ratio_worst": max(ratios) if ratios else None,
        "finalize_ms": {
            leg: finalize_quantiles(x["progress"], tenants)
            for leg, x in (("clean", clean), ("card", card))},
        "seconds": {"single": single_dt, "clean": clean["dt"],
                    "noisy": noisy["dt"], "card": card["dt"]},
    }


def finalize_quantiles(progress: dict, tenants: list) -> dict:
    """p50 / p99 of the well-behaved tenants' ``finalizeMs`` (the wait
    for a batch's output) over their committed batches."""
    vals = np.asarray([p["finalizeMs"] for tid in tenants
                       for p in progress.get(tid, []) if "finalizeMs" in p])
    if not len(vals):
        return {"p50": None, "p99": None, "n": 0}
    return {"p50": float(np.percentile(vals, 50)),
            "p99": float(np.percentile(vals, 99)), "n": int(len(vals))}


def mt_inputs(d: str) -> None:
    """The chaos harness's three tenant streams (``scripts/
    chaos_crash_matrix.py:921-935``): 4 files of 6 rows each, the
    tenant's index in the row values."""
    for k, tid in enumerate(MT_TENANTS):
        tdir = os.path.join(d, "in", tid)
        os.makedirs(tdir, exist_ok=True)
        for i in range(MT_FILES):
            with open(os.path.join(tdir, f"in_{i:03d}.csv"), "w") as f:
                f.write("x\n" + "".join(
                    f"{k * 100_000 + i * 1000 + r}\n" for r in range(MT_ROWS)))


def mt_state(d: str) -> dict:
    """Each tenant's committed ranges and sink rows."""
    out = {}
    for tid in MT_TENANTS:
        rows = {}
        for p in sorted(glob.glob(os.path.join(d, "out", tid,
                                               "batch_*.csv"))):
            with open(p) as f:
                rows[os.path.basename(p)] = max(0, sum(1 for _ in f) - 1)
        out[tid] = {"commits": committed_ranges(os.path.join(
            d, "ckpt", "tenant", tid, "ckpt")), "rows": rows}
    return out


def mt_worker(dev, d: str, faults: str = "") -> subprocess.Popen:
    """One drain-and-exit daemon over the three tenant streams, in its
    own process (the chaos harness's ``run_daemon_worker``)."""
    return subprocess.Popen(
        [sys.executable, "-c", MT_WORKER, os.path.join(d, "in"),
         os.path.join(d, "out"), os.path.join(d, "ckpt"), str(dev)],
        cwd=REPO, env=env_with(SNTC_FAULTS=faults), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def mt_chaos(dev, work: str) -> dict:
    """(b)'s chaos legs, the smoke's copies of the JAX harness's
    ``run_multi_tenant_kill_scenario`` and
    ``run_tenant_isolation_scenario`` (``scripts/chaos_crash_matrix.py:
    953-1040``) against an unkilled reference run."""
    ref_dir, kill_dir, iso_dir = (os.path.join(work, "mt", x) for x in (
        "reference", "kill", "isolation"))
    for d in (ref_dir, kill_dir, iso_dir):
        mt_inputs(d)
    # the three first runs are independent processes: started together
    procs = [mt_worker(dev, ref_dir),
             mt_worker(dev, kill_dir, "tenant/t1/stream.wal:kill"),
             mt_worker(dev, iso_dir, "tenant/t1/sink.write:io:1.0:0")]
    finished(procs[0], "the chaos reference", phase="17 (b)")
    finished(procs[1], "the daemon killed at tenant/t1/stream.wal",
             rc=KILL_EXIT_CODE, phase="17 (b)")
    iso_out = finished(procs[2], "the isolation daemon", phase="17 (b)")
    finished(mt_worker(dev, kill_dir), "the restarted daemon",
             phase="17 (b)")
    reference = mt_state(ref_dir)
    got_kill = mt_state(kill_dir)
    got_iso = mt_state(iso_dir)
    verdict = json.loads(iso_out.strip().splitlines()[-1])
    dead_letter = os.path.join(iso_dir, "ckpt", "tenant", "t1", "ckpt",
                               "dead_letter", "dead_letter.jsonl")
    out = {
        "reference_commits": {t: len(s["commits"])
                              for t, s in reference.items()},
        "kill_converged": got_kill == reference,
        "isolation": {"states": verdict["tenants"],
                      "others_equal": all(got_iso[t] == reference[t]
                                          for t in ("t0", "t2")),
                      "t1_rows": got_iso["t1"]["rows"],
                      "t1_dead_letter": os.path.exists(dead_letter)},
    }
    iso_ok = (out["isolation"]["others_equal"]
              and out["isolation"]["t1_rows"] == {}
              and out["isolation"]["t1_dead_letter"]
              and verdict["tenants"]["t1"] in ("QUARANTINED", "STOPPED")
              and verdict["tenants"]["t0"] == verdict["tenants"]["t2"]
              == "OK")
    if not out["kill_converged"] or not iso_ok or any(
            len(s["commits"]) != MT_FILES for s in reference.values()):
        raise SystemExit(f"phase 17 (b) chaos: {out}")
    return out


def command_pad_launches(summary: dict, want: int) -> bool:
    """A serving process launched ``pad_assemble`` once for each batch it
    padded (its own counts, from its summary line), and at least once."""
    return want >= 1 and summary["kernel_launches"]["pad_assemble"] == want


COMMAND_TENANTS = {"lr00": "lr", "lr01": "lr", "nb00": "nb"}


def daemon_command(dev, models: dict, streams: dict, tmp: str) -> dict:
    """(b): ``python -m sntc_tpu_torch serve-daemon --once`` over three of
    (a)'s tenants, two sharing the saved LR checkpoint and one the NB
    one: every tenant OK, no new row shape after the warm pass, drained,
    ``fsck --tenant-tree`` clean (its predictions are held to (a)'s by
    ``check_command``)."""
    chosen = COMMAND_TENANTS
    doc = {"tenants": [
        {"id": tid, "model": models[pipe]["model_dir"],
         "watch": os.path.join(tmp, "in", tid),
         "out": os.path.join(tmp, "out", "command", tid)}
        for tid, pipe in chosen.items()]}
    path = os.path.join(tmp, "tenants17.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    root = os.path.join(tmp, "root_command")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sntc_tpu_torch", "serve-daemon", "--tenants",
         path, "--root", root, "--shape-buckets", str(C8_BUCKETS), "--once",
         "--device", str(dev)], cwd=REPO, env=env_with(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    summary = json.loads(finished(proc, "serve-daemon", phase="17 (b)")
                         .strip().splitlines()[-1])
    fsck = subprocess.run(
        [sys.executable, "-m", "sntc_tpu_torch", "fsck", root,
         "--tenant-tree", "--no-repair"], cwd=REPO, env=env_with(),
        capture_output=True, text=True, timeout=P16_WAIT_S)
    report = json.loads(fsck.stdout)
    want_pad = padded_of(sum((streams["sizes"][t] for t in chosen), []))
    out = {"summary": {k: summary[k] for k in (
               "batches", "tenants", "recompiles_after_warmup", "drained",
               "health", "kernel_launches")},
           "padded_dispatches": want_pad,
           "fsck_ok": fsck.returncode == 0 and report["ok"] and not any(
               r["errors"] for r in report["roots"]),
           "fsck_tenants": sorted(r["tenant"] for r in report["roots"][1:])}
    if set(summary["tenants"].values()) != {"OK"} \
            or summary["recompiles_after_warmup"] != 0 \
            or not summary["drained"] \
            or not out["fsck_ok"] or out["fsck_tenants"] != sorted(chosen) \
            or not command_pad_launches(summary, want_pad) \
            or summary["batches"] != sum(len(streams["sizes"][t])
                                         for t in chosen):
        raise SystemExit(f"phase 17 (b): {out}")
    return out


def check_command(b: dict, tmp: str) -> None:
    """(b)'s predictions, tenant by tenant, equal to (a)'s clean leg."""
    b["predictions_equal"] = all(
        np.array_equal(sink_predictions(os.path.join(tmp, "out", "command",
                                                     tid)),
                       sink_predictions(os.path.join(tmp, "out", "clean",
                                                     tid)))
        for tid in COMMAND_TENANTS)
    if not b["predictions_equal"]:
        raise SystemExit(f"phase 17 (b): predictions differ from (a): {b}")


def c11_daemon(dev, models: dict, a: dict, tmp: str) -> dict:
    """(c): bench config 11's arm B (``bench.py:1981-2075``): over (a)'s
    10 tenant streams, the hand-tuned config-8 flags (buckets 256, no
    controller) against cold defaults (no buckets) with
    ``ServeDaemon(controller=True)`` under the bench's achievable SLOs,
    ``C11_REPS`` reps in turns; every tenant OK, the sinks equal between
    the arms.
    Then the journal leg: three tenants with the controller armed, one
    under an unreachable floor, its ``controller.jsonl`` written and
    reconciled by a second daemon over the same root."""
    import pyarrow as pa

    from sntc_tpu_torch.resilience.control import ControlPolicy
    from sntc_tpu_torch.serve import ServeDaemon, TenantSpec

    tenants = a["streams"]["tenants"]
    preds = {
        "hand": {p: BatchPredictor(m["served"], bucket_rows=C8_BUCKETS,
                                   device=dev) for p, m in models.items()},
        "ctl": {p: BatchPredictor(m["served"], bucket_rows=0, device=dev)
                for p, m in models.items()},
    }
    chunks = sorted(set(sum(a["streams"]["sizes"].values(), [])))
    test = a["test"]
    for arm in preds.values():
        for pred in arm.values():
            for c in chunks:
                pred.predict_frame(test.slice(0, c))
    policy = ControlPolicy(confirm=1, cooldown=0)

    def run(arm: str, rep: int) -> dict:
        specs = [TenantSpec(
            tenant_id=tid, model=preds[arm][tid[:2]],
            watch=os.path.join(tmp, "in", tid),
            sink=CsvDirSink(os.path.join(tmp, "out", f"c11{arm}{rep}", tid),
                            columns=["prediction"], durable=False),
            max_batch_offsets=1, max_batch_failures=2,
            **(C11_SLO if arm == "ctl" else {})) for tid in tenants]
        root = os.path.join(tmp, f"root_c11{arm}{rep}")
        d = ServeDaemon(specs, root, shape_buckets=0,
                        controller=arm == "ctl", controller_policy=policy,
                        device=dev)
        try:
            t0 = time.perf_counter()
            d.process_available()
            dt = time.perf_counter() - t0
            snap = {t.spec.tenant_id: t.snapshot() for t in d.tenants}
            ctl = None
            if d.controller is not None:
                c = d.controller
                ctl = {"windows": c.guard.windows,
                       "decisions": c.guard.decisions_total,
                       "applied": len(c.guard.applied()),
                       "delegated": c.delegated_total,
                       "knobs": c.knob_values(),
                       "compliant": {t: s["compliant"]
                                     for t, s in c.slo_status().items()}}
        finally:
            d.close()
        return {"dt": dt, "tenants": snap, "ctl": ctl, "root": root}

    arrow_cpus = pa.cpu_count()
    pa.set_cpu_count(1)
    try:
        reps = {"hand": [], "ctl": []}
        for rep in range(C11_REPS):  # interleaved, as the bench's arm A
            reps["hand"].append(run("hand", rep))
            reps["ctl"].append(run("ctl", rep))
    finally:
        pa.set_cpu_count(arrow_cpus)
    rows = sum(sum(v) for v in a["streams"]["sizes"].values())

    def median(xs):
        return sorted(xs, key=lambda r: r["dt"])[len(xs) // 2]

    hand, ctl = median(reps["hand"]), median(reps["ctl"])
    ratios = [ctl["tenants"][t]["p99_ms"] / hand["tenants"][t]["p99_ms"]
              for t in tenants if hand["tenants"][t]["p99_ms"]
              and ctl["tenants"][t]["p99_ms"]]
    sinks_equal = all(
        np.array_equal(sink_predictions(os.path.join(
            tmp, "out", f"c11{arm}{rep}", tid)), sink_predictions(
            os.path.join(tmp, "out", "clean", tid)))
        for arm in ("hand", "ctl") for rep in range(C11_REPS)
        for tid in tenants)
    all_ok = all(s["state"] == "OK" for arm in reps.values() for r in arm
                 for s in r["tenants"].values())
    journal = c11_journal_leg(dev, preds["ctl"], tmp, policy)
    out = {"rows": rows,
           "rows_per_s": {"hand": rows / hand["dt"], "ctl": rows / ctl["dt"]},
           "ctl_vs_hand": hand["dt"] / ctl["dt"],
           "p99_ratio_worst": max(ratios) if ratios else None,
           "reps_s": {arm: [round(r["dt"], 4) for r in xs]
                      for arm, xs in reps.items()},
           "controller": ctl["ctl"], "sinks_equal": sinks_equal,
           "all_ok": all_ok, "journal": journal}
    if not sinks_equal or not all_ok or not journal["ok"]:
        raise SystemExit(f"phase 17 (c): {out}")
    return out


def c11_journal_leg(dev, preds: dict, tmp: str, policy) -> dict:
    """Three of (a)'s tenants with every batch on the card, the
    controller armed, ``lr00`` under a floor it cannot reach: the
    controller steps its knobs and journals each decision to
    ``<root>/controller.jsonl``; a second daemon over the same root writes
    the ``restart`` record, the journal's last knobs against its cold
    ones.  The tenants stay OK and their sinks equal (a)'s.  Then the
    same three at pipeline depth 2 (each tenant's delivery on a thread
    of its own, every dispatch on the one stream): its ``finalizeMs``
    beside the depth-1 run's, the wait a finalize may spend behind
    another tenant's launch."""
    from sntc_tpu_torch.serve import ServeDaemon, TenantSpec

    chosen = ("lr00", "lr01", "nb00")
    root = os.path.join(tmp, "root_c11journal")

    def specs(tag):
        return [TenantSpec(
            tenant_id=tid, model=preds[tid[:2]],
            watch=os.path.join(tmp, "in", tid),
            sink=CsvDirSink(os.path.join(tmp, "out", f"journal{tag}", tid),
                            columns=["prediction"], durable=False),
            max_batch_offsets=1, max_batch_failures=2,
            slo_min_rows_per_sec=(C11_UNREACHABLE if tid == "lr00"
                                  else None))
            for tid in chosen]

    with environ(SNTC_SERVE_HOST_ROWS=0):
        d = ServeDaemon(specs("1"), root, controller=True,
                        controller_policy=policy, device=dev)
        try:
            d.process_available()
            decisions = d.controller.guard.decisions_total
            delegated = d.controller.delegated_total
            knobs = d.controller.knob_values()
            states = {t.spec.tenant_id: t.state for t in d.tenants}
            progress = {t.spec.tenant_id: list(t.query.recentProgress)
                        for t in d.tenants}
            d.drain()
        finally:
            d.close()
        path = os.path.join(root, "controller.jsonl")
        with open(path) as f:
            before = [json.loads(line) for line in f if line.strip()]
        d2 = ServeDaemon(specs("2"), root, controller=True,
                         controller_policy=policy, device=dev)
        d2.close()
        d3 = ServeDaemon(specs("3"), os.path.join(tmp, "root_depth2"),
                         pipeline_depth=2, device=dev)
        try:
            d3.process_available()
            progress2 = {t.spec.tenant_id: list(t.query.recentProgress)
                         for t in d3.tenants}
            states.update({f"{t.spec.tenant_id}@2": t.state
                           for t in d3.tenants})
        finally:
            d3.close()
    with open(path) as f:
        after = [json.loads(line) for line in f if line.strip()]
    restart = after[-1]
    last_knobs = next(r["knobs"] for r in reversed(before) if r.get("knobs"))
    out = {"decisions": decisions, "delegated": delegated,
           "journal_lines": len(before),
           "knobs": knobs, "states": states,
           "restart_delta": restart.get("delta"),
           "finalize_ms": {
               "depth1": finalize_quantiles(progress, list(chosen)),
               "depth2": finalize_quantiles(progress2, list(chosen))}}
    out["ok"] = (decisions >= 1 and len(before) == decisions + delegated
                 and restart["action"] == "restart"
                 and restart["journal_knobs"] == last_knobs == knobs
                 and bool(restart["delta"])
                 and set(states.values()) == {"OK"}
                 and all(np.array_equal(
                     sink_predictions(os.path.join(tmp, "out", f"journal{k}",
                                                   tid)),
                     sink_predictions(os.path.join(tmp, "out", "clean", tid)))
                     for tid in chosen for k in ("1", "3")))
    return out


def multi_tenant(dev, work: str) -> dict:
    """Phase 17: the multi-tenant serve daemon on the card (see the
    module docs)."""
    t0 = time.perf_counter()
    parts = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = round(time.perf_counter() - t, 1)
        return out

    tmp = os.path.join(work, "c8")
    os.makedirs(tmp)
    # (b)'s processes run beside the fits, each other and (a), whose
    # rates are printed, ungated; they are done before (c)'s controller
    # reads its latencies
    pool = ThreadPoolExecutor(2)
    chaos = pool.submit(mt_chaos, dev, work)
    try:
        data = part("data", c9_data)
        models = part("fits", c8_pipelines, dev, data, work)
        streams = part("streams", c8_streams, data["test"], tmp)
        command = pool.submit(daemon_command, dev, models, streams, tmp)
        a = part("a", c8_serve, dev, data, models, streams, tmp)
        b = part("b wait", command.result)
        b["chaos"] = part("chaos wait", chaos.result)
        a["test"] = data["test"]
        check_command(b, tmp)
        c = part("c", c11_daemon, dev, models, a, tmp)
    finally:
        pool.shutdown()
    kernels = []
    t = time.perf_counter()
    for key in sorted(a["pad_launch_shapes"]):
        n = int(key.split("]")[0][1:].split(", ")[0])
        dtype = torch.float64 if " f64 " in key else torch.float32
        kernels.append(measure_pad_at(dev, n, a["pad_launch_shapes"], dtype,
                                      int(key.split("-> ")[1])))
    parts["pads"] = round(time.perf_counter() - t, 1)
    a.pop("test", None)
    # phases 18 and 19 serve the same LR pipeline on the same test split
    shared = {"model_dir": models["lr"]["model_dir"], "test": data["test"]}
    return {"a": a, "b": b, "c": c, "kernels": kernels, "parts_s": parts,
            "seconds": time.perf_counter() - t0, "shared": shared}


def report_phase17(p17: dict, card: str) -> None:
    """Phase 17's lines: config 8's rates, latencies and placement, the
    command and chaos legs, config 11's arm B, each timed kernel shape,
    one JSON line."""
    a, b, c = p17["a"], p17["b"], p17["c"]
    ev = a["evidence"]
    log(f"phase 17 (a) bench config 8: {ev['tenants']} tenants, {ev['rows']} "
        f"rows; aggregate {a['rows_per_s']['aggregate']:.1f} rows/s, single "
        f"{a['rows_per_s']['single']:.1f} rows/s, aggregate_vs_single "
        f"{a['aggregate_vs_single']:.4f}; every batch on the card "
        f"{a['rows_per_s']['card_leg']:.1f} rows/s; noisy {ev['noisy']}; "
        f"well_behaved_p99_ratio_worst {a['well_behaved_p99_ratio_worst']}; "
        f"batches by placement {ev['placement']} [{card}]")
    for tid, lat in a["latency_ms"].items():
        log(f"phase 17 (a) {tid}: p50 {lat['p50']} ms, p99 {lat['p99']} ms "
            f"[{card}]")
    log(f"phase 17 (a) finalizeMs {a['finalize_ms']}; three tenants on "
        f"the card at depth 1 and 2 {c['journal']['finalize_ms']} [{card}]")
    log(f"phase 17 (b) serve-daemon: {b['summary']}; fsck "
        f"{b['fsck_tenants']} clean; chaos {b['chaos']} [{card}]")
    log(f"phase 17 (c) bench config 11 arm B: hand "
        f"{c['rows_per_s']['hand']:.1f} rows/s, controller "
        f"{c['rows_per_s']['ctl']:.1f} rows/s, ctl_vs_hand "
        f"{c['ctl_vs_hand']:.4f}, p99_ratio_worst {c['p99_ratio_worst']} "
        f"(reps {c['reps_s']} s); controller {c['controller']}; journal "
        f"{c['journal']} [{card}]")
    for k in p17["kernels"]:
        log(f"phase 17 {k['name']} {k['shape']}: {k['ms']:.4f} ms a call, "
            f"{k['device_ms']:.4f} ms of device time a launch (plain "
            f"{k['plain_ms']:.4f} ms; {k['library_call']} "
            f"{k['library_ms']:.4f} ms a call, {k['library_device_ms']:.4f} "
            f"ms of device time; bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}); {k['launches']} launches at this shape in "
            f"(a), max abs error {k['max_abs_err']} [{card}]")
    log("phase 17 " + json.dumps({
        "phase": 17, "card": card, "seconds": round(p17["seconds"], 3),
        "parts_s": p17["parts_s"],
        "config8": {**ev, "rows_per_s": a["rows_per_s"],
                    "aggregate_vs_single": a["aggregate_vs_single"],
                    "well_behaved_p99_ratio_worst":
                        a["well_behaved_p99_ratio_worst"],
                    "seconds": a["seconds"]},
        "command": b, "config11": c}, default=str))


# -- phases 18 and 19: replication and the fleet, in their kernel form ------

DR_CHUNK = max(96, min(512, C9_ROWS // 120))  # bench.py:3743: 512 rows
DR_TAIL_ROWS = 200  # the extra file a stream ends with: [200, 78] -> 256
DR_BUCKETS = 256
BENCH18_PHASE_FILES = (6, 6)  # bench.py:3724: pre-kill, post-promotion
#: the Nth-call kills of the JAX chaos matrix (scripts/
#: chaos_crash_matrix.py:237-242): ship fires per shipped file,
#: apply and barrier once a commit
REPL_KILL_AFTER = {"repl.ship": 4, "repl.apply": 1, "repl.barrier": 1}
BENCH14_WORKERS, BENCH14_TENANTS = 3, 10  # bench.py:2579-2580
BENCH14_PHASE_FILES = (3, 3)  # bench.py:2581: pre-kill, post-recovery
C14_LEASE_TTL_S = 1.0  # bench.py:2667
C14_BOOT_GRACE_S = 600.0
C14_WAIT_S = 300.0


def dr_shared(dev, work: str) -> dict:
    """The model and test split phases 18 and 19 serve: config 9's data
    and bench.py:3733's pipeline (StringIndexer -> VectorAssembler(78) ->
    StandardScaler(withMean) -> LR(maxIter=20)), fitted on the card and
    saved; phase 17's own fit of the same pipeline when it ran."""
    data = c9_data()
    fitted = c9_pipeline(dev).fit(data["train"])
    return {"model_dir": save_model(fitted, os.path.join(work, "model18")),
            "test": data["test"]}


def dr_write(test: Frame, at: int, rows: int, path: str) -> int:
    """``rows`` rows of the test split from ``at``, the 78 features, as
    bench.py writes them; the rows written."""
    import pyarrow.csv as pacsv

    part = test.slice(at, at + rows)
    pacsv.write_csv(part.select(CICIDS2017_FEATURES).to_arrow(), path)
    return part.num_rows


def dr_at(test: Frame, k: int) -> int:
    return (k * 131) % max(1, test.num_rows - DR_CHUNK)


def dr_link(staging: str, names: list, watch: str) -> None:
    os.makedirs(watch, exist_ok=True)
    for name in names:
        os.link(os.path.join(staging, name), os.path.join(watch, name))


def dr_argv(dev, model_dir: str, watch: str, out: str, ckpt: str,
            *extra) -> list:
    """bench.py:3774's serve flags in the kernel form (row buckets of
    256)."""
    return ["--model", model_dir, "--watch", watch, "--out", out,
            "--checkpoint", ckpt, "--max-files-per-batch", "1",
            "--poll-interval", "0.05", "--no-device-faults",
            "--shape-buckets", str(DR_BUCKETS), "--device", str(dev), *extra]


def sink_batch_files(out: str) -> dict:
    out_files = {}
    for p in sorted(glob.glob(os.path.join(out, "batch_*.csv"))):
        with open(p, "rb") as f:
            out_files[os.path.basename(p)] = f.read()
    return out_files


def summary_of(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def tail_pads_match(summaries: list, tails: int) -> bool:
    """The serving processes launched ``pad_assemble`` once for each
    200-row file they served, at ``[200, 78] f64 -> 256``, and nothing
    else: their own counts, from their summary lines."""
    key = pad_launch_shape(DR_TAIL_ROWS, len(CICIDS2017_FEATURES),
                           torch.float64, DR_BUCKETS)
    launches = sum(s["kernel_launches"]["pad_assemble"] for s in summaries)
    shapes = merged_shapes(summaries)
    return tails >= 1 and launches == tails and shapes == {key: tails}


def merged_shapes(summaries: list) -> dict:
    out: dict = {}
    for s in summaries:
        for key, n in s["pad_launch_shapes"].items():
            out[key] = out.get(key, 0) + n
    return out


def poll_until(pred, what: str, phase: str, proc=None, tick=None,
             timeout: float = C14_WAIT_S) -> None:
    """Poll ``pred`` (``tick`` first, each round) until it holds; fail
    when ``proc`` exits meanwhile or the time runs out."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if tick is not None:
            tick()
        if pred():
            return
        if proc is not None and proc.poll() is not None:
            raise SystemExit(f"phase {phase}: the process exited "
                             f"{proc.returncode} waiting for {what}")
        time.sleep(0.05)
    raise SystemExit(f"phase {phase}: no {what} after {timeout} s")


def dr_stage18(test: Frame, staging: str) -> list:
    """bench.py:3745-3754's files (512 rows each) and the extra 200-row
    file; their names."""
    os.makedirs(staging)
    names = []
    n = sum(BENCH18_PHASE_FILES)
    for fi in range(n + 1):
        name = f"part_{fi:03d}.csv"
        dr_write(test, dr_at(test, fi), DR_CHUNK if fi < n else DR_TAIL_ROWS,
                 os.path.join(staging, name))
        names.append(name)
    return names


def dr_promote(standby: str, dest: str, ckpt: str, out: str) -> dict:
    return promote_standby(standby, "default", os.path.join(dest, "ckpt"),
                           dest_sink=os.path.join(dest, "out"),
                           primary_root=ckpt, primary_sink=out)


def dr_drill(dev, model_dir: str, staging: str, names: list,
             tmp: str) -> dict:
    """(a): bench.py:3776-3900 through the port's commands."""
    n_pre = BENCH18_PHASE_FILES[0]
    ref_dir, pri = os.path.join(tmp, "ref"), os.path.join(tmp, "pri")
    dr_link(staging, names, os.path.join(ref_dir, "in"))
    watch = os.path.join(pri, "in")
    out, ckpt = os.path.join(pri, "out"), os.path.join(pri, "ckpt")
    standby = os.path.join(tmp, "standby")
    dr_link(staging, names[:n_pre], watch)
    # the unfailed reference beside the replicated primary
    ref = serve_cli(dr_argv(dev, model_dir, os.path.join(ref_dir, "in"),
                            os.path.join(ref_dir, "out"),
                            os.path.join(ref_dir, "ckpt"), "--once"))
    proc = serve_cli(dr_argv(dev, model_dir, watch, out, ckpt,
                             "--standby-root", standby))

    def sealed(bid):
        bar = last_barrier(standby, "default")
        return bar is not None and bar["batch_id"] >= bid

    poll_until(lambda: sealed(n_pre - 1), "the pre-kill phase's barrier",
             "18 (a)", proc)
    # one file past the pre-kill phase: once its commit's barrier is
    # sealed the primary idles, so the SIGKILL lands between ship passes
    dr_link(staging, names[n_pre:n_pre + 1], watch)
    poll_until(lambda: sealed(n_pre), "a barrier past the pre-kill phase",
             "18 (a)", proc)
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    dr_link(staging, names[n_pre + 1:], watch)
    ref_summary = summary_of(finished(ref, "the reference serve",
                                      phase="18 (a)"))
    ref_sink = sink_batch_files(os.path.join(ref_dir, "out"))
    pro = os.path.join(tmp, "promoted")
    report = dr_promote(standby, pro, ckpt, out)
    through = int(report.get("batches_through") or 0)
    pro_sink = sink_batch_files(os.path.join(pro, "out"))
    t_resume = time.perf_counter()
    resume = serve_cli(dr_argv(dev, model_dir, watch, os.path.join(pro, "out"),
                               os.path.join(pro, "ckpt"), "--once"))
    resume_summary = summary_of(finished(resume, "the resumed serve",
                                         phase="18 (a)"))
    resume_s = time.perf_counter() - t_resume
    final_sink = sink_batch_files(os.path.join(pro, "out"))
    evidence = {
        "stream_files": len(names),
        "killed_after_batches": int(report.get("committed_primary") or 0),
        "promotion_ok": bool(report.get("ok")),
        "batches_through_barrier": through,
        # the RPO counts are 0 by construction: the SIGKILL waits for
        # the barrier of its batch; (b)'s torn legs lose a tail.
        # rpo_seconds is the last barrier's age at the promotion
        "rpo_counts_zero_by_construction": True,
        "rpo_batches": int(report.get("tail_loss_batches") or 0),
        "rpo_rows": int(report.get("tail_loss_rows") or 0),
        "rpo_bytes": int(report.get("rpo_bytes") or 0),
        "rpo_seconds": float(report.get("rpo_seconds") or 0.0),
        "rto_seconds": float(report.get("rto_seconds") or 0.0),
        "law_exact": bool(report.get("law_exact")),
        "quarantined": len(report.get("quarantined") or ()),
        "promoted_sink_bitwise": bool(through) and all(
            pro_sink.get(f"batch_{i:06d}.csv")
            == ref_sink.get(f"batch_{i:06d}.csv") for i in range(through)),
        "final_sink_bitwise": final_sink == ref_sink,
        "resume_s": resume_s,
    }
    ok = (evidence["promotion_ok"] and evidence["law_exact"]
          and evidence["promoted_sink_bitwise"]
          and evidence["final_sink_bitwise"] and evidence["quarantined"] == 0
          and evidence["killed_after_batches"] == n_pre + 1)
    launches = {"reference": ref_summary["kernel_launches"],
                "resumed": resume_summary["kernel_launches"]}
    if not ok or not tail_pads_match([ref_summary], 1) \
            or not tail_pads_match([resume_summary], 1):
        raise SystemExit(f"phase 18 (a): {evidence}; launches {launches}")
    return {"evidence": evidence, "launches": launches, "ref_sink": ref_sink,
            "ref_commits": committed_ranges(os.path.join(ref_dir, "ckpt")),
            "summaries": [ref_summary, resume_summary],
            "primary": (ckpt, standby)}


def dr_kill_argv(dev, model_dir: str, d: str) -> list:
    return dr_argv(dev, model_dir, os.path.join(d, "in"),
                   os.path.join(d, "out"), os.path.join(d, "ckpt"), "--once",
                   "--standby-root", os.path.join(d, "standby"))


def dr_kill_legs(dev, model_dir: str, staging: str, names: list,
                 tmp: str) -> tuple:
    """(b)'s serves over the whole stream, each killed inside
    ``repl.ship`` / ``repl.apply`` / ``repl.barrier`` at the JAX matrix's
    call, all started at once; their directories and processes."""
    legs = {}
    for site in REPL_KILL_AFTER:
        d = os.path.join(tmp, "kill_" + site.replace(".", "_"))
        dr_link(staging, names, os.path.join(d, "in"))
        legs[site] = d
    killed = {site: serve_cli(dr_kill_argv(dev, model_dir, d),
                              armed=(site, REPL_KILL_AFTER[site]))
              for site, d in legs.items()}
    return legs, killed


def dr_kills(dev, model_dir: str, legs: dict, killed: dict, n_files: int,
             drilled) -> dict:
    """(b), once the killed serves have exited: the torn standby promotes
    to its last sealed barrier (its strays quarantined, never promoted) or
    refuses and leaves no tree; the clean restarts, the three beside each
    other and beside (a), converge bitwise to (a)'s reference
    (``drilled``, the future of :func:`dr_drill`); the converged standby
    promotes with zero tail loss to it."""
    for site, p in killed.items():
        finished(p, f"the serve killed at {site}", rc=KILL_EXIT_CODE,
                 phase="18 (b)")
    out = {}
    for site, d in legs.items():
        torn = dr_promote(os.path.join(d, "standby"),
                          os.path.join(d, "promoted_torn"),
                          os.path.join(d, "ckpt"), os.path.join(d, "out"))
        left = glob.glob(os.path.join(d, "promoted_torn", "ckpt", "**", "*"),
                         recursive=True)
        strays_out = not any(
            os.path.exists(os.path.join(d, "promoted_torn", "ckpt", q["rel"]))
            for q in torn.get("quarantined", []))
        out[site] = {
            "torn_ok": torn["ok"],
            "torn_reason": torn.get("reason"),
            "torn_law_exact": torn.get("law_exact"),
            "torn_tail_loss_batches": torn.get("tail_loss_batches"),
            "torn_tail_loss_rows": torn.get("tail_loss_rows"),
            "torn_rpo_bytes": torn.get("rpo_bytes"),
            "torn_rpo_seconds": torn.get("rpo_seconds"),
            "quarantined": len(torn.get("quarantined", [])),
            "torn_safe": (torn.get("law_exact") is True and strays_out)
            if torn["ok"] else not left,
        }
    restarts = {site: serve_cli(dr_kill_argv(dev, model_dir, d))
                for site, d in legs.items()}
    summaries = []
    ref = None
    for site, p in restarts.items():
        s = summary_of(finished(p, f"the restart after {site}",
                                phase="18 (b)"))
        summaries.append(s)
        d = legs[site]
        final = dr_promote(os.path.join(d, "standby"),
                           os.path.join(d, "promoted_final"),
                           os.path.join(d, "ckpt"), os.path.join(d, "out"))
        promoted = sink_batch_files(os.path.join(d, "promoted_final", "out"))
        ref = ref or drilled.result()
        out[site].update(
            launches=s["kernel_launches"]["pad_assemble"],
            bitwise=(sink_batch_files(os.path.join(d, "out"))
                     == ref["ref_sink"]
                     and committed_ranges(os.path.join(d, "ckpt"))
                     == ref["ref_commits"]),
            final_ok=(final["ok"] and final.get("law_exact") is True
                      and final.get("tail_loss_batches") == 0
                      and final.get("batches_through") == n_files
                      and promoted == ref["ref_sink"]))
    bad = {s: v for s, v in out.items()
           if not (v["torn_safe"] and v["bitwise"] and v["final_ok"])}
    if bad or out["repl.apply"]["quarantined"] < 1 \
            or not out["repl.apply"]["torn_ok"] \
            or not tail_pads_match(summaries, len(summaries)):
        raise SystemExit(f"phase 18 (b): {out}")
    return {"legs": out, "summaries": summaries}


def replication(dev, work: str, shared: dict | None = None) -> dict:
    """Phase 18: bench config 18's disaster drill on the card (see the
    module docs)."""
    t0 = time.perf_counter()
    parts = {}
    tmp = os.path.join(work, "c18")
    os.makedirs(tmp)
    t = time.perf_counter()
    shared = shared or dr_shared(dev, work)
    names = dr_stage18(shared["test"], os.path.join(tmp, "staging"))
    parts["setup"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()
    # (b)'s killed serves, and then their restarts, run beside (a)'s
    # processes
    legs, killed = dr_kill_legs(dev, shared["model_dir"],
                                os.path.join(tmp, "staging"), names,
                                os.path.join(tmp, "kills"))
    drilled = Future()
    with ThreadPoolExecutor(1) as pool:
        kills = pool.submit(dr_kills, dev, shared["model_dir"], legs,
                            killed, len(names), drilled)
        try:
            ab = dr_drill(dev, shared["model_dir"],
                          os.path.join(tmp, "staging"), names,
                          os.path.join(tmp, "drill"))
        except BaseException as e:
            drilled.set_exception(e)
            raise
        drilled.set_result(ab)
        parts["drill"] = round(time.perf_counter() - t, 1)
        t = time.perf_counter()
        c = kills.result()
    # the kill legs' seconds past the drill's
    parts["kills"] = round(time.perf_counter() - t, 1)
    ckpt, standby = ab["primary"]
    fsck = subprocess.run(
        [sys.executable, "-m", "sntc_tpu_torch", "fsck", ckpt, "--standby",
         standby], cwd=REPO, env=env_with(), capture_output=True, text=True,
        timeout=P16_WAIT_S)
    report = json.loads(fsck.stdout)
    fsck_ok = fsck.returncode == 0 and report["ok"] \
        and report["standby"]["ok"]
    if not fsck_ok:
        raise SystemExit(f"phase 18 fsck --standby: {report}")
    shapes = merged_shapes(ab["summaries"] + c["summaries"])
    key = pad_launch_shape(DR_TAIL_ROWS, len(CICIDS2017_FEATURES),
                           torch.float64, DR_BUCKETS)
    t = time.perf_counter()
    err = check_pad_shapes(dev, shapes, "phase 18")
    kernels = [measure_pad_at(dev, DR_TAIL_ROWS, {key: shapes[key]},
                              torch.float64, DR_BUCKETS)]
    parts["pads"] = round(time.perf_counter() - t, 1)
    return {"drill": ab["evidence"], "launches": ab["launches"], "kills": c["legs"],
            "fsck_standby_ok": fsck_ok, "pad_shapes": shapes,
            "pad_max_abs_err": err, "kernels": kernels, "parts_s": parts,
            "seconds": time.perf_counter() - t0}


def report_phase18(p18: dict, card: str) -> None:
    ev = p18["drill"]
    log(f"phase 18 (a) bench config 18: {ev['stream_files']} files, killed "
        f"after {ev['killed_after_batches']} batches; promotion_ok "
        f"{ev['promotion_ok']}, {ev['batches_through_barrier']} batches "
        f"through the barrier, rpo_batches {ev['rpo_batches']}, rpo_rows "
        f"{ev['rpo_rows']}, rpo_bytes {ev['rpo_bytes']} (0 by construction: "
        f"the kill waits for its batch's barrier), rpo_seconds "
        f"{ev['rpo_seconds']}, rto_seconds {ev['rto_seconds']}, resume_s "
        f"{ev['resume_s']}; law_exact {ev['law_exact']}, "
        f"promoted_sink_bitwise {ev['promoted_sink_bitwise']}, "
        f"final_sink_bitwise {ev['final_sink_bitwise']}, quarantined "
        f"{ev['quarantined']}; launches {p18['launches']} [{card}]")
    for site, leg in p18["kills"].items():
        log(f"phase 18 (b) killed at {site}: {leg} [{card}]")
    for k in p18["kernels"]:
        log(f"phase 18 {k['name']} {k['shape']}: {k['ms']:.4f} ms a call, "
            f"{k['device_ms']:.4f} ms of device time a launch (plain "
            f"{k['plain_ms']:.4f} ms; {k['library_call']} "
            f"{k['library_ms']:.4f} ms a call, {k['library_device_ms']:.4f} "
            f"ms of device time; bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}); {k['launches']} launches at this shape in "
            f"the reference, resumed and restarted serves, max abs error "
            f"{k['max_abs_err']} [{card}]")
    log("phase 18 " + json.dumps({
        "phase": 18, "card": card, "seconds": round(p18["seconds"], 3),
        "parts_s": p18["parts_s"], "config18": ev, "kills": p18["kills"],
        "fsck_standby_ok": p18["fsck_standby_ok"],
        "pad_shapes": p18["pad_shapes"]}, default=str))


def c14_stage(test: Frame, staging: str, tids: list) -> dict:
    """bench.py:2607-2618's files, 512 rows each, and each tenant's extra
    200-row file; the rows of each."""
    os.makedirs(staging)
    n = sum(BENCH14_PHASE_FILES)
    rows = {}
    for ti, tid in enumerate(tids):
        for fi in range(n + 1):
            rows[tid, fi] = dr_write(
                test, dr_at(test, ti * n + fi),
                DR_CHUNK if fi < n else DR_TAIL_ROWS,
                os.path.join(staging, f"{tid}_part_{fi:03d}.csv"))
    return rows


def fleet_worker(argv: list, wid: str, logs: str) -> tuple:
    """One ``fleet-serve --fleet-worker-id`` process, its output to
    files (it runs for the whole pass)."""
    out = open(os.path.join(logs, f"{wid}.out"), "w")
    err = open(os.path.join(logs, f"{wid}.err"), "w")
    proc = subprocess.Popen(argv + ["--fleet-worker-id", wid], cwd=REPO,
                            env=env_with(), stdout=out, stderr=err)
    out.close()
    err.close()
    return proc


def fleet_stop(procs: dict, logs: str, killed: str | None) -> dict:
    """SIGTERM every live worker (the drain marker is up) and wait for
    each drain; a worker that hangs gets SIGABRT and its threads' stacks
    fail the phase.  Each drained worker's summary line."""
    for wid, p in procs.items():
        if wid != killed and p.poll() is None:
            p.terminate()
    lines = {}
    for wid, p in procs.items():
        if wid == killed:
            continue
        try:
            p.wait(timeout=P16_WAIT_S)
        except subprocess.TimeoutExpired:
            p.send_signal(signal.SIGABRT)
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            with open(os.path.join(logs, f"{wid}.err")) as f:
                raise SystemExit(f"phase 19: worker {wid} still draining "
                                 f"after {P16_WAIT_S} s:\n{f.read()[-6000:]}")
        with open(os.path.join(logs, f"{wid}.err")) as f:
            err = f.read()
        if p.returncode != 0:
            raise SystemExit(f"phase 19: worker {wid} exited "
                             f"{p.returncode}:\n{err[-3000:]}")
        with open(os.path.join(logs, f"{wid}.out")) as f:
            lines[wid] = summary_of(f.read())
    return lines


def c14_pass(dev, model_dir: str, staging: str, rows: dict, tids: list,
             tmp: str, name: str, kill: bool) -> dict:
    """One pass of bench.py:2637-2802: 3 ``fleet-serve --fleet-worker-id``
    children under an in-process coordinator; the kill pass SIGKILLs
    the most-loaded worker once every tenant has committed a batch, waits
    for the dead-worker recovery, scales out a fourth worker and waits
    for it to join; then the second phase's files (with each tenant's
    200-row file) are fed and served."""
    n = sum(BENCH14_PHASE_FILES)
    worker_ids = [f"w{i}" for i in range(BENCH14_WORKERS)]
    pass_dir = os.path.join(tmp, name)
    root, logs = os.path.join(pass_dir, "root"), os.path.join(pass_dir, "logs")
    os.makedirs(logs)

    def feed(tid, lo, hi):
        dr_link(staging, [f"{tid}_part_{fi:03d}.csv" for fi in range(lo, hi)],
                os.path.join(pass_dir, "in", tid))

    def batches(tid):
        return sorted(glob.glob(os.path.join(pass_dir, "out", tid,
                                             "batch_*.csv")))

    def rows_done():
        done = 0
        for tid in tids:
            for p in batches(tid):
                with open(p, "rb") as f:
                    done += max(0, f.read().count(b"\n") - 1)
        return done

    entries = []
    for tid in tids:
        feed(tid, 0, BENCH14_PHASE_FILES[0])
        entries.append({"id": tid, "model": model_dir,
                        "watch": os.path.join(pass_dir, "in", tid),
                        "out": os.path.join(pass_dir, "out", tid)})
    tenants_json = os.path.join(pass_dir, "tenants.json")
    with open(tenants_json, "w") as f:
        json.dump({"tenants": entries}, f)
    coord = FleetCoordinator(
        root, worker_ids,
        {tid: SimpleNamespace(placement_cost=None, weight=1.0,
                              pinned_worker=None) for tid in tids},
        lease_ttl_s=C14_LEASE_TTL_S, boot_grace_s=C14_BOOT_GRACE_S)
    argv = [sys.executable, "-m", "sntc_tpu_torch", "fleet-serve",
            "--tenants", tenants_json, "--root", root, "--poll-interval",
            "0.05", "--no-device-faults", "--shape-buckets",
            str(DR_BUCKETS), "--device", str(dev)]
    procs = {wid: fleet_worker(argv, wid, logs) for wid in worker_ids}
    out: dict = {"killed_worker": None}
    try:
        poll_until(lambda: all(batches(t) for t in tids),
                 "first committed batch per tenant", f"19 {name}",
                 tick=coord.tick)
        t_mid = time.perf_counter()
        rows_mid = rows_done()
        if kill:
            victim = max(worker_ids, key=lambda w: sum(
                1 for e in coord.assignments.values() if e["worker"] == w))
            out["killed_worker"] = victim
            out["dead_tenants"] = sorted(
                t for t, e in coord.assignments.items()
                if e["worker"] == victim)
            procs[victim].kill()
            procs[victim].wait()
            poll_until(lambda: (
                coord.status()["workers"][victim]["state"] == "dead"
                and all(e["phase"] == "serving" and e["worker"] != victim
                        for e in coord.assignments.values())),
                "dead-worker recovery", f"19 {name}", tick=coord.tick)
            out["recovery_s"] = time.perf_counter() - t_mid
            newid = f"w{BENCH14_WORKERS}"
            procs[newid] = fleet_worker(argv, newid, logs)
            coord.add_worker(newid)
            out["scaled_out_worker"] = newid
            poll_until(lambda: (
                coord.status()["workers"][newid]["state"] == "live"
                and all(e["phase"] == "serving"
                        for e in coord.assignments.values())),
                "the scale-out worker joining", f"19 {name}",
                tick=coord.tick)
        t2 = time.perf_counter()
        for tid in tids:
            feed(tid, BENCH14_PHASE_FILES[0], n + 1)
        poll_until(lambda: all(len(batches(t)) == n + 1 for t in tids),
                 "every tenant fully served", f"19 {name}", tick=coord.tick)
        t_end = time.perf_counter()
        rows_end = rows_done()
        out["rows"] = rows_end
        out["rows_per_s"] = (rows_end - rows_mid) / (t_end - t_mid)
        out["recovered_rows_per_s"] = sum(
            rows[t, fi] for t in tids
            for fi in range(BENCH14_PHASE_FILES[0], n + 1)) / (t_end - t2)
        out["migrations"] = dict(coord.migrations)
        out["assignments"] = {t: dict(e) for t, e in
                              coord.assignments.items()}
        out["sinks"] = {
            tid: sink_batch_files(os.path.join(pass_dir, "out", tid))
            for tid in tids}
    finally:
        coord.drain_fleet("smoke")
        try:
            out["workers"] = fleet_stop(procs, logs, out["killed_worker"])
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
            coord.tick()
            coord.close()
    out["root"] = root
    out["homes"] = {t: sorted(
        p.split(os.sep)[-3] for p in glob.glob(
            os.path.join(root, "worker", "*", "tenant", t)))
        for t in tids}
    out["retired"] = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(root, "fleet", "retired", "*")))
    return out


def fleet_serving(dev, work: str, shared: dict | None = None) -> dict:
    """Phase 19: bench config 14's worker death on the card (see the
    module docs)."""
    t0 = time.perf_counter()
    parts = {}
    tmp = os.path.join(work, "c14")
    os.makedirs(tmp)
    t = time.perf_counter()
    shared = shared or dr_shared(dev, work)
    tids = [f"t{i}" for i in range(BENCH14_TENANTS)]
    staging = os.path.join(tmp, "staging")
    rows = c14_stage(shared["test"], staging, tids)
    parts["setup"] = round(time.perf_counter() - t, 1)
    passes = {}
    for name, kill in (("reference", False), ("killed", True)):
        t = time.perf_counter()
        passes[name] = c14_pass(dev, shared["model_dir"], staging, rows,
                                tids, tmp, name, kill)
        parts[name] = round(time.perf_counter() - t, 1)
    ref, k = passes["reference"], passes["killed"]
    victim = k["killed_worker"]
    drained = {name: p["workers"] for name, p in passes.items()}
    launches = {name: sum(s["kernel_launches"]["pad_assemble"]
                          for s in lines.values())
                for name, lines in drained.items()}
    evidence = {
        "workers": BENCH14_WORKERS, "tenants": BENCH14_TENANTS,
        "stream_files": BENCH14_TENANTS * (sum(BENCH14_PHASE_FILES) + 1),
        "killed_worker": victim,
        "scaled_out_worker": k["scaled_out_worker"],
        "dead_tenants_migrated": len(k["dead_tenants"]),
        "dead_tenants": k["dead_tenants"],
        "migrations": k["migrations"],
        "reference_migrations": ref["migrations"],
        "recovery_s": k["recovery_s"],
        "zero_committed_rows_lost": all(k["sinks"][t] == ref["sinks"][t]
                                        for t in tids),
        "recovered_rows_per_s": k["recovered_rows_per_s"],
        "reference_rows_per_s": ref["recovered_rows_per_s"],
        "recovered_over_reference": (k["recovered_rows_per_s"]
                                     / ref["recovered_rows_per_s"]),
        "single_homed": all(
            p["homes"][t] == [p["assignments"][t]["worker"]]
            for p in passes.values() for t in tids),
        "retired_not_deleted": all(
            any(r.startswith(f"{t}.{victim}.") for r in k["retired"])
            for t in k["dead_tenants"]),
        # the SIGKILLed worker prints no line: its launches are not
        # counted, and it served no 200-row file (the kill precedes the
        # second phase's feed)
        "pad_launches_drained": launches,
        "tail_files_served_by_drained": {name: len(tids) for name in passes},
    }
    root = k["root"]
    fsck = subprocess.run(
        [sys.executable, "-m", "sntc_tpu_torch", "fsck", root, "--fleet-root"],
        cwd=REPO, env=env_with(), capture_output=True, text=True,
        timeout=P16_WAIT_S)
    evidence["fsck_fleet_ok"] = fsck.returncode == 0 and json.loads(
        fsck.stdout)["ok"]
    restored = os.path.join(tmp, "restored")
    name = min((r for r in k["retired"] if r.split(".")[1] == victim),
               default="")
    rr = subprocess.run(
        [sys.executable, "-m", "sntc_tpu_torch", "fleet-restore-retired",
         root, name, "--dest", restored], cwd=REPO, env=env_with(),
        capture_output=True, text=True, timeout=P16_WAIT_S)
    verify = subprocess.run(
        [sys.executable, "-m", "sntc_tpu_torch", "fsck",
         os.path.join(restored, "ckpt"), "--no-repair"], cwd=REPO,
        env=env_with(), capture_output=True, text=True, timeout=P16_WAIT_S)
    evidence["restore_retired"] = {
        "name": name,
        "ok": rr.returncode == 0 and json.loads(rr.stdout).get("ok") is True,
        "fsck_ok": verify.returncode == 0
        and json.loads(verify.stdout)["ok"]}
    pads_ok = all(tail_pads_match(list(lines.values()), len(tids))
                  for lines in drained.values())
    if not (evidence["zero_committed_rows_lost"]
            and k["migrations"]["reverted"] == 0
            and evidence["dead_tenants_migrated"] >= 1
            and evidence["single_homed"] and evidence["retired_not_deleted"]
            and evidence["fsck_fleet_ok"]
            and evidence["restore_retired"]["ok"]
            and evidence["restore_retired"]["fsck_ok"] and pads_ok):
        raise SystemExit(f"phase 19: {evidence}; workers {drained}")
    shapes = merged_shapes([s for lines in drained.values()
                            for s in lines.values()])
    key = pad_launch_shape(DR_TAIL_ROWS, len(CICIDS2017_FEATURES),
                           torch.float64, DR_BUCKETS)
    t = time.perf_counter()
    err = check_pad_shapes(dev, shapes, "phase 19")
    kernels = [measure_pad_at(dev, DR_TAIL_ROWS, {key: shapes[key]},
                              torch.float64, DR_BUCKETS)]
    parts["pads"] = round(time.perf_counter() - t, 1)
    return {"evidence": evidence, "workers": drained, "pad_shapes": shapes,
            "pad_max_abs_err": err, "kernels": kernels, "parts_s": parts,
            "seconds": time.perf_counter() - t0}


def report_phase19(p19: dict, card: str) -> None:
    ev = p19["evidence"]
    log(f"phase 19 bench config 14: {ev['workers']} workers, {ev['tenants']} "
        f"tenants, {ev['stream_files']} files; killed {ev['killed_worker']}, "
        f"{ev['dead_tenants_migrated']} dead tenants migrated "
        f"{ev['dead_tenants']}, scaled out {ev['scaled_out_worker']}; "
        f"migrations {ev['migrations']} (reference pass "
        f"{ev['reference_migrations']}); recovery_s {ev['recovery_s']:.3f}; "
        f"recovered {ev['recovered_rows_per_s']:.1f} rows/s against the "
        f"reference's {ev['reference_rows_per_s']:.1f} "
        f"({ev['recovered_over_reference']:.4f}); zero_committed_rows_lost "
        f"{ev['zero_committed_rows_lost']}, single-homed "
        f"{ev['single_homed']}, retired not deleted "
        f"{ev['retired_not_deleted']}, fsck --fleet-root "
        f"{ev['fsck_fleet_ok']}, fleet-restore-retired "
        f"{ev['restore_retired']} [{card}]")
    log(f"phase 19 pad_assemble launches of the drained workers "
        f"{ev['pad_launches_drained']} for their 200-row files "
        f"{ev['tail_files_served_by_drained']}; the SIGKILLed worker prints "
        f"no line, so its launches are not counted (it served no 200-row "
        f"file) [{card}]")
    for k in p19["kernels"]:
        log(f"phase 19 {k['name']} {k['shape']}: {k['ms']:.4f} ms a call, "
            f"{k['device_ms']:.4f} ms of device time a launch (plain "
            f"{k['plain_ms']:.4f} ms; {k['library_call']} "
            f"{k['library_ms']:.4f} ms a call, {k['library_device_ms']:.4f} "
            f"ms of device time; bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}); {k['launches']} launches at this shape in the "
            f"drained workers, max abs error {k['max_abs_err']} [{card}]")
    log("phase 19 " + json.dumps({
        "phase": 19, "card": card, "seconds": round(p19["seconds"], 3),
        "parts_s": p19["parts_s"], "config14": ev,
        "workers": p19["workers"], "pad_shapes": p19["pad_shapes"]},
        default=str))


# -- phase 20: the families pass and the statistics ---------------------------

FAM_SEED = 7  # bench.py:226
FAM_ROWS = 200_000  # bench.py:4870, the --rows of the families pass
FAM_JAX_GMM_LL = -29.9746  # bench_runs.jsonl:66 (the JAX package, CPU)
FAM_JAX_LDA_PERPLEXITY = 5.9284  # bench_runs.jsonl:67 (the JAX package, CPU)
FAM_KM_RTOL = 1e-5  # tests/test_torch_clustering.py's KMeans tolerance
# BisectingKMeans on the lognormal rows: each split starts from its
# parent ± 1e-4, so f32 rounding decides ~1 % of a split's first
# assignment and the card's and the CPU's 2-means reach other local optima
# (0.067 of the largest center apart, costs 9.5e-5 apart, the same tree,
# on an NVIDIA H100 80GB HBM3 at 700 W): held to the same tree and a cost
# within this; the same estimator on the GMM's five blobs is held to
# FAM_KM_RTOL
FAM_BISECT_COST_RTOL = 1e-3
FAM_TIE_RTOL = 1e-5  # near-tie rows: the two nearest within this share
FAM_GMM_TOL = 1e-4  # tests/test_torch_clustering.py's GMM tolerance
FAM_E_STEP_RTOL = 1e-4  # tests/test_torch_lda_als.py's E-step tolerance
FAM_PERPLEXITY_RTOL = 0.01  # ... and its whole-fit tolerance
FAM_ALS_TOL = 1e-4  # ... and ALS's
FAM_PIC_TOL = 1e-4  # tests/test_torch_clustering.py's PIC tolerance
FAM_PIC_BLOCKS, FAM_PIC_BLOCK = 4, 750  # PIC's graph: 3 000 vertices
# the moment statistics against their float64 sums, of the largest: one
# float32 pass about a pilot row (the JAX package's) on the heavy-tailed
# flow features lies 3e-6 to 3.4e-5 from them at 199 800 rows, by the
# summation order (the card and the CPU's threads); tests/test_torch_
# stat.py holds 1e-5 between the packages at 4 003 rows
ST_MOMENT_RTOL = 1e-4
ST_WIDE_BINS = 4096  # quantile bins of the wide chi-square feature
ST_TOP = 40  # the selectors' numTopFeatures (config 3's TOP)


def fam_data() -> dict:
    """The families pass's data (``bench.py:3959-4094``): one
    ``default_rng(7)``, drawn in its order at its 200 000 rows — KMeans'
    lognormal rows, GMM's five gaussians, LDA's corpus, ALS's implicit
    ratings — and PIC's graph of 4 blocks of 750 vertices from seed 8."""
    rng = np.random.default_rng(FAM_SEED)
    Xk = rng.lognormal(0.5, 1.2, size=(FAM_ROWS, 78)).astype(np.float32)
    n_gm = min(FAM_ROWS, 50_000)
    centers = rng.normal(size=(5, 20)) * 4
    Xg = (
        centers[rng.integers(0, 5, n_gm)]
        + rng.normal(size=(n_gm, 20))
    ).astype(np.float32)
    n_docs, vocab, k_t = min(FAM_ROWS // 40, 5_000), 1_000, 10
    beta = rng.dirichlet([0.05] * vocab, size=k_t)
    theta = rng.dirichlet([0.3] * k_t, size=n_docs)
    Xl = np.zeros((n_docs, vocab), np.float32)
    for d0 in range(0, n_docs, 1_000):
        d1 = min(d0 + 1_000, n_docs)
        probs = theta[d0:d1] @ beta
        Xl[d0:d1] = np.stack(
            [rng.multinomial(120, probs[i]) for i in range(d1 - d0)]
        )
    n_r = 500_000
    users = rng.integers(0, 20_000, n_r)
    items = rng.integers(0, 2_000, n_r)
    ratings = rng.integers(1, 6, n_r).astype(np.float32)
    g = np.random.default_rng(FAM_SEED + 1)
    n = FAM_PIC_BLOCKS * FAM_PIC_BLOCK
    block = np.arange(n) // FAM_PIC_BLOCK
    iu, ju = np.triu_indices(n, 1)
    same = block[iu] == block[ju]
    # dense blocks, few bridges: the embedding's block levels lie apart
    # (at 0.02 / 0.0005, 1e-6 of noise on v moved vertices between
    # clusters)
    keep = g.random(len(iu)) < np.where(same, 0.1, 0.0001)
    return {
        "kmeans": Frame({"features": Xk}),
        "gmm": Frame({"features": Xg}),
        "lda": Frame({"features": Xl}),
        "als": Frame({"user": users, "item": items, "rating": ratings}),
        "pic": Frame({"src": iu[keep].astype(np.int64),
                      "dst": ju[keep].astype(np.int64),
                      "weight": np.where(same[keep], 1.0, 0.1)}),
        "pic_blocks": block,
    }


def fam_fit(name: str, dev, data: dict, mesh=None):
    """One family's fit on ``dev`` (over ``mesh`` when given): ``(model
    or PIC, fit_stats)``."""
    on = {"device": dev, "mesh": mesh}
    if name == "kmeans":
        m = KMeans(**on, k=8, maxIter=20, seed=FAM_SEED).fit(data["kmeans"])
    elif name == "bisecting_kmeans":
        m = BisectingKMeans(**on, k=8, seed=FAM_SEED).fit(data["kmeans"])
    elif name == "bisecting_kmeans_blobs":
        m = BisectingKMeans(**on, k=5, seed=FAM_SEED).fit(data["gmm"])
    elif name == "gaussian_mixture":
        m = GaussianMixture(**on, k=5, maxIter=30, seed=FAM_SEED,
                            tol=1e-3).fit(data["gmm"])
    elif name == "lda":
        m = LDA(**on, k=10, maxIter=20, subsamplingRate=0.1,
                seed=FAM_SEED).fit(data["lda"])
    elif name == "als":
        m = ALS(**on, rank=16, maxIter=5, regParam=0.05,
                implicitPrefs=True, seed=FAM_SEED).fit(data["als"])
    else:
        m = PowerIterationClustering(**on, k=FAM_PIC_BLOCKS, maxIter=20,
                                     weightCol="weight", seed=FAM_SEED)
        m.clusters = m.assignClusters(data["pic"])
    return m, m.fit_stats


FAM_NAMES = ("kmeans", "bisecting_kmeans", "bisecting_kmeans_blobs",
             "gaussian_mixture", "lda", "als", "pic")


class FamilyFits(CpuFits):
    """Phase 20's CPU side, made by ``chip_smoke.py --side family_fits
    DIR`` in a process of its own that starts after phase 12 (at once
    under ``--phases``), on the families' data and config 3's rows
    regenerated from their seeds; the card's fits and statistics are
    compared with it."""

    SIDE = "family_fits"

    def model(self, name: str):
        if name == "pic":
            return self.arrays("pic")
        m = super().model(name)
        with open(os.path.join(self.out, name, "summary.json")) as f:
            summ = json.load(f)
        if summ is not None:  # the fit's summary, which saving drops
            m.summary = TrainingSummary(summ["objectiveHistory"],
                                        summ["totalIterations"])
            m.summary.trainingCost = m.summary.logLikelihood = \
                summ["objectiveHistory"][0]
        return m


def background_side() -> None:
    """Phase 20's and 21's CPU processes start after phase 12 and are
    needed only at the run's end: ``SIDE_THREADS`` threads each, at a
    lower scheduling priority, so the phases they overlap keep most of
    the host."""
    os.nice(10)
    torch.set_num_threads(SIDE_THREADS)


# a fixed count, not a share of ``os.cpu_count()``: a CPU product's sums
# take their order from the thread count, and a reference that follows
# the host's count is another reference on another host (a quarter of
# the 8 cores of the card's machine)
SIDE_THREADS = 2


def family_fits_main(out: str) -> int:
    """``--side family_fits DIR``: phase 20's CPU side, saved under DIR: the
    families' fits (PIC's clusters and embedding as ``pic.npz``), and
    the statistics path on config 3's rows with the float64 oracle of its
    moments (``stat_cpu.npz``, ``stat_f64.npz``); prints the seconds of
    each as one JSON line."""
    cpu = torch.device("cpu")
    background_side()
    secs = {}
    t0 = time.perf_counter()
    inp = st20_inputs(config3_train(), cpu)
    st = st20_run(cpu, inp)
    np.savez(os.path.join(out, "stat_cpu.npz"), **st20_flat(st["out"]))
    np.savez(os.path.join(out, "stat_f64.npz"), **st20_oracle(inp))
    np.savez(os.path.join(out, "stat_inputs.npz"), binned=inp["binned"],
             wide=inp["wide"])
    secs["statistics"] = time.perf_counter() - t0
    data = fam_data()
    for name in FAM_NAMES:
        t0 = time.perf_counter()
        m, stats = fam_fit(name, cpu, data)
        secs[name] = time.perf_counter() - t0
        if name == "pic":
            np.savez(os.path.join(out, "pic.npz"), id=m.clusters["id"],
                     cluster=m.clusters["cluster"],
                     embedding=stats["embedding"],
                     steps=stats["power_steps"])
        else:
            save_model(m, os.path.join(out, name))
            summ = getattr(m, "summary", None)
            with open(os.path.join(out, name, "summary.json"), "w") as f:
                json.dump(None if summ is None else {
                    "objectiveHistory": summ.objectiveHistory,
                    "totalIterations": summ.totalIterations}, f)
    return side_done(secs)


def fam_rel(a, b) -> float:
    """Largest difference over the largest magnitude (the tests' rule)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.nanmax(np.abs(a - b)) / max(np.nanmax(np.abs(b)), 1e-30))


def near_ties(d: np.ndarray, rtol: float) -> np.ndarray:
    """Rows whose two smallest of ``d [N, k]`` lie within ``rtol`` of the
    smallest's magnitude (at least 1)."""
    two = np.sort(d, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) <= rtol * np.maximum(np.abs(two[:, 0]),
                                                        1.0)


FAM_PROFILED = ("kmeans", "gaussian_mixture", "lda", "als")  # the bench's


def fam_card_fits(dev, data: dict) -> dict:
    """Every family fitted on the card cold and warm; the bench's four
    once more under a profiler window (device busy ms, idle share)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = {}
    for name in FAM_NAMES:
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m, stats = fam_fit(name, dev, data)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = {"model": m, "cold_s": times[0], "warm_s": times[1],
                     "host_reads": stats["host_reads"]}
        if name not in FAM_PROFILED:
            continue
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fam_fit(name, dev, data)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ops = _device_ms(prof)
        busy = sum(ops.values())
        out[name].update({
            "profiled_s": wall, "device_ms": busy,
            # no device event in the window: not measured, not idle
            "device_idle_share": (max(0.0, 1.0 - busy / (wall * 1e3))
                                  if ops else None),
            "top_device_ops_ms": {k: round(v, 3)
                                  for k, v in list(ops.items())[:4]},
        })
    return out


def fam_compare(dev, data: dict, card: dict, cpu: FamilyFits,
                fails: list) -> dict:
    """Each card fit held against the CPU fit of the same data, with the
    tests' tolerances; KMeans-like predictions equal except on near-tie
    rows (the two nearest centers within ``FAM_TIE_RTOL``).  A check that
    fails adds its message to ``fails``."""
    res = {}
    Xk = data["kmeans"]["features"]
    # KMeans
    mc, mh = card["kmeans"]["model"], cpu.model("kmeans")
    pc, ph = mc.predict(Xk), mh.predict(Xk)
    ties = near_ties(_sq_dists(Xk.astype(np.float64), mh.clusterCenters,
                               False), FAM_TIE_RTOL)
    res["kmeans"] = {
        "centers_rel": fam_rel(mc.clusterCenters, mh.clusterCenters),
        "cost_rel": abs(mc.summary.trainingCost / mh.summary.trainingCost
                        - 1.0),
        "iterations": [mc.summary.totalIterations,
                       mh.summary.totalIterations],
        "rows_differing": int((pc != ph).sum()),
        "near_tie_rows": int(ties.sum()),
        "cost": mc.summary.trainingCost,
    }
    r = res["kmeans"]
    if (r["centers_rel"] > FAM_KM_RTOL or r["cost_rel"] > FAM_KM_RTOL
            or r["iterations"][0] != r["iterations"][1]
            or ((pc != ph) & ~ties).any()):
        fails.append(f"phase 20 KMeans: the card's fit is not the "
                         f"CPU's: {r}")
    # ClusteringEvaluator on the card fit's predictions
    ev = ClusteringEvaluator()
    s_card = ev.evaluate(Frame({"features": Xk, "prediction": pc}))
    s_cpu = ev.evaluate(Frame({"features": Xk, "prediction": ph}))
    res["silhouette"] = {"card": s_card, "cpu": s_cpu}
    if r["rows_differing"] == 0 and s_card != s_cpu:
        fails.append(f"phase 20 silhouette: {s_card} != {s_cpu}")
    # BisectingKMeans: on the lognormal rows the same tree and cost, on
    # the GMM's blobs the same fit
    for name, X, strict in (("bisecting_kmeans", Xk, False),
                            ("bisecting_kmeans_blobs",
                             data["gmm"]["features"], True)):
        bc, bh = card[name]["model"], cpu.model(name)
        same_tree = (np.array_equal(bc._left, bh._left)
                     and np.array_equal(bc._right, bh._right))
        pbc, pbh = bc.predict(X), bh.predict(X)
        ties = near_ties(_sq_dists(X.astype(np.float64), bh.clusterCenters,
                                   False), FAM_TIE_RTOL)
        r = res[name] = {
            "same_tree": same_tree,
            "centers_rel": (fam_rel(bc.clusterCenters, bh.clusterCenters)
                            if same_tree else None),
            "rows_differing": int((pbc != pbh).sum()),
            "near_tie_rows": int(ties.sum()),
            "cost": bc.summary.trainingCost,
            "cost_rel": abs(bc.summary.trainingCost
                            / bh.summary.trainingCost - 1.0),
        }
        if not same_tree or r["cost_rel"] > (
                FAM_KM_RTOL if strict else FAM_BISECT_COST_RTOL) or (
                strict and (r["centers_rel"] > FAM_KM_RTOL
                            or ((pbc != pbh) & ~ties).any())):
            fails.append(f"phase 20 {name}: the card's fit is not the "
                         f"CPU's: {r}")
    # GaussianMixture
    gc, gh = card["gaussian_mixture"]["model"], cpu.model("gaussian_mixture")
    Xg = data["gmm"]["features"]
    prob_c, prob_h = gc.predictProbability(Xg), gh.predictProbability(Xg)
    top2 = np.sort(prob_h, axis=1)[:, -2:]
    gties = (top2[:, 1] - top2[:, 0]) <= FAM_GMM_TOL
    res["gaussian_mixture"] = {
        "loglik": gc.summary.logLikelihood,
        "loglik_cpu": gh.summary.logLikelihood,
        "iterations": [gc.summary.totalIterations,
                       gh.summary.totalIterations],
        "means_abs": float(np.abs(gc.means - gh.means).max()),
        "covs_abs": float(np.abs(gc.covs - gh.covs).max()),
        "weights_abs": float(np.abs(gc.weights - gh.weights).max()),
        "rows_differing": int((prob_c.argmax(1) != prob_h.argmax(1)).sum()),
    }
    r = res["gaussian_mixture"]
    if (max(r["means_abs"], r["covs_abs"], r["weights_abs"],
            abs(r["loglik"] - r["loglik_cpu"])) > FAM_GMM_TOL
            or r["iterations"][0] != r["iterations"][1]
            or ((prob_c.argmax(1) != prob_h.argmax(1)) & ~gties).any()):
        fails.append(f"phase 20 GaussianMixture: the card's fit is not "
                         f"the CPU's: {r}")
    # LDA: the fits' perplexities, and one E-step on the card and the CPU
    lc, lh = card["lda"]["model"], cpu.model("lda")
    perp_c = lc.logPerplexity(data["lda"])
    perp_h = lh.logPerplexity(data["lda"])
    Xl = data["lda"]["features"]
    eeb = np.exp(psi(lc.lam) - psi(lc.lam.sum(axis=1, keepdims=True))
                 ).astype(np.float32)
    g0 = gamma0(FAM_SEED, (0,), Xl.shape[0], lc.lam.shape[0])
    steps = {}
    for tag, d in (("card", dev), ("cpu", torch.device("cpu"))):
        g, s, it, _ = e_step(torch.from_numpy(Xl).to(d),
                             torch.from_numpy(eeb).to(d), lc.alpha,
                             torch.from_numpy(g0).to(d))
        steps[tag] = (g.cpu().numpy(), s.cpu().numpy(), it)
    res["lda"] = {
        "log_perplexity": perp_c, "log_perplexity_cpu": perp_h,
        "e_step_gamma_rel": fam_rel(steps["card"][0], steps["cpu"][0]),
        "e_step_stat_rel": fam_rel(steps["card"][1], steps["cpu"][1]),
        "e_step_updates": [steps["card"][2], steps["cpu"][2]],
    }
    r = res["lda"]
    if (abs(perp_c / perp_h - 1.0) > FAM_PERPLEXITY_RTOL
            or r["e_step_gamma_rel"] > FAM_E_STEP_RTOL
            or r["e_step_stat_rel"] > FAM_E_STEP_RTOL
            or r["e_step_updates"][0] != r["e_step_updates"][1]):
        fails.append(f"phase 20 LDA: the card is not the CPU: {r}")
    # ALS
    ac, ah = card["als"]["model"], cpu.model("als")
    res["als"] = {
        "user_rel": fam_rel(ac.userFactors["features"],
                            ah.userFactors["features"]),
        "item_rel": fam_rel(ac.itemFactors["features"],
                            ah.itemFactors["features"]),
    }
    if max(res["als"].values()) > FAM_ALS_TOL:
        fails.append(f"phase 20 ALS: the card's factors are not the "
                         f"CPU's: {res['als']}")
    # PIC
    pic, ref = card["pic"]["model"], cpu.model("pic")
    cl, cl_h = np.asarray(pic.clusters["cluster"]), ref["cluster"]
    pairs = set(zip(cl.tolist(), cl_h.tolist()))
    blocks = data["pic_blocks"][np.asarray(pic.clusters["id"])]
    res["pic"] = {
        "v_rel": fam_rel(pic.fit_stats["embedding"], ref["embedding"]),
        "steps": [pic.fit_stats["power_steps"], int(ref["steps"])],
        "same_partition": len(pairs) == len(set(cl.tolist()))
        == len(set(cl_h.tolist())),
        "block_purity": float(np.mean([
            np.bincount(cl[blocks == b]).max() / FAM_PIC_BLOCK
            for b in range(FAM_PIC_BLOCKS)])),
    }
    r = res["pic"]
    if (r["v_rel"] > FAM_PIC_TOL or r["steps"][0] != r["steps"][1]
            or not r["same_partition"]):
        fails.append(f"phase 20 PIC: the card is not the CPU: {r}")
    return res


def config3_train() -> Frame:
    """Config 3's training rows (phase 4's split): 250 000 generated
    flows from seed 0, cleaned, the 0.8 share."""
    raw = generate_frame(TRAIN_ROWS, seed=SEED, min_class_fraction=0.005)
    train, _ = clean_flows(raw).random_split(
        [1 - TEST_FRACTION, TEST_FRACTION], seed=SEED)
    return train


def st20_inputs(train: Frame, dev) -> dict:
    """The statistics' inputs: the 78 raw features, the 15 label ids, the
    features quantile-binned to 32 bins on the card, and the wide
    chi-square input (the feature of most distinct values binned to 4 096
    quantiles, beside the first binned feature)."""
    X = np.stack([train[c] for c in CICIDS2017_FEATURES],
                 axis=1).astype(np.float32)
    y = StringIndexer(inputCol="Label", outputCol="label").fit(
        train).transform(train)["label"]
    binned = bin_features(
        torch.from_numpy(X).to(dev),
        torch.from_numpy(quantile_bin_edges(X, BINS)).to(dev)).cpu().numpy()
    j = int(np.argmax([len(np.unique(X[:, i])) for i in range(X.shape[1])]))
    col = X[:, [j]]
    wide = bin_features(
        torch.from_numpy(col).to(dev),
        torch.from_numpy(quantile_bin_edges(col, ST_WIDE_BINS)).to(dev)
    ).cpu().numpy()[:, 0]
    t = CICIDS2017_FEATURES.index(REG_TARGET)
    return {
        "X": X, "y": y, "binned": binned,
        "wide": np.stack([wide, binned[:, 0]], axis=1),
        "wide_feature": CICIDS2017_FEATURES[j],
        "X77": np.delete(X, t, axis=1),
        "target": np.log1p(np.abs(X[:, t].astype(np.float64))),
    }


def st20_run(dev, inp: dict) -> dict:
    """The statistics path on ``dev``: each result, its seconds, and the
    ``tree_hist`` launches of its two chi-square shapes."""
    X, y = inp["X"], inp["y"]
    out, secs = {}, {}

    def timed20(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t0

    l0 = LAUNCHES["tree_hist"]
    timed20("chi_square", lambda: ChiSquareTest.test(
        Frame({"f": inp["binned"], "label": y}), "f", "label", device=dev))
    timed20("ufs_chi2", lambda: UnivariateFeatureSelector(
        device=dev, featureType="categorical", labelType="categorical",
        selectionThreshold=ST_TOP).fit(Frame({"features": X, "label": y})))
    l1 = LAUNCHES["tree_hist"]
    timed20("wide_chi_square", lambda: ChiSquareTest.test(
        Frame({"f": inp["wide"], "label": y}), "f", "label", device=dev))
    l2 = LAUNCHES["tree_hist"]
    timed20("ufs_anova", lambda: UnivariateFeatureSelector(
        device=dev, featureType="continuous", labelType="categorical",
        selectionThreshold=ST_TOP).fit(Frame({"features": X, "label": y})))
    timed20("anova", lambda: ANOVATest.test(
        Frame({"features": X, "label": y}), "features", "label",
        device=dev))
    timed20("f_value", lambda: FValueTest.test(
        Frame({"features": inp["X77"], "label": inp["target"]}), "features",
        "label", device=dev))
    timed20("variance", lambda: VarianceThresholdSelector(device=dev).fit(
        Frame({"features": X})))
    for method in ("pearson", "spearman"):
        timed20(method, lambda: Correlation.corr(
            Frame({"features": X}), "features", method, device=dev)[method])
    timed20("summary", lambda: Summarizer.metrics(*ST_METRICS).summary(
        Frame({"features": X}), "features", device=dev))
    x = inp["target"]
    timed20("ks", lambda: KolmogorovSmirnovTest.test(
        Frame({"s": x}), "s", "norm", float(x.mean()), float(x.std())))
    return {"out": out, "seconds": secs,
            "launches": {"narrow": l1 - l0, "wide": l2 - l1}}


ST_METRICS = ("mean", "sum", "variance", "std", "count", "numNonZeros",
              "max", "min", "normL1", "normL2", "weightSum")
ST_EXACT = ("chi_square/", "wide_chi_square/", "ks/", "ufs_chi2",
            "ufs_anova", "variance_selected", "anova/degreesOfFreedom",
            "f_value/degreesOfFreedom", "summary/count",
            "summary/min", "summary/max", "summary/numNonZeros",
            "summary/weightSum")


def st20_flat(out: dict) -> dict:
    """The statistics path's results as named arrays."""
    flat = {}
    for name in ("chi_square", "wide_chi_square", "ks", "anova", "f_value"):
        for col in out[name].columns:
            flat[f"{name}/{col}"] = np.asarray(out[name][col])
    flat["ufs_chi2"] = np.asarray(out["ufs_chi2"].selected_features)
    flat["ufs_anova"] = np.asarray(out["ufs_anova"].selected_features)
    flat["variance_selected"] = np.asarray(out["variance"].selectedFeatures)
    flat["pearson"] = np.asarray(out["pearson"])
    flat["spearman"] = np.asarray(out["spearman"])
    for m in ST_METRICS:
        flat[f"summary/{m}"] = np.asarray(out["summary"][m])
    return flat


def _corr64(X: np.ndarray) -> np.ndarray:
    """``Correlation``'s matrix from float64 sums about the pilot row."""
    xc = X - X[0]
    n, s = float(len(X)), xc.sum(axis=0)
    cov = xc.T @ xc - np.outer(s, s) / n
    d = np.sqrt(np.maximum(np.diag(cov), 0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        m = cov / np.outer(d, d)
    m[np.isinf(m)] = np.nan
    np.fill_diagonal(m, 1.0)
    return np.clip(m, -1.0, 1.0)


def st20_oracle(inp: dict) -> dict:
    """The moment statistics from float64 sums (the same formulas, the
    same pilot rows): what the float32 sums of card and CPU approach."""
    from scipy.stats import rankdata
    from sntc_tpu_torch.feature.univariate_selector import (
        f_classif,
        f_regression,
    )

    X = inp["X"].astype(np.float64)
    y = np.asarray(inp["y"]).astype(np.int64)
    xc = X - X[0]
    oh = np.eye(int(y.max()) + 1)[y]
    F, _ = f_classif((oh.sum(axis=0), xc.T @ oh, (xc * xc).T @ oh))
    X77, t = inp["X77"].astype(np.float64), inp["target"].astype(
        np.float32).astype(np.float64)
    x7, tc = X77 - X77[0], t - t[0]
    Fr, _ = f_regression((float(len(t)), x7.sum(axis=0),
                          (x7 * x7).sum(axis=0), tc.sum(), (tc * tc).sum(),
                          (x7 * tc[:, None]).sum(axis=0)))
    ranks = np.stack([rankdata(X[:, j], method="average")
                      for j in range(X.shape[1])], axis=1)
    n = float(len(X))
    mean = X.mean(axis=0)
    var = ((X - mean) ** 2).sum(axis=0) / (n - 1.0)
    return {
        "anova/statistics": F[None, :], "f_value/statistics": Fr[None, :],
        "pearson": _corr64(X), "spearman": _corr64(ranks),
        "summary/mean": mean[None, :], "summary/sum": X.sum(axis=0)[None],
        "summary/variance": var[None, :], "summary/std": np.sqrt(var)[None],
        "summary/normL1": np.abs(X).sum(axis=0)[None],
        "summary/normL2": np.sqrt((X * X).sum(axis=0))[None],
    }


def st20_compare(card: dict, cpu: dict, f64: dict, fails: list) -> dict:
    """The card's statistics against the CPU's: the chi-square tests, KS,
    the selections and the Summarizer's counts and extrema bitwise; each
    moment statistic, the card's and the CPU's, within
    ``ST_MOMENT_RTOL`` of the largest of its float64 value."""
    res = {}
    for key, want in cpu.items():
        got = card[key]
        if key.startswith(ST_EXACT):
            if not np.array_equal(got, want):
                fails.append(f"phase 20 {key}: differs from the CPU's")
            res[key] = "bitwise"
        elif key in f64:
            if not np.array_equal(np.isnan(got), np.isnan(f64[key])):
                fails.append(f"phase 20 {key}: NaN where float64 has none")
            e_card, e_cpu = fam_rel(got, f64[key]), fam_rel(want, f64[key])
            res[key] = {"card_vs_f64": e_card, "cpu_vs_f64": e_cpu,
                        "card_vs_cpu": fam_rel(got, want)}
            if not max(e_card, e_cpu) <= ST_MOMENT_RTOL:
                fails.append(f"phase 20 {key}: {res[key]} beyond "
                             f"{ST_MOMENT_RTOL} of the float64 sums")
    return res


def st20_cases(inp: dict, dev) -> dict:
    """The two chi-square contingencies as ``tree_hist`` cases (one node,
    one-hot label stats), bitwise against the plain version."""
    y_t = torch.from_numpy(np.asarray(inp["y"]).astype(np.int64)).to(dev)
    stats = torch.nn.functional.one_hot(y_t, CLASSES).to(
        torch.float32).contiguous()
    n = y_t.shape[0]
    cases = {}
    for name, X in (("chi-square test", inp["binned"]),
                    ("wide chi-square test", inp["wide"])):
        binned, n_bins, _, _ = factorize(X, inp["y"],
                                         ChiSquareTest.MAX_CATEGORIES)
        cases[name] = dict(
            binned_t=torch.from_numpy(np.ascontiguousarray(binned.T)).to(dev),
            stats=stats, weights=None,
            node_idx=torch.zeros((1, n), dtype=torch.int32, device=dev),
            n_nodes=1, n_bins=n_bins, integer=True)
    return cases


def families(dev, train: Frame, cpu_fits: FamilyFits) -> dict:
    """Phase 20: (a) the families pass on the card against the CPU, (b)
    the statistics at config 3's width against the CPU and float64.  The
    CPU side runs in its own process from the run's start; every check
    runs, and the phase fails with all the failures at its end."""
    t0 = time.perf_counter()
    parts, fails = {}, []

    def part(name, t):
        parts[name] = round(time.perf_counter() - t, 3)
        return time.perf_counter()

    try:
        t = time.perf_counter()
        data = fam_data()
        t = part("data", t)
        reset_launches()
        card = fam_card_fits(dev, data)
        fam_launches = dict(LAUNCHES)
        t = part("card_fits", t)
        inp = st20_inputs(train, dev)
        reset_launches()
        st_card = st20_run(dev, inp)
        st_launches = dict(LAUNCHES)
        t = part("card_statistics", t)
        if st_launches["tree_hist"] != 3 or st_card["launches"] != {
                "narrow": 2, "wide": 1}:
            fails.append(f"phase 20: tree_hist launched "
                         f"{st_card['launches']} (want 2 at 32 bins, 1 "
                         f"wide), counts {st_launches}")
        if any(fam_launches.values()):
            fails.append(f"phase 20: the families launched kernels "
                         f"{fam_launches}")
        cases = st20_cases(inp, dev)
        err = check_tree_hist(cases)
        plans = {k: tree_hist_plan(c["binned_t"].shape[1],
                                   c["binned_t"].shape[0], 1, 1, c["n_bins"],
                                   CLASSES) for k, c in cases.items()}
        if plans["wide chi-square test"]["regime"] != "rows":
            fails.append(f"phase 20: the wide contingency took the "
                         f"{plans['wide chi-square test']} plan")
        kernels = (measure_tree_hist({"chi-square test":
                                      cases["chi-square test"]}, err,
                                     st_card["launches"]["narrow"])
                   + measure_tree_hist({"wide chi-square test":
                                        cases["wide chi-square test"]}, err,
                                       st_card["launches"]["wide"]))
        t = part("kernel_checks_and_times", t)
        cpu_secs = cpu_fits.seconds()
        t = part("waited_for_cpu", t)
        same_in = cpu_fits.arrays("stat_inputs")
        if not (np.array_equal(same_in["binned"], inp["binned"])
                and np.array_equal(same_in["wide"], inp["wide"])):
            fails.append("phase 20: the CPU process binned other values")
        st = st20_compare(st20_flat(st_card["out"]),
                          cpu_fits.arrays("stat_cpu"),
                          cpu_fits.arrays("stat_f64"), fails)
        cmp = fam_compare(dev, data, card, cpu_fits, fails)
        t = part("compare", t)
    finally:
        cpu_fits.close()
    p20 = {
        "seconds": time.perf_counter() - t0, "parts_s": parts, "fits": {
            k: {kk: vv for kk, vv in v.items() if kk != "model"}
            for k, v in card.items()},
        "cpu_s": cpu_secs, "compare": cmp, "stat": st,
        "stat_seconds": st_card["seconds"],
        "wide_feature": inp["wide_feature"], "plans": plans,
        "kernels": kernels,
        # phase 25's mesh-1 twins and their inputs
        "handoff": {"data": data, "models": {
            k: v["model"] for k, v in card.items()}, "seconds": {
            k: v["warm_s"] for k, v in card.items()}},
    }
    if fails:
        log("phase 20 " + json.dumps({k: p20[k] for k in (
            "parts_s", "compare", "stat")}, default=str))
        raise SystemExit("phase 20 failed:\n" + "\n".join(fails))
    return p20


def idle_text(share) -> str:
    """An idle share as printed: null where no device event was seen."""
    return "not measured" if share is None else f"{share:.3f}"


def report_phase20(p20: dict, card: str) -> None:
    fits, cmp = p20["fits"], p20["compare"]
    for name, f in fits.items():
        prof = ("" if "profiled_s" not in f else
                f"; profiled {f['profiled_s']:.3f} s with device busy "
                f"{f['device_ms']:.1f} ms (idle share "
                f"{idle_text(f['device_idle_share'])}), top device ops "
                f"{f['top_device_ops_ms']}")
        log(f"phase 20 {name}: cold {f['cold_s']:.3f} s, warm "
            f"{f['warm_s']:.3f} s, {f['host_reads']} host reads{prof}; CPU "
            f"fit {p20['cpu_s'][name]:.3f} s [{card}]")
    g, lda = cmp["gaussian_mixture"], cmp["lda"]
    log(f"phase 20 GaussianMixture mean log-likelihood {g['loglik']:.4f} on "
        f"the card, {g['loglik_cpu']:.4f} on the CPU; the JAX package's "
        f"record {FAM_JAX_GMM_LL} (bench_runs.jsonl:66, CPU) [{card}]")
    log(f"phase 20 LDA log perplexity {lda['log_perplexity']:.4f} on the "
        f"card, {lda['log_perplexity_cpu']:.4f} on the CPU; the JAX "
        f"package's record {FAM_JAX_LDA_PERPLEXITY} (bench_runs.jsonl:67, "
        f"CPU) [{card}]")
    log(f"phase 20 KMeans cost {cmp['kmeans']['cost']:.6g}, silhouette "
        f"{cmp['silhouette']['card']:.6f} (CPU fit's "
        f"{cmp['silhouette']['cpu']:.6f}) [{card}]")
    for k in p20["kernels"]:
        log(f"phase 20 {k['name']} {k['shape']}: {k['ms']:.4f} ms a call, "
            f"{k['device_ms']:.4f} ms of device time a launch (plain "
            f"{k['plain_ms']:.4f} ms, index_add_ {k['library_ms']:.4f} ms, "
            f"bound {k['bound_ms']:.4f} ms by {k['bound_by']}); "
            f"{_plan(k['plan'])}; {k['launches']} launches on the path "
            f"[{card}]")
    log("phase 20 " + json.dumps({
        "phase": 20, "card": card, "seconds": round(p20["seconds"], 3),
        "parts_s": p20["parts_s"], "cpu_s": p20["cpu_s"],
        "compare": cmp, "stat": p20["stat"],
        "stat_seconds": p20["stat_seconds"],
        "wide_feature": p20["wide_feature"], "plans": p20["plans"]},
        default=str))


# -- phase 21: the fusible feature stages and the other supervised fits -----

P21_BATCHES = [1000, 4096, 65536]  # served micro-batches; 1000 pads
P21_TRAFFIC_SEED = 21  # the served flows' generate_frame seed
P21_LR_ITERS = 20  # bench config 5's maxIter (bench.py:508)
P21_DEGREE = 2  # the 40 sliced features -> 860 float64 monomials
P21_DISCRETE_BUCKETS = 16
P21_FOUR = 4  # the small serve's slice: the first 4 of config 3's 40
P21_DURATION = "Flow Duration"
P21_PACKETS = "Total Fwd Packets"
P21_CENSOR_Q = 0.9  # AFT: right-censored at this quantile of the times
P21_MAX_CATEGORIES = 16
P21_EN = {"regParam": 0.01, "elasticNetParam": 0.5}  # the l-bfgs LR
# FM at Spark's default step (1.0) runs the regressor's loss up to ~1 900
# before it settles (on the CPU, these rows): a trajectory two devices
# cannot follow alike; 0.1 descends monotonically on both
P21_FM = {"factorSize": 8, "maxIter": 100, "stepSize": 0.1}
#: GLM name -> (params, target, the column left out of the features)
P21_GLMS = {
    "glm_gaussian": ({"family": "gaussian", "link": "identity"},
                     "log_iat", REG_TARGET),
    "glm_poisson": ({"family": "poisson", "link": "log"}, "packets",
                    P21_PACKETS),
    "glm_gamma": ({"family": "gamma", "link": "log"}, "iat_plus_1",
                  REG_TARGET),
    "glm_binomial": ({"family": "binomial", "link": "logit"}, "attack",
                     REG_TARGET),
    "glm_tweedie": ({"family": "tweedie", "variancePower": 1.5}, "packets",
                    P21_PACKETS),
}
P21_FITS = ("lr_normal", "lr_elastic", *P21_GLMS, "aft", "fm_classifier",
            "fm_regressor")
# The card against the CPU.  Each limit sits above its fit's reading on
# an NVIDIA H100 80GB HBM3, 700 W (the same value in every run of this
# phase: the card's and the CPU's fits are each deterministic), about
# ten times above it where the reading is a rounding gap, so another
# build's rounding passes and a fault does not.  Readings are against
# the CPU process with its order pinned (``P21Fits.ENV``); where the
# unpinned process read otherwise, its reading comes first.
# Histories are relative to the first objective.
# The served heads.  The degree-2 head's fit is chaotic: its 20 LBFGS
# iterations carry a last-bit change of a product on, and on the
# monomials of raw counters (up to ~1e16) a small change of a coefficient
# moves a margin far.  Readings against the CPU process's fit: the
# card's fit 1.4e-5 of the start apart over the first LANE_PREFIX
# iterations, 1.1e-4 at the end, P(attack) 0.021 apart at the 99.9th
# percentile, agreement 0.99960, AUCs 1.2e-5; the CPU's own refits under
# other summation orders (``P21_WITNESSES``) up to 3.4e-5, 7.1e-5, 0.048,
# 0.99888 and 3.6e-5 (one thread; a refit on eight threads 1.2e-5,
# 8.7e-5, 0.017, 0.99968 and 1.0e-5); and a CPU fit on another host, before
# the reference's order was pinned, 1.3e-3 apart over its history,
# P(attack) 0.145 at the 99.9th percentile and 0.556 at most, agreement
# 0.99692.  The gaps grow about tenfold from the first LANE_PREFIX
# iterations to the end in every pair (the card against the one-thread
# refit 5e-5 then 4e-4), so that host's fit parted by ~1.3e-4 early.
# The two fits are held where that chaos does not reach far: their
# first iterations (ten times the largest pair's reading), the end
# objective, AUC and agreement with room above the other host's reading;
# their P(attack) gaps are reported.  The card's serving of one fit is
# held tightly (``P21_SAME_MODEL``).
P21_HEADS = {
    "poly": {"prefix_gap": 5e-4, "end_gap": 5e-3, "auc_gap": 2e-3,
             "agreement": 0.99},
    # readings: agreement 1.0 (49 950 rows), history 2.5e-6, P(attack)
    # 9.4e-5
    "discrete": {"agreement": 0.9999, "history_gap": 2.5e-5,
                 "prob_p999_err": 1e-3},
}
# the CPU's degree-2 fit loaded on the card against the CPU's outputs of
# it: the same float64 monomials, the 860-term float32 margins summed in
# two orders (readings: agreement 1.0, P(attack) 1.9e-6 / 2.4e-6 at
# most)
P21_SAME_MODEL = {"agreement": 0.9999, "prob_max_err": 2e-5}
# the witnesses: the CPU's refits of the degree-2 head on its rows
# permuted (``P21_WITNESS_SEED``) and on one thread (``threadsN``: N
# threads; the side's others would take the cores the card's phases use)
P21_WITNESSES = ("permuted", "threads1")
P21_WITNESS_SEED = 2121
# the LBFGS and adamW fits' histories (readings 1.9e-7 / 7.6e-7,
# 2.9e-7 / 5.4e-7, 1.0e-6 / 4.7e-7, 2.6e-6)
P21_HISTORY_TOL = {"lr_elastic": 8e-6, "aft": 3e-6, "fm_classifier": 1e-5,
                   "fm_regressor": 2.5e-5}
# the normal solver's predictions, relative to the target's spread (its
# f32 moments summed in two orders, the solve in float64; 1.5e-5 /
# 2.3e-5)
P21_NORMAL_TOL = 1.5e-4
# the IRLS fits' coefficients relative to the largest (readings 1.6e-6,
# 2.0e-6 / 1.9e-6, 1.2e-6, 1.9e-6 / 1.8e-6, 2.1e-6 / 1.5e-6); the
# deviance (at most 9.1e-8, some 0: a float32 sum, so 1e-6 is ~16 of its
# ulps); the iteration
# counts may part by one where the stop test meets float32 noise
# (poisson, binomial, tweedie did)
P21_GLM_RTOL = {"glm_gaussian": 1.6e-5, "glm_poisson": 2e-5,
                "glm_gamma": 1.2e-5, "glm_binomial": 1.9e-5,
                "glm_tweedie": 2.1e-5}
P21_DEVIANCE_RTOL = 1e-6
# isotonic calibration of one head's P(attack), the CPU's degree-2 fit:
# fitted here on the card's outputs of it against the CPU process's fit
# on its own, over the held-out rows: the mean gap and the 99.9th
# percentile (readings 1.3e-6 and 1.4e-4, 6.3e-4 at most: 126 blocks on
# both; a row whose P(attack) rounding crosses a block's edge moves by a
# step)
P21_ISOTONIC_MEAN, P21_ISOTONIC_P999 = 1e-4, 1e-3


def p21_flows(split: tuple = None) -> dict:
    """Config 3's flows (phase 4's split: 250 000 generated from seed 0,
    cleaned, 0.8 / 0.2 with seed 0; ``split``, when phase 4 made it),
    relabelled benign / attack as bench config 1 labels them, the 15
    classes kept as ``Class``."""
    if split is None:
        raw = generate_frame(TRAIN_ROWS, seed=SEED, min_class_fraction=0.005)
        split = clean_flows(raw).random_split(
            [1 - TEST_FRACTION, TEST_FRACTION], seed=SEED)
    out = {}
    for name, f in zip(("train", "test"), split):
        out[name] = f.with_column("Class", f["Label"]).with_column(
            "Label", np.where(f["Label"].astype(str) == "BENIGN", "benign",
                              "attack").astype(object))
    return out


def p21_selected(train: Frame, dev) -> list:
    """The 40 indices config 3's ChiSqSelector keeps (its 15 classes)."""
    f = StringIndexer(inputCol="Class", outputCol="classId").fit(
        train).transform(train)
    f = f.with_column("rawFeatures", raw_features(train))
    sel = ChiSqSelector(device=dev, numTopFeatures=TOP,
                        featuresCol="rawFeatures", labelCol="classId",
                        outputCol="selected").fit(f)
    return [int(i) for i in sel.selected_features]


def p21_poly_pipeline(dev, selected: list) -> Pipeline:
    """StringIndexer -> VectorAssembler (78, keep) -> VectorSlicer (40)
    -> PolynomialExpansion (degree 2: 860 columns) -> binary LR."""
    return Pipeline(stages=[
        StringIndexer(inputCol="Label", outputCol="label"),
        VectorAssembler(inputCols=CICIDS2017_FEATURES,
                        outputCol="rawFeatures", handleInvalid="keep"),
        VectorSlicer(inputCol="rawFeatures", outputCol="sliced",
                     indices=selected),
        PolynomialExpansion(inputCol="sliced", outputCol="features",
                            degree=P21_DEGREE),
        LogisticRegression(device=dev, maxIter=P21_LR_ITERS),
    ])


def p21_discrete_pipeline(dev, selected: list) -> Pipeline:
    """The small serve: the Bucketizer that a QuantileDiscretizer (16
    buckets, keep, open ends) fits on the flow duration, interacted with
    a 4-column VectorSlicer (the first 4 of config 3's 40 but the
    duration) into a binary LR.  The assembler takes the other 77
    features: a segment binds each external column once, and the
    Bucketizer reads the duration as float64 where an assembler would
    cast it to float32, so the two would split the segment."""
    others = [c for c in CICIDS2017_FEATURES if c != P21_DURATION]
    four = [others.index(CICIDS2017_FEATURES[j]) for j in selected
            if CICIDS2017_FEATURES[j] != P21_DURATION][:P21_FOUR]
    return Pipeline(stages=[
        StringIndexer(inputCol="Label", outputCol="label"),
        VectorAssembler(inputCols=others, outputCol="rawFeatures",
                        handleInvalid="keep"),
        VectorSlicer(inputCol="rawFeatures", outputCol="four",
                     indices=four),
        QuantileDiscretizer(inputCol=P21_DURATION, outputCol="durBucket",
                            numBuckets=P21_DISCRETE_BUCKETS,
                            handleInvalid="keep"),
        Interaction(inputCols=["durBucket", "four"], outputCol="features"),
        LogisticRegression(device=dev, maxIter=P21_LR_ITERS),
    ])


def p21_head_outputs(model, test: Frame) -> dict:
    """The fitted pipeline's held-out P(attack) and predictions, the head
    on its device (the host-serve crossover pinned off), and the head's
    history where it has a summary (a loaded model has none)."""
    with environ(SNTC_SERVE_HOST_ROWS="0"):
        out = model.transform(test)
    res = {"prob": to_host(out["probability"])[:, 1].astype(np.float64),
           "pred": to_host(out["prediction"]).astype(np.float64),
           "label": to_host(out["label"]).astype(np.float64)}
    summ = model.getStages()[-1].summary
    if summ is not None:  # a loaded model has none
        res.update(objectiveHistory=np.asarray(summ.objectiveHistory),
                   totalIterations=summ.totalIterations)
    return res


def _log_std(X: np.ndarray, drop: str) -> np.ndarray:
    """log1p of the raw features but ``drop``, standardized in float64,
    as float32 (the GLM, AFT and FM fits' features: raw flow counters
    span nine decades)."""
    L = np.log1p(np.delete(X, CICIDS2017_FEATURES.index(drop),
                           axis=1).astype(np.float64))
    sd = L.std(axis=0)
    sd[sd == 0] = 1.0
    return ((L - L.mean(axis=0)) / sd).astype(np.float32)


def p21_reg_inputs(train: Frame = None) -> dict:
    """Config 4's training flows (``GBT_ROWS`` from seed
    ``GBT_DATA_SEED``, cleaned, the 0.8 share; ``train``, when phase 6
    made it) as the fits' frames: phase 9's 77 raw features with target
    log1p(Flow IAT Mean), and the log-standardized features with the
    GLM, AFT and FM targets."""
    if train is None:
        raw = generate_frame(GBT_ROWS, seed=GBT_DATA_SEED,
                             min_class_fraction=0.005)
        train, _ = clean_flows(raw).random_split(
            [1 - TEST_FRACTION, TEST_FRACTION], seed=SEED)
    X = raw_features(train)

    def col(name):
        return X[:, CICIDS2017_FEATURES.index(name)].astype(np.float64)

    iat = col(REG_TARGET)
    targets = {
        "log_iat": np.log1p(iat).astype(np.float32),
        "iat_plus_1": (iat + 1.0).astype(np.float32),
        "packets": col(P21_PACKETS).astype(np.float32),
        "attack": (train["Label"].astype(str) != "BENIGN").astype(
            np.float32),
    }
    logs = {d: _log_std(X, d) for d in (REG_TARGET, P21_PACKETS,
                                        P21_DURATION)}
    t = col(P21_DURATION) + 1.0
    cut = np.quantile(t, P21_CENSOR_Q)
    out = {
        "lr": Frame({"features": np.ascontiguousarray(np.delete(
            X, CICIDS2017_FEATURES.index(REG_TARGET), axis=1)),
            "label": targets["log_iat"]}),
        "aft": Frame({"features": logs[P21_DURATION],
                      "label": np.minimum(t, cut),
                      "censor": (t < cut).astype(np.float64)}),
        "fm_classifier": Frame({"features": logs[REG_TARGET],
                                "label": targets["attack"]}),
        "fm_regressor": Frame({"features": logs[REG_TARGET],
                               "label": targets["log_iat"]}),
    }
    for name, (_, target, drop) in P21_GLMS.items():
        out[name] = Frame({"features": logs[drop],
                           "label": targets[target]})
    return out


def p21_fit(name: str, dev, frames: dict, mesh=None):
    """One of ``P21_FITS`` on ``dev`` (over ``mesh`` when given)."""
    on = {"device": dev, "mesh": mesh}
    if name == "lr_normal":
        est = LinearRegression(**on, solver="normal")
    elif name == "lr_elastic":
        est = LinearRegression(**on, solver="l-bfgs", **P21_EN)
    elif name in P21_GLMS:
        est = GeneralizedLinearRegression(**on, **P21_GLMS[name][0])
    elif name == "aft":
        est = AFTSurvivalRegression(**on)
    elif name == "fm_classifier":
        est = FMClassifier(**on, **P21_FM)
    else:
        est = FMRegressor(**on, **P21_FM)
    return est.fit(frames["lr" if name.startswith("lr_") else name])


class P21Fits(CpuFits):
    """Phase 21's CPU side, made by ``chip_smoke.py --side p21_fits DIR``
    in a process of its own that starts after phase 12 (at once under
    ``--phases``): the two served pipelines (the degree-2 one also on its
    rows permuted), the estimators, the isotonic calibration and the
    VectorIndexer fitted on the CPU on the phase's data regenerated from
    its seeds; the card's are compared with them."""

    SIDE = "p21_fits"
    # the degree-2 fit parts far from another summation order's (see
    # P21_HEADS), so its reference takes one order on any x86 host: two
    # threads (``background_side``), MKL's AVX2 code path in its
    # reproducible mode, ATen's AVX2 kernels
    ENV = {"MKL_CBWR": "AVX2", "ATEN_CPU_CAPABILITY": "avx2"}

    def summary(self, name: str) -> dict:
        self.seconds()
        with open(os.path.join(self.out, name, "summary.json")) as f:
            return json.load(f)


def _p21_summary(m) -> dict:
    """What saving drops and the comparison reads: the objective
    history, the iteration count, a GLM's deviances."""
    s = m.summary
    out = {"totalIterations": s.totalIterations,
           "objectiveHistory": list(s.objectiveHistory)}
    if hasattr(s, "deviance"):
        out.update(deviance=s.deviance, nullDeviance=s.nullDeviance,
                   dispersion=s.dispersion)
    return out


def cpu_side_host() -> dict:
    """What sets a CPU process's rounding: its threads, ATen's kernels,
    the BLAS and MKL's reproducible mode."""
    blas = re.search(r"BLAS_INFO=(\w+)", torch.__config__.show())
    return {"threads": torch.get_num_threads(),
            "capability": torch.backends.cpu.get_cpu_capability(),
            "blas": blas.group(1) if blas else None,
            "mkl_cbwr": os.environ.get("MKL_CBWR"),
            "host_cpus": os.cpu_count()}


def p21_fits_main(out: str) -> int:
    """``--side p21_fits DIR``: phase 21's CPU side, saved under DIR;
    prints the seconds of each part as one JSON line."""
    cpu = torch.device("cpu")
    background_side()
    with open(os.path.join(out, "host.json"), "w") as f:
        json.dump(cpu_side_host(), f)
    secs = {}
    t0 = time.perf_counter()
    flows = p21_flows()
    selected = p21_selected(flows["train"], cpu)
    np.savez(os.path.join(out, "selected.npz"), selected=selected)
    secs["data"] = time.perf_counter() - t0
    heads = {}
    for name, build in (("poly", p21_poly_pipeline),
                        ("discrete", p21_discrete_pipeline)):
        t0 = time.perf_counter()
        m = build(cpu, selected).fit(flows["train"])
        secs[name] = time.perf_counter() - t0
        save_model(m, os.path.join(out, name))
        heads[name] = p21_head_outputs(m, flows["test"])
        np.savez(os.path.join(out, f"{name}_test.npz"), **heads[name])
    train = flows["train"]
    for name in P21_WITNESSES:
        t0 = time.perf_counter()
        if name == "permuted":
            perm = np.random.default_rng(P21_WITNESS_SEED).permutation(
                train.num_rows)
            m = p21_poly_pipeline(cpu, selected).fit(train.take(perm))
        else:
            torch.set_num_threads(int(name.removeprefix("threads")))
            m = p21_poly_pipeline(cpu, selected).fit(train)
            torch.set_num_threads(SIDE_THREADS)
        np.savez(os.path.join(out, f"poly_{name}_test.npz"),
                 **p21_head_outputs(m, flows["test"]))
        secs[f"poly_{name}"] = time.perf_counter() - t0
    frames = p21_reg_inputs()
    for name in P21_FITS:
        t0 = time.perf_counter()
        m = p21_fit(name, cpu, frames)
        secs[name] = time.perf_counter() - t0
        save_model(m, os.path.join(out, name))
        with open(os.path.join(out, name, "summary.json"), "w") as f:
            json.dump(_p21_summary(m), f)
    t0 = time.perf_counter()
    iso = IsotonicRegression(device=cpu).fit(Frame({
        "features": heads["poly"]["prob"], "label": heads["poly"]["label"]}))
    np.savez(os.path.join(out, "isotonic.npz"), boundaries=iso.boundaries,
             predictions=iso.predictions,
             calibrated=iso.predict(heads["poly"]["prob"]))
    secs["isotonic"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vi = VectorIndexer(device=cpu, inputCol="rawFeatures",
                       maxCategories=P21_MAX_CATEGORIES).fit(
        Frame({"rawFeatures": raw_features(flows["train"])}))
    secs["vector_indexer"] = time.perf_counter() - t0
    save_model(vi, os.path.join(out, "vector_indexer"))
    return side_done(secs)


def p21_write_traffic(work: str) -> tuple:
    """The served flows: ``sum(P21_BATCHES)`` cleaned rows from seed
    ``P21_TRAFFIC_SEED`` without their label, one raw CSV a batch."""
    traffic = clean_flows(generate_frame(sum(P21_BATCHES) + 2000,
                                         seed=P21_TRAFFIC_SEED))
    traffic = traffic.slice(0, sum(P21_BATCHES)).drop("Label")
    watch = os.path.join(work, "in21")
    os.makedirs(watch)
    batches, start = [], 0
    for i, n in enumerate(P21_BATCHES):
        b = traffic.slice(start, start + n)
        write_raw_csv(b, os.path.join(watch, f"part_{i:04d}.csv"))
        batches.append(b)
        start += n
    return watch, batches


def p21_serve_poly(dev, model_dir: str, watch: str, work: str,
                   fails: list) -> dict:
    """(a): the degree-2 pipeline served by ``python -m sntc_tpu_torch
    serve`` in its default form and in the staged, serial form, the two
    processes together (the staged head pinned to the card by
    ``SNTC_SERVE_HOST_ROWS=0``): one fused segment of the slicer, the
    expansion and the head, files byte-identical, every batch served,
    ``pad_assemble`` once a padded batch."""
    fused, staged = together(
        (serve_command, model_dir, watch, os.path.join(work, "out21f"),
         os.path.join(work, "ckpt21f"), dev, []),
        (serve_command, model_dir, watch, os.path.join(work, "out21s"),
         os.path.join(work, "ckpt21s"), dev, STAGED_FORM, 1,
         env_with(SNTC_SERVE_HOST_ROWS="0")))
    padded = sum(bucket_rows_for(n, BUCKET_FLOOR) != n for n in P21_BATCHES)
    want = {"forest_traversal": 0, "pad_assemble": padded, "tree_hist": 0}
    fz = fused["fusion"] or {}
    for tag, s in (("fused", fused), ("staged", staged)):
        if s["batches"] != len(P21_BATCHES) or \
                s["rows"] != sum(P21_BATCHES):
            fails.append(f"phase 21 (a) {tag} serve covered {s['batches']} "
                         f"batches, {s['rows']} rows")
        if s["kernel_launches"] != want:
            fails.append(f"phase 21 (a) {tag} serve launched "
                         f"{s['kernel_launches']}, want {want}")
    if fz.get("segments") != 1 or fz.get("fused_stages") != 3 or \
            fz.get("fallbacks") != 0 or staged["fusion"] is not None:
        fails.append(f"phase 21 (a): fusion {fused['fusion']} (want one "
                     "segment of VectorSlicer, PolynomialExpansion and the "
                     f"head), staged {staged['fusion']}")
    same = sink_files(os.path.join(work, "out21f")) == sink_files(
        os.path.join(work, "out21s"))
    if not same:
        fails.append("phase 21 (a): the fused form's batch files differ "
                     "from the staged form's")
    pred = sink_predictions(os.path.join(work, "out21f"))
    if len(pred) != sum(P21_BATCHES) or not np.isin(pred, (0.0, 1.0)).all():
        fails.append(f"phase 21 (a): {len(pred)} predictions, values "
                     f"{np.unique(pred)[:5]}")
    return {"fused": fused, "staged": staged, "files_identical": same,
            "rows_per_s": {t: s["rows"] / s["seconds"]
                           for t, s in (("fused", fused),
                                        ("staged", staged))}}


def p21_serve_discrete(dev, model, batches: list, fails: list) -> dict:
    """(a)'s small serve, in this process: the QuantileDiscretizer's
    Bucketizer and the Interaction fused with the 4-column slicer and the
    head, against the staged stages, each batch through a bucketed
    ``BatchPredictor`` on the card (launch counts from 0)."""
    fused_m = serving_form(model, "label", True)[0]
    staged_m = serving_form(model, "label", False)[0]
    segs = fused_segments(fused_m)
    names = [type(s).__name__ for s in segs[0].fused_stages] if segs else []
    if len(segs) != 1 or names != ["VectorSlicer", "Bucketizer",
                                   "Interaction",
                                   "LogisticRegressionModel"]:
        fails.append(f"phase 21 (a) small serve: segments "
                     f"{[repr(s) for s in segs]}")
    reset_launches()
    outs = {}
    with environ(SNTC_SERVE_HOST_ROWS="0"):
        for tag, m in (("fused", fused_m), ("staged", staged_m)):
            pred = BatchPredictor(m, bucket_rows=BUCKET_FLOOR, device=dev)
            t0 = time.perf_counter()
            outs[tag] = [pred.predict_frame(b) for b in batches]
            torch.cuda.synchronize()
            outs[tag + "_s"] = time.perf_counter() - t0
    launches, shapes = dict(LAUNCHES), dict(PAD_LAUNCH_SHAPES)
    padded = sum(bucket_rows_for(n, BUCKET_FLOOR) != n for n in P21_BATCHES)
    if launches != {"forest_traversal": 0, "tree_hist": 0,
                    "pad_assemble": 2 * padded}:
        fails.append(f"phase 21 (a) small serve launched {launches}")
    equal = all(
        np.array_equal(to_host(a[c]), to_host(b[c]))
        for a, b in zip(outs["fused"], outs["staged"])
        for c in ("rawPrediction", "probability", "prediction"))
    if not equal:
        fails.append("phase 21 (a) small serve: fused and staged differ")
    return {"equal": equal, "launches": launches, "pad_launch_shapes": shapes,
            "fused_stages": names, "seconds": {
                t: outs[t + "_s"] for t in ("fused", "staged")}}


def p21_head_gaps(a: dict, b: dict) -> dict:
    """Two outputs of a served head on the held-out rows: the share of
    equal predictions, |P(attack)| gaps (mean, 99.9th percentile,
    largest), their AUCs' gap and, for two fits, their histories' gaps
    (``fit_gaps``: the prefix, the end, the largest of all)."""
    d = np.abs(a["prob"] - b["prob"])
    out = {"agreement": float(np.mean(a["pred"] == b["pred"])),
           "prob_mean_err": float(d.mean()),
           "prob_p999_err": float(np.quantile(d, 0.999)),
           "prob_max_err": float(d.max()),
           "auc_gap": abs(p21_auc(a) - p21_auc(b))}
    if "objectiveHistory" in a and "objectiveHistory" in b:
        g = fit_gaps(a, b)
        out.update(prefix_gap=g["prefix_gap"], end_gap=g["end_gap"],
                   history_gap=max(g["max_gap"], g["end_gap"]))
    return out


def p21_auc(h: dict) -> float:
    """A head's held-out AUC."""
    return BinaryClassificationEvaluator().evaluate(Frame({
        "label": h["label"], "rawPrediction": np.stack(
            [1 - h["prob"], h["prob"]], axis=1)}))


def p21_outside(gaps: dict, lim: dict) -> list:
    """The keys of ``lim`` that ``gaps`` breaks: agreement below its
    limit, any other gap above."""
    return [k for k, v in lim.items()
            if (gaps[k] < v if k == "agreement" else gaps[k] > v)]


def range_device_ops(prof, prefix: str) -> tuple:
    """Device time of a profiler window's ``record_function`` ranges
    named ``prefix + name``: a device event carries the correlation id of
    the op that launched it, and that op's start, on the host, places it
    in a range.  Returns ``(spans, ops, matched, unmatched)``: each
    range's (start, end) in ns on the host's clock, its device ms by op
    name, its count of matched device events; and the count of device
    events whose launching op the window did not see.  It reads the
    profiler's raw records (its FunctionEvent tree takes seconds to build
    over the FM fits' autograd ops)."""
    events = prof.profiler.kineto_results.events()
    cpu_t, cuda_t = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans = {e.name()[len(prefix):]: (e.start_ns(),
                                      e.start_ns() + e.duration_ns())
             for e in events
             if e.name().startswith(prefix) and e.device_type() == cpu_t}
    launched_at = {e.correlation_id(): e.start_ns() for e in events
                   if e.device_type() == cpu_t
                   and e.linked_correlation_id() == 0
                   and e.correlation_id() > 0}
    ops = {name: {} for name in spans}
    matched = dict.fromkeys(spans, 0)
    unmatched = 0
    for e in events:
        name_ = e.name()
        if e.device_type() != cuda_t or e.is_user_annotation() \
                or name_.startswith(("Activity Buffer", prefix)):
            continue
        at = launched_at.get(e.linked_correlation_id())
        if at is None:
            unmatched += 1
            continue
        for name, (lo, hi) in spans.items():
            if lo <= at <= hi:
                key = name_ if len(name_) <= 60 else name_[:57] + "..."
                ops[name][key] = (ops[name].get(key, 0.0)
                                  + e.duration_ns() / 1e6)
                matched[name] += 1
                break
    return spans, ops, matched, unmatched


def p21_card_fits(dev, frames: dict) -> dict:
    """Each of ``P21_FITS`` on the card, timed; then all of them once
    more in one profiler window, each inside a ``record_function`` range
    that ends with a synchronize: a fit's device busy ms are the device
    events whose launching op (matched by correlation id) started inside
    its range, its idle share the rest of the range, null where no device
    event was matched (one window: the profiler's start and its trace
    processing are paid once)."""
    out = {}
    for name in P21_FITS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = p21_fit(name, dev, frames)
        torch.cuda.synchronize()
        stats = (getattr(m, "optimizer_stats", None)
                 or getattr(m, "fit_stats", None) or {})
        out[name] = {
            "model": m, "seconds": time.perf_counter() - t0,
            "iterations": m.summary.totalIterations,
            "host_reads": stats.get("host_syncs", stats.get("host_reads")),
        }
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        # the window's first device records can come late (call 2: the
        # first fit showed none): one fit outside the ranges first
        p21_fit(P21_FITS[0], dev, frames)
        torch.cuda.synchronize()
        for name in P21_FITS:
            with torch.profiler.record_function(f"p21 {name}"):
                p21_fit(name, dev, frames)
                torch.cuda.synchronize()
    spans, ops, matched, unmatched = range_device_ops(prof, "p21 ")
    for name in P21_FITS:
        wall_ms = (spans[name][1] - spans[name][0]) / 1e6
        busy = sum(ops[name].values())
        top = sorted(ops[name].items(), key=lambda kv: -kv[1])[:3]
        out[name].update({
            "profiled_s": wall_ms / 1e3, "device_ms": busy,
            "device_events": matched[name],
            # no device event matched: not measured, not idle
            "device_idle_share": (max(0.0, 1.0 - busy / wall_ms)
                                  if matched[name] else None),
            "top_device_ops_ms": {k: round(v, 3) for k, v in top},
            "unmatched_device_events": unmatched,
        })
    return out


def p21_compare_fits(dev, frames: dict, card: dict, cpu: P21Fits,
                     fails: list) -> dict:
    """Each card fit held against the CPU's with the tolerances above."""
    res = {}
    for name in P21_FITS:
        mc, mh = card[name]["model"], cpu.model(name)
        sh = cpu.summary(name)
        r = res[name] = {"iterations": [mc.summary.totalIterations,
                                        sh["totalIterations"]]}
        if name == "lr_normal":
            X = frames["lr"]["features"]
            y = frames["lr"]["label"]
            gap = np.abs(mc.predict(X) - mh.predict(X)).max() / np.std(y)
            r["prediction_gap"] = float(gap)
            ok = gap <= P21_NORMAL_TOL
        elif name in P21_GLMS:
            coef = np.append(mc.coefficients, mc.intercept)
            r["coef_rel"] = fam_rel(coef, np.append(mh.coefficients,
                                                    mh.intercept))
            r["deviance_rel"] = abs(mc.summary.deviance / sh["deviance"]
                                    - 1.0)
            r["deviance"] = mc.summary.deviance
            r["null_deviance"] = mc.summary.nullDeviance
            if P21_GLMS[name][0]["family"] != "tweedie":
                r["aic"] = mc.summary.aic
            ok = (np.isfinite(coef).all()
                  and r["coef_rel"] <= P21_GLM_RTOL[name]
                  and r["deviance_rel"] <= P21_DEVIANCE_RTOL)
        else:
            g = fit_gaps(mc, sh)
            r["history_gap"] = max(g["max_gap"], g["end_gap"])
            r["final_objective"] = mc.summary.objectiveHistory[-1]
            if name == "aft":
                r["scale"] = [mc.scale, mh.scale]
            ok = r["history_gap"] <= P21_HISTORY_TOL[name]
        if not (ok and all(np.isfinite(v) for k, v in r.items()
                           if isinstance(v, float))):
            fails.append(f"phase 21 (b) {name}: the card's fit is not the "
                         f"CPU's: {r}")
    return res


def p21_vector_indexer(dev, train: Frame, test: Frame, cpu: P21Fits,
                       fails: list) -> dict:
    """VectorIndexer over the 78 raw features on the card: its category
    maps equal to the CPU fit's, its transform of the held-out rows on
    the card bitwise the CPU model's on the host."""
    t0 = time.perf_counter()
    vi = VectorIndexer(device=dev, inputCol="rawFeatures",
                       maxCategories=P21_MAX_CATEGORIES).fit(
        Frame({"rawFeatures": raw_features(train)}))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    ref = cpu.model("vector_indexer")
    same_maps = sorted(vi.categoryMaps) == sorted(ref.categoryMaps) and all(
        np.array_equal(vi.categoryMaps[j], ref.categoryMaps[j],
                       equal_nan=True) for j in ref.categoryMaps)
    Xt = raw_features(test)
    vi.setHandleInvalid("keep")
    ref.setHandleInvalid("keep")
    got = to_host(vi.transform(Frame({
        "rawFeatures": torch.from_numpy(Xt).to(dev)}))["indexed"])
    want = ref.transform(Frame({"rawFeatures": Xt}))["indexed"]
    equal = np.array_equal(got, want)
    if not (same_maps and equal):
        fails.append(f"phase 21 (b) VectorIndexer: maps equal {same_maps}, "
                     f"transform equal {equal}")
    return {"fit_s": fit_s, "categorical": len(vi.categoryMaps),
            "same_maps": same_maps, "transform_equal": equal}


def p21_isotonic(dev, same: dict, served: dict, cpu: P21Fits,
                 fails: list) -> dict:
    """IsotonicRegression calibrating a head's P(attack) against the
    held-out label (host work in both packages), fitted here with
    ``device`` the card: on the card's outputs of the CPU's degree-2 fit
    (``same``), its calibrated outputs held against the CPU process's fit
    on its own outputs of that fit, within ``P21_ISOTONIC_MEAN`` on
    average and ``P21_ISOTONIC_P999`` at the 99.9th percentile; and on
    the served head's (``served``), its Brier score reported."""
    ref = cpu.arrays("isotonic")
    t0 = time.perf_counter()
    own = IsotonicRegression(device=dev).fit(Frame({
        "features": same["prob"], "label": same["label"]}))
    fit_s = time.perf_counter() - t0
    calibrated = own.predict(same["prob"])
    d = np.abs(calibrated - ref["calibrated"])
    served_iso = IsotonicRegression(device=dev).fit(Frame({
        "features": served["prob"], "label": served["label"]}))
    res = {"blocks": [int(len(own.boundaries)), int(len(ref["boundaries"]))],
           "fit_s": fit_s, "calibrated_mean_err": float(d.mean()),
           "calibrated_p999_err": float(np.quantile(d, 0.999)),
           "calibrated_max_err": float(d.max()),
           "brier": float(np.mean((served_iso.predict(served["prob"])
                                   - served["label"]) ** 2)),
           "brier_uncalibrated": float(np.mean(
               (served["prob"] - served["label"]) ** 2))}
    if not (np.all(np.diff(own.predictions) >= 0)
            and np.isfinite(calibrated).all()
            and res["calibrated_mean_err"] <= P21_ISOTONIC_MEAN
            and res["calibrated_p999_err"] <= P21_ISOTONIC_P999):
        fails.append(f"phase 21 (b) isotonic: the card's calibration of "
                     f"the CPU's head is not the CPU's: {res}")
    return res


def phase21(dev, work: str, cpu: P21Fits, split3: tuple = None,
            train4: Frame = None) -> dict:
    """Phase 21: (a) the fusible feature stages on the serve segment, (b)
    the other supervised fits, each on the card against the CPU process
    of the run's start; on phase 4's split and phase 6's training rows
    where the run made them.  Every check runs; the phase fails with all
    the failures at its end."""
    t0 = time.perf_counter()
    parts, fails = {}, []

    def part(name, t):
        parts[name] = round(time.perf_counter() - t, 3)
        return time.perf_counter()

    t = time.perf_counter()
    flows = p21_flows(split3)
    selected = p21_selected(flows["train"], dev)
    watch, batches = p21_write_traffic(work)
    t = part("data", t)
    fitted, fit_s = {}, {}
    for name, build in (("poly", p21_poly_pipeline),
                        ("discrete", p21_discrete_pipeline)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fitted[name] = build(dev, selected).fit(flows["train"])
        torch.cuda.synchronize()
        fit_s[name] = time.perf_counter() - t1
    model_dir = save_model(fitted["poly"], os.path.join(work, "model21"))
    t = part("pipeline_fits", t)
    served = p21_serve_poly(dev, model_dir, watch, work, fails)
    t = part("serve_commands", t)
    small = p21_serve_discrete(dev, fitted["discrete"], batches, fails)
    t = part("small_serve", t)
    kernels = pads_of(dev, served["fused"]["pad_launch_shapes"])
    # the small serve's batches are float32 1-D columns (column-major)
    kernels += pads_of(dev, small["pad_launch_shapes"], False)
    t = part("pad_checks", t)
    frames = p21_reg_inputs(train4)
    card = p21_card_fits(dev, frames)
    t = part("card_fits", t)
    heads = {n: p21_head_outputs(m, flows["test"])
             for n, m in fitted.items()}
    t = part("heads", t)
    cpu_secs = cpu.seconds()
    t = part("waited_for_cpu", t)
    cmp = {"selected_equal": list(cpu.arrays("selected")["selected"])
           == selected}
    if not cmp["selected_equal"]:
        fails.append("phase 21: the card's ChiSqSelector kept other "
                     "features than the CPU's")
    for name in fitted:
        c = cmp[name] = p21_head_gaps(heads[name], cpu.arrays(
            f"{name}_test"))
        c["auc"] = p21_auc(heads[name])
        if p21_outside(c, P21_HEADS[name]):
            fails.append(f"phase 21 (a) {name}: the card's head is not the "
                         f"CPU's: {c}")
    with open(os.path.join(cpu.out, "host.json")) as f:
        cmp["cpu_side"] = json.load(f)
    # the witnesses: the CPU's degree-2 head against its refits under
    # other summation orders on the same device (readings, not checks)
    ref = cpu.arrays("poly_test")
    cmp["poly_witnesses"] = {w: p21_head_gaps(cpu.arrays(f"poly_{w}_test"),
                                              ref) for w in P21_WITNESSES}
    # one model on two devices: the CPU's degree-2 fit on the card
    same = p21_head_outputs(load_model(os.path.join(cpu.out, "poly"),
                                       device=dev), flows["test"])
    c = cmp["poly_same_model"] = p21_head_gaps(same, ref)
    if p21_outside(c, P21_SAME_MODEL):
        fails.append("phase 21 (a) poly: the card's outputs of the CPU's "
                     f"fit are not the CPU's: {c}")
    cmp["isotonic"] = p21_isotonic(dev, same, heads["poly"], cpu, fails)
    cmp["fits"] = p21_compare_fits(dev, frames, card, cpu, fails)
    cmp["vector_indexer"] = p21_vector_indexer(
        dev, flows["train"], flows["test"], cpu, fails)
    t = part("compare", t)
    p21 = {
        "seconds": time.perf_counter() - t0, "parts_s": parts,
        "pipeline_fit_s": fit_s, "serve": {
            k: served[k] for k in ("files_identical", "rows_per_s")},
        "fusion": served["fused"]["fusion"],
        "pad_launch_shapes": served["fused"]["pad_launch_shapes"],
        "small": small, "fits": {
            k: {kk: vv for kk, vv in v.items() if kk != "model"}
            for k, v in card.items()},
        "cpu_s": cpu_secs, "compare": cmp, "kernels": kernels,
        "monomials": len(_expansion_plan(TOP, P21_DEGREE)),
        # the degree-2 fits' objective histories (the --out-json record)
        "poly_histories": {"card": heads["poly"]["objectiveHistory"].tolist(),
                           "cpu": ref["objectiveHistory"].tolist(), **{
                               w: cpu.arrays(f"poly_{w}_test")[
                                   "objectiveHistory"].tolist()
                               for w in P21_WITNESSES}},
        # phase 25's mesh-1 twins and their inputs
        "handoff": {"frames": frames, "models": {
            k: v["model"] for k, v in card.items()}, "seconds": {
            k: v["seconds"] for k, v in card.items()}},
    }
    if fails:
        log("phase 21 " + json.dumps({k: p21[k] for k in (
            "parts_s", "serve", "fusion", "small", "compare",
            "poly_histories")}, default=str))
        raise SystemExit("phase 21 failed:\n" + "\n".join(fails))
    return p21


def _gaps(g: dict) -> str:
    """``p21_head_gaps`` as text."""
    return ", ".join(f"{k} {v:.6f}" if k == "agreement" else f"{k} {v:.3g}"
                     for k, v in g.items())


def report_phase21(p21: dict, card: str) -> None:
    cmp = p21["compare"]
    log(f"phase 21 (a) the degree-{P21_DEGREE} pipeline ({TOP} sliced "
        f"features -> {p21['monomials']} float64 monomials -> binary LR): "
        "fit on the card "
        f"{p21['pipeline_fit_s']['poly']:.3f} s (CPU process "
        f"{p21['cpu_s']['poly']:.3f} s); served in batches {P21_BATCHES}: "
        f"fused {p21['serve']['rows_per_s']['fused']:.1f} rows/s, staged "
        f"{p21['serve']['rows_per_s']['staged']:.1f} rows/s (each with its "
        f"first batch), files identical {p21['serve']['files_identical']}; "
        f"fusion {p21['fusion']}; held-out AUC {cmp['poly']['auc']:.6f}; "
        f"the card's fit against the CPU's: {_gaps(cmp['poly'])}; the CPU's "
        "refits under other summation orders against its fit: "
        + "; ".join(f"{w} {_gaps(g)}"
                    for w, g in cmp["poly_witnesses"].items())
        + f"; the CPU's fit served on the card against the CPU: "
        f"{_gaps(cmp['poly_same_model'])}; the CPU process "
        f"{cmp['cpu_side']} [{card}]")
    iso = cmp["isotonic"]
    log(f"phase 21 (b) isotonic calibration of the CPU head's P(attack) on "
        f"the card: {iso['blocks'][0]} blocks ({iso['blocks'][1]} on the "
        f"CPU) in {iso['fit_s']:.3f} s; calibrated outputs against the "
        f"CPU's {iso['calibrated_mean_err']:.3g} on average, "
        f"{iso['calibrated_p999_err']:.3g} at the 99.9th percentile, "
        f"{iso['calibrated_max_err']:.3g} at most; the served head's "
        f"Brier {iso['brier_uncalibrated']:.6f} -> {iso['brier']:.6f} "
        f"[{card}]")
    s = p21["small"]
    log(f"phase 21 (a) the small serve ({s['fused_stages']}): fused and "
        f"staged equal {s['equal']}, {s['seconds']['fused']:.3f} s / "
        f"{s['seconds']['staged']:.3f} s for {sum(P21_BATCHES)} rows; "
        f"held-out AUC {cmp['discrete']['auc']:.6f}, agreement "
        f"{cmp['discrete']['agreement']:.6f} [{card}]")
    for name, f in p21["fits"].items():
        log(f"phase 21 (b) {name}: {f['seconds']:.3f} s on the card "
            f"({f['iterations']} iterations, {f['host_reads']} host reads); "
            f"profiled {f['profiled_s']:.3f} s with device busy "
            f"{f['device_ms']:.1f} ms over {f['device_events']} device "
            f"events (idle share {idle_text(f['device_idle_share'])}), "
            "top device ops "
            f"{f['top_device_ops_ms']}; CPU fit {p21['cpu_s'][name]:.3f} s; "
            f"against the CPU {cmp['fits'][name]} [{card}]")
    for k in p21["kernels"]:
        log(f"phase 21 {k['name']} {k['shape']}: {k['ms']:.4f} ms a call, "
            f"{k['device_ms']:.4f} ms of device time a launch (plain "
            f"{k['plain_ms']:.4f} ms; {k['library_call']} "
            f"{k['library_ms']:.4f} ms a call; bound {k['bound_ms']:.4f} ms "
            f"by {k['bound_by']}); {k['launches']} launches at this shape "
            f"in its run, max abs error {k['max_abs_err']} [{card}]")
    log("phase 21 " + json.dumps({
        "phase": 21, "card": card, "seconds": round(p21["seconds"], 3),
        "parts_s": p21["parts_s"], "cpu_s": p21["cpu_s"],
        "compare": cmp, "small": {k: s[k] for k in ("equal", "launches")},
        "pad_launch_shapes": p21["pad_launch_shapes"],
        "poly_histories": p21["poly_histories"]}, default=str))


# -- phase 22: the object-column group and the long tail ---------------------

P22_BUCKETS = 8  # QuantileDiscretizer's buckets: one token a feature
P22_HASH_WIDTH = 4096  # HashingTF's width (its default)
P22_HASHER_WIDTH = 1024  # FeatureHasher's width over the 78 features + Label
P22_W2V_DOCS = 2000  # Word2Vec's documents (its defaults, maxIter 1)
#: the profiled window: the fit's first steps, on the fit's own inputs
P22_W2V_WINDOW = 2 * UNIFORM_CHUNK
P22_W2V_WARM = 16  # steps before the window's range, in the profiler
#: card against CPU, same inputs and uniforms: how far the card's steps
#: moved the vectors from where the CPU's moved them, over how far they
#: moved (``p22_move_gap``; 1 where the card did not step): the fit's
#: input vectors, and the window's input and output vectors.  The
#: float32 rounding of ``w_in`` sets the input vectors' floor: half an
#: ulp of |w_in| ~ 5e-3 is 2.3e-10, 8.4e-5 of the fit's largest move
#: (2.8e-6) and 6.7e-4 of the window's (3.5e-7); the CPU's own steps
#: with each batch's rows permuted moved them 8.4e-5, 1.7e-4 and 1.7e-7
#: apart; an H100 (80GB HBM3, 700 W) 8.4e-5, 1.7e-4 and 2.3e-7.  Each
#: limit is at least 4 times its floor (``resolution``): a run whose
#: moves are too small to check at the limit fails.
P22_W2V_MOVE_RTOL = {"fit_in": 1e-3, "window_in": 5e-3, "window_out": 1e-5}
P22_BRP_TABLES = 3
P22_BRP_BUCKET = 4.0  # bucketLength on the standard-scaled rows
#: a pre-floor value this many float32 ulps of its terms' magnitude from
#: an integer may floor apart on two devices
P22_EDGE_ULPS = 8
P22_ANN_KEYS = 5
P22_ANN_K = 10
P22_JOIN_ROWS = (4096, 20_000)  # held-out A against training B
P22_JOIN_THRESHOLD = 3.0
P22_DIST_RTOL = 1e-6
P22_MINHASH_TABLES = 5
P22_MINHASH_ROWS = 2000
P22_MINHASH_THRESHOLD = 0.3
P22_BINARY_QUANTILE = 0.25  # MinHash's rows: above this training quantile
P22_FP_SUPPORT = 0.2
P22_FP_CONFIDENCE = 0.5
P22_HIDDEN = 2  # the feature whose token FPGrowth's rules predict
P22_MULTILABEL = ("f1Measure", "hammingLoss")
P22_BUDGET_S = 25.0


def p22_documents(train: Frame, test: Frame) -> np.ndarray:
    """The flow documents: each held-out flow as one token ``"{j}:{b}"``
    a feature, in feature order (``b`` its bucket of
    ``QuantileDiscretizer(numBuckets=8)`` fitted on the training rows),
    joined by spaces."""
    cols = list(CICIDS2017_FEATURES)
    outs = [f"q{j}" for j in range(len(cols))]
    qd = QuantileDiscretizer(inputCols=cols, outputCols=outs,
                             numBuckets=P22_BUCKETS).fit(train)
    binned = qd.transform(test.select(cols))
    B = np.stack([np.asarray(binned[o]) for o in outs], 1).astype(np.int64)
    names = [[f"{j}:{b}" for b in range(P22_BUCKETS + 1)]
             for j in range(len(cols))]
    docs = [" ".join(names[j][b] for j, b in enumerate(row))
            for row in B.tolist()]
    return object_column(docs)


def p22_text(dev, frame: Frame, fails: list) -> dict:
    """(a): Tokenizer -> StopWordsRemover -> NGram(2) -> HashingTF(4096),
    IDF fitted on the card and on the CPU (``docFreq`` bitwise, the idf
    equal), then CountVectorizer on the tokens and FeatureHasher on the
    flows' columns."""
    t = {}
    t0 = time.perf_counter()
    frame = Tokenizer(inputCol="text", outputCol="tokens").transform(frame)
    frame = StopWordsRemover(inputCol="tokens",
                             outputCol="filtered").transform(frame)
    frame = NGram(inputCol="filtered", outputCol="bigrams").transform(frame)
    frame = HashingTF(inputCol="bigrams", outputCol="tf",
                      numFeatures=P22_HASH_WIDTH).transform(frame)
    t["stages_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    idf = IDF(device=dev, inputCol="tf", outputCol="tfidf").fit(frame)
    torch.cuda.synchronize()
    t["idf_card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    idf_cpu = IDF(device="cpu", inputCol="tf", outputCol="tfidf").fit(frame)
    t["idf_cpu_s"] = time.perf_counter() - t0
    n = frame.num_rows
    doc_freq_equal = np.array_equal(idf.docFreq, idf_cpu.docFreq)
    if not doc_freq_equal or not np.array_equal(idf.idf, idf_cpu.idf):
        fails.append("phase 22 (a): IDF on the card differs from the CPU "
                     f"({int((idf.docFreq != idf_cpu.docFreq).sum())} "
                     "docFreq entries)")
    tfidf = idf.transform(frame.slice(0, P22_W2V_DOCS))["tfidf"]
    lens = np.fromiter(map(len, frame["bigrams"]), np.float32, count=n)
    if not (np.array_equal(frame["tf"].sum(1), lens)
            and np.isfinite(tfidf).all()
            and idf.docFreq.max() <= n):
        fails.append("phase 22 (a): term frequencies or tf-idf malformed")
    t0 = time.perf_counter()
    cv = CountVectorizer(inputCol="filtered", outputCol="cv").fit(frame)
    counts = cv.transform(frame)["cv"]
    t["count_vectorizer_s"] = time.perf_counter() - t0
    if counts.shape != (n, len(cv.vocabulary)) or not np.array_equal(
            counts.sum(1), np.fromiter(map(len, frame["filtered"]),
                                       np.float32, count=n)):
        fails.append(f"phase 22 (a): CountVectorizer {counts.shape}")
    cols = list(CICIDS2017_FEATURES) + ["Label"]
    t0 = time.perf_counter()
    hashed = FeatureHasher(inputCols=cols, outputCol="hashed",
                           numFeatures=P22_HASHER_WIDTH).transform(frame)
    t["feature_hasher_s"] = time.perf_counter() - t0
    X = np.stack([np.asarray(frame[c], np.float64)
                  for c in CICIDS2017_FEATURES], 1)
    got = hashed["hashed"].astype(np.float64).sum(1)
    err = np.abs(got - (X.sum(1) + 1.0)) / (np.abs(X).sum(1) + 1.0)
    if not err.max() <= 1e-5:
        fails.append(f"phase 22 (a): FeatureHasher rows sum off by "
                     f"{err.max():.3g}")
    return {"frame": frame, "seconds": t, "docs": n,
            "doc_freq_equal": doc_freq_equal,
            "terms_seen": int((idf.docFreq > 0).sum()),
            "cv_vocabulary": len(cv.vocabulary),
            "hasher_sum_err": float(err.max())}


def p22_w2v_docs(frame: Frame) -> Frame:
    """(b)'s corpus: the first ``P22_W2V_DOCS`` documents' filtered
    tokens."""
    return frame.slice(0, P22_W2V_DOCS).select(["filtered"])


def p22_w2v_inputs(docs: Frame) -> tuple:
    """The Word2Vec fit's host inputs at its defaults, drawn as the fit
    draws them, and its batch."""
    est = Word2Vec(device="cpu", inputCol="filtered")
    inp = skipgram_inputs([list(map(str, d)) for d in docs["filtered"]],
                          int(est.getMinCount()), int(est.getWindowSize()),
                          int(est.getVectorSize()), est.getSeed())
    return inp, int(min(1024, len(inp["pairs"])))


def p22_w2v_window(dev, inp: dict, batch: int):
    """The window: ``run(n)`` runs the fit's first ``n`` steps through
    ``train_epochs`` on ``dev``, on the fit's own pairs, unigram table,
    ``w_in0`` and uniforms (its rate decays over the ``n`` steps, not over
    the fit: the same work), and returns ``(w_in, w_out)``."""
    est = Word2Vec(device="cpu")
    pairs = upload(inp["pairs"].astype(np.int64), dev)
    probs_cum = upload(inp["probs_cum"], dev)

    def run(n_steps: int = P22_W2V_WINDOW):
        return train_epochs(
            pairs, probs_cum, torch.from_numpy(inp["w_in0"]),
            torch.zeros(inp["w_in0"].shape, dtype=torch.float32),
            float(np.float32(est.getStepSize())), batch=batch,
            n_steps=n_steps,
            uniforms=numpy_uniforms(est.getSeed(), batch))

    return run


def p22_move_gap(got: np.ndarray, want: np.ndarray, start: np.ndarray
                 ) -> float:
    """``max |Δgot − Δwant| / max |Δwant|`` with ``Δ = w − start``: how
    far one run's training moved the vectors from where the other's
    moved them, over how far they moved (1 where ``got`` did not move,
    inf where ``want`` did not)."""
    d_want = want.astype(np.float64) - start
    d_got = got.astype(np.float64) - start
    scale = float(np.abs(d_want).max())
    return (float(np.abs(d_got - d_want).max()) / scale if scale > 0
            else float("inf"))


def p22_word2vec(dev, frame: Frame, cpu: "P22Fits", fails: list) -> dict:
    """(b): Word2Vec at its defaults on the first documents' tokens,
    fitted on the card and (in ``--side p22_fits``) on the CPU from the
    same seed, hence the same numpy uniforms; then the fit's first
    ``P22_W2V_WINDOW`` steps again on both, the card's in a profiler
    window inside a ``record_function`` range (after a few steps that
    let the window's first device records arrive): its device busy ms,
    device events and idle share.  Each is held against the CPU's by
    the training's movement (``P22_W2V_MOVE_RTOL``)."""
    docs = p22_w2v_docs(frame)
    est = Word2Vec(device=dev, inputCol="filtered", maxIter=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = est.fit(docs)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    stats = est.fit_stats
    secs = {"fit": card_s}
    t0 = time.perf_counter()
    inp, batch = p22_w2v_inputs(docs)
    run = p22_w2v_window(dev, inp, batch)
    secs["inputs"] = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        run(P22_W2V_WARM)
        torch.cuda.synchronize()
        with torch.profiler.record_function("p22 window"):
            w_in, w_out = run()
            torch.cuda.synchronize()
    secs["profiled"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spans, ops, matched, unmatched = range_device_ops(prof, "p22 ")
    secs["events"] = time.perf_counter() - t0
    lo, hi = spans["window"]
    wall_ms = (hi - lo) / 1e6
    busy = sum(ops["window"].values())
    top = sorted(ops["window"].items(), key=lambda kv: -kv[1])[:3]
    t0 = time.perf_counter()
    ref = cpu.arrays("word2vec")
    ref_meta = cpu.json("word2vec")
    secs["cpu_wait"] = time.perf_counter() - t0
    w_in0 = inp["w_in0"].astype(np.float64)
    gaps = {
        "fit_in": p22_move_gap(card.vectors, ref["vectors"], w_in0),
        "window_in": p22_move_gap(to_host(w_in), ref["window_in"], w_in0),
        "window_out": p22_move_gap(to_host(w_out), ref["window_out"], 0.0),
    }
    moves = {"fit_in": float(np.abs(ref["vectors"] - w_in0).max()),
             "window_in": float(np.abs(ref["window_in"] - w_in0).max()),
             "window_out": float(np.abs(ref["window_out"]).max())}
    # the gap one rounding of w_in can make, over the move
    resolution = {
        k: float(np.spacing(np.float32(np.abs(inp["w_in0"]).max())))
        / 2 / moves[k] for k in ("fit_in", "window_in")}
    outside = {k: v for k, v in gaps.items() if not v <= P22_W2V_MOVE_RTOL[k]}
    blind = {k: v for k, v in resolution.items()
             if not v <= P22_W2V_MOVE_RTOL[k] / 4}
    if card.vocabulary != ref_meta["words"] or \
            ref_meta["steps"] != stats["steps"] or outside or blind:
        fails.append(f"phase 22 (b): Word2Vec card against CPU, the moves' "
                     f"gaps {gaps} (limits {P22_W2V_MOVE_RTOL}), the "
                     f"resolution {resolution}, steps {stats['steps']} / "
                     f"{ref_meta['steps']}")
    syn = card.findSynonyms(card.vocabulary[0], 5)
    return {"steps": stats["steps"], "pairs": stats["pairs"],
            "vocabulary": len(card.vocabulary), "card_s": card_s,
            "cpu_s": cpu.seconds()["word2vec"], "move_gaps": gaps,
            "moves": moves, "resolution": resolution,
            "seconds": {k: round(v, 3) for k, v in secs.items()},
            "window": {"steps": P22_W2V_WINDOW, "seconds": wall_ms / 1e3,
                       "device_ms": busy, "device_events": matched["window"],
                       "unmatched_device_events": unmatched,
                       # no device event matched: not measured, not idle
                       "device_idle_share": (
                           max(0.0, 1.0 - busy / wall_ms)
                           if matched["window"] else None),
                       "top_device_ops_ms": {k: round(v, 3)
                                             for k, v in top}},
            "synonyms_of": card.vocabulary[0],
            "synonyms": list(syn["word"])}


class P22Fits(CpuFits):
    """Phase 22's CPU side, made by ``chip_smoke.py --side p22_fits DIR``
    in a process of its own that starts after phase 12 (at once under
    ``--phases``): the Word2Vec fit of (b) and its window on the CPU, on
    the phase's documents regenerated from config 1's seeds."""

    SIDE = "p22_fits"

    def json(self, name: str) -> dict:
        self.seconds()
        with open(os.path.join(self.out, name + ".json")) as f:
            return json.load(f)


def p22_fits_main(out: str) -> int:
    """``--side p22_fits DIR``: phase 22's CPU side, saved under DIR;
    prints the seconds of each part as one JSON line."""
    background_side()
    secs = {}
    t0 = time.perf_counter()
    train, test = lbfgs_split(generate_frame(
        LR_ROWS, seed=LBFGS_DATA_SEED, min_class_fraction=0.005), True)
    docs = p22_documents(train, test.slice(0, P22_W2V_DOCS))
    frame = Tokenizer(inputCol="text", outputCol="tokens").transform(
        Frame({"text": docs}))
    frame = StopWordsRemover(inputCol="tokens",
                             outputCol="filtered").transform(frame)
    secs["data"] = time.perf_counter() - t0
    docs = p22_w2v_docs(frame)
    est = Word2Vec(device="cpu", inputCol="filtered", maxIter=1)
    t0 = time.perf_counter()
    model = est.fit(docs)
    secs["word2vec"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    w_in, w_out = p22_w2v_window(torch.device("cpu"),
                                 *p22_w2v_inputs(docs))()
    secs["word2vec_window"] = time.perf_counter() - t0
    np.savez(os.path.join(out, "word2vec.npz"), vectors=model.vectors,
             window_in=w_in.numpy(), window_out=w_out.numpy())
    with open(os.path.join(out, "word2vec.json"), "w") as f:
        json.dump({**est.fit_stats, "words": model.vocabulary,
                   "host": cpu_side_host()}, f)
    return side_done(secs)


def p22_edge_cells(X: np.ndarray, R: np.ndarray) -> np.ndarray:
    """BRP cells whose pre-floor value lies within ``P22_EDGE_ULPS``
    float32 ulps of its terms' magnitude from an integer."""
    v = X.astype(np.float64) @ R.astype(np.float64).T / P22_BRP_BUCKET
    mag = np.abs(X.astype(np.float64)) @ np.abs(R.astype(np.float64)).T \
        / P22_BRP_BUCKET
    eps = float(np.finfo(np.float32).eps)
    return np.abs(v - np.rint(v)) <= P22_EDGE_ULPS * eps * np.maximum(mag, 1)


def p22_keys(n: int) -> np.ndarray:
    """The held-out rows whose neighbours (c) looks up."""
    return np.linspace(0, n - 1, P22_ANN_KEYS).astype(int)


def _p22_rel(a, b) -> float:
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))) \
        if len(b) else 0.0


def p22_lsh(dev, Xtr: np.ndarray, Xte: np.ndarray, Bte: np.ndarray,
            fails: list) -> dict:
    """(c): BRP on the standard-scaled training rows (hashes card against
    CPU away from bucket edges, nearest neighbours of held-out keys, a
    join of held-out against training rows), MinHash on the binarized
    held-out rows (hashes bitwise, a join at Jaccard distance 0.3 of the
    first rows against the next); each model run on the card and again
    on the CPU."""
    out, t = {}, {}
    brp = BucketedRandomProjectionLSH(
        device=dev, inputCol="x", numHashTables=P22_BRP_TABLES,
        bucketLength=P22_BRP_BUCKET, seed=SEED).fit(Frame({"x": Xtr}))
    train = Frame({"x": Xtr, "id": np.arange(len(Xtr))})
    A = Frame({"x": Xte[:P22_JOIN_ROWS[0]]})
    B = Frame({"x": Xtr[:P22_JOIN_ROWS[1]]})
    keys = Xte[p22_keys(len(Xte))]
    res = {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        brp.device = d
        r = res[side] = {}
        t0 = time.perf_counter()
        r["hashes"] = brp.transform(train)["hashes"]
        t[f"brp_hash_{side}_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r["ann"] = [brp.approxNearestNeighbors(train, k, P22_ANN_K,
                                               distCol="d") for k in keys]
        t[f"ann_{side}_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r["join"] = brp.approxSimilarityJoin(A, B, P22_JOIN_THRESHOLD)
        t[f"brp_join_{side}_s"] = time.perf_counter() - t0
    brp.device = dev
    card, cpu = res["card"], res["cpu"]
    edge = p22_edge_cells(Xtr, brp.randUnitVectors)
    differ = card["hashes"] != cpu["hashes"]
    out["brp"] = {"cells": int(differ.size), "edge_cells": int(edge.sum()),
                  "differing_cells": int(differ.sum()),
                  "differing_off_edge": int((differ & ~edge).sum()),
                  "buckets": [int(len(np.unique(card["hashes"][:, i])))
                              for i in range(P22_BRP_TABLES)]}
    if out["brp"]["differing_off_edge"]:
        fails.append(f"phase 22 (c): BRP hashes differ off the edges: "
                     f"{out['brp']}")
    ann_same = all(
        np.array_equal(a["id"], b["id"])
        and _p22_rel(a["d"], b["d"]) <= P22_DIST_RTOL
        for a, b in zip(card["ann"], cpu["ann"]))
    jc, jh = card["join"], cpu["join"]
    join_same = (np.array_equal(jc["idA"], jh["idA"])
                 and np.array_equal(jc["idB"], jh["idB"]))
    join_rel = _p22_rel(jc["distCol"], jh["distCol"]) if join_same else None
    if not ann_same or not join_same or join_rel > P22_DIST_RTOL:
        fails.append(f"phase 22 (c): BRP queries differ: neighbours "
                     f"{ann_same}, join pairs {join_same} "
                     f"({len(jc['idA'])} / {len(jh['idA'])}), distances "
                     f"{join_rel}")
    out["ann"] = {"keys": P22_ANN_KEYS, "k": P22_ANN_K, "same": ann_same,
                  "found": [a.num_rows for a in card["ann"]],
                  "ids": [[int(i) for i in a["id"]] for a in card["ann"]],
                  "nearest": [float(a["d"][0]) if a.num_rows else None
                              for a in card["ann"]]}
    out["brp_join"] = {"pairs": int(len(jc["idA"])), "same": join_same,
                       "max_rel_dist": join_rel}
    # MinHash on the binarized held-out rows with at least one set bit
    nz = Bte.any(axis=1)
    Bx = Bte[nz]
    mh = MinHashLSH(device=dev, inputCol="b", numHashTables=P22_MINHASH_TABLES,
                    seed=SEED).fit(Frame({"b": Bx}))
    fb = Frame({"b": Bx})
    ma = Frame({"b": Bx[:P22_MINHASH_ROWS]})
    mb = Frame({"b": Bx[P22_MINHASH_ROWS:2 * P22_MINHASH_ROWS]})
    mres = {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        mh.device = d
        t0 = time.perf_counter()
        h = mh.transform(fb)["hashes"]
        t[f"minhash_{side}_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        j = mh.approxSimilarityJoin(ma, mb, P22_MINHASH_THRESHOLD)
        t[f"minhash_join_{side}_s"] = time.perf_counter() - t0
        mres[side] = (h, j)
    mh.device = dev
    (hc, jc), (hh, jh) = mres["card"], mres["cpu"]
    mh_same = np.array_equal(hc, hh)
    mjoin_same = all(np.array_equal(jc[c], jh[c])
                     for c in ("idA", "idB", "distCol"))
    if not mh_same or not mjoin_same:
        fails.append(f"phase 22 (c): MinHash differs: hashes {mh_same}, "
                     f"join {mjoin_same}")
    out["minhash"] = {"rows": int(len(Bx)), "empty_rows": int((~nz).sum()),
                      "hashes_bitwise": mh_same, "join_pairs": int(len(jc)),
                      "join_same": mjoin_same}
    out["seconds"] = t
    return out


def p22_tail(data: dict, text: dict, lsh: dict, fails: list) -> dict:
    """(d): FPGrowth on the documents' token sets, its rules predicting a
    hidden feature's token (MultilabelClassificationEvaluator), RFormula
    and SQLTransformer on config 1's frame, RankingEvaluator on (c)'s
    neighbours (relevant: the training rows of the key's label)."""
    t, out = {}, {}
    frame = text["frame"]
    # a document holds one token a feature, in feature order: the hidden
    # feature's token is the one at its place
    docs = frame["filtered"]
    hidden = [[doc[P22_HIDDEN]] for doc in docs]
    baskets = [doc[:P22_HIDDEN] + doc[P22_HIDDEN + 1:] for doc in docs]
    t0 = time.perf_counter()
    fp = FPGrowth(itemsCol="filtered", minSupport=P22_FP_SUPPORT,
                  minConfidence=P22_FP_CONFIDENCE).fit(frame)
    rules = fp.associationRules
    pred = fp.transform(Frame({"filtered": object_column(baskets)}))
    t["fpgrowth_s"] = time.perf_counter() - t0
    ml = Frame({"prediction": pred["prediction"],
                "label": object_column(hidden)})
    t0 = time.perf_counter()
    out["fpgrowth"] = {
        "itemsets": fp.freqItemsets.num_rows, "rules": rules.num_rows,
        "predicted_rows": int(sum(map(bool, pred["prediction"]))),
        "multilabel": {m: MultilabelClassificationEvaluator(
            metricName=m).evaluate(ml) for m in P22_MULTILABEL}}
    t["multilabel_s"] = time.perf_counter() - t0
    if fp.freqItemsets.num_rows == 0 or not all(
            np.isfinite(v) for v in out["fpgrowth"]["multilabel"].values()):
        fails.append(f"phase 22 (d): FPGrowth {out['fpgrowth']}")
    test = data["test"]
    port = np.asarray(test["Destination Port"])
    service = np.where(port == 80, "http", np.where(port == 443, "https",
                       np.where(port == 53, "dns", "other"))).astype(object)
    rf_frame = test.select(["Label", "Flow Duration", "Total Fwd Packets",
                            "Destination Port"]).with_column(
        "service", service)
    t0 = time.perf_counter()
    rfm = RFormula(formula="Label ~ Flow Duration + Total Fwd Packets + "
                           "service + service:Flow Duration").fit(rf_frame)
    rf_out = rfm.transform(rf_frame)
    t["rformula_s"] = time.perf_counter() - t0
    levels = len(rfm.encodings["service"])
    width = 2 + 2 * max(levels - 1, 1)
    y = rf_out["label"]
    want_y = (np.asarray(rf_frame["Label"]) != rfm.labelLevels[0])
    if rf_out["features"].shape != (test.num_rows, width) or \
            not np.array_equal(y, want_y.astype(np.float64)):
        fails.append(f"phase 22 (d): RFormula {rf_out['features'].shape}")
    out["rformula"] = {"width": width, "service_levels": levels,
                       "label_levels": rfm.labelLevels}
    dur = np.asarray(test["Flow Duration"])
    cut = float(np.median(dur))
    t0 = time.perf_counter()
    sql = SQLTransformer(statement=(
        "SELECT `Destination Port`, (`Total Fwd Packets` + "
        "`Total Backward Packets`) AS pkts FROM __THIS__ WHERE "
        f"`Flow Duration` > {cut!r} AND Label <> 'benign'")).transform(test)
    t["sql_s"] = time.perf_counter() - t0
    keep = (dur > cut) & (np.asarray(test["Label"]) != "benign")
    want = (np.asarray(test["Total Fwd Packets"])
            + np.asarray(test["Total Backward Packets"]))[keep]
    if sql.columns != ["Destination Port", "pkts"] or not len(want) or \
            not np.array_equal(sql["pkts"], want):
        fails.append(f"phase 22 (d): SQLTransformer {sql.columns}")
    out["sql"] = {"rows": sql.num_rows}
    labels_tr = np.asarray(data["train"]["Label"])
    labels_te = np.asarray(test["Label"])
    keys_at = p22_keys(test.num_rows)
    rel = {lab: list(np.flatnonzero(labels_tr == lab))
           for lab in np.unique(labels_te[keys_at])}
    rk = Frame({"prediction": object_column(lsh["ann"]["ids"]),
                "label": object_column([rel[labels_te[i]]
                                        for i in keys_at])})
    t0 = time.perf_counter()
    out["ranking"] = {m: RankingEvaluator(metricName=m,
                                          k=P22_ANN_K).evaluate(rk)
                      for m in RankingEvaluator._METRICS}
    t["ranking_s"] = time.perf_counter() - t0
    if not all(np.isfinite(v) for v in out["ranking"].values()):
        fails.append(f"phase 22 (d): ranking {out['ranking']}")
    out["seconds"] = t
    return out


def phase22(dev, data: dict, cpu: P22Fits) -> dict:
    """Phase 22, in this process: config 1's held-out flows as flow
    documents through the text stages, IDF, CountVectorizer and
    FeatureHasher (a), Word2Vec (b), the LSH models on the scaled and the
    binarized rows (c), FPGrowth, RFormula, SQLTransformer and the
    ranking evaluators (d); each device part on the card and again on the
    CPU."""
    t0 = time.perf_counter()
    fails: list = []
    parts = {}
    train, test = data["train"], data["test"]
    frame = test.with_column("text", p22_documents(train, test))
    parts["documents"] = time.perf_counter() - t0
    t = time.perf_counter()
    text = p22_text(dev, frame, fails)
    parts["a_text"] = time.perf_counter() - t
    t = time.perf_counter()
    w2v = p22_word2vec(dev, text["frame"], cpu, fails)
    parts["b_word2vec"] = time.perf_counter() - t
    t = time.perf_counter()
    cols = list(CICIDS2017_FEATURES)
    Xtr = np.stack([np.asarray(train[c], np.float32) for c in cols], 1)
    Xte = np.stack([np.asarray(test[c], np.float32) for c in cols], 1)
    scaler = StandardScaler(device=dev, withMean=True, inputCol="x",
                            outputCol="s").fit(Frame({"x": Xtr}))
    Str = scaler.transform(Frame({"x": Xtr}))["s"]
    Ste = scaler.transform(Frame({"x": Xte}))["s"]
    # binarized at each feature's training first quartile: at 0 nearly
    # every flow sets the same bits, and every pair of the join matches
    Bte = (Xte > np.quantile(Xtr, P22_BINARY_QUANTILE, axis=0)).astype(
        np.float32)
    lsh = p22_lsh(dev, Str, Ste, Bte, fails)
    parts["c_lsh"] = time.perf_counter() - t
    t = time.perf_counter()
    tail = p22_tail(data, text, lsh, fails)
    parts["d_tail"] = time.perf_counter() - t
    text.pop("frame")
    p22 = {"seconds": time.perf_counter() - t0,
           "parts_s": {k: round(v, 3) for k, v in parts.items()},
           "text": text, "word2vec": w2v, "lsh": lsh, "tail": tail}
    if fails:
        log("phase 22 " + json.dumps(p22, default=str))
        raise SystemExit("phase 22 failed:\n" + "\n".join(fails))
    return p22


def report_phase22(p22: dict, card: str) -> None:
    a, b, c, d = p22["text"], p22["word2vec"], p22["lsh"], p22["tail"]
    w = b["window"]
    log(f"phase 22 (a) {a['docs']} flow documents -> Tokenizer -> "
        f"StopWordsRemover -> NGram(2) -> HashingTF({P22_HASH_WIDTH}): "
        f"{a['terms_seen']} buckets seen; IDF on the card "
        f"{a['seconds']['idf_card_s']:.3f} s (CPU "
        f"{a['seconds']['idf_cpu_s']:.3f} s), docFreq bitwise "
        f"{a['doc_freq_equal']}; CountVectorizer {a['cv_vocabulary']} terms; "
        f"FeatureHasher({P22_HASHER_WIDTH}) rows within "
        f"{a['hasher_sum_err']:.3g}; seconds {a['seconds']} [{card}]")
    log(f"phase 22 (b) Word2Vec (vectorSize 100, window 5, minCount 5, "
        f"maxIter 1) on {P22_W2V_DOCS} documents: {b['vocabulary']} words, "
        f"{b['pairs']} pairs, {b['steps']} steps; the card "
        f"{b['card_s']:.3f} s, the CPU process {b['cpu_s']:.3f} s; its "
        f"first {w['steps']} steps again in a profiler window "
        f"{w['seconds']:.3f} s, device busy {w['device_ms']:.4f} ms in "
        f"{w['device_events']} device events (idle share "
        f"{idle_text(w['device_idle_share'])}; unmatched "
        f"{w['unmatched_device_events']}; top {w['top_device_ops_ms']}); "
        f"card against CPU, moves {b['moves']}, their gaps {b['move_gaps']} "
        f"(limits {P22_W2V_MOVE_RTOL}; resolution "
        f"{b['resolution']}); seconds {b['seconds']}; nearest to "
        f"{b['synonyms_of']}: {b['synonyms']} [{card}]")
    log(f"phase 22 (c) BRP ({P22_BRP_TABLES} tables, bucketLength "
        f"{P22_BRP_BUCKET}) on the scaled training rows: {c['brp']}; "
        f"nearest {P22_ANN_K} of {P22_ANN_KEYS} held-out keys equal "
        f"{c['ann']['same']} (found {c['ann']['found']}); join "
        f"{P22_JOIN_ROWS[0]} x {P22_JOIN_ROWS[1]} at {P22_JOIN_THRESHOLD}: "
        f"{c['brp_join']}; MinHash ({P22_MINHASH_TABLES} tables): "
        f"{c['minhash']}; seconds "
        f"{ {k: round(v, 3) for k, v in c['seconds'].items()} } [{card}]")
    log(f"phase 22 (d) FPGrowth(minSupport {P22_FP_SUPPORT}, minConfidence "
        f"{P22_FP_CONFIDENCE}): {d['fpgrowth']}; RFormula {d['rformula']}; "
        f"SQLTransformer {d['sql']}; RankingEvaluator at k {P22_ANN_K}: "
        f"{d['ranking']}; seconds "
        f"{ {k: round(v, 3) for k, v in d['seconds'].items()} } [{card}]")
    log("phase 22 " + json.dumps({
        "phase": 22, "card": card, "seconds": round(p22["seconds"], 3),
        "budget_s": P22_BUDGET_S, "parts_s": p22["parts_s"]}))


# -- phase 5: times ----------------------------------------------------------


def _device_ms(prof) -> dict:
    """Device time (ms) of each kernel and copy a profiler window saw,
    largest first: device-side events only (the host ops that launched
    them would count the same time twice), without CUPTI's own
    "Activity Buffer Request" records."""
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name.startswith("Activity Buffer"):
            continue
        name = e.name if len(e.name) <= 60 else e.name[:57] + "..."
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def breakdown(dev, work: str) -> list:
    """Host-clock stages of the largest batches, served in this process
    exactly as the serve command does (after one warm pass): CSV read,
    predict (ending in the device→host copy), sink write; and the device
    time a profiler window over the predict saw, hence its idle share."""
    model, _, out_cols = serving_form(
        load_model(os.path.join(work, "model"), device=dev))
    pred = BatchPredictor(model, bucket_rows=BUCKET_FLOOR, device=dev)
    sink = CsvDirSink(os.path.join(work, "breakdown"), columns=out_cols)
    rows = []
    for i, n in enumerate(BATCHES):
        if n < 50000:
            continue
        path = os.path.join(work, "in", f"part_{i:04d}.csv")
        pred.predict_frame(load_csv(path))  # warm pass
        t0 = time.perf_counter()
        frame = load_csv(path)
        t1 = time.perf_counter()
        out = pred.predict_frame(frame)
        t2 = time.perf_counter()
        sink.add_batch(i, out)
        t3 = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            pred.predict_frame(frame)
        ops = _device_ms(prof) if dev.type == "cuda" else {}
        device_ms = sum(ops.values()) if ops else None
        predict_ms = (t2 - t1) * 1e3
        rows.append({
            "rows": n, "read_ms": (t1 - t0) * 1e3, "predict_ms": predict_ms,
            "sink_ms": (t3 - t2) * 1e3, "device_ms": device_ms,
            "device_idle_share": None if not device_ms
            else max(0.0, 1.0 - device_ms / predict_ms),
            "top_device_ops_ms": dict(list(ops.items())[:5]),
        })
    return rows


def forest_work(X, feature, threshold, leaf_stats, depth: int):
    """(bytes, comparisons) that ``forest_traversal`` needs on these
    inputs: each element the walks read, counted once — the X values
    compared, the feature index of every slot visited, the threshold of
    every internal slot visited, the stats row of every leaf reached —
    plus the ``[T, N, S]`` output, written once; one comparison per
    internal slot on each (tree, row) walk."""
    T, M = feature.shape
    N, F = X.shape
    S, item, dev = leaf_stats.shape[2], X.element_size(), X.device
    node = torch.zeros((T, N), dtype=torch.long, device=dev)
    walking = torch.ones((T, N), dtype=torch.bool, device=dev)
    slot0 = (torch.arange(T, device=dev) * M)[:, None]
    rows = torch.arange(N, device=dev)[None, :] * F
    feat_read = torch.zeros(T * M, dtype=torch.bool, device=dev)
    thr_read = torch.zeros_like(feat_read)
    x_read = torch.zeros(N * F, dtype=torch.bool, device=dev)
    comparisons = 0
    for _ in range(depth):
        f = feature.gather(1, node).long()
        feat_read[(slot0 + node)[walking]] = True
        walking &= f >= 0
        fc = f.clamp_min(0)
        thr_read[(slot0 + node)[walking]] = True
        x_read[(rows + fc)[walking]] = True
        comparisons += int(walking.sum())
        xv = X.t().gather(0, fc)
        child = 2 * node + 1 + (xv >= threshold.gather(1, node)).long()
        node = torch.where(walking, child, node)
    leaf_read = torch.zeros(T * M, dtype=torch.bool, device=dev)
    leaf_read[(slot0 + node).flatten()] = True
    nbytes = (int(x_read.sum()) * item + int(feat_read.sum()) * 4
              + int(thr_read.sum()) * item + int(leaf_read.sum()) * S * item
              + T * N * S * item)
    return nbytes, comparisons


def hist_work(c: dict) -> tuple:
    """(bytes, operations) that ``tree_hist`` needs on these inputs: the
    node ids of every (tree, row), the weight of each (tree, row) whose
    node is in range, the bins and stats row of each row some tree needs,
    each read once, and the output written once; one add (and one
    multiply by the weight) per non-zero stat of each active (tree, row)
    and feature."""
    node, w, stats = c["node_idx"], c["weights"], c["stats"]
    T, N = node.shape
    F, S = c["binned_t"].shape[0], stats.shape[-1]
    in_range = (node >= 0) & (node < c["n_nodes"])
    active = in_range if w is None else in_range & (w != 0)
    rows = int(active.any(0).sum())
    if stats.ndim == 3:  # per-tree stats: each active (tree, row)'s own
        stat_bytes = int(active.sum()) * S * 4
        nnz = (stats != 0).sum(2)
    else:
        stat_bytes = rows * S * 4
        nnz = (stats != 0).sum(1)[None, :]
    nbytes = (T * N * 4 + (0 if w is None else int(in_range.sum()) * 4)
              + F * rows * 4 + stat_bytes
              + T * F * c["n_nodes"] * c["n_bins"] * S * 4)
    adds = int((active.long() * nnz).sum()) * F
    return nbytes, adds * (1 if w is None else 2)


def index_add_call(c: dict, expect: torch.Tensor):
    """One ``index_add_`` of the weighted stat rows of every active
    (tree, row) and feature into the flat output (per-tree stats: the
    tree's own row) — the same function in one PyTorch call.  The flat ids and the rows are built here, outside
    the timed window; one call is checked against ``expect`` first."""
    node, w, stats, bins = (c["node_idx"], c["weights"], c["stats"],
                            c["binned_t"])
    T = node.shape[0]
    F, S = bins.shape[0], stats.shape[-1]
    nb = c["n_nodes"] * c["n_bins"]
    active = (node >= 0) & (node < c["n_nodes"])
    if w is not None:
        active &= w != 0
    t_idx, n_idx = active.nonzero(as_tuple=True)
    f = torch.arange(F, device=bins.device)[:, None]
    ids = ((t_idx[None, :] * F + f) * nb + node[t_idx, n_idx].long()[None, :]
           * c["n_bins"] + bins[:, n_idx].long()).reshape(-1)
    rows = stats[t_idx, n_idx] if stats.ndim == 3 else stats[n_idx]
    if w is not None:
        rows = rows * w[t_idx, n_idx][:, None]
    src = rows.repeat(F, 1)
    out = torch.zeros((T * F * nb, S), dtype=torch.float32, device=bins.device)
    out.index_add_(0, ids, src)
    if c["integer"]:
        same = torch.equal(out.view(expect.shape), expect)
    else:  # fractional sums: two f32 sums, each within the cell bound
        same = bool(((out.view(expect.shape) - expect).abs()
                     <= 2 * exact_and_bound(c)[1]).all())
    if not same:
        raise SystemExit("the index_add_ yardstick computes another function")
    return lambda: out.index_add_(0, ids, src)


def measure_tree_hist(cases: dict, err: float, launches: int) -> list:
    """``tree_hist`` at the widest level group (the JSON line's entry:
    the deepest level dominates the fit's histogram passes), at the
    chi-square contingency, at config 3's own launches of levels 7 (64
    nodes) and 8 (128 nodes), and at config 4's own per-tree launches of
    levels 0-3: a call's time, the device time a launch (the output's
    zero fill and the kernel, 100 queued), and for per-tree stats the
    device time of the same histogram as K launches of the shared form,
    one per class tree."""
    out = []
    for name in cases:
        c = cases[name]
        args, kw = _hist_args(c)
        nbytes, ops = hist_work(c)
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        expect = tree_hist_cuda(*args, **kw)
        library = index_add_call(c, expect)
        per_class = None
        if c["stats"].ndim == 3:
            per_class = per_class_launches(c)
            apart = torch.stack([h[0] for h in per_class()])
            if not bool(((apart - expect).abs() <= 2 * exact_and_bound(c)[1])
                        .all()):
                raise SystemExit(f"tree_hist {name}: K launches of the "
                                 "shared form compute another histogram")
            del apart
        del expect
        out.append({
            "name": "tree_hist", "route": "cuda",
            "source": "sntc_tpu_torch/kernels/csrc/tree_hist.cu",
            "replaces": "sntc_tpu/ops/pallas_histogram.py:132",
            "launches": launches, "max_abs_err": err,
            "ms": time_ms(lambda: tree_hist_cuda(*args, **kw)),
            # a launch and its output's zero fill a call: 50 calls
            # queued; the per-class form, 15 of each a call: 5 calls
            "device_ms": kernel_device_ms(
                lambda: tree_hist_cuda(*args, **kw), 50),
            "per_class_device_ms": (None if per_class is None
                                    else kernel_device_ms(per_class, 5)),
            "plain_ms": time_ms(lambda: tree_hist_reference(*args, **kw),
                                iters=3),
            "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": time_ms(library, iters=5),
            "shape": f"{name}: {_shape(c)}; needs {nbytes} B, {ops} flops",
            "plan": tree_hist_plan(c["binned_t"].shape[1],
                                   c["binned_t"].shape[0],
                                   c["node_idx"].shape[0], c["n_nodes"],
                                   c["n_bins"], c["stats"].shape[-1]),
        })
        del library, per_class
        torch.cuda.empty_cache()
    return out


def measure_forest(dev, served: dict, err: float, launches: int) -> list:
    """``forest_traversal`` at each of ``FOREST_ROWS``, on two forests:
    complete random trees of depth 10 over standard-normal features (the
    JSON line's entry is its 65 536-row shape), and the config-3 forest
    the serve phase served, over the served traffic's own rows."""
    rng = np.random.default_rng(SEED + 2)
    feat, thr, leaf = random_forest(rng, TREES, DEPTH, TOP, CLASSES,
                                    leaf_p=0.0)
    X = rng.normal(size=(max(FOREST_ROWS), TOP)).astype(np.float32)
    forests = {
        f"random depth-{DEPTH} forest, normal X": (
            torch.from_numpy(X).to(dev),
            [torch.from_numpy(a).to(dev) for a in (feat, thr, leaf)]),
        "served config-3 forest, traffic X": (served["X"],
                                              list(served["forest"])),
    }
    out = []
    for name, (X_all, forest) in forests.items():
        T, M = forest[0].shape
        for n in FOREST_ROWS:
            args = [X_all[:n].contiguous(), *forest]
            nbytes, ops = forest_work(*args, depth=DEPTH)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            o_ms = ops / FP32_OPS_PER_S * 1e3
            out.append({
                "name": "forest_traversal", "route": "cuda",
                "source": "sntc_tpu_torch/kernels/csrc/forest_traversal.cu",
                "replaces": "sntc_tpu/kernels/forest.py:92",
                "launches": launches, "max_abs_err": err,
                "ms": time_ms(
                    lambda: forest_leaf_stats_cuda(*args, max_depth=DEPTH)),
                # the kernel's own time: below ~20 000 rows a call's
                # host work outlasts it
                "device_ms": kernel_device_ms(
                    lambda: forest_leaf_stats_cuda(*args, max_depth=DEPTH)),
                "plain_ms": time_ms(
                    lambda: forest_leaf_stats_reference(*args,
                                                        max_depth=DEPTH)),
                "bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "library_ms": None,  # no single PyTorch call walks a tree
                "shape": f"{name}: X [{n}, {TOP}] f32, T={T}, M={M}, "
                         f"S={forest[2].shape[2]}; needs {nbytes} B, {ops} "
                         "comparisons",
                "rows": n, "forest": name,
            })
    return out


def measure_pad_at(dev, n: int, shapes: dict, dtype=torch.float64,
                   target: int | None = None, columns: int | None = None,
                   row_major: bool = False) -> dict:
    """``pad_assemble`` of an ``[n, 78]`` block to its bucket (or to
    ``target``), in the layout the serve path launches (column-major: the
    transpose of a contiguous ``[78, n]`` block): bitwise against its
    plain version on the same inputs, a call's time by CUDA events, as
    for every kernel, and the device time a launch (100 queued: the
    output's allocation costs no launch), beside the one PyTorch call
    that computes the same function on the same view (``index_select``
    of the rows; at a zero-row pad ``contiguous()``).  ``launches`` is
    what ``shapes`` (a serve run's ``pad_launch_shapes``) counted at this
    block and target; none there fails the phase.  ``columns`` (default
    the 78 features) and ``row_major`` (a contiguous ``[n, C]`` block, as
    a 2-D column is padded) cover the lifecycle's shadow dispatch."""
    target = bucket_rows_for(n, BUCKET_FLOOR) if target is None else target
    c = len(CICIDS2017_FEATURES) if columns is None else columns
    key = pad_launch_shape(n, c, dtype, target)
    if shapes.get(key, 0) < 1:
        raise SystemExit(f"pad_assemble {key}: not launched in its run, "
                         f"which padded {shapes}")
    a = (torch.randn((n, c), dtype=dtype, device=dev) if row_major
         else torch.randn((c, n), dtype=dtype, device=dev).t())
    out, ref = pad_rows_cuda(a, target), pad_rows_reference(a, target)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise SystemExit(f"pad_assemble {key}: differs from its plain "
                         "version")
    if target == n:
        library, library_name = a.contiguous, "contiguous"
    else:
        idx = torch.clamp(torch.arange(target, device=dev), max=n - 1)
        library, library_name = (lambda: a.index_select(0, idx),
                                 "index_select")
    p_bytes = (n + target) * c * a.element_size()
    return {
        "name": "pad_assemble", "route": "cuda",
        "source": "sntc_tpu_torch/kernels/csrc/pad_rows.cu",
        "replaces": "sntc_tpu/kernels/assemble.py:69",
        "launches": shapes[key],
        "max_abs_err": (out - ref).abs().max().item(),
        "ms": time_ms(lambda: pad_rows_cuda(a, target)),
        "device_ms": kernel_device_ms(lambda: pad_rows_cuda(a, target)),
        "plain_ms": time_ms(lambda: pad_rows_reference(a, target)),
        "bound_ms": p_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(library),
        "library_device_ms": kernel_device_ms(library),
        "library_call": library_name,
        "shape": f"{key}, {'row' if row_major else 'column'}-major; "
                 f"needs {p_bytes} B",
    }


def measure_pad(dev, shapes: dict) -> list:
    """``pad_assemble`` at the largest padded micro-batch ([50 000, 78]
    f64 -> 65 536, the JSON line's entry) and at a small one ([1 000,
    78] -> 1 024)."""
    return [measure_pad_at(dev, n, shapes)
            for n in (max(b for b in BATCHES
                          if bucket_rows_for(b, BUCKET_FLOOR) != b), 1000)]


# -- phase 23: bench config 17 on the card, the mesh substrate ---------------

P23_ROWS = 62_500  # bench.py:260 (BENCH_ROWS // 8)
P23_SEED = 7  # bench.py's SEED
# the forms in rotated order; BENCH17_REPS (bench.py:3339) is 3, cut to
# hold the smoke's time
P23_REPS = 1
P23_SERVE_SHARDS = 4  # (a)'s serve mesh: [cuda:0] * 4
P23_FIT_SHARDS = 4  # (b)'s and (e)'s mesh
P23_KM_SIZES = (1, 2, 4, 8)  # BENCH17_MESH_SIZES
P23_KM_K, P23_KM_ITERS = 8, 20  # BENCH17_KMEANS_K, bench.py:3556
P23_CHAOS_SHARDS = 8
P23_PROB_TOL = 1e-5  # tests/test_mesh.py:301's serve-mesh tolerance
P23_F1_DELTA = 0.02  # bench.py:3688
P23_OBJ_RTOL = 1e-5  # one objective evaluation, mesh 4 against mesh 1
P23_CENTER_TOL = 1e-3  # bench.py:3696
P23_RMSE, P23_RMSE_SLACK = 0.1, 0.02  # bench.py:3699-3700
P23_KM_RTOL = 1e-5  # (f)'s centers, two ranks against one process
P23_RANK_WAIT_S = 120.0
P23_HELD_ROWS = 20_000  # (e)'s held-out rows, after the fit's 20 000
#: (f)'s rank process: joins the group the launcher environment names
#: (two gloo ranks on cuda:0, or one nccl rank), builds the global mesh,
#: and runs StandardScaler's moments aggregate on integer-valued rows and
#: (c)'s KMeans; its results in an npz.  Gloo reduces the CUDA tensors
#: itself (no host copies)
P23_RANK = r"""
import sys, time
import numpy as np
import torch
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.feature.standard_scaler import standardization_moments
from sntc_tpu_torch.models import KMeans
from sntc_tpu_torch.parallel import (global_mesh, initialize, process_info,
                                     shard_batch)

backend, rows_path, feat_path, out = sys.argv[1:5]
t0 = time.time()
assert initialize(device="cuda:0", backend=backend)
mesh = global_mesh()
xi = np.load(rows_path)
xs, w = shard_batch(mesh, xi)
n, mean, var = standardization_moments(xs, w, xi[0], mesh)
res = dict(n=n, mean=mean, var=var, shards=mesh.shape["data"],
           local=mesh.local_shards(),
           info=[process_info()[k] for k in ("process_index",
                                             "process_count")])
if feat_path != "-":
    feats = np.load(feat_path)
    km = KMeans(mesh=mesh, k=8, maxIter=20, seed=0).fit(
        Frame({"features": feats}))
    res.update(centers=km.clusterCenters,
               iterations=km.fit_stats["iterations"])
res["seconds"] = time.time() - t0
np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
torch.distributed.destroy_process_group()
"""


def card_mesh(dev, n: int):
    """``[dev] * n``: ``n`` virtual shards of the one card."""
    return make_mesh(devices=[dev] * n)


def p23_data(binary: bool) -> tuple:
    """Config 17's flows (``bench.py:264-280``): ``generate_frame(62 500,
    seed=7)`` cleaned, binary (benign/attack) or multiclass, split
    0.8/0.2 with seed 0, as phase 15's data is split."""
    df = clean_flows(generate_frame(P23_ROWS, seed=P23_SEED,
                                    min_class_fraction=0.005))
    if binary:
        df = df.with_column("Label", np.where(
            df["Label"].astype(str) == "BENIGN", "benign", "attack",
        ).astype(object))
    return df.random_split([0.8, 0.2], seed=0)


def counter_total(name: str) -> float:
    snap = registry().snapshot().get(name)
    return float(sum(r.get("value", 0.0) for r in snap["series"])) \
        if snap else 0.0


def p23_serve(dev, work: str, fails: list) -> dict:
    """(a): config 6's fused pipeline fitted on the card, its stream served
    direct, at serve mesh 1 and at serve mesh ``[cuda:0] * 4``,
    ``P23_REPS`` reps in rotated order; the sinks, the probabilities
    in this process, the pad launches."""
    train, test = p23_data(True)
    tmp = os.path.join(work, "p23")
    with environ(SNTC_SERVE_HOST_ROWS=0, SNTC_SERVE_MESH_DEVICES=None):
        fitted, fit_s = timed(lambda: c6_pipeline(dev).fit(train))
        staged = PipelineModel(stages=fitted.getStages()[1:])
        features = PipelineModel(stages=fitted.getStages()[1:5]).transform(
            train)["features"]
        in_dir = os.path.join(tmp, "in")
        sizes = write_bench_stream(in_dir, test, passes=C6_PASSES)
        stream_rows, n_files = sum(sizes), len(sizes)
        forms = (("direct", None), ("mesh1", card_mesh(dev, 1)),
                 ("mesh4", card_mesh(dev, P23_SERVE_SHARDS)))
        try:
            engines = []
            for name, mesh in forms:
                set_serve_mesh(mesh)
                eng = c6_engine(dev, tmp, name, in_dir, sizes,
                                compile_pipeline(staged), test)
                eng["mesh"] = mesh
                engines.append(eng)
            segs = {e["name"]: fused_segments(e["predictor"])
                    for e in engines}

            def seg_counts():
                return {n: (sum(g.mesh_splits for g in gs),
                            sum(g.invocations for g in gs))
                        for n, gs in segs.items()}

            counts0 = seg_counts()
            reset_launches()
            for rep in range(P23_REPS):
                k = rep % len(engines)
                for eng in engines[k:] + engines[:k]:
                    set_serve_mesh(eng["mesh"])
                    c6_run(dev, tmp, eng, in_dir, rep, stream_rows, n_files)
            launches, shapes = dict(LAUNCHES), dict(PAD_LAUNCH_SHAPES)
            # the segment dispatches of the timed reps, and how many of
            # them were split over the serve mesh
            splits = {n: c[0] - counts0[n][0]
                      for n, c in seg_counts().items()}
            dispatches = {n: c[1] - counts0[n][1]
                          for n, c in seg_counts().items()}
            probs = {}
            for eng in engines:
                set_serve_mesh(eng["mesh"])
                probs[eng["name"]] = np.concatenate([
                    to_host(eng["predictor"].predict_frame(
                        test.slice(0, n))["probability"])
                    for n in sorted(set(sizes))])
        finally:
            reset_serve_mesh()
    files = {e["name"]: [sink_files(r["out_dir"]) for r in e["reps"]]
             for e in engines}
    preds = {e["name"]: [sink_predictions(r["out_dir"]) for r in e["reps"]]
             for e in engines}
    padded = sum(bucket_rows_for(n, BUCKET_FLOOR) != n for n in sizes)
    want_pad = padded * P23_REPS * len(engines)
    base = files["direct"][0]
    direct_mesh1 = all(f == base for f in files["direct"] + files["mesh1"])
    mesh4_files = all(f == base for f in files["mesh4"])
    mesh4_preds = all(np.array_equal(p, preds["direct"][0])
                      for p in preds["mesh4"])
    p_err = float(np.abs(probs["mesh4"] - probs["direct"]).max())
    p_rows = int((probs["mesh4"] != probs["direct"]).any(axis=1).sum())
    if not direct_mesh1:
        fails.append("phase 23 (a): the direct and serve-mesh-1 sinks differ")
    if not mesh4_preds or p_err > P23_PROB_TOL or not np.array_equal(
            probs["mesh1"], probs["direct"]):
        fails.append(f"phase 23 (a): serve mesh 4 predictions equal "
                     f"{mesh4_preds}, probabilities {p_err} apart")
    # every batch of the mesh-4 form split, none of the other forms'
    if splits["direct"] or splits["mesh1"] \
            or not all(segs.values()) \
            or splits["mesh4"] != dispatches["mesh4"] \
            or dispatches["mesh4"] != P23_REPS * n_files * len(segs["mesh4"]):
        fails.append(f"phase 23 (a): serve-mesh splits {splits} of segment "
                     f"dispatches {dispatches}, want every mesh-4 dispatch "
                     f"({P23_REPS} x {n_files} batches) split and no other")
    if any(r["batches"] != n_files for e in engines for r in e["reps"]) \
            or want_pad < 1 or launches != {"forest_traversal": 0,
                                            "tree_hist": 0,
                                            "pad_assemble": want_pad}:
        fails.append(f"phase 23 (a): launches {launches}, want {want_pad} "
                     "pad_assemble")

    def median(eng):
        reps = sorted(r["rows_per_s"] for r in eng["reps"])
        return reps[len(reps) // 2]

    rps = {e["name"]: median(e) for e in engines}
    return {"fit_s": fit_s, "files": n_files, "stream_rows": stream_rows,
            "rows_per_s": rps,
            "reps": {e["name"]: [round(r["rows_per_s"], 1)
                                 for r in e["reps"]] for e in engines},
            "mesh1_vs_direct": rps["mesh1"] / rps["direct"],
            "mesh4_vs_direct": rps["mesh4"] / rps["direct"],
            "sinks_direct_mesh1_identical": direct_mesh1,
            "sinks_mesh4_identical": mesh4_files,
            "mesh4_predictions_equal": mesh4_preds,
            "mesh4_prob_max_err": p_err, "mesh4_prob_rows_not_bitwise": p_rows,
            "mesh_splits": splits, "segment_dispatches": dispatches,
            "prob_rows": int(probs["direct"].shape[0]),
            "launches": launches, "pad_launch_shapes": shapes,
            "features": np.ascontiguousarray(to_host(features), np.float32)}


def p23_flagship(dev, fails: list) -> dict:
    """(b): config 2's pipeline (StandardScaler(withMean) -> MLP [78, 64,
    15], 100 iterations, seed 0) fitted cold then warm at mesh 1 and at
    ``[cuda:0] * 4``; macro-F1 on the held-out rows, and one objective
    evaluation at the mesh-1 fit's weights through both meshes."""
    train, test = p23_data(False)

    def build(mesh):
        return Pipeline(stages=[
            StringIndexer(inputCol="Label", outputCol="label",
                          handleInvalid="skip"),
            VectorAssembler(inputCols=CICIDS2017_FEATURES,
                            outputCol="rawFeatures", handleInvalid="skip"),
            StandardScaler(device=dev, mesh=mesh, inputCol="rawFeatures",
                           outputCol="features", withMean=True),
            MultilayerPerceptronClassifier(
                device=dev, mesh=mesh, layers=MLP_LAYERS,
                maxIter=LBFGS_ITERS, seed=SEED),
        ])

    out, models = {}, {}
    for n in (1, P23_FIT_SHARDS):
        mesh = card_mesh(dev, n)
        _, cold = timed(lambda: build(mesh).fit(train))
        models[n], warm = timed(lambda: build(mesh).fit(train))
        f1 = MulticlassClassificationEvaluator(metricName="macroF1").evaluate(
            models[n].transform(test))
        head = models[n].getStages()[-1]
        out[f"mesh{n}"] = {"cold_s": cold, "warm_s": warm, "macro_f1": f1,
                           "iterations": head.optimizer_stats["iterations"]}
    delta = abs(out["mesh1"]["macro_f1"]
                - out[f"mesh{P23_FIT_SHARDS}"]["macro_f1"])
    # one evaluation of the objective at the mesh-1 weights, both ways
    one = models[1]
    feats = PipelineModel(stages=one.getStages()[:3]).transform(train)
    X = np.ascontiguousarray(to_host(feats["features"]), np.float32)
    y = np.asarray(to_host(feats["label"])).astype(np.int64)
    w = np.ones(len(y), np.float32)
    theta = torch.from_numpy(one.getStages()[-1].weights.copy()).to(dev)
    with full_f32():
        v1, g1 = mlp_value_and_grad(
            torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev),
            torch.from_numpy(w).to(dev), tuple(MLP_LAYERS))(theta)
        mesh = card_mesh(dev, P23_FIT_SHARDS)
        xs, ys, _ = shard_batch(mesh, X, y)
        v4, g4 = mlp_value_and_grad(xs, ys, shard_weights(mesh, w, xs.shape[0]),
                                    tuple(MLP_LAYERS))(theta)
    v_rel = abs(float(v4) - float(v1)) / abs(float(v1))
    g_rel = float((g4 - g1).abs().max() / g1.abs().max())
    if delta > P23_F1_DELTA or v_rel > P23_OBJ_RTOL:
        fails.append(f"phase 23 (b): macro-F1 {delta} apart, objective "
                     f"{v_rel} relative: {out}")
    return {**out, "f1_delta": delta, "objective": float(v1),
            "objective_rel": v_rel, "gradient_rel": g_rel}


def p23_kmeans(dev, features: np.ndarray, fails: list) -> dict:
    """(c): KMeans (k 8, 20 iterations, seed 0) on (a)'s PCA features at
    mesh sizes ``P23_KM_SIZES`` of the one card, with the collective
    series' deltas."""
    feat = Frame({"features": features})
    sweep, centers = [], {}
    for n in P23_KM_SIZES:
        d0 = counter_total("sntc_collective_dispatches_total")
        b0 = counter_total("sntc_collective_bytes_moved_total")
        km, fit_s = timed(lambda: KMeans(
            mesh=card_mesh(dev, n), k=P23_KM_K, maxIter=P23_KM_ITERS,
            seed=0).fit(feat))
        centers[n] = np.asarray(km.clusterCenters, np.float64)
        sweep.append({
            "mesh": n, "fit_s": fit_s,
            "iterations": km.fit_stats["iterations"],
            "dispatches": counter_total("sntc_collective_dispatches_total")
            - d0,
            "bytes": counter_total("sntc_collective_bytes_moved_total") - b0,
            "max_center_diff": float(np.abs(centers[n] - centers[1]).max()),
        })
    byts = [r["bytes"] for r in sweep]
    disp = {r["dispatches"] for r in sweep[1:]}
    if byts[0] != 0 or not all(b > a for a, b in zip(byts, byts[1:])) \
            or len(disp) != 1 or sweep[0]["dispatches"] != 0 \
            or max(r["max_center_diff"] for r in sweep) >= P23_CENTER_TOL:
        fails.append(f"phase 23 (c): {sweep}")
    return {"sweep": sweep}


def p23_chaos(dev, fails: list) -> dict:
    """(d): ALS (rank 4, 10 iterations, regParam 0.02, seed 2) on the
    bench's 40 x 30 ratings at ``[cuda:0] * 8``, a device fault domain
    attached and ``collective.dispatch`` armed ``device_lost`` after 3,
    once; then the same fit unfaulted."""
    from sntc_tpu_torch.resilience import DeviceFaultDomain
    from sntc_tpu_torch.resilience import faults as fault_plane

    rng = np.random.default_rng(0)
    n_u, n_i, rank = 40, 30, 3
    U = rng.normal(size=(n_u, rank)) / np.sqrt(rank)
    V = rng.normal(size=(n_i, rank)) / np.sqrt(rank)
    full = U @ V.T + 2.0
    uu, ii = np.nonzero(rng.random((n_u, n_i)) < 0.6)
    truth = full[uu, ii]
    ratings = Frame({"user": uu.astype(np.int64), "item": ii.astype(np.int64),
                     "rating": truth.astype(np.float32)})
    pairs = Frame({"user": uu, "item": ii})
    strikes0 = counter_total("sntc_tenant_strikes_total")

    def fit():
        return ALS(mesh=card_mesh(dev, P23_CHAOS_SHARDS), rank=4, maxIter=10,
                   regParam=0.02, seed=2).fit(ratings)

    dom = DeviceFaultDomain()
    set_collective_domain(dom)
    fault_plane.arm("collective.dispatch", kind="device_lost", after=3,
                    times=1)
    try:
        faulted, fit_s = timed(fit)
    finally:
        fault_plane.clear()
        set_collective_domain(None)
    # read before the unfaulted fit, whose aggregates record the full mesh
    survivors = registry().get("sntc_collective_mesh_devices", axis="data")
    ref = fit()

    def rmse(m):
        pred = np.asarray(m.transform(pairs)["prediction"])
        return float(np.sqrt(np.mean((pred - truth) ** 2)))

    res = {"fit_s": fit_s,
           "resizes": [(r["from"], r["to"]) for r in dom.journal
                       if r.get("decision") == "mesh_resize"],
           "mesh_devices_after": survivors, "rmse": rmse(faulted),
           "rmse_unfaulted": rmse(ref), "domain_failed": dom.failed,
           "tenant_strikes": counter_total("sntc_tenant_strikes_total")
           - strikes0}
    if res["resizes"] != [(P23_CHAOS_SHARDS, 4)] or survivors != 4 \
            or res["rmse"] >= P23_RMSE \
            or res["rmse"] > res["rmse_unfaulted"] + P23_RMSE_SLACK \
            or dom.failed or res["tenant_strikes"]:
        fails.append(f"phase 23 (d): {res}")
    return res


def forest_arrays(model) -> tuple:
    f = model.getStages()[-1].forest
    return f.feature, f.threshold, f.leaf_stats, f.gain, f.count


def p23_trees(dev, train3: Frame, fails: list) -> dict:
    """(e): the reduced config-3 fit (ChiSq top 40 -> RF 20 trees, depth
    6, 20 000 rows) at mesh 1 and at ``[cuda:0] * 4``, each with the
    launch counts set to 0 just before it; both forests served on the
    next 20 000 rows through ``forest_traversal``; the device quantile
    edges of the fit's features against the host path."""
    frame = train3.slice(0, REDUCED_ROWS)
    held = train3.slice(REDUCED_ROWS, REDUCED_ROWS + P23_HELD_ROWS)
    models, launches, secs = {}, {}, {}
    for n in (1, P23_FIT_SHARDS):
        reset_launches()
        with recording_tree_hist() as calls:
            models[n], secs[n] = timed(lambda: pipeline(
                dev, REDUCED_DEPTH, card_mesh(dev, n)).fit(frame))
        launches[n] = LAUNCHES["tree_hist"]
        if n == P23_FIT_SHARDS:
            sharded_calls = calls
    sel = [models[n].getStages()[2].selected_features for n in models]
    same = sel[0] == sel[1] and all(
        np.array_equal(a, b) for a, b in zip(
            forest_arrays(models[1]), forest_arrays(models[P23_FIT_SHARDS])))
    reset_launches()
    preds = {n: to_host(m.transform(held)["prediction"])
             for n, m in models.items()}
    walks = LAUNCHES["forest_traversal"]
    same_pred = np.array_equal(preds[1], preds[P23_FIT_SHARDS])
    if not same or launches[P23_FIT_SHARDS] != P23_FIT_SHARDS * launches[1] \
            or launches[1] < 1 or not same_pred or walks < 2:
        fails.append(f"phase 23 (e): forests equal {same}, tree_hist "
                     f"launches {launches}, predictions equal {same_pred}, "
                     f"forest_traversal {walks}")
    # the device quantile edges of the fit's 78 features
    X = np.stack([np.asarray(frame[c], np.float32)
                  for c in CICIDS2017_FEATURES], axis=1)
    host = quantile_bin_edges(X, max_bins=BINS, seed=SEED)
    on_card = to_host(quantile_bin_edges(torch.from_numpy(X).to(dev),
                                         max_bins=BINS, seed=SEED))
    edge_cells = int((host != on_card).sum())
    if edge_cells:
        fails.append(f"phase 23 (e): {edge_cells} device edges differ from "
                     "the host path's")
    # the kernels line: tree_hist at the sharded fit's contingency and
    # widest level-group shard, forest_traversal at the held-out walk
    shard_rows = frame.num_rows // P23_FIT_SHARDS
    cases = {}
    for i, c in enumerate(sharded_calls):
        key = ("mesh-4 contingency shard" if c["n_nodes"] == 1
               and c["binned_t"].shape[0] == len(CICIDS2017_FEATURES)
               else "mesh-4 widest level-group shard")
        if key not in cases or c["n_nodes"] > cases[key]["n_nodes"]:
            cases[key] = c
    err = check_tree_hist(cases)
    kernels = measure_tree_hist(cases, err, launches[P23_FIT_SHARDS])
    rf = models[P23_FIT_SHARDS].getStages()[-1]
    held_x = PipelineModel(stages=models[P23_FIT_SHARDS].getStages()[:3]) \
        .transform(held)["features"]
    args = [rf._features_on_device(held_x), *rf._device_forest()]
    depth = rf.getMaxDepth()
    out = forest_leaf_stats_cuda(*args, max_depth=depth)
    ref = forest_leaf_stats_reference(*args, max_depth=depth)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        fails.append("phase 23 (e): forest_traversal differs from its plain "
                     "version")
    nbytes, ops = forest_work(*args, depth=depth)
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    T, M = args[1].shape
    kernels.append({
        "name": "forest_traversal", "route": "cuda",
        "source": "sntc_tpu_torch/kernels/csrc/forest_traversal.cu",
        "replaces": "sntc_tpu/kernels/forest.py:92",
        "launches": walks, "max_abs_err": (out - ref).abs().max().item(),
        "ms": time_ms(lambda: forest_leaf_stats_cuda(*args,
                                                     max_depth=depth)),
        "device_ms": kernel_device_ms(
            lambda: forest_leaf_stats_cuda(*args, max_depth=depth)),
        "plain_ms": time_ms(lambda: forest_leaf_stats_reference(
            *args, max_depth=depth)),
        "bound_ms": max(b_ms, o_ms),
        "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "library_ms": None,  # no single PyTorch call walks a tree
        "shape": f"phase 23 (e) held-out walk of the mesh-fitted forest: X "
                 f"[{args[0].shape[0]}, {TOP}] f32, T={T}, M={M}, "
                 f"S={args[3].shape[2]}; needs {nbytes} B, {ops} "
                 "comparisons",
    })
    return {"fit_s": secs, "tree_hist_launches": launches,
            "shard_rows": shard_rows, "forests_equal": same,
            "selected_equal": sel[0] == sel[1],
            "splits": int((forest_arrays(models[1])[0] >= 0).sum()),
            "forest_traversal_launches": walks,
            "predictions_equal": same_pred,
            "edges_not_bitwise": edge_cells, "edges_cells": int(host.size),
            "kernels": kernels}


def p23_start_ranks(work: str, features: np.ndarray) -> dict:
    """(f): two gloo ranks on cuda:0 and one nccl rank, each in a
    process of its own with the launcher environment; they run beside
    (b)-(e)."""
    import socket as socketlib

    def free_port() -> int:
        with socketlib.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    d = os.path.join(work, "p23ranks")
    os.makedirs(d, exist_ok=True)
    rows = np.random.default_rng(P23_SEED).integers(
        -50, 50, size=(515, 6)).astype(np.float32)
    np.save(os.path.join(d, "rows.npy"), rows)
    np.save(os.path.join(d, "feats.npy"), features)
    procs = {}
    for group, backend, world, feats in (("gloo", "gloo", 2, "feats.npy"),
                                         ("nccl", "nccl", 1, "-")):
        port = free_port()
        for r in range(world):
            env = env_with(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                           WORLD_SIZE=str(world), RANK=str(r),
                           LOCAL_RANK=str(r))
            procs[f"{group}{r}"] = subprocess.Popen(
                [sys.executable, "-c", P23_RANK, backend,
                 os.path.join(d, "rows.npy"),
                 "-" if feats == "-" else os.path.join(d, feats),
                 os.path.join(d, f"{group}{r}.npz")],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    return {"dir": d, "procs": procs, "rows": rows, "started": time.time()}


def p23_finish_ranks(dev, ranks: dict, features: np.ndarray,
                     fails: list) -> dict:
    """(f)'s results against this process: the gloo ranks' moments
    bitwise the one-process mesh ``[cuda:0] * 2``'s, their centers within
    ``P23_KM_RTOL``; the nccl rank's moments bitwise mesh 1's.  A rank
    that hangs gets SIGABRT (its stacks: ``PYTHONFAULTHANDLER``)."""
    from sntc_tpu_torch.feature.standard_scaler import standardization_moments

    deadline = ranks["started"] + P23_RANK_WAIT_S
    for name, p in ranks["procs"].items():
        try:
            _out, err = p.communicate(timeout=max(1.0,
                                                  deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in ranks["procs"].values():
                if q.poll() is None:
                    q.send_signal(signal.SIGABRT)
            _out, err = p.communicate()
            for q in ranks["procs"].values():
                q.communicate()
            raise SystemExit(f"phase 23 (f): rank {name} still running "
                             f"after {P23_RANK_WAIT_S} s:\n{err[-6000:]}")
        if p.returncode != 0:
            raise SystemExit(f"phase 23 (f): rank {name} exited "
                             f"{p.returncode}:\n{err[-3000:]}")
    got = {name: dict(np.load(os.path.join(ranks["dir"], f"{name}.npz")))
           for name in ranks["procs"]}
    rows = ranks["rows"]

    def moments(n):
        mesh = card_mesh(dev, n)
        xs, w = shard_batch(mesh, rows)
        return standardization_moments(xs, w, rows[0], mesh)

    ref = {1: moments(1), 2: moments(2)}
    km2 = KMeans(mesh=card_mesh(dev, 2), k=P23_KM_K, maxIter=P23_KM_ITERS,
                 seed=0).fit(Frame({"features": features}))
    c2 = np.asarray(km2.clusterCenters, np.float64)
    res = {"seconds": time.time() - ranks["started"],
           "rank_seconds": {k: float(v["seconds"]) for k, v in got.items()}}
    bitwise = {}
    for name, n in (("gloo0", 2), ("gloo1", 2), ("nccl0", 1)):
        g = got[name]
        bitwise[name] = all(np.array_equal(np.asarray(g[k]), np.asarray(v))
                            for k, v in zip(("n", "mean", "var"), ref[n]))
    res["moments_bitwise"] = bitwise
    res["center_rel"] = {
        name: float(np.abs(got[name]["centers"] - c2).max()
                    / np.abs(c2).max()) for name in ("gloo0", "gloo1")}
    res["shards"] = {k: int(v["shards"]) for k, v in got.items()}
    if not all(bitwise.values()) or max(res["center_rel"].values()) > \
            P23_KM_RTOL or res["shards"] != {"gloo0": 2, "gloo1": 2,
                                             "nccl0": 1}:
        fails.append(f"phase 23 (f): {res}")
    return res


def phase23(dev, work: str, train3: Frame) -> dict:
    """Phase 23, bench config 17 on the card: (a) the serve mesh, (b) the
    flagship fit, (c) the KMeans sweep, (d) the chaos leg, (e) the trees
    on the mesh, in this process; (f) the process groups in three rank
    processes started after (a) and read last."""
    t0 = time.perf_counter()
    fails: list = []
    parts = {}

    def part(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        parts[name] = round(time.perf_counter() - t, 3)
        return out

    serve = part("a_serve_mesh", p23_serve, dev, work, fails)
    features = serve.pop("features")
    ranks = part("f_start", p23_start_ranks, work, features)
    flagship = part("b_flagship", p23_flagship, dev, fails)
    kmeans = part("c_kmeans", p23_kmeans, dev, features, fails)
    chaos = part("d_chaos", p23_chaos, dev, fails)
    trees = part("e_trees", p23_trees, dev, train3, fails)
    groups = part("f_groups", p23_finish_ranks, dev, ranks, features, fails)
    kernels = pads_of(dev, serve["pad_launch_shapes"], False)
    kernels += trees.pop("kernels")
    p23 = {"seconds": time.perf_counter() - t0, "parts_s": parts,
           "serve": serve, "flagship": flagship, "kmeans": kmeans,
           "chaos": chaos, "trees": trees, "groups": groups}
    PHASE_SECONDS["23 parts"] = parts
    if fails:
        log("phase 23 " + json.dumps(p23, default=str))
        raise SystemExit("phase 23 failed:\n" + "\n".join(fails))
    p23["kernels"] = kernels
    return p23


def report_phase23(p23: dict, card: str) -> None:
    """Phase 23's lines: every leg's numbers beside the card, the kernel
    shapes, one JSON line.  The seconds at each mesh size are the
    virtual shards' overhead on one card, not a scaling."""
    s, b, k, c, t, g = (p23[x] for x in ("serve", "flagship", "kmeans",
                                          "chaos", "trees", "groups"))
    log(f"phase 23 (a) config 6's stream ({s['files']} files, "
        f"{s['stream_rows']} rows, {P23_REPS} reps a form in rotated order):"
        f" median rows/s direct {s['rows_per_s']['direct']:.1f}, serve mesh "
        f"1 {s['rows_per_s']['mesh1']:.1f}, serve mesh [cuda:0] x "
        f"{P23_SERVE_SHARDS} {s['rows_per_s']['mesh4']:.1f} (ratios "
        f"{s['mesh1_vs_direct']:.3f}, {s['mesh4_vs_direct']:.3f}; reps "
        f"{s['reps']}); sinks direct = mesh 1 byte-identical "
        f"{s['sinks_direct_mesh1_identical']}, mesh 4 byte-identical "
        f"{s['sinks_mesh4_identical']}, predictions equal "
        f"{s['mesh4_predictions_equal']}; probabilities of {s['prob_rows']} "
        f"rows in process {s['mesh4_prob_max_err']:.3g} apart "
        f"({s['mesh4_prob_rows_not_bitwise']} rows not bitwise); segment "
        f"dispatches split {s['mesh_splits']} of {s['segment_dispatches']}; "
        f"launches "
        f"{s['launches']} [{card}]")
    log(f"phase 23 (b) config 2 fit: mesh 1 cold {b['mesh1']['cold_s']:.3f} "
        f"s, warm {b['mesh1']['warm_s']:.3f} s, macro-F1 "
        f"{b['mesh1']['macro_f1']:.4f}; [cuda:0] x {P23_FIT_SHARDS} cold "
        f"{b[f'mesh{P23_FIT_SHARDS}']['cold_s']:.3f} s, warm "
        f"{b[f'mesh{P23_FIT_SHARDS}']['warm_s']:.3f} s, macro-F1 "
        f"{b[f'mesh{P23_FIT_SHARDS}']['macro_f1']:.4f} (delta "
        f"{b['f1_delta']:.4f}); one objective evaluation at the mesh-1 "
        f"weights {b['objective_rel']:.3g} relative apart, gradient "
        f"{b['gradient_rel']:.3g} [{card}]")
    log("phase 23 (c) KMeans sweep: " + "; ".join(
        f"mesh {r['mesh']}: {r['fit_s']:.3f} s, {r['iterations']} iterations, "
        f"{r['dispatches']:.0f} dispatches, {r['bytes']:.0f} wire bytes, "
        f"centers {r['max_center_diff']:.3g} from mesh 1's"
        for r in k["sweep"]) + f" [{card}]")
    log(f"phase 23 (d) ALS chaos at [cuda:0] x {P23_CHAOS_SHARDS}: resizes "
        f"{c['resizes']}, gauge {c['mesh_devices_after']}, RMSE "
        f"{c['rmse']:.5f} (unfaulted {c['rmse_unfaulted']:.5f}), domain "
        f"failed {c['domain_failed']}, tenant strikes {c['tenant_strikes']}, "
        f"{c['fit_s']:.3f} s [{card}]")
    log(f"phase 23 (e) reduced config-3 fit: mesh 1 {t['fit_s'][1]:.3f} s, "
        f"[cuda:0] x {P23_FIT_SHARDS} {t['fit_s'][P23_FIT_SHARDS]:.3f} s "
        f"({t['shard_rows']} rows a shard); tree_hist launches "
        f"{t['tree_hist_launches']}; forests equal node for node "
        f"{t['forests_equal']} ({t['splits']} splits), held-out predictions "
        f"equal {t['predictions_equal']} ({t['forest_traversal_launches']} "
        f"forest_traversal launches); device quantile edges "
        f"{t['edges_not_bitwise']} of {t['edges_cells']} cells off the host "
        f"path [{card}]")
    log(f"phase 23 (f) process groups: moments bitwise "
        f"{g['moments_bitwise']}, gloo ranks' centers {g['center_rel']} "
        f"relative from the one-process [cuda:0] x 2, rank seconds "
        f"{g['rank_seconds']} [{card}]")
    for x in p23["kernels"]:
        lib = ("" if x["library_ms"] is None else
               f", library {x['library_ms']:.4f} ms")
        log(f"phase 23 {x['name']} {x['shape']}: {x['ms']:.4f} ms a call, "
            f"{x['device_ms']:.4f} ms of device time a launch (plain "
            f"{x['plain_ms']:.4f} ms{lib}, bound {x['bound_ms']:.4f} ms by "
            f"{x['bound_by']}); {x['launches']} launches on its path, max "
            f"abs error {x['max_abs_err']} [{card}]")
    log("phase 23 " + json.dumps({
        "phase": 23, "card": card, "seconds": round(p23["seconds"], 3),
        "parts_s": p23["parts_s"],
        "serve": {x: s[x] for x in ("rows_per_s", "mesh1_vs_direct",
                                    "mesh4_vs_direct", "mesh4_prob_max_err",
                                    "mesh4_prob_rows_not_bitwise")},
        "flagship": b, "kmeans": k, "chaos": c,
        "trees": {x: t[x] for x in ("tree_hist_launches", "forests_equal",
                                    "edges_not_bitwise")},
        "groups": g}, default=str))


# -- phase 24: mesh= on the classification path -----------------------------

P24_SHARDS = 4  # the mesh of every mesh-4 leg: [cuda:0] * 4
P24_BUDGET_S = 15.0
P24_ITERS = 20  # OneVsRest's LR, the CV's LR and LinearSVC
P24_REG = 1e-4  # the train command's --reg-param default (lr, svc)
P24_CV_GRID = [{"regParam": 1e-4}, {"regParam": 1e-2}]
P24_CV_FOLDS = 2
P24_PF_BLOCKS = 4  # NaiveBayes.partial_fit's row blocks
P24_SERVE_ROWS = 1000  # one padded batch a served model: -> 1024
P24_IDF_ROWS, P24_IDF_WIDTH = 20_000, 1024
# the tolerances of tests/test_torch_mesh_classification.py, mesh 4
# against mesh 1: moments (MOMENT_TOL); the CV's best model (LANE_TOL);
# an objective evaluated at the same weights through both programs,
# within HIST_TOL of its start; predictions (SVC_AGREE).  The 20-
# iteration OneVsRest and LinearSVC fits on 199 800 rows are held by
# the last two and by their paths (the objective histories within
# P24_PATH_TOL of the start): their coefficients part along flat
# directions (the rare classes' lanes, the hinge's optimum), printed
# beside.  The hinge's predictions part on ~0.2 % of the rows between
# the two reduction orders at this size (99.9 % holds at the CPU tests'
# 600 rows): its limit is P24_SVC_AGREE
P24_MOMENT_TOL = 1e-5
P24_LANE_TOL = 5e-4
P24_OBJ_TOL = 1e-5
P24_PATH_TOL = 1e-3
P24_AGREE = 0.999
P24_SVC_AGREE = 0.99


@contextlib.contextmanager
def objectives(module, name: str):
    """Records ``(value_and_grad, result)`` of every call of the
    minimizer ``module.name`` while the block runs."""
    seen, orig = [], getattr(module, name)

    def spy(value_and_grad, x0, **kw):
        res = orig(value_and_grad, x0, **kw)
        seen.append((value_and_grad, res if hasattr(res, "x") else res[0]))
        return res

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


def p24_inputs(dev, train3: Frame) -> dict:
    """Phase 4's training rows as the slice's inputs: the 78 features
    (float32) raw and standard-scaled (withMean, fitted on the card: the
    LBFGS fits' input, as config 2's pipeline gives it), the 15 label
    ids, the benign/attack label, the features in 32 quantile bins
    (binned on the card), and a ``[20 000, 1 024]`` hashed count matrix
    of the first rows' (feature, bin) tokens."""
    X = np.stack([np.asarray(train3[c], np.float32)
                  for c in CICIDS2017_FEATURES], axis=1)
    scaler = StandardScaler(device=dev, withMean=True, inputCol="x",
                            outputCol="s").fit(Frame({"x": X}))
    Xs = np.ascontiguousarray(to_host(scaler.transform(Frame({"x": X}))[
        "s"]), np.float32)
    y = np.asarray(StringIndexer(inputCol="Label", outputCol="label").fit(
        train3).transform(train3)["label"], np.float64)
    yb = (np.asarray(train3["Label"]).astype(str) != "BENIGN").astype(
        np.float64)
    binned = bin_features(
        torch.from_numpy(X).to(dev),
        torch.from_numpy(quantile_bin_edges(X, BINS)).to(dev)).cpu().numpy()
    tokens = (np.arange(X.shape[1])[None, :] * BINS
              + binned[:P24_IDF_ROWS].astype(np.int64))
    bucket = (tokens * 2654435761) % P24_IDF_WIDTH  # Knuth's hash
    counts = np.zeros((P24_IDF_ROWS, P24_IDF_WIDTH), np.float32)
    np.add.at(counts, (np.arange(P24_IDF_ROWS)[:, None], bucket), 1.0)
    return {"X": X, "Xs": Xs, "y": y, "yb": yb,
            "binned": binned.astype(np.float32), "counts": counts}


def _p24_lr(models) -> np.ndarray:
    return np.concatenate([np.concatenate([m.coefficientMatrix.ravel(),
                                           m.interceptVector])
                           for m in models])


def _p24_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def p24_fits(dev, inp: dict, mesh, tag: str, secs: dict) -> dict:
    """(a)-(d) at one mesh: gaussian NaiveBayes fit and its partial_fit
    over ``P24_PF_BLOCKS`` row blocks on the raw features, then on the
    scaled ones OneVsRest over LR (15 lanes), CrossValidator over LR
    (fold x grid lanes), the binary LinearSVC; each result and its
    seconds (``secs[tag]``), the lanes' and the hinge's objectives."""
    y, yb = inp["y"], inp["yb"]
    f = Frame({"features": inp["X"], "label": y})
    fs = Frame({"features": inp["Xs"], "label": y})
    out, s = {}, secs.setdefault(tag, {})

    def leg(name, fn):
        out[name], s[name] = timed(fn)

    leg("nb", lambda: NaiveBayes(device=dev, mesh=mesh,
                                 modelType="gaussian").fit(f))

    def nb_partial():
        est, state = NaiveBayes(device=dev, mesh=mesh,
                                modelType="gaussian"), None
        per = -(-f.num_rows // P24_PF_BLOCKS)
        for i in range(P24_PF_BLOCKS):
            m, state = est.partial_fit(f.slice(i * per, (i + 1) * per),
                                       state, n_classes=int(y.max()) + 1)
        return m

    leg("nb_partial", nb_partial)
    with objectives(lr_module, "minimize_lbfgs_lanes") as lanes:
        leg("ovr_lr", lambda: OneVsRest(
            classifier=LogisticRegression(device=dev, maxIter=P24_ITERS,
                                          regParam=P24_REG),
            mesh=mesh).fit(fs))
    out["ovr_objective"] = lanes[0]
    with counted(LogisticRegression, "_fit_grid_folds") as folds:
        leg("cv", lambda: CrossValidator(
            estimator=LogisticRegression(device=dev, mesh=mesh,
                                         maxIter=P24_ITERS),
            estimatorParamMaps=P24_CV_GRID,
            evaluator=MulticlassClassificationEvaluator(
                metricName="macroF1", mesh=mesh),
            numFolds=P24_CV_FOLDS, seed=0).fit(fs))
    out["cv_fold_lane_calls"] = len(folds)
    with objectives(svc_module, "minimize_lbfgs") as hinge:
        leg("svc", lambda: LinearSVC(device=dev, mesh=mesh,
                                     maxIter=P24_ITERS,
                                     regParam=P24_REG).fit(
            Frame({"features": inp["Xs"], "label": yb})))
    out["svc_objective"] = hinge[0]
    return out


def p24_stats(dev, inp: dict, mesh, tag: str, secs: dict) -> dict:
    """(f) and (g) at one mesh, each with the launch counts set to 0
    just before it: UnivariateFeatureSelector (χ² on 32 bins, ANOVA),
    VarianceThresholdSelector, MaxAbsScaler, ChiSquareTest on the binned
    features, Correlation, the Summarizer, IDF on the count matrix."""
    X, y = inp["X"], inp["y"]
    f = Frame({"features": X, "label": y})
    fb = Frame({"features": inp["binned"], "label": y})
    out, s, launches = {}, secs.setdefault(tag, {}), {}

    def leg(name, fn):
        reset_launches()
        out[name], s[name] = timed(fn)
        launches[name] = LAUNCHES["tree_hist"]

    leg("ufs_chi2", lambda: UnivariateFeatureSelector(
        device=dev, mesh=mesh, featureType="categorical",
        labelType="categorical", selectionThreshold=40,
        maxBins=BINS).fit(f).selected_features)
    leg("ufs_anova", lambda: UnivariateFeatureSelector(
        device=dev, mesh=mesh, featureType="continuous",
        labelType="categorical", selectionThreshold=40).fit(
            f).selected_features)
    leg("variance", lambda: VarianceThresholdSelector(
        device=dev, mesh=mesh, varianceThreshold=1.0).fit(
            f).selectedFeatures)
    leg("maxabs", lambda: MaxAbsScaler(device=dev, mesh=mesh,
                                       inputCol="features").fit(f).maxAbs)
    leg("chi_square_test", lambda: ChiSquareTest.test(
        fb, "features", "label", device=dev, mesh=mesh)["statistics"])
    leg("correlation", lambda: Correlation.corr(
        f, "features", device=dev, mesh=mesh)["pearson"])
    leg("summarizer", lambda: Summarizer.metrics(
        "mean", "variance", "min", "max", "count").summary(
            f, "features", device=dev, mesh=mesh))
    leg("idf", lambda: IDF(device=dev, mesh=mesh, inputCol="features").fit(
        Frame({"features": inp["counts"]})).docFreq)
    out["tree_hist_launches"] = launches
    return out


def p24_compare(one: dict, four: dict, st1: dict, st4: dict,
                inp: dict, fails: list) -> dict:
    """Each mesh-4 result against its mesh-1 twin."""
    gaps = {}

    def nb_arrays(m):
        return np.concatenate([m.gaussian_mu.ravel(), m.gaussian_var.ravel(),
                               m.pi])

    gaps["nb"] = _p24_rel(nb_arrays(four["nb"]), nb_arrays(one["nb"]))
    # the lanes' and the hinge's objectives at the mesh-1 solution
    # through the mesh-1 and the mesh-4 programs, apart as a share of
    # each objective's start
    for key in ("ovr", "svc"):
        (vg1, r1), (vg4, r4) = one[f"{key}_objective"], \
            four[f"{key}_objective"]
        with full_f32():
            v1, g1 = vg1(r1.x)
            v4, g4 = vg4(r1.x)
        start = r1.history[..., :1].abs()
        gaps[f"{key}_objective"] = float(((v4 - v1).abs()
                                          / start[..., 0]).max())
        gaps[f"{key}_gradient"] = float((g4 - g1).abs().max()
                                        / g1.abs().max())
        # the two fits' paths: their objective histories apart
        gaps[f"{key}_history"] = float(((r4.history - r1.history).abs()
                                        / start).max())
    gaps["nb_partial"] = _p24_rel(nb_arrays(four["nb_partial"]),
                                  nb_arrays(one["nb_partial"]))
    gaps["ovr_lr"] = _p24_rel(_p24_lr(four["ovr_lr"].models),
                              _p24_lr(one["ovr_lr"].models))
    cv1, cv4 = one["cv"], four["cv"]
    gaps["cv_best"] = _p24_rel(_p24_lr([cv4.bestModel]),
                               _p24_lr([cv1.bestModel]))
    gaps["cv_metrics"] = float(np.abs(np.subtract(cv4.avgMetrics,
                                                  cv1.avgMetrics)).max())
    s1, s4 = one["svc"], four["svc"]
    gaps["svc"] = _p24_rel(np.append(s4.coefficients, s4.intercept),
                           np.append(s1.coefficients, s1.intercept))
    fs = Frame({"features": inp["Xs"]})
    agree = {key: float(np.mean(
        to_host(four[key].transform(fs)["prediction"])
        == to_host(one[key].transform(fs)["prediction"])))
        for key in ("ovr_lr", "svc")}
    for k in ("correlation", "chi_square_test"):
        gaps[k] = _p24_rel(st4[k], st1[k])
    for c in ("mean", "variance"):
        gaps[f"summarizer_{c}"] = _p24_rel(st4["summarizer"][c],
                                           st1["summarizer"][c])
    limits = {"nb": P24_MOMENT_TOL, "nb_partial": P24_MOMENT_TOL,
              "ovr_objective": P24_OBJ_TOL, "svc_objective": P24_OBJ_TOL,
              "ovr_history": P24_PATH_TOL, "svc_history": P24_PATH_TOL,
              "cv_best": P24_LANE_TOL, "cv_metrics": 1e-3,
              "correlation": P24_MOMENT_TOL, "chi_square_test": 0.0,
              "summarizer_mean": P24_MOMENT_TOL,
              "summarizer_variance": P24_MOMENT_TOL}
    over = {k: v for k, v in gaps.items() if v > limits.get(k, np.inf)}
    equal = {k: (list(st4[k]) == list(st1[k]) if isinstance(st4[k], list)
                 else np.array_equal(st4[k], st1[k]))
             for k in ("ufs_chi2", "ufs_anova", "variance", "maxabs", "idf")}
    for c in ("min", "max", "count"):
        equal[f"summarizer_{c}"] = np.array_equal(st4["summarizer"][c],
                                                  st1["summarizer"][c])
    if over or not all(equal.values()) or agree["ovr_lr"] < P24_AGREE \
            or agree["svc"] < P24_SVC_AGREE:
        fails.append(f"phase 24: mesh 4 against mesh 1, gaps over their "
                     f"limits {over} (limits {limits}), equal {equal}, "
                     f"predictions agree {agree}")
    if one["cv_fold_lane_calls"] != 1 or four["cv_fold_lane_calls"] != 1:
        fails.append("phase 24 (c): the CrossValidator's fold lanes ran "
                     f"{one['cv_fold_lane_calls']} / "
                     f"{four['cv_fold_lane_calls']} times")
    return {"gaps": gaps, "limits": limits, "equal": equal,
            "agree": agree}


def p24_evaluate(dev, inp: dict, model, fails: list) -> dict:
    """(e): the evaluator over the OneVsRest model's training
    predictions at mesh 1 and at ``[cuda:0] * 4``: whole counts, every
    metric bitwise."""
    pred = model.transform(Frame({"features": inp["Xs"],
                                  "label": inp["y"]}))
    out, secs = {}, {}
    for n in (1, P24_SHARDS):
        mesh = card_mesh(dev, n)
        out[n], secs[n] = timed(lambda: {
            name: MulticlassClassificationEvaluator(
                metricName=name, mesh=mesh).evaluate(pred)
            for name in ("macroF1", "f1", "accuracy")})
    if out[1] != out[P24_SHARDS]:
        fails.append(f"phase 24 (e): the evaluator at mesh 1 {out[1]} and "
                     f"mesh {P24_SHARDS} {out[P24_SHARDS]}")
    return {"metrics": out[1], "equal": out[1] == out[P24_SHARDS],
            "seconds": secs}


def p24_serve(dev, inp: dict, fits: dict, fails: list) -> dict:
    """The NB and OneVsRest-LR models fitted at mesh 1 and at mesh 4,
    each served once on a ``[1 000, 78]`` float32 batch through a
    bucketed ``BatchPredictor`` (one ``pad_assemble`` launch to 1 024
    rows), launch counts from 0; the predictions of the two mesh sizes
    compared."""
    reset_launches()
    preds = {}
    for key, x in (("nb", "X"), ("ovr_lr", "Xs")):
        batch = Frame({"features": inp[x][-P24_SERVE_ROWS:]})
        for n, fit in fits.items():
            out = BatchPredictor(fit[key], bucket_rows=BUCKET_FLOOR,
                                 device=dev).predict_frame(batch)
            preds[(key, n)] = to_host(out["prediction"])
    torch.cuda.synchronize()
    launches, shapes = dict(LAUNCHES), dict(PAD_LAUNCH_SHAPES)
    agree = {key: float(np.mean(preds[(key, 1)] == preds[(key, P24_SHARDS)]))
             for key in ("nb", "ovr_lr")}
    if launches["pad_assemble"] != 4 or launches["tree_hist"] or \
            agree["nb"] != 1.0 or agree["ovr_lr"] < P24_AGREE:
        fails.append(f"phase 24 serve: launches {launches}, predictions "
                     f"agree {agree}")
    return {"launches": launches, "pad_launch_shapes": shapes,
            "agree": agree}


def phase24(dev, train3: Frame) -> dict:
    """Phase 24, in this process: the classification path, the
    selectors, MaxAbsScaler, IDF and ``stat`` at mesh 1 and at
    ``[cuda:0] * 4`` on phase 4's training rows; each mesh-4 result held
    against its mesh-1 twin, ``tree_hist`` launched once a shard and
    every shard's launch held against its plain version, the NB and
    OneVsRest-LR models served once each."""
    t0 = time.perf_counter()
    fails: list = []
    inp, inputs_s = timed(lambda: p24_inputs(dev, train3))
    secs: dict = {}
    fits, stats = {}, {}
    for n in (1, P24_SHARDS):
        mesh = card_mesh(dev, n)
        fits[n] = p24_fits(dev, inp, mesh, f"mesh{n}", secs)
        if n == 1:
            stats[n] = p24_stats(dev, inp, mesh, f"mesh{n}", secs)
        else:
            with recording_tree_hist() as calls:
                stats[n] = p24_stats(dev, inp, mesh, f"mesh{n}", secs)
    launches = {n: stats[n].pop("tree_hist_launches") for n in stats}
    for name in ("ufs_chi2", "chi_square_test"):
        if launches[1][name] != 1 or \
                launches[P24_SHARDS][name] != P24_SHARDS:
            fails.append(f"phase 24 (f) {name}: tree_hist launches "
                         f"{launches[1][name]} at mesh 1, "
                         f"{launches[P24_SHARDS][name]} at mesh "
                         f"{P24_SHARDS}")
    cmp_ = p24_compare(fits[1], fits[P24_SHARDS], stats[1],
                       stats[P24_SHARDS], inp, fails)
    evaluated = p24_evaluate(dev, inp, fits[1]["ovr_lr"], fails)
    served = p24_serve(dev, inp, fits, fails)
    # every mesh-4 launch of tree_hist against its plain version; the
    # kernels line's entry: the χ² selector's widest shard
    cases = {f"mesh-4 shard {i} of "
             f"{'the selector' if i < P24_SHARDS else 'ChiSquareTest'}": c
             for i, c in enumerate(calls)}
    err = check_tree_hist(cases)
    shard = next(iter(cases))
    kernels = measure_tree_hist(
        {f"phase 24 (f) UnivariateFeatureSelector chi2, {shard}":
         cases[shard]}, err, launches[P24_SHARDS]["ufs_chi2"])
    kernels += pads_of(dev, served["pad_launch_shapes"])
    lanes = {n: fits[n]["ovr_lr"].models[0].optimizer_stats
             for n in fits}
    for n in fits:
        for key in ("ovr_objective", "svc_objective"):
            fits[n].pop(key)
    p24 = {"seconds": time.perf_counter() - t0, "inputs_s": inputs_s,
           "parts_s": secs, "rows": int(inp["X"].shape[0]),
           "classes": int(inp["y"].max()) + 1,
           "tree_hist_launches": launches, "shard_rows": [
               int(c["binned_t"].shape[1]) for c in calls],
           "compare": cmp_, "evaluator": evaluated, "serve": served,
           "lanes": lanes,
           "cv_avg_metrics": {n: list(fits[n]["cv"].avgMetrics)
                              for n in fits}}
    PHASE_SECONDS["24 parts"] = secs
    if fails:
        log("phase 24 " + json.dumps(p24, default=str))
        raise SystemExit("phase 24 failed:\n" + "\n".join(fails))
    p24["kernels"] = kernels
    return p24


def report_phase24(p24: dict, card: str) -> None:
    """Phase 24's lines: each leg's seconds at both mesh sizes, the gaps
    against the limits, the launches, one JSON line.  The mesh-4
    seconds are the virtual shards' overhead on one card, not a
    scaling."""
    c, s = p24["compare"], p24["parts_s"]
    log(f"phase 24 (a)-(d) fits on {p24['rows']} rows, {p24['classes']} "
        f"classes, seconds at mesh 1 {s['mesh1']} and [cuda:0] x "
        f"{P24_SHARDS} {s[f'mesh{P24_SHARDS}']}; mesh 4 against mesh 1: "
        f"gaps {c['gaps']} (limits {c['limits']}), equal {c['equal']}, "
        f"predictions agree {c['agree']}; the OneVsRest "
        f"lanes' loop {p24['lanes']}; CV avgMetrics "
        f"{p24['cv_avg_metrics']} [{card}]")
    log(f"phase 24 (e) evaluator {p24['evaluator']['metrics']}, bitwise at "
        f"mesh {P24_SHARDS} {p24['evaluator']['equal']}, seconds "
        f"{p24['evaluator']['seconds']} [{card}]")
    log(f"phase 24 (f) tree_hist launches {p24['tree_hist_launches']}, "
        f"shard rows {p24['shard_rows']}; serve: launches "
        f"{p24['serve']['launches']}, pads "
        f"{p24['serve']['pad_launch_shapes']}, predictions agree "
        f"{p24['serve']['agree']} [{card}]")
    for x in p24["kernels"]:
        lib = ("" if x["library_ms"] is None else
               f", library {x['library_ms']:.4f} ms")
        log(f"phase 24 {x['name']} {x['shape']}: {x['ms']:.4f} ms a call, "
            f"{x['device_ms']:.4f} ms of device time a launch (plain "
            f"{x['plain_ms']:.4f} ms{lib}, bound {x['bound_ms']:.4f} ms by "
            f"{x['bound_by']}); {x['launches']} launches on its path, max "
            f"abs error {x['max_abs_err']} [{card}]")
    log("phase 24 " + json.dumps({
        "phase": 24, "card": card, "seconds": round(p24["seconds"], 3),
        "budget_s": P24_BUDGET_S,
        "within_budget": p24["seconds"] <= P24_BUDGET_S,
        "inputs_s": round(p24["inputs_s"], 3), "parts_s": p24["parts_s"],
        "gaps": c["gaps"], "tree_hist_launches": p24["tree_hist_launches"],
        "serve_launches": p24["serve"]["launches"]}, default=str))


# -- phase 25: mesh= on the regression fits and the families -----------------

P25_SHARDS = 4  # the mesh of every mesh-4 leg: [cuda:0] * 4
P25_BUDGET_S = 20.0
P25_SERVE_ROWS = 1000  # one padded batch a served model: -> 1024
#: the families' mesh-4 legs, by phase 20's names.  BisectingKMeans on
#: the lognormal rows (3.5 s at mesh 4 alone, 2.9 s in the whole run;
#: there it holds only its cost) is left out: the whole smoke took 1 140
#: s of its 1 200 on a slow host (NVIDIA H100 80GB HBM3, 700.00 W)
P25_FAMILIES = ("gaussian_mixture", "bisecting_kmeans_blobs", "lda", "pic")
# Mesh 4 against mesh 1 at the card-against-CPU limits of phases 20 and
# 21 (P21_NORMAL_TOL, P21_HISTORY_TOL, P21_GLM_RTOL, P21_DEVIANCE_RTOL;
# FAM_GMM_TOL, FAM_KM_RTOL, FAM_BISECT_COST_RTOL, FAM_PERPLEXITY_RTOL,
# FAM_E_STEP_RTOL, FAM_PIC_TOL): the shards' sums in shard order are
# another summation order of the same float32 terms, as the CPU's are.
# The IRLS stop counts are printed, not held (float32 noise at the stop
# test).


def p25_twins(dev, frames: dict, data: dict, p21: dict, p20: dict,
              secs: dict) -> tuple:
    """The mesh-1 twins: phase 21's and phase 20's card fits of the same
    inputs where the run made them (mesh 1 is their path, bitwise), else
    fitted here, each with its seconds."""
    regs, fams = {}, {}
    s = secs.setdefault("mesh1", {})
    for name in P21_FITS:
        if name in p21.get("models", {}):
            regs[name], s[name] = p21["models"][name], p21["seconds"][name]
        else:
            regs[name], s[name] = timed(
                lambda: p21_fit(name, dev, frames, card_mesh(dev, 1)))
    for name in P25_FAMILIES:
        if name in p20.get("models", {}):
            fams[name], s[name] = p20["models"][name], p20["seconds"][name]
        else:
            (fams[name], _), s[name] = timed(
                lambda: fam_fit(name, dev, data, card_mesh(dev, 1)))
    return regs, fams


def p25_fits(dev, frames: dict, data: dict, secs: dict) -> tuple:
    """Every leg at ``[cuda:0] * 4``, timed."""
    mesh, s = card_mesh(dev, P25_SHARDS), secs.setdefault(
        f"mesh{P25_SHARDS}", {})
    regs, fams = {}, {}
    for name in P21_FITS:
        regs[name], s[name] = timed(lambda: p21_fit(name, dev, frames, mesh))
    for name in P25_FAMILIES:
        (fams[name], _), s[name] = timed(
            lambda: fam_fit(name, dev, data, mesh))
    return regs, fams


def p25_compare_regression(frames: dict, one: dict, four: dict,
                           fails: list) -> dict:
    """(a): each mesh-4 regression fit against its mesh-1 twin."""
    res = {}
    for name in P21_FITS:
        m1, m4 = one[name], four[name]
        r = res[name] = {"iterations": [m4.summary.totalIterations,
                                        m1.summary.totalIterations]}
        if name == "lr_normal":
            X, y = frames["lr"]["features"], frames["lr"]["label"]
            r["prediction_gap"] = float(np.abs(m4.predict(X) - m1.predict(X))
                                        .max() / np.std(y))
            ok = r["prediction_gap"] <= P21_NORMAL_TOL
        elif name in P21_GLMS:
            coef = np.append(m4.coefficients, m4.intercept)
            r["coef_rel"] = fam_rel(coef, np.append(m1.coefficients,
                                                    m1.intercept))
            r["deviance_rel"] = abs(m4.summary.deviance / m1.summary.deviance
                                    - 1.0)
            ok = (np.isfinite(coef).all()
                  and r["coef_rel"] <= P21_GLM_RTOL[name]
                  and r["deviance_rel"] <= P21_DEVIANCE_RTOL)
        else:
            g = fit_gaps(m4, m1)
            r["history_gap"] = max(g["max_gap"], g["end_gap"])
            ok = (r["iterations"][0] == r["iterations"][1]
                  and r["history_gap"] <= P21_HISTORY_TOL[name])
        if not ok:
            fails.append(f"phase 25 (a) {name}: mesh {P25_SHARDS} is not "
                         f"mesh 1: {r}")
    return res


def p25_compare_families(dev, data: dict, one: dict, four: dict,
                         fails: list) -> dict:
    """(b): each mesh-4 family fit against its mesh-1 twin; LDA's E-step
    fed one γ₀ at both sizes."""
    res = {}
    Xg = data["gmm"]["features"]
    g1, g4 = one["gaussian_mixture"], four["gaussian_mixture"]
    p1, p4 = g1.predictProbability(Xg), g4.predictProbability(Xg)
    top2 = np.sort(p1, axis=1)[:, -2:]
    ties = (top2[:, 1] - top2[:, 0]) <= FAM_GMM_TOL
    r = res["gaussian_mixture"] = {
        "iterations": [g4.summary.totalIterations,
                       g1.summary.totalIterations],
        "abs_gap": float(max(np.abs(g4.means - g1.means).max(),
                             np.abs(g4.covs - g1.covs).max(),
                             np.abs(g4.weights - g1.weights).max(),
                             abs(g4.summary.logLikelihood
                                 - g1.summary.logLikelihood))),
        "rows_differing": int((p4.argmax(1) != p1.argmax(1)).sum())}
    if (r["abs_gap"] > FAM_GMM_TOL or r["iterations"][0] != r["iterations"][1]
            or ((p4.argmax(1) != p1.argmax(1)) & ~ties).any()):
        fails.append(f"phase 25 (b) GaussianMixture: {r}")
    b1, b4 = one["bisecting_kmeans_blobs"], four["bisecting_kmeans_blobs"]
    same = (np.array_equal(b4._left, b1._left)
            and np.array_equal(b4._right, b1._right))
    r = res["bisecting_kmeans_blobs"] = {
        "same_tree": same,
        "centers_rel": (fam_rel(b4.clusterCenters, b1.clusterCenters)
                        if same else None),
        "cost_rel": abs(b4.summary.trainingCost
                        / b1.summary.trainingCost - 1.0)}
    if not (same and r["centers_rel"] <= FAM_KM_RTOL
            and r["cost_rel"] <= FAM_KM_RTOL):
        fails.append(f"phase 25 (b) BisectingKMeans: {r}")
    l1, l4 = one["lda"], four["lda"]
    Xl = data["lda"]["features"]
    perp = [l4.logPerplexity(data["lda"]), l1.logPerplexity(data["lda"])]
    eeb = torch.from_numpy(np.exp(psi(l1.lam) - psi(
        l1.lam.sum(axis=1, keepdims=True))).astype(np.float32)).to(dev)
    g0 = gamma0(FAM_SEED, (0,), Xl.shape[0], l1.lam.shape[0])
    ga, sa, ua, _ = e_step(torch.from_numpy(Xl).to(dev), eeb, l1.alpha,
                           torch.from_numpy(g0).to(dev))
    xs, gs, wm = shard_batch(card_mesh(dev, P25_SHARDS), Xl, g0)
    gb, sb, ub, _ = e_step(xs, eeb, l1.alpha, gs, wm=wm)
    r = res["lda"] = {
        "log_perplexity": perp,
        "e_step_gamma_rel": fam_rel(gb.numpy()[:len(Xl)], ga.cpu().numpy()),
        "e_step_stat_rel": fam_rel(sb.cpu().numpy(), sa.cpu().numpy()),
        "e_step_updates": [ub, ua]}
    if (abs(perp[0] / perp[1] - 1.0) > FAM_PERPLEXITY_RTOL
            or r["e_step_gamma_rel"] > FAM_E_STEP_RTOL
            or r["e_step_stat_rel"] > FAM_E_STEP_RTOL or ua != ub):
        fails.append(f"phase 25 (b) LDA: {r}")
    c1 = np.asarray(one["pic"].clusters["cluster"])
    c4 = np.asarray(four["pic"].clusters["cluster"])
    r = res["pic"] = {
        "v_rel": fam_rel(four["pic"].fit_stats["embedding"],
                         one["pic"].fit_stats["embedding"]),
        "steps": [four["pic"].fit_stats["power_steps"],
                  one["pic"].fit_stats["power_steps"]],
        "assignments_equal": bool(np.array_equal(c4, c1))}
    if (r["v_rel"] > FAM_PIC_TOL or r["steps"][0] != r["steps"][1]
            or not r["assignments_equal"]):
        fails.append(f"phase 25 (b) PIC: {r}")
    return res


def p25_serve(dev, frames: dict, data: dict, one: tuple, four: tuple,
              fails: list) -> dict:
    """(c): the LinearRegression (normal) and GaussianMixture models of
    both sizes, each served once on a ``[1 000, C]`` float32 batch
    through a bucketed ``BatchPredictor`` (one ``pad_assemble`` launch to
    1 024 rows), launch counts from 0; the two sizes' predictions
    compared."""
    batches = {"lr_normal": frames["lr"]["features"][-P25_SERVE_ROWS:],
               "gaussian_mixture": data["gmm"]["features"][-P25_SERVE_ROWS:]}
    models = {1: {"lr_normal": one[0]["lr_normal"],
                  "gaussian_mixture": one[1]["gaussian_mixture"]},
              P25_SHARDS: {"lr_normal": four[0]["lr_normal"],
                           "gaussian_mixture": four[1]["gaussian_mixture"]}}
    reset_launches()
    preds = {}
    for key, x in batches.items():
        for n, fit in models.items():
            out = BatchPredictor(fit[key], bucket_rows=BUCKET_FLOOR,
                                 device=dev).predict_frame(
                Frame({"features": x}))
            preds[(key, n)] = np.asarray(to_host(out["prediction"]),
                                         np.float64)
    torch.cuda.synchronize()
    launches, shapes = dict(LAUNCHES), dict(PAD_LAUNCH_SHAPES)
    y = frames["lr"]["label"]
    gaps = {"lr_normal": float(np.abs(preds[("lr_normal", P25_SHARDS)]
                                      - preds[("lr_normal", 1)]).max()
                               / np.std(y)),
            "gaussian_mixture_rows_differing": int(
                (preds[("gaussian_mixture", P25_SHARDS)]
                 != preds[("gaussian_mixture", 1)]).sum())}
    if launches["pad_assemble"] != 4 or launches["tree_hist"] or \
            launches["forest_traversal"] or \
            gaps["lr_normal"] > P21_NORMAL_TOL or \
            gaps["gaussian_mixture_rows_differing"]:
        fails.append(f"phase 25 (c) serve: launches {launches}, gaps {gaps}")
    return {"launches": launches, "pad_launch_shapes": shapes, "gaps": gaps}


def phase25(dev, p20: dict = None, p21: dict = None) -> dict:
    """Phase 25, in this process: the regression fits on phase 21's
    inputs and the families on phase 20's at ``[cuda:0] * 4``, each held
    against its mesh-1 twin (phases 21's and 20's card fits where the run
    made them: ``p21`` / ``p20``, their handoffs), and the mesh-4
    LinearRegression and GaussianMixture served once each."""
    t0 = time.perf_counter()
    fails: list = []
    p20, p21 = p20 or {}, p21 or {}
    (frames, data), inputs_s = timed(lambda: (
        p21.get("frames") or p21_reg_inputs(),
        p20.get("data") or fam_data()))
    secs: dict = {}
    one = p25_twins(dev, frames, data, p21, p20, secs)
    four = p25_fits(dev, frames, data, secs)
    cmp_ = {"regression": p25_compare_regression(frames, one[0], four[0],
                                                  fails),
            "families": p25_compare_families(dev, data, one[1], four[1],
                                             fails)}
    served = p25_serve(dev, frames, data, one, four, fails)
    mesh_s = sum(secs[f"mesh{P25_SHARDS}"].values())
    p25 = {"seconds": time.perf_counter() - t0, "inputs_s": inputs_s,
           "parts_s": secs, "mesh4_fit_s": mesh_s,
           "twins_from_run": {"phase 21": bool(p21), "phase 20": bool(p20)},
           "compare": cmp_, "serve": served}
    PHASE_SECONDS["25 parts"] = secs
    if fails:
        log("phase 25 " + json.dumps(p25, default=str))
        raise SystemExit("phase 25 failed:\n" + "\n".join(fails))
    p25["kernels"] = pads_of(dev, served["pad_launch_shapes"])
    return p25


def report_phase25(p25: dict, card: str) -> None:
    """Phase 25's lines: each leg's seconds at both sizes, the gaps, the
    serve's launches, ``pad_assemble``'s entries, one JSON line.  The
    mesh-4 seconds are the virtual shards' overhead on one card, not a
    scaling."""
    c, s = p25["compare"], p25["parts_s"]
    log(f"phase 25 seconds at mesh 1 {s['mesh1']} and [cuda:0] x "
        f"{P25_SHARDS} {s[f'mesh{P25_SHARDS}']} (mesh-1 twins from the run: "
        f"{p25['twins_from_run']}) [{card}]")
    log(f"phase 25 (a) regression fits, mesh {P25_SHARDS} against mesh 1: "
        f"{c['regression']} (limits: normal {P21_NORMAL_TOL}, histories "
        f"{P21_HISTORY_TOL}, GLM coefficients {P21_GLM_RTOL}, deviance "
        f"{P21_DEVIANCE_RTOL}; IRLS stop counts printed, not held) [{card}]")
    log(f"phase 25 (b) families, mesh {P25_SHARDS} against mesh 1: "
        f"{c['families']} (limits: GMM {FAM_GMM_TOL}, blobs {FAM_KM_RTOL}, "
        f"perplexity {FAM_PERPLEXITY_RTOL}, E-step {FAM_E_STEP_RTOL}, PIC "
        f"{FAM_PIC_TOL}) [{card}]")
    log(f"phase 25 (c) serve: launches {p25['serve']['launches']}, pads "
        f"{p25['serve']['pad_launch_shapes']}, gaps {p25['serve']['gaps']} "
        f"[{card}]")
    for x in p25["kernels"]:
        log(f"phase 25 {x['name']} {x['shape']}: {x['ms']:.4f} ms a call, "
            f"{x['device_ms']:.4f} ms of device time a launch (plain "
            f"{x['plain_ms']:.4f} ms, library {x['library_ms']:.4f} ms, "
            f"bound {x['bound_ms']:.4f} ms by {x['bound_by']}); "
            f"{x['launches']} launches on its path, max abs error "
            f"{x['max_abs_err']} [{card}]")
    log("phase 25 " + json.dumps({
        "phase": 25, "card": card, "seconds": round(p25["seconds"], 3),
        "budget_s": P25_BUDGET_S,
        "within_budget": p25["seconds"] <= P25_BUDGET_S,
        "mesh4_fit_s": round(p25["mesh4_fit_s"], 3),
        "inputs_s": round(p25["inputs_s"], 3), "parts_s": p25["parts_s"],
        "serve_launches": p25["serve"]["launches"]}, default=str))


#: side process name -> (its handle in the run, its main)
SIDES = {"cpu_fits": (CpuFits, cpu_fits_main),
         "family_fits": (FamilyFits, family_fits_main),
         "p21_fits": (P21Fits, p21_fits_main),
         "p22_fits": (P22Fits, p22_fits_main)}

PHASES = ("2", "3", "11", "12", "13", "14", "15", "16", "17", "18", "19",
          "20", "21", "22", "23", "24", "25")


#: the compiled bytecode of every Python process the run starts
PYCACHE = os.path.join(REPO, "sntc_tpu_torch", "_build", "pycache")


def cache_bytecode() -> None:
    """Keep the bytecode every process of the run compiles under
    :data:`PYCACHE` (inside the checkout), for this process and each
    one it starts.  An environment with ``PYTHONDONTWRITEBYTECODE`` and
    packages installed without their ``__pycache__`` otherwise compiles
    torch's sources afresh in every process (~3 s of a serving
    process's start on an H100 host)."""
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
    sys.dont_write_bytecode = False
    sys.pycache_prefix = PYCACHE


def main() -> int:
    cache_bytecode()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--verbose-build", action="store_true",
                    help="show the compiler's output (registers, spills)")
    ap.add_argument("--out-json", default=None,
                   help="also write every number of the run to this file")
    ap.add_argument("--phases", default=None,
                    help="run only these phases, comma-separated, of "
                    f"{', '.join(PHASES)} (11-13 serve phase 3's model, "
                    "15 trains config 1 first, 18 and 19 config 9's LR "
                    "pipeline, 20 generates config 3's rows, 21 config 3's "
                    "and config 4's, 22 config 1's, 23 and 24 config "
                    "3's, 25 phase 20's and 21's inputs, and fits their "
                    "mesh-1 twins unless 20 and 21 run too); "
                    "default: every phase")
    # a CPU side process (``SIDES``), which the run starts itself
    ap.add_argument("--side", nargs=2, default=None, metavar=("NAME", "DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        name, out = args.side
        return SIDES[name][1](out)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = gpu_line()
    log(f"card: {card}")
    log(f"host: {os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} "
        "usable by this process")
    # the kernels build (nvcc processes) beside the first data set's
    # generation on the host
    build_pool = ThreadPoolExecutor(1)
    built = build_pool.submit(_build.library, args.verbose_build)
    phases = args.phases.split(",") if args.phases else list(PHASES)
    # the CPU sides of phases 4 and 6, 20 and 21 run in processes of
    # their own beside the card's work: phases 4's and 6's from the
    # start, 20's and 21's after phase 12 (at once under --phases)
    with tempfile.TemporaryDirectory(prefix="sntc_chip_smoke_") as cpu_dir:
        sides = {}

        def start(*names):
            for name in names:
                out = os.path.join(cpu_dir, name)
                os.makedirs(out)
                sides[name] = SIDES[name][0](out)

        try:
            if args.phases:
                start(*(name for name, p in (("family_fits", "20"),
                                             ("p21_fits", "21"),
                                             ("p22_fits", "22"))
                        if p in phases))
                with clock("1 build"):
                    built.result()
                return main_phases(dev, card, phases, sides)
            start("cpu_fits")
            return main_all(dev, card, args, built, build_pool, sides,
                            start)
        finally:
            for side in sides.values():
                side.close()


def main_all(dev, card: str, args, built, build_pool, sides: dict,
             start) -> int:
    """Every phase, in the order that keeps the card busy; ``start(name,
    ...)`` starts a side process into ``sides``."""
    with tempfile.TemporaryDirectory(prefix="sntc_chip_smoke_") as work:
        with clock("4 data"):
            data = fit_data(work)
        with clock("1 build"):
            built.result()
        build_pool.shutdown()
        log(f"kernels built via {_build.BUILD_INFO['route']} in "
            f"{_build.BUILD_INFO['seconds']:.1f} s [{card}]")
        with clock("2 kernels"):
            errs = check_kernels(dev)
            cases = hist_cases(data["train"], dev)
            errs["tree_hist"] = check_tree_hist(cases)
        with clock("3 serve"):
            summary, served = serve(dev, work)
        with clock("8 forms"):
            forms = serve_forms(dev, work)
            split8 = dispatch_split(dev, [os.path.join(work, "in8", f)
                                          for f in ("part_0000.csv",
                                                    "part_0001.csv")],
                                    admit=False)
        # phases 12's and 13's inputs are generated and written in a
        # thread, each beside the phase before its own (whose main
        # thread mostly waits on serving processes)
        gen = ThreadPoolExecutor(1)
        inputs12 = gen.submit(dp_streams, work)
        with clock("11 failures"):
            failures = failure_paths(dev, work)
        inputs13 = gen.submit(st_streams, work)
        with clock("12 data plane"):
            phase12 = data_plane(dev, work, inputs12)
        gen.shutdown()
        # phases 20's and 21's CPU sides (~1.5 min each) start once the
        # serve phases that load the host most (3, 8, 12) are done, and
        # end long before phase 20 needs them
        start("family_fits", "p21_fits", "p22_fits")
        with clock("13 self-tuning"):
            phase13 = self_tuning(dev, work, inputs13)
        with clock("14 lifecycle"):
            phase14 = lifecycle(dev, work)
        with clock("5 breakdown"):
            stages = breakdown(dev, work)
        with clock("4+6 train commands"):
            data4 = gbt_data(work)
            # the two train processes start together
            trained, trained4 = together((train, dev, data, work),
                                         (train_gbt, dev, data4, work))
        with clock("6 config 4"):
            served4 = serve_gbt(dev, data4, trained4, work)
    cpu_fits = sides["cpu_fits"]
    with clock("4 reduced fit"):
        reduced = reduced_fit(data, dev, cpu_fits)
    with clock("6 config 4"):
        reduced4 = reduced_gbt_fit(data4, dev, cpu_fits)
        tree = dt_fit(data4, dev, cpu_fits)
    with clock("5 fit profiles"):
        # config 3's profiled fit first: after a long profile in a
        # process, later profiler windows may drop launches (config 4
        # counts on none)
        fit = fit_breakdown(data, dev)
        own = fit.pop("cases")
        errs["tree_hist"] = max(errs["tree_hist"], check_tree_hist(own))
        fit4 = gbt_fit_breakdown(data4, dev)
        own4 = fit4.pop("cases")
        check_per_tree_forms(own4)
        errs["tree_hist"] = max(errs["tree_hist"], check_tree_hist(own4))
    with clock("5 kernel times"):
        walks = measure_forest(dev, served, errs["forest_traversal"],
                               summary["kernel_launches"]["forest_traversal"])
        walks += measure_forest_gbt(dev, data4, trained4, served4, {
            "fit": trained4["kernel_launches"]["forest_traversal"],
            "serve": served4["summary"]["kernel_launches"][
                "forest_traversal"]})
        kernels = [next(k for k in walks if k["rows"] == max(FOREST_ROWS))]
        pads = measure_pad(dev, summary["pad_launch_shapes"])
        kernels.append(pads[0])
        timed = {k: cases[k] for k in ("widest level group", "chisq")}
        hist = measure_tree_hist({**timed, **own}, errs["tree_hist"],
                                 trained["kernel_launches"]["tree_hist"])
        hist += measure_tree_hist(own4, errs["tree_hist"],
                                  trained4["kernel_launches"]["tree_hist"])
        kernels.append(hist[0])

    with tempfile.TemporaryDirectory(prefix="sntc_chip_smoke_") as work:
        with clock("7 configs 2 and 1"):
            # each train process starts once its data is written: config
            # 1's beside config 2's data, then config 2's and phase 9's
            # two (nb, svc on config 2's flows) together
            pool = ThreadPoolExecutor(4)
            data1 = lbfgs_data(work, LR_ROWS, binary=True, tag="1")
            job1 = pool.submit(train_lbfgs, dev, data1, work, [
                "--estimator", "lr", "--binary", "--reg-param", str(LR_REG)])
            data2 = lbfgs_data(work, MLP_ROWS, binary=False, tag="2")
            job2 = pool.submit(train_lbfgs, dev, data2, work, [])
            jobs9 = {est: pool.submit(train_estimator, dev, data2, est, work)
                     for est in ("nb", "svc")}
            # phase 9's tree regressors fit on the card while the four
            # train processes run
            regs = fit_regressors(dev, data4)
            trained2, trained1 = job2.result(), job1.result()
            check_config2(trained2)
            check_config1(dev, data1, trained1)
            # the staged and default config-2 serves on the card, in the
            # commands and in this process alike: the host-serve
            # crossover is pinned off, as bench config 6 pins it (one
            # more default serve leaves it unset: serve_mlp_rule)
            with environ(SNTC_SERVE_HOST_ROWS=0):
                served2 = serve_mlp(dev, data2, trained2, work)
            reduced_lbfgs = reduced_lbfgs_fits(dev, data2, data1, work)
        with clock("9 nb, svc, evaluate"):
            trained9 = {est: job.result() for est, job in jobs9.items()}
            pool.shutdown()
            nb_check = check_nb_card_vs_cpu(dev, data2, trained9["nb"])
            served9 = serve_nb_svc(dev, data2, trained9, work)
            evaluated9 = evaluate_commands(dev, data2, trained9, work)
        with clock("15 fused serve"):
            phase15 = fused_serve(dev, data1, trained1, work)
        with clock("16 live capture"):
            phase16 = live_capture(dev, work)
        with clock("17 multi-tenant"):
            phase17 = multi_tenant(dev, work)
        shared = phase17.pop("shared")
        with clock("18 replication"):
            phase18 = replication(dev, work, shared)
        with clock("19 fleet"):
            phase19 = fleet_serving(dev, work, shared)
    with clock("7 configs 2 and 1"):
        fit2 = mlp_fit_profile(dev, data2)
    with clock("9 nb, svc, evaluate"):
        new9 = measure_phase9(dev, regs, served9)
    kernels += new9
    with tempfile.TemporaryDirectory(prefix="sntc_chip_smoke_") as work:
        with clock("10 lanes"):
            phase10 = lane_fits(dev, data2, data1, work)
    with clock("14 lifecycle"):
        phase14["lr"] = lr_partial_fit(dev, data1)
    with clock("20 families"):
        phase20 = families(dev, data["train"], sides["family_fits"])
    with tempfile.TemporaryDirectory(prefix="sntc_chip_smoke_") as work:
        with clock("21 feature stages, fits"):
            phase21_ = phase21(dev, work, sides["p21_fits"],
                               (data["train"], data["test"]), data4["train"])
    with clock("22 object columns, long tail"):
        phase22_ = phase22(dev, data1, sides["p22_fits"])
    with tempfile.TemporaryDirectory(prefix="sntc_chip_smoke_") as work:
        with clock("23 mesh substrate"):
            phase23_ = phase23(dev, work, data["train"])
    with clock("24 mesh classification"):
        phase24_ = phase24(dev, data["train"])
    with clock("25 mesh regression, families"):
        phase25_ = phase25(dev, phase20.pop("handoff"),
                           phase21_.pop("handoff"))
    kernels.append(phase10["pad"])
    kernels += phase12["pads"]
    kernels += phase13["pads"]
    kernels += phase14["kernels"]
    kernels += phase15["kernels"]
    kernels += phase16["kernels"]
    kernels += phase17["kernels"]
    kernels += phase18["kernels"]
    kernels += phase19["kernels"]
    kernels += phase20["kernels"]
    kernels += phase21_["kernels"]
    kernels += phase23_["kernels"]
    kernels += phase24_["kernels"]
    kernels += phase25_["kernels"]

    rows_per_s = summary["rows"] / summary["seconds"]
    log(f"serve throughput: {rows_per_s:.0f} rows/s over {summary['rows']} "
        f"rows, batches {BATCHES}, bucket floor {BUCKET_FLOOR} [{card}]")
    for p in summary["progress"]:
        log(f"  batch {p['batchId']}: {p['numInputRows']} rows in "
            f"{p['durationMs']:.2f} ms [{card}]")
    for x in forms:
        s = x["summary"]
        log(f"phase 8, {x['form']} form, run {x['run']}: "
            f"{x['rows_per_s']:.0f} rows/s without the first batch "
            f"({s['rows']} rows in {s['seconds']:.3f} s in all); mean read "
            f"{x['read_ms']:.2f} ms, predict {x['predict_ms']:.2f} ms "
            f"(dispatch {x['dispatch_ms']:.2f}, finalize "
            f"{x['finalize_ms']:.2f}), sink {x['sink_ms']:.2f} ms a batch; "
            "first batch: read "
            f"{s['progress'][0]['readMs']:.1f}, predict "
            f"{s['progress'][0]['predictMs']:.1f} ms; prefetch "
            f"{s['pipeline_stats'].get('prefetch')}, delivery busy "
            f"{s['pipeline_stats']['delivery_busy_s']} s, transfers "
            f"{s['pipeline_stats']['transfers']}, fusion {s['fusion']}, "
            f"launches {s['kernel_launches']} [{card}]")
    for tag, x in (("phase 8", split8), ("phase 12", phase12["split"])):
        log(f"{tag} pad_assemble split, in process, of a {x['block']} "
            "batch (ms, min / median / max): column-major pack "
            f"{_mmm(x['pack_column_major_ms'])} (row-major, as before the "
            f"redesign: {_mmm(x['pack_row_major_ms'])}), upload "
            f"{_mmm(x['upload_ms'])} ({x['upload_bytes']} B), launch "
            f"{x['launch_column_major_device_ms']:.4f} device ms "
            f"(row-major {x['launch_row_major_device_ms']:.4f}), the whole "
            f"call {_mmm(x['call_ms'])}; measured in {x['seconds']:.1f} s "
            f"[{card}]")
    for b in stages:
        log(f"breakdown of a {b['rows']}-row batch: read {b['read_ms']:.2f} "
            f"ms, predict {b['predict_ms']:.2f} ms (device busy "
            f"{b['device_ms']} ms, idle share {b['device_idle_share']}), "
            f"sink {b['sink_ms']:.2f} ms; top device ops "
            f"{b['top_device_ops_ms']} [{card}]")
    log(f"fit ({trained['train_rows']} rows, {TREES} trees, depth {DEPTH}): "
        f"train command {trained['fit_wall_clock_s']} s; in this process "
        f"{fit['staged_fit_ms']:.1f} ms by stage {fit['stages_ms']}, "
        f"{fit['profiled_fit_ms']:.1f} ms under the profiler with device "
        f"busy {fit['device_ms']:.1f} ms (idle share "
        f"{fit['device_idle_share']:.3f}); top device ops "
        f"{fit['top_device_ops_ms']} [{card}]")
    for x in fit["tree_hist_launches"]:
        log(f"  tree_hist launch {x['launch']}: level {x['level']}, "
            f"{x['group_nodes']} nodes in the group ({x['hist_nodes']} "
            f"histogrammed), [{x['F']}, {x['N']}] T={x['T']}: "
            f"{x['device_ms']:.4f} ms ({_profiled(x)} by the profiler); "
            f"{_plan(x)} [{card}]")
    log(f"tree_hist in the profiled fit: {len(fit['tree_hist_launches'])} "
        f"launches, {fit['tree_hist_ms']:.4f} ms of device time, "
        f"{fit['tree_hist_seen_by_profiler']} seen by the profiler [{card}]")
    s4 = served4["summary"]
    log(f"config-4 serve: {s4['rows'] / s4['seconds']:.0f} rows/s over "
        f"{s4['rows']} rows, batches {GBT_BATCHES}; "
        + ", ".join(f"{p['numInputRows']} rows in {p['durationMs']:.2f} ms"
                    for p in s4["progress"]) + f" [{card}]")
    log(f"config-4 fit ({trained4['train_rows']} rows, {CLASSES} classes x "
        f"{GBT_ROUNDS} rounds, depth {GBT_DEPTH}): train command "
        f"{trained4['fit_wall_clock_s']} s; in this process "
        f"{fit4['profiled_fit_ms']:.1f} ms under the profiler with device "
        f"busy {fit4['device_ms']:.1f} ms (idle share "
        f"{fit4['device_idle_share']:.3f}); top device ops "
        f"{fit4['top_device_ops_ms']} [{card}]")
    for x in fit4["tree_hist_launches"]:
        log(f"  config-4 tree_hist launch {x['launch']}: round {x['round']}, "
            f"level {x['level']}, {x['hist_nodes']} nodes histogrammed, "
            f"[{x['F']}, {x['N']}] T={x['T']} per-tree stats: "
            f"{x['device_ms']:.4f} ms ({_profiled(x)} by the profiler); "
            f"{_plan(x)} [{card}]")
    log(f"config-4 tree_hist: {len(fit4['tree_hist_launches'])} launches, "
        f"{fit4['tree_hist_seen_by_profiler']} seen by the profiler [{card}]")
    vg = fit2["value_and_grad"]
    log(f"config-2 fit ({fit2['train_rows']} rows, layers {MLP_LAYERS}, "
        f"{fit2['lbfgs']['iterations']} LBFGS iterations, "
        f"{fit2['lbfgs']['evaluations']} evaluations, "
        f"{fit2['lbfgs']['host_syncs']} host reads): train command "
        f"{trained2['fit_wall_clock_s']} s; in this process "
        f"{fit2['profiled_fit_ms']:.1f} ms under the profiler by stage "
        f"{ {k: round(v, 1) for k, v in fit2['stages_ms'].items()} }, with "
        f"device busy {fit2['device_ms']:.1f} ms (idle share "
        f"{fit2['device_idle_share']:.3f}); device ms by group "
        f"{ {k: round(v, 3) for k, v in fit2['device_ms_by_group'].items()} }"
        f"; top device ops {fit2['top_device_ops_ms']} [{card}]")
    log(f"config-2 value_and_grad at [{fit2['train_rows']}, 78]: "
        f"{vg['ms']:.4f} ms a call, {vg['device_ms']:.4f} ms of device time "
        f"a call (bound {vg['bound_ms']:.4f} ms by {vg['bound_by']}: "
        f"{vg['flops']} FLOP, {vg['bytes']} B) [{card}]")
    log(f"config-1 fit ({trained1['train_rows']} rows): train command "
        f"{trained1['fit_wall_clock_s']} s, LBFGS {trained1['lbfgs']}, "
        f"held-out AUC {trained1['areaUnderROC']:.6f} [{card}]")
    for k in walks:
        log(f"{k['name']} {k['shape']}: {k['ms']:.4f} ms a call, "
            f"{k['device_ms']:.4f} ms of device time a launch (plain "
            f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}); {k['launches']} launches on its path "
            f"[{card}]")
    for k in pads:
        log(f"{k['name']} {k['shape']}: {k['ms']:.4f} ms a call, "
            f"{k['device_ms']:.4f} ms of device time a launch (plain "
            f"{k['plain_ms']:.4f} ms; {k['library_call']} "
            f"{k['library_ms']:.4f} ms "
            f"a call, {k['library_device_ms']:.4f} ms of device time; bound "
            f"{k['bound_ms']:.4f} ms by {k['bound_by']}); {k['launches']} "
            f"launches at this shape over {len(BATCHES)} batches [{card}]")
    for k in new9:
        lib = ("" if k["library_ms"] is None else
               f", library {k['library_ms']:.4f} ms a call")
        log(f"phase 9 {k['name']} {k['shape']}: {k['ms']:.4f} ms a call, "
            f"{k['device_ms']:.4f} ms of device time a launch (plain "
            f"{k['plain_ms']:.4f} ms{lib}, bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}); {k['launches']} launches on its path "
            f"[{card}]")
    k = phase10["pad"]
    log(f"phase 10 {k['name']} {k['shape']}: {k['ms']:.4f} ms a call, "
        f"{k['device_ms']:.4f} ms of device time a launch (plain "
        f"{k['plain_ms']:.4f} ms, {k['library_call']} "
        f"{k['library_ms']:.4f} ms; "
        f"bound {k['bound_ms']:.4f} ms by {k['bound_by']}); {k['launches']} "
        f"launches on its path [{card}]")
    p10 = {key: phase10[key] for key in ("ovr", "cv", "pipeline_cv")}
    log(f"phase 10 wall-clock, lanes against one by one: "
        + "; ".join(f"{key} {v['lanes_s']:.3f} s / "
                    f"{v.get('single_s', v.get('sequential_s')):.3f} s"
                    for key, v in p10.items()) + f" [{card}]")
    for k in hist:
        per_class = ("" if k["per_class_device_ms"] is None else
                     f", as {CLASSES} launches of the shared form "
                     f"{k['per_class_device_ms']:.4f} ms")
        log(f"{k['name']} {k['shape']}: {k['ms']:.4f} ms a call, "
            f"{k['device_ms']:.4f} ms of device time a launch{per_class} "
            f"(plain {k['plain_ms']:.4f} ms, library {k['library_ms']:.4f} "
            f"ms, bound {k['bound_ms']:.4f} ms by {k['bound_by']}); "
            f"{_plan(k['plan'])}; {k['launches']} launches in the train run "
            f"[{card}]")
    f11 = failures
    log("phase 11 " + json.dumps({
        "phase": 11, "card": card, "seconds": round(f11["seconds"], 3),
        "injected_oom_splits": f11["injected_oom"]["splits"],
        "injected_oom_launches": f11["injected_oom"]["launches"],
        "clean_launches": f11["injected_oom"]["clean_launches"],
        "real_oom_splits": f11["real_oom"]["splits"],
        "real_oom_launches": f11["real_oom"]["launches"],
        "split_dispatch_ms": f11["real_oom"]["split_dispatch_ms"],
        "clean_dispatch_ms": f11["real_oom"]["clean_dispatch_ms"],
        "quarantined_batch": f11["corrupt_file"]["quarantined"],
        "quarantine_rounds": f11["corrupt_file"]["rounds"],
        "drained": f11["corrupt_file"]["drained"],
        "device_lost_transient": f11["transient_device_lost"]["faults"],
        "device_lost_persistent_rc": f11["persistent_device_lost"]["rc"],
    }))
    p12 = phase12["runs"]
    for tag in ("clean", "salvage", "exact_clean", "exact", "zero",
                "permissive"):
        s = p12[tag]
        log(f"phase 12 {tag} run: {s['batches']} batches, {s['rows']} rows in "
            f"{s['seconds']:.3f} s of serving; launches "
            f"{s['kernel_launches']}; admission "
            f"{s['pipeline_stats'].get('admission')}; padded rows "
            f"{s['pipeline_stats']['padded_rows_total']} [{card}]")
    for k in phase12["pads"]:
        log(f"phase 12 {k['name']} {k['shape']}: {k['ms']:.4f} ms a call, "
            f"{k['device_ms']:.4f} ms of device time a launch (plain "
            f"{k['plain_ms']:.4f} ms; {k['library_call']} "
            f"{k['library_ms']:.4f} ms "
            f"a call, {k['library_device_ms']:.4f} ms of device time; bound "
            f"{k['bound_ms']:.4f} ms by {k['bound_by']}); {k['launches']} "
            f"launches at this shape in its run, max abs error "
            f"{k['max_abs_err']} against the plain version [{card}]")
    log("phase 12 " + json.dumps({
        "phase": 12, "card": card, "seconds": round(phase12["seconds"], 3),
        "batches": p12["batches"], "row_dead_letters": p12["dead_letters"],
        "salvage_launches": p12["salvage"]["kernel_launches"],
        "exact_launches": p12["exact"]["kernel_launches"],
        "permissive_launches": p12["permissive"]["kernel_launches"],
        **phase12["storage"]}))
    report_phase13(phase13, card)
    report_phase14(phase14, card)
    report_phase15(phase15, card)
    report_phase16(phase16, card)
    report_phase17(phase17, card)
    report_phase18(phase18, card)
    report_phase19(phase19, card)
    report_phase20(phase20, card)
    report_phase21(phase21_, card)
    report_phase22(phase22_, card)
    report_phase23(phase23_, card)
    report_phase24(phase24_, card)
    report_phase25(phase25_, card)
    if args.out_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.out_json)),
                    exist_ok=True)
        with open(args.out_json, "w") as f:
            json.dump({"card": card, "build": dict(_build.BUILD_INFO),
                       "serve": summary, "rows_per_s": rows_per_s,
                       "serve_forms": forms, "split8": split8,
                       "breakdown": stages, "train": trained,
                       "reduced_fit": reduced, "fit": fit,
                       "config4": {"train": trained4,
                                   "serve": served4["summary"],
                                   "reduced_fit": reduced4,
                                   "decision_tree": tree, "fit": fit4},
                       "forest_traversal": walks, "tree_hist": hist,
                       "pad_assemble": pads, "kernels": kernels,
                       "config2": {"train": trained2, "serve": served2,
                                   "reduced_fit": reduced_lbfgs["2"],
                                   "fit": fit2},
                       "config1": {"train": trained1,
                                   "reduced_fit": reduced_lbfgs["1"]},
                       "phase9": {"train": trained9, "nb_check": nb_check,
                                  "serve": served9, "evaluate": evaluated9,
                                  "regressors": regs["fits"],
                                  "kernels": new9},
                       "phase10": phase10, "phase11": failures,
                       "phase12": phase12, "phase13": phase13,
                       "phase14": phase14, "phase15": phase15,
                       "phase16": phase16, "phase17": phase17,
                       "phase18": phase18, "phase19": phase19,
                       "phase20": phase20, "phase21": phase21_,
                       "phase22": phase22_, "phase23": phase23_,
                       "phase24": phase24_, "phase25": phase25_,
                       "phase_seconds": PHASE_SECONDS,
                       "sides": side_spans(sides)}, f,
                      indent=1, default=str)
    finish(kernels, card, sides)
    return 0


def finish(kernels: list, card: str, sides: dict) -> None:
    """The last lines: the side processes' spans, each phase's
    wall-clock, the kernels, the card, the result."""
    print("sides " + json.dumps(side_spans(sides)))
    print("phase_seconds " + json.dumps(PHASE_SECONDS))
    print(json.dumps({"kernels": [
        {k2: v for k2, v in k.items()
         if k2 not in ("plan", "rows", "forest", "per_class_device_ms",
                       "library_device_ms", "shapes")}
        for k in kernels
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def main_phases(dev, card: str, phases: list, sides: dict) -> int:
    """``--phases``: the named phases alone, each after what it needs
    (phase 3's saved model for 11-13; config 1's data and train command
    for 15), every check as in the whole run; the kernels line holds the
    entries those phases measure."""
    bad = [p for p in phases if p not in PHASES]
    if bad:
        raise SystemExit(f"--phases: unknown {bad} (known: {PHASES})")
    log(f"kernels built via {_build.BUILD_INFO['route']} in "
        f"{_build.BUILD_INFO['seconds']:.1f} s [{card}]")
    kernels: list = []
    with tempfile.TemporaryDirectory(prefix="sntc_chip_smoke_") as work:
        if "2" in phases:
            with clock("2 kernels"):
                check_kernels(dev)
        if any(p in phases for p in ("3", "11", "12", "13")):
            with clock("3 serve"):
                summary, _served = serve(dev, work)
            if "3" in phases:
                kernels += measure_pad(dev, summary["pad_launch_shapes"])
        if "11" in phases:
            with clock("11 failures"):
                failure_paths(dev, work)
        if "12" in phases:
            with clock("12 data plane"):
                kernels += data_plane(dev, work)["pads"]
        if "13" in phases:
            with clock("13 self-tuning"):
                p13 = self_tuning(dev, work)
            report_phase13(p13, card)
            kernels += p13["pads"]
        if "14" in phases:
            with clock("14 lifecycle"):
                p14 = lifecycle(dev, work)
            report_phase14(p14, card)
            kernels += p14["kernels"]
        if "15" in phases:
            with clock("15 fused serve"):
                data1 = lbfgs_data(work, LR_ROWS, binary=True, tag="1")
                trained1 = train_lbfgs(dev, data1, work, [
                    "--estimator", "lr", "--binary", "--reg-param",
                    str(LR_REG)])
                check_config1(dev, data1, trained1)
                p15 = fused_serve(dev, data1, trained1, work)
            report_phase15(p15, card)
            kernels += p15["kernels"]
        if "16" in phases:
            with clock("16 live capture"):
                p16 = live_capture(dev, work)
            report_phase16(p16, card)
            kernels += p16["kernels"]
        if "17" in phases:
            with clock("17 multi-tenant"):
                p17 = multi_tenant(dev, work)
            report_phase17(p17, card)
            kernels += p17["kernels"]
        shared = None
        if "18" in phases or "19" in phases:
            with clock("18 replication"):
                shared = (p17["shared"] if "17" in phases
                          else dr_shared(dev, work))
        if "18" in phases:
            with clock("18 replication"):
                p18 = replication(dev, work, shared)
            report_phase18(p18, card)
            kernels += p18["kernels"]
        if "19" in phases:
            with clock("19 fleet"):
                p19 = fleet_serving(dev, work, shared)
            report_phase19(p19, card)
            kernels += p19["kernels"]
        if "20" in phases:
            with clock("20 families"):
                p20 = families(dev, config3_train(), sides["family_fits"])
            report_phase20(p20, card)
            kernels += p20["kernels"]
        if "21" in phases:
            with clock("21 feature stages, fits"):
                p21 = phase21(dev, work, sides["p21_fits"])
            report_phase21(p21, card)
            kernels += p21["kernels"]
        if "22" in phases:
            data1 = lbfgs_data(work, LR_ROWS, binary=True, tag="1")
            with clock("22 object columns, long tail"):
                p22 = phase22(dev, data1, sides["p22_fits"])
            report_phase22(p22, card)
        train3 = None
        if "23" in phases:
            train3 = config3_train()
            with clock("23 mesh substrate"):
                p23 = phase23(dev, work, train3)
            report_phase23(p23, card)
            kernels += p23["kernels"]
        if "24" in phases:
            train3 = config3_train() if train3 is None else train3
            with clock("24 mesh classification"):
                p24 = phase24(dev, train3)
            report_phase24(p24, card)
            kernels += p24["kernels"]
        if "25" in phases:
            with clock("25 mesh regression, families"):
                p25 = phase25(dev, p20.pop("handoff") if "20" in phases
                              else None,
                              p21.pop("handoff") if "21" in phases else None)
            report_phase25(p25, card)
            kernels += p25["kernels"]
    finish(kernels, card, sides)
    return 0


if __name__ == "__main__":
    sys.exit(main())
