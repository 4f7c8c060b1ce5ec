#!/usr/bin/env python3
"""Drive xgboost_ray_tpu_torch on one NVIDIA GPU and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc``, and nothing of JAX (``triton``, where installed,
is only where it may find ``cuobjdump``). Phases:

1. build: compile the CUDA kernels of ``xgboost_ray_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel); time K4's first launches in both
   modes and the softmax pass's; report each K1, K3, B8, B4, K4 and softmax
   kernel's registers, shared memory and spills (``-Xptxas -v``)
   and the atomic opcodes ``cuobjdump -sass`` finds in them (whether K1's
   shared adds are native or a compare-and-swap loop), and the dynamic
   shared memory per CTA of B8's kernels on the main path;
2. every kernel against its plain PyTorch version on the card, at the main
   path's shapes (HIGGS width F = 28, int16 bins, 257 buckets, a level-5
   fan-out of 32 nodes; K1 also at the root: one node, identity order;
   K2's level step at level 5 with the sibling prologue (16 parents, 32
   nodes) and its final-level records and K3's leaf-value mode at the
   final level's 64 nodes), with integer-valued gradients (exact sums: K1's
   dequantised output equals the f32 sums and K2 must be bitwise) and
   random ones (stated tolerances; K2's level step and records are bitwise
   on both; K4's margins and gradients bitwise, 0 ulps, its partials within
   1e-5 relative); K1's int64 sums and its dequantise step are bitwise against
   ``build_histogram_fixed_plain`` / ``dequantize_plain`` on both; K3
   also with the smaller children chosen from counts merged with a second
   rank's (what it does above one rank), compacted into N slots; each
   kernel is timed with
   CUDA events around its wrapper (``ms``: the host's issue time shows
   where it is the slower) and by ``torch.profiler`` (``device_ms``: the
   kernels' own device time per launch, the L2 flushed by a write; K4
   also its host time a call), beside its plain
   version and,
   where one PyTorch call computes the same function, that call (K1: an
   int64 ``index_add_``; the dequantise step: int64 times f32; K3: a
   stable ``torch.sort`` of the child key, which covers only the partition
   core);
3. the main path: ``train()`` on a HIGGS-shaped synthetic set (11,000,000 x
   28 rows, depth 6, 256 bins, 10 rounds) with ``num_actors=1`` twice and
   ``2`` once (folded onto the card), with the launch counters set to 0
   before and read after each run; determinism (ROADMAP C1): the three
   runs' dumps equal and their final margins bitwise; ranks (A6): two
   ranks sharing the card in one gloo world (``distributed.launch_world``)
   train the same config on their shards and must give the 1-rank dump
   and margins bitwise, each rank's kernel launches counted from 0 just
   before its ``train()`` and checked exactly (world size, backend,
   all-reduce bytes per round and round times printed; the NCCL path, a
   rank per card, and ``train()`` alone spawning its NCCL ranks run only
   with two or more cards and are reported as not run otherwise); then
   two more rounds under ``torch.profiler`` (device time by kernel, CUDA
   launches per round, idle share against the unprofiled round);
4. the card against the port's CPU path on a 50,000-row slice (3 rounds):
   against the f32 CPU path the first tree equal, logloss within 1e-5 and
   margins within 1e-3; against the CPU path summing in the card's fixed
   point the whole model (dumps equal, final margins bitwise);
5. ``save_model`` -> ``load_model`` on the card, ``save_raw`` bytes equal;
6. predict and serve (the main paths of the predict slice): ``train()``
   for 500 rounds on the same set (``num_actors=1``), keeping the engine's
   final margins; then four paths, each with B8's launch counters set to 0
   just before it and read just after, and each count checked exactly:
   ``predict(bst, RayDMatrix(x), RayParams(num_actors=2))`` over every row,
   margins and values (one launch per device chunk and call, the values'
   through the kernel's fused sigmoid; no row's margin may differ from
   training's by more than 1e-3, the values must be bitwise the sigmoid of
   the margins on the CPU and their logloss equal the last
   ``train-logloss`` within 1e-5);
   ``predict(..., pred_leaf=True)`` over two leaf chunks (one launch per
   chunk; the first rows equal to the plain walk on the CPU); and
   ``serve.create_server`` with that model in the heap and the node-array
   layout (``max_batch`` 256, ``max_delay_ms`` 2.0; 16 clients sending
   1-32 row requests, 1.5 s of warmup and 6 s measured for the heap,
   0.5 s and 2 s for the node array: the clients are parked at both ends
   of the window, so the window's launches equal its batches, each a value
   launch of B8's windows mapping in the server's layout; probe responses
   bitwise equal to ``booster.predict`` and to the plain walk on the CPU,
   no kernel build after warmup, no client error); then whether
   ``torch.profiler`` sees B8's full-size launch this late in the process
   (recorded only);
7. B8 against its plain version (bitwise, in both layouts, every mode:
   margins, values, leaf indices, and each mapping, forced by the SM count
   the launch plan reads) at 262,144 rows x 500 trees and at every serve
   bucket (8-256 rows), one row and a size for each rows-per-CTA choice
   of the windows mapping; then timed at the
   main path's shapes: the margins over every row, the leaf indices over
   the booster's chunk, and the margins of a serve batch of 8, 32 and 256
   rows (``device_ms`` from ``torch.profiler``, as for the other
   kernels).

8. held-out eval sets (``evals``, right after phase 2), the HIGGS
   protocol's split: the first 10,500,000 rows train, the last 500,000 are
   the test set (``evals=[(dtrain, "train"), (dtest, "test")]``, 10
   rounds, ``eval_metric`` error then logloss); ``train()`` without and
   with the test set in turns (without, with, with, without: round times,
   each run's launches counted from 0 and checked exactly, with the test
   set one B4 and one K4 eval-mode launch a round; no kernel build in any
   of them); B4 bitwise against its
   plain version over the test rows for every tree, K4's eval mode against
   its plain version (margins bitwise, partials within 1e-5 relative), both
   timed (B4's bound from the 32-byte sectors of bins its walks read; B4
   also on each mapping of its launch plan, each bitwise, beside the plan's
   choice and the bytes a tiled walk reads); the
   test margins within 1e-4 of ``booster.predict(x_test,
   output_margin=True)``; 15 rounds with ``early_stopping_rounds=3``
   (``best_iteration`` the argmin of the test logloss, stopped 3 rounds
   after it or at round 15); a warm start, 5 rounds then 5 more through
   ``xgb_model``, twice (10 trees, the first 5 the uninterrupted run's, the
   rerun bitwise; the margin difference to the uninterrupted run printed);
   and ROADMAP C2, every row sketched with random positive weights twice
   and with its rows in two shards folded: bitwise the same cuts.

9. multiclass (``multiclass``, right after phase 8): Covertype's shape
   (``make_covertype_like``: 581,012 rows x 54 features, 10 continuous
   then 4 + 40 one-hot columns, labels a seeded function of the features
   with Covertype's class counts), the last 116,202 rows the test set,
   ``multi:softprob`` with ``num_class`` 7, depth 6, 256 bins, 10 rounds
   (70 trees); ``train()`` without and with the test set in turns, each
   run's launches counted from 0 and checked exactly (per tree the binary
   path's K1-K3, one training-mode softmax pass a round and round 0's;
   with the test set one B4 over the round's 7 trees and one eval-mode
   pass a round); reruns and two shards folded give equal dumps and
   bitwise margins; the test mlogloss falls and the test margins are the
   booster's within 1e-4; the softmax pass in each mode and B4 at T = 7
   bitwise against their plain versions on the phase's tensors (partial
   sums within 1e-5 relative) and timed, the transform beside
   ``torch.softmax``; K1 and K2's level step at 54 features; a profile
   of two rounds; ``predict()`` over every row (values bitwise the plain
   transform of B8's margins, one B8 and one transform launch a chunk);
   a server of the model (probes bitwise, no build after warmup, a short
   closed loop: every batch one B8 margin launch and one transform
   launch, no client error); early stopping on the test mlogloss; a
   5 + 5 warm start twice; the card against the CPU path on 50,000 rows
   and 3 rounds (phase 4's rule); and ``multi:softprob`` at K = 33 classes
   (the softmax pass's path above 32 classes: 10,000 rows, 3 rounds, labels
   a seeded score's quantiles), launches checked, against the CPU path
   summing in the card's fixed point by phase 4's rule.

10. the facade (``facade``, right after phase 9), each step's launches
   counted from 0 and checked exactly: ``RayXGBClassifier`` (10 rounds,
   depth 6, 256 bins, ``eval_metric`` error then logloss) on phase 8's
   HIGGS split with the test set as ``eval_set``: its model, test history
   and launches equal to ``train()``'s with the test set, ``predict_proba``
   bitwise ``booster.predict``, ``predict`` the classes of p > 0.5,
   ``apply`` bitwise ``predict(pred_leaf=True)``, ``feature_importances_``
   the normalised gain, the fit's wall time beside ``train()``'s and the
   label encoding's (``np.unique``) beside the JAX module's per-row dict
   loop; early stopping over 15 rounds (``best_iteration`` the argmin of
   the test logloss, predictions from rounds [0, best + 1)); a pickle
   round trip (bitwise predictions); ``RayXGBRegressor`` over all
   11,000,000 rows with a numpy squared-error objective and with
   ``reg:squarederror`` (``base_score`` 0.5): the same model and final
   margins bit for bit, K4 only in its no-gradient mode in the custom run,
   whose mode at this shape is held against its plain version and timed,
   the two runs' rounds printed; the classifier on phase 9's Covertype
   set with labels 1..7 (``classes_``, the ``train()`` model, predictions
   the classes of the probabilities' argmax); a numpy softmax objective
   and mlogloss ``custom_metric`` at Covertype's shape (history within
   1e-5 of the built-in mlogloss; the softmax pass's no-gradient mode at
   464,810 x 7 held and timed); Covertype's 116,202 test rows x 54 as 4
   CSV files loaded centrally (the native parser read every file; the tune
   report callback under a ``TuneSession`` reported every round) and by 2
   gloo ranks sharing the card (``distributed=True``, 2 files a rank, each
   rank's distributed callbacks in the JAX package's hook order), every
   model the numpy-input model; Parquet where pyarrow imports; and, where
   scikit-learn imports, ``clone`` and a 2-fold ``GridSearchCV`` over
   ``max_depth`` {2, 3} on 50,000 rows.
11. SHAP (``shap``, after phase 6's paths), B15's counters set to 0 just
   before each path and checked exactly after it (one launch a chunk):
   ``predict(bst, RayDMatrix(x[:1,048,576]), RayParams(num_actors=2),
   pred_contribs=True)`` on phase 6's 500-tree model (122 MB out), again
   with ``approx_contribs=True``, and ``pred_interactions=True`` over
   65,536 rows (220 MB): every row sums to B8's margin within the f32
   bound of ``shap_sum_bound``, each interaction row to its feature's
   exact contribution; the exact result bitwise the booster's own call, a
   rerun, and the rows at batch 8 and 256 bitwise inside the big call (all
   three entry points); each entry point bitwise its plain version on the
   card on 4,096 rows (exact and Saabas over the whole forest, the
   interactions over the first 50 rounds: the plain version's D^2 loops
   of PyTorch calls take minutes over 500 trees); Covertype's model
   (``multi:softprob``, K = 7, 70 trees, F = 54, trained here) over its
   116,202 test rows (179 MB, exact and Saabas) and interactions over
   4,096 rows, their sums checked, exact and Saabas held against plain
   (Saabas over all the test rows, and in each mapping over 4,096); the
   Saabas walk tables' bytes and each call's scratch bytes recorded; each
   entry point timed at the
   main path's shape (events; device time L2 flushed by a write) and at
   4,096 rows (the same) beside its plain version,
   its bound from the forest's actual leaves (``ops/shap.leaf_ops``;
   Saabas from the leaf each row reaches, ``ops/shap.saabas_ops``, with
   the count of ``leaf_ops`` beside it) and,
   beside it, the unfused ceiling (twice the operations bound: B15 builds
   with --fmad=false) and the bytes bound; no PyTorch call computes
   TreeSHAP, so ``library_ms`` is null. Every entry point's launches are
   counted by mapping on each path; each mapping is held bitwise against
   the plain version and against the main path's mapping, and timed at the
   main path's shape; each record carries its mapping and its kernel's
   registers and spills (``-Xptxas -v``; no B15 kernel of a forest up to
   depth 8 may spill), beside the seconds ``csrc/shap.cu`` alone takes to
   build; then a 37-row serve ``contribs`` batch through
   ``serve.CompiledPredictor`` (host clock) and its B15 launch (events);
12. the replica pool (``serve_pool``): ``create_server(bst,
   n_replicas=1)`` and ``n_replicas=4`` under the 16-client closed loop
   (1 s warmup, 3 s measured; qps and p50/p95/p99 side by side, no
   claim), probes of all four kinds bitwise ``booster.predict`` on the
   card and on the CPU (``contribs`` one B15 launch a batch; the 37-row
   probe's request and, before the windows, the predictor's call and its
   B15 launch timed), no kernel
   build after warmup, one B8 value launch per batch, no client error;
   a replica killed half-way through a 4-replica window and then
   rejoined: no client error, the kill on the trace; an autoscaler up /
   down cycle read back from the trace alone (scale events and the
   replica count replayed from the membership events); the canary on a
   2-replica server: a 20-round model on shuffled labels rolls back, a
   ``refresh`` of the served model (5 rounds with ``xgb_model``, on the
   card) is promoted and then served, counted in the serve metrics; the
   served model exported to xgboost JSON and imported: margins and values
   over 1,000,000 rows and contributions over 4,096 bitwise the
   original's, and ``POST /models`` with the file hot-swaps a server
   (margins bitwise); the whole trace valid against the schema and the
   event names.
13. the row-elementwise objectives (``objectives``, after phase 10;
   ``--objectives-only`` runs the build and it alone): at the HIGGS shape
   and split (10,500,000 + 500,000 rows, depth 6, 256 bins, 10 rounds,
   ``evals=[(dtrain, "train"), (dtest, "test")]``) one ``train()`` per
   objective of ``OBJ_RUNS`` (absolute, pseudo-Huber, squared log,
   Poisson, gamma, Tweedie rho 1.5, hinge and logitraw with auc / aucpr,
   quantiles at alphas 0.1 / 0.5 / 0.9, AFT normal and logistic; the five
   whose kernel no row of the table times on the first 2,000,000 training
   rows, ``OBJ_CUT_ROWS``), labels
   made from the seed by ``objective_labels`` (30 % of the AFT times
   right-censored, 10 % interval-censored); each run's launches counted
   from 0 and checked exactly (``objectives_expect``), no kernel build
   inside it; K4 in each mode, the AFT pass and the K-output kernel
   against their plain versions over the run's rows (margins and
   gradients bitwise, partial sums within 1e-5 relative), B9a against its
   plain version over the training and the test margins (bitwise),
   timed with B8's exp fused; auc and aucpr bitwise on a rerun and over 2
   gloo ranks sharing the card; early stopping on the test auc; the
   Poisson, AFT and quantile models equal to the fixed-point CPU path's on
   ``--compare-rows`` rows; ``predict()`` and a served ``value`` probe of
   the Poisson and the quantile model.
14. learning to rank and survival:cox (``ranking``, after phase 13;
   ``--ranking-only`` runs the build and it alone): path R at
   MSLR-WEB30K's shape (``make_mslr_like`` of
   ``tests/release/benchmark_ranking.py``: 30,000 queries of about 120
   documents x 136 features, a 10,000-query test fold from seed 1),
   ``rank:ndcg``, ``rank:pairwise`` and ``rank:map`` with ``ndcg@10`` and
   ``map@10``, depth 8, eta 0.1, 256 bins, 10 rounds, each run's launches
   counted from 0 and checked exactly (``ranking_expect``), the test
   ndcg@10 rising; B13 in both modes and B9r for both metrics bitwise their
   plain versions on the run's rows and timed, and on edge cases (queries
   of 1, 2, 1,300 and 2,500 documents, tied scores, equal labels, zero
   weights); K1 at F = 136 with 128 nodes and B4's 511-node heap held once;
   ``predict()`` over the test fold within 1e-3 of its training margins,
   a served probe, ``RayXGBRanker`` equal to ``train()``; on a 300-query
   cut (and 200,000 Cox rows) the card's models at ``num_actors=2`` equal
   to the fixed-point CPU path's, and 2 gloo ranks equal to it too (Cox's
   margins gathered every round). Path C: ``survival:cox`` with
   ``cox-nloglik`` at the HIGGS split (``cox_labels``: phase 13's AFT
   times, censored ones right-censored at their lower bound), launches
   exact (``cox_expect``), B14 bitwise its plain version and timed beside
   the set-up's ``torch.sort``, on edge cases too (all censored, ties,
   zero-weight rows holding the largest margin); ``predict()`` values
   bitwise exp of the margins, and B8's exp finite up to a margin of 88.72
   and inf above (C7).
15. stochastic boosting and random forests (``sampling``, after phase 14;
   ``--sampling-only`` runs the build and it alone): at the HIGGS split,
   10 rounds at depth 6, the unsampled main path and S1 (``subsample``
   0.8, ``colsample_bytree`` and ``colsample_bynode`` 0.8, ``error@0.3``
   and ``error@0.7`` beside ``logloss`` and ``auc``), S2 (GOSS 0.2 / 0.1,
   ``colsample_bylevel`` 0.7) and S3 (``colsample_bynode`` 0.5 over
   ``feature_weights``, a quarter of them 0), each run's launches counted
   from 0 and checked exactly (``sampling_expect``), the test logloss
   falling, no split on a zero-weight feature; B12r (both policies, the
   rows compared sorted and their gradients by row), B12f, K2's masked
   level step and K4's T-tree add bitwise their plain versions at the
   runs' shapes and timed (B12r beside ``torch.topk`` over its keys);
   every configuration (2 rounds) and a 6-tree forest equal to the
   fixed-point CPU path's on a 50,000-row cut; S4 ``RayXGBRFClassifier(n_estimators=100,
   max_depth=8).fit`` and ``predict_proba`` on the test rows (B8); S5 a
   sampled Covertype ``multi:softprob`` with ``logloss`` (column 0) and
   ``auc`` (column 1), equal to the fixed-point CPU path on a cut; S6 S1
   over 2 gloo ranks equal to one rank at ``num_actors=2``.

16. monotone and interaction constraints, parallel trees of K outputs
   (``constraints``, after phase 15; ``--constraints-only`` runs the build
   and it alone): at the HIGGS split, 10 rounds at depth 6, M1 monotone
   (+1 on four features, -1 on three), M2 interaction groups covering all
   28 features, M3 both with ``colsample_bynode`` 0.8, each run's launches
   counted from 0 and checked exactly (``constraints_expect``), the test
   logloss falling, the card's margins along a grid in each constrained
   feature monotone exactly, every root-to-leaf path inside one group;
   K2's constrained level step at level 5 (unmasked and masked) bitwise its
   plain version, the next level's bounds included, and timed in turns with
   the unconstrained step on the same inputs; P1 a Covertype-shaped
   ``multi:softprob`` with 4 parallel trees a class (``subsample`` and
   ``colsample_bynode`` 0.8) and P2 ``reg:quantileerror`` at three alphas
   with 2 parallel trees each, their launches exact (``forest_expect``);
   the T-tree modes of the softmax pass and of K4's K-output kernel bitwise
   their plain versions at the runs' shapes and timed; every configuration
   equal to the fixed-point CPU path's on a cut (50,000 HIGGS rows, 20,000
   Covertype rows for P1, 50,000 for P2; 2 rounds);
17. categorical one-vs-rest splits (``categorical``, after phase 16;
   ``--categorical-only`` runs the build and it alone): a seeded
   airline-shaped set (``make_airline_like``: the ASA Data Expo 2009
   on-time data's columns as NVIDIA gbm-bench's "airline" set uses them,
   Month, DayofMonth, DayOfWeek, UniqueCarrier, Origin and Dest as
   categories, CRSDepTime, CRSArrTime and Distance numeric; Origin and
   Dest cut to 254 codes, the rarest airports NaN), 11,000,000 rows split
   as HIGGS's, depth 6, 10 rounds: C1 from the pandas ``category`` frame
   (its set-up auto-encodes it), C2 the same codes with ``feature_types``
   (its model C1's), C3 C1 with ``colsample_bynode`` 0.8 and a monotone
   sign on Distance; launches exact (``categorical_expect``), the test
   logloss falling and recorded beside the same columns coded as numbers;
   K2's categorical level step (unmasked and masked), K3's categorical
   route and B4's categorical walk bitwise their plain versions and timed
   beside their numeric forms; predict on a frame of another category
   order equal to predict on the codes; pred_contribs summing to the
   margins; each configuration equal to the fixed-point CPU path on a
   50,000-row cut;
18. lossguide growth (``lossguide``, after phase 17; ``--lossguide-only``
   runs the build and it alone): L1 the HIGGS split at depth 6 and
   ``max_leaves`` 64 against the depthwise model (the same leaf
   structure, margins within 1e-4), L2 depth 10 and 255 leaves (the
   budget binds, leaves below depth 6), L3 phase 17's set with 255
   leaves, ``subsample`` and ``colsample_bytree`` 0.8; launches exact
   (``lossguide_expect``), the test logloss falling, a tree's host syncs
   counted; the frontier-step kernel bitwise its plain version and timed;
   each run equal to the fixed-point CPU path on a 50,000-row cut.
19. quantized gradients and the quantized histogram wire (``quantized``,
   after phase 18; ``--quantized-only`` runs the build and it alone): the
   HIGGS split at depth 6, Q0 the f32 main path of the call, Q1 / Q2
   ``gh_precision`` int8 / int16 (qmax 204 at 10,500,000 rows), Q3
   ``hist_quant="int8"`` at one rank, Q4 int8 gradients on the
   ``int8_block`` wire as 2 gloo ranks sharing the card, Q5 L1's lossguide
   with int8 gradients on the int8 wire; launches exact
   (``quantized_expect``), the test logloss falling beside Q0's,
   ``hist_allreduce_bytes_per_round`` (``quant_world_bytes``) and
   ``gh_plane_bytes_per_shard`` against their formulas; Q1 and Q4 equal
   to the port's CPU path (Q4: the CPU's 2-rank world) on a 50,000-row
   cut, and Q5 on a 50,000-row cut, with no fixed-point patch, Q3 to the
   fixed-point CPU path;
   B10 (two blocks, int8 and int16), K1's integer instantiation (level 5
   and the root at F = 28, level 5 at F = 54), the form-and-dequantise
   step and B11's three kernels (every mode at blocks 64, 512 and 4096 on
   a level-5 HIGGS histogram) bitwise their plain versions and timed.
20. dart and gblinear (``dart_gblinear``, after phase 19;
   ``--dart-gblinear-only`` runs the build and it alone): D1 dart
   ``binary:logistic`` at the HIGGS split, depth 6, ``rate_drop`` 0.1; D2
   with weighted drops, forest normalisation, ``one_drop`` and
   ``skip_drop`` 0.5; D3 dart ``multi:softprob`` at Covertype's shape (K =
   7); G1 gblinear ``reg:squarederror`` at the HIGGS split (``eta`` 0.5,
   ``lambda`` 0.01, ``alpha`` 0.001), G2 ``binary:logistic`` with the test
   set, G3 ``multi:softprob`` at Covertype's 54 features, G4 G1 as 2 gloo
   ranks sharing the card; launches exact (``dart_expect``,
   ``linear_expect``: B4w twice a dart round and once a held-out set, but
   not over round 0's empty forest, B16
   once a gblinear round at world 1 and F + 2 times at world 2), every
   loss falling; B4w and B16 bitwise their plain versions, on reruns, B16
   also in its world mode, both timed with their bounds; D1, D3 and G1-G3
   on a 50,000-row cut (2 rounds) run twice on the card and equal to the
   port's CPU path (dart: summing in the card's fixed point), G4 to the
   CPU's 2-rank world; ``predict()`` equal to the booster's own call and a
   gblinear model's xgboost JSON predicting bitwise; the round medians
   beside the main path's gbtree median.

Every phase's seconds are printed on one line (``phase_seconds``) before
the ``kernels`` line.

Phase 6's model is trained, and phase 7 run, right after phase 1: later in
the process ``torch.profiler`` records no device activity for B8's
full-size launches (not in a fresh process, nor after any one of phases
2-4 alone), so phase 7 runs first. Phase 6's paths run last.

It prints one JSON line per phase result, the ``{"kernels": [...]}`` line,
the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line. ``--rows`` and ``--rounds`` shrink phase 3 for a quick run;
results also go to ``chiprun_out/chip_smoke.json``.

``--predict-rounds`` shrinks phase 6's model for a quick run.
``--b8-only`` stops after phase 7 (build, phase 6's model, B8's checks
and timings) and prints no result line; it works on another tree of the
package too (copy this script into it; there it checks the modes and
mappings that tree has), to compare two versions of B8 in one call.

``--profile-only`` runs the build and phase 3's profile alone and prints
no result line; it also works against an older tree of the package (copy
this script into that tree), to count that tree's CUDA launches per round.

``--k1-time`` runs the build and then times K1 alone (``torch.profiler``
device time at level 5 and at the root of the 11M x 28 set, and whether
it is bitwise its fixed-point plain version there) and a 10-round
``train()`` (median round, md5 of the dump); it prints one JSON line and
no result line, and works in an older tree too (one from before K1's
fixed point is timed with its f32 K1), so two trees are compared in turns
in one call.

``--multiclass-only`` runs the build and phase 9 alone and prints its
kernel rows but no result line; ``--evals-only`` the same for phase 8.
Both work in an older tree of the package too (copy this script into its
root), so two versions of the softmax pass and B4 are timed in turns in
one call.

``--kernels-only`` runs the build and phase 2 alone and prints its kernel
rows but no result line; it works in an older tree too (copy this script
into its root; there K4's gradients are held within 1e-6, as that tree's
Triton K4 was), so two versions of K4's gh mode are timed in turns in one
call.

``--k4-variants`` runs the build and then times K4 as built against edits
of its source compiled beside it (``K4_VARIANTS``: no last-CTA sum,
streaming loads, streaming stores) in turns, in both modes, and prints one
JSON line and no result line.

``--facade-only`` runs the build and phase 10 alone and prints its kernel
rows but no result line.

``--b15-variants`` runs the build, phase 6's model and then times B15's
exact and interaction kernels (rows mapping, phase 11's shapes) as built
against edits of ``csrc/shap.cu`` compiled beside it (``B15_VARIANTS``:
the compiler's division for the quotients, warp votes around the UNWIND
branches, the pair loop unrolled, the Saabas fold's reads before its
writes) and
against every rows-mapping buffer on
chip, in turns, bitwise checked; the Saabas rows mapping at 256 or 128
rows a CTA and 8, 4 or 2 trees a tile, in turns, bitwise checked, and its
lanes mapping at 1, 2, 4 and 8 rows a CTA over 37 to 16,384 rows; then
the rows and lanes mappings of all three entry points across batch
sizes; one JSON line and no result line.

``--ranks-only`` runs the build, the 1-rank main path and the ranks phase
(on a host of two or more cards also the NCCL path, against the 1-rank
run, and phase 19's Q4 over NCCL against the same over gloo) and prints no
result line.

``--shap-only`` runs the build, phase 6's model and phase 11 and prints
its kernel rows but no result line; ``--pool-only`` the same for phase 12.

``--constraints-only`` runs the build and phase 16 and prints its kernel
rows but no result line; ``--categorical-only`` and ``--lossguide-only``
the same for phases 17 and 18 (with the registers and spills of K2's
instantiations, K3's route, B4 and the frontier step).
``--ranking-only`` runs the build and phase 14 and prints its kernel rows
but no result line.

"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM
OUT_DIR = "chiprun_out"
#: the card's name and power limit, stamped on every result line once known
CARD = None


#: seconds of each phase of the full run, printed on one line before the
#: kernels line
PHASE_SECONDS = {}
T_START = time.perf_counter()


class SmokeFailure(Exception):
    pass


def timed(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds recorded under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    return out


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(obj):
    if CARD is not None and "ok" not in obj:
        obj = {**obj, "card": CARD}
    print(json.dumps(obj), flush=True)


def make_higgs_like(n_rows, n_features, seed=0):
    """The HIGGS-shaped synthetic recipe of the repo's benchmark."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal(size=(n_rows, n_features)).astype(np.float32)
    logits = 0.8 * x[:, 0] - 0.6 * x[:, 1] + 0.4 * x[:, 2] * x[:, 3] + 0.3 * x[:, 4]
    y = (logits + rng.standard_normal(n_rows).astype(np.float32) > 0).astype(np.float32)
    return x, y


def cuda_ms(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_call_us(fn, iters=100, runs=3):
    """Host time per call of ``fn`` called back to back, in us: its Python,
    argument set-up and launch, not the device's work (100 launches stay
    far from the launch queue's bound). The median of ``runs`` runs, each
    followed by a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per_call.append((time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return float(np.median(per_call))


def device_ms(fn, iters=10, only=None, every=False, blind="events",
              tries=3):
    """Device time per call of ``fn`` of the kernels it launches, from
    ``torch.profiler``: the port's own kernels, not the wrapper's
    allocations and fills (PyTorch's ``at::`` kernels, copies, memsets);
    with ``only``, the kernels whose name holds it (any case), PyTorch's
    too (a library call's); with ``every``, all of its device work.

    Late in a long process the profiler drops an execution or two of the
    ``iters`` calls now and then, so a kernel's time is its mean over the
    executions recorded times its executions a call (the recorded count
    over the calls, rounded); a drop is reported as a ``profiler_lost``
    line. Now and then it records no device activity at all (its CUPTI
    buffer comes back empty): it is asked ``tries`` times, and if it stays
    blind the call is timed with CUDA events instead (``cuda_ms``: all of
    the call's device work, the wrapper's fills too), reported as a
    ``profiler_blind`` line; with ``blind="raise"`` it fails instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times, counts = {}, {}
        seen = []
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            t = e.self_cuda_time_total if t is None else t
            seen.append((e.key[:60], str(e.device_type), t))
            if e.device_type != torch.autograd.DeviceType.CUDA or (
                    not every and ((only.lower() not in e.key.lower())
                                   if only else
                                   ("at::" in e.key or
                                    e.key.startswith(("Memcpy", "Memset"))))):
                continue
            times[e.key] = times.get(e.key, 0.0) + t / 1e3
            counts[e.key] = counts.get(e.key, 0) + e.count
        if sum(times.values()) > 0:
            break
    else:
        events = sorted(seen, key=lambda v: -v[2])[:8]
        check(blind == "events",
              f"torch.profiler saw no device time of the kernels in "
              f"{tries} tries; events: {events}")
        ms = cuda_ms(fn, iters=iters)
        emit({"phase": "profiler_blind", "tries": tries, "calls": iters,
              "events": events, "cuda_event_ms": ms})
        return ms
    if any(c % iters for c in counts.values()):
        emit({"phase": "profiler_lost", "calls": iters,
              "executions": {k[:80]: c for k, c in counts.items()}})
    return sum(times[k] / counts[k] * max(1, round(counts[k] / iters))
               for k in times if counts[k])


def profile_steps(step, first, rounds, tries=3):
    """``torch.profiler`` over ``rounds`` calls of ``step(i)`` from round
    ``first`` on: the profile and its wall ms. Where the profiler records no
    device activity, the next ``rounds`` are profiled, up to ``tries``
    times; a profile that stays blind is None (a ``profiler_blind``
    line)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    for k in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(rounds):
                step(first + k * rounds + i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if any(e.device_type == cuda for e in prof.key_averages()):
            return prof, wall_ms
    emit({"phase": "profiler_blind", "tries": tries, "rounds": rounds})
    return None, wall_ms


def bound_ms(nbytes, nflops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = nflops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: what nvcc made of K1 and K3
# ---------------------------------------------------------------------------

_TYPE_CODES = {"s": "int16", "h": "uint8"}


def kernel_name(mangled):
    """``_Z15xrt_hist_kernelIsLb1EEv...`` -> ``xrt_hist_kernel<int16, true>``,
    ``_Z18xrt_predict_kernelILi0ELi1EEv...`` -> ``xrt_predict_kernel<0, 1>``."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    rest = mangled[start + int(m.group(1)):]
    if not rest.startswith("I"):
        return name
    args, i = [], 1
    while i < len(rest) and rest[i] != "E":
        if rest[i] == "L":  # a literal: L<type code><value>E
            j = rest.index("E", i)
            code, value = rest[i + 1], rest[i + 2:j]
            args.append(("true" if value == "1" else "false") if code == "b"
                        else value)
            i = j + 1
        else:
            args.append(_TYPE_CODES.get(rest[i], rest[i]))
            i += 1
    return f"{name}<{', '.join(args)}>"


def ptxas_report(log):
    """{kernel: registers, shared bytes, spills} from ``-Xptxas -v``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(_Z\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def cuobjdump_path():
    import shutil

    found = shutil.which("cuobjdump")
    if found:
        return found
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "cuobjdump")]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cands if os.path.exists(c)), None)


def sass_atomics(lib_path):
    """{kernel: {atomic opcode: count}} from ``cuobjdump -sass``."""
    exe = cuobjdump_path()
    if exe is None:
        return {"error": "cuobjdump not found"}
    out = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        return {"error": out.stderr.strip()[:300]}
    funcs, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = kernel_name(m.group(1))
            funcs[cur] = {}
            continue
        m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)(?:\.[A-Za-z0-9_]+)*)"
                      r"\s", line)
        if m and cur is not None:
            funcs[cur][m.group(1)] = funcs[cur].get(m.group(1), 0) + 1
    return funcs


def b8_main_path_kernels(n_trees, n_rows):
    """{B8 kernel: (what it runs, dynamic shared memory per CTA)} at the
    main path's shapes (depth 6, F = 28): the rows mapping of predict()'s
    margins and leaf chunks, the windows mapping of the serve buckets."""
    import torch

    from xgboost_ray_tpu_torch.ops import predict as PR

    fo = PR.PredictForest(None, n_trees, 6, "heap", 28, False)
    out = {}
    for what, n, leaf in (("predict() margins and values", n_rows, False),
                          ("predict(pred_leaf=True) chunks", 1_000_000, True),
                          ("serve batches of 8-256 rows", 32, False)):
        plan = PR.launch_plan(n, 1, fo, leaf, torch.device("cuda"))
        name = (f"xrt_rows_kernel<{int(leaf)}, {str(plan.staged).lower()}, "
                f"false>" if plan.mapping == "rows"
                else f"xrt_windows_kernel<{int(leaf)}, false>")
        out[name] = (what, plan.shared_bytes)
    return out


def k2_ptxas():
    """Registers and spills of K2's level-step instantiations (<MASKED,
    CONS, CAT>; <false, false, false> is the main path's) and of the
    categorical route, the walk and the frontier step."""
    from xgboost_ray_tpu_torch.ops import _build

    out = {}
    for stem, prefix in (("split", "xrt_split_level_kernel"),
                         ("partition", "xrt_part_route_kernel"),
                         ("walk", "xrt_walk_kernel"),
                         ("lossguide", "xrt_lossguide_step_kernel")):
        for name, v in ptxas_report(_build.build_log(stem)).items():
            if name.startswith(prefix):
                out[name] = v
    return out


def quant_ptxas():
    """Registers and spills of phase 19's kernels: B10 and B11's
    (``csrc/quant.cu``), K1's integer instantiations, its totals pass and
    the form-and-dequantise step (``csrc/histogram.cu``)."""
    from xgboost_ray_tpu_torch.ops import _build

    out = {}
    for name, v in ptxas_report(_build.build_log("quant")).items():
        out[name] = v
    for name, v in ptxas_report(_build.build_log("histogram")).items():
        if name.startswith(("xrt_hist_int_kernel", "xrt_node_totals_int",
                            "xrt_form_dequant")):
            out[name] = v
    return out


def phase_build_report(n_trees, n_rows):
    """Registers, shared memory and spills of every kernel (K1, K2's four
    instantiations, K3, B8, B4, the softmax pass, K4; B8's main-path
    kernels with their dynamic shared
    memory per CTA), and whether K1's shared adds compile to native adds or
    a compare-and-swap loop."""
    from xgboost_ray_tpu_torch.ops import _build
    from xgboost_ray_tpu_torch.ops import predict as PR

    paths = _build.build_all()
    report = {}
    for stem in ("histogram", "split", "partition", "predict", "walk",
                 "softmax", "objective", "shap", "lossguide", "quant"):
        if stem in paths:  # walk, softmax, objective: not in older trees
            report[stem] = {"ptxas": ptxas_report(_build.build_log(stem)),
                            "sass_atomics": sass_atomics(paths[stem])}
    if hasattr(PR, "launch_plan"):  # this tree's B8 (not an older one)
        ptxas = report["predict"]["ptxas"]
        report["b8_main_path"] = {
            name: {"runs": what, "dynamic_smem_bytes": smem,
                   **ptxas.get(name, {"error": "not in the ptxas log"})}
            for name, (what, smem) in b8_main_path_kernels(
                n_trees, n_rows).items()}
    shared = {op: c for fn, ops in report["histogram"]["sass_atomics"].items()
              if fn.startswith("xrt_hist_kernel") and isinstance(ops, dict)
              for op, c in ops.items() if op.startswith("ATOMS")}
    if not shared:
        finding = "no ATOMS opcode found in xrt_hist_kernel"
    elif any("CAS" in op for op in shared):
        finding = "a shared add compiles to a compare-and-swap loop"
    else:
        finding = "every shared add compiles to a native ATOMS add"
    report["k1_shared_atomic_finding"] = finding
    report["k1_shared_atomic_opcodes"] = shared
    # K1's integer instantiation: native 32-bit shared adds, no CAS loop
    shared_int = {op: c for fn, ops in
                  report["histogram"]["sass_atomics"].items()
                  if fn.startswith("xrt_hist_int_kernel")
                  and isinstance(ops, dict)
                  for op, c in ops.items() if op.startswith("ATOMS")}
    if shared_int:
        report["k1int_shared_atomic_opcodes"] = shared_int
        check(not any("CAS" in op for op in shared_int),
              f"K1int's shared adds compile to a CAS loop: {shared_int}")
    # B15 sums in a fixed order: no atomic of any kind
    b15_atomics = {fn: ops for fn, ops in
                   report.get("shap", {}).get("sass_atomics", {}).items()
                   if isinstance(ops, dict) and ops}
    report["b15_atomics"] = b15_atomics
    check(not b15_atomics, f"B15 kernels use atomics: {b15_atomics}")
    emit({"phase": "build_report", **report})
    return report


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def bits(t):
    """A tensor to compare bit for bit (float32 as its int32 pattern)."""
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def level_inputs(n, f, n_nodes, seed, integer_gh):
    """A level-5-like state: bins, gh, node-sorted rows and segments."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    bins = torch.randint(0, 256, (n, f), generator=g, device=dev,
                         dtype=torch.int16)
    miss = torch.rand((n, f), generator=g, device=dev) < 0.05
    bins[miss] = 256
    if integer_gh:
        gh = torch.stack([
            torch.randint(-2, 3, (n,), generator=g, device=dev),
            torch.randint(1, 4, (n,), generator=g, device=dev)], 1).float()
    else:
        gh = torch.stack([torch.randn(n, generator=g, device=dev),
                          torch.rand(n, generator=g, device=dev) * 0.25], 1)
    node = torch.randint(0, n_nodes, (n,), generator=g, device=dev)
    order = torch.sort(node, stable=True).indices.to(torch.int32)
    counts = torch.bincount(node, minlength=n_nodes)
    seg = torch.cat([torch.zeros(1, device=dev, dtype=torch.long),
                     torch.cumsum(counts, 0)]).to(torch.int32)
    return bins.contiguous(), gh.contiguous(), order, seg


def hold_k1(bins, gh, rows, seg, n_nodes, nbt, qs, integer_gh, what):
    """K1 against ``build_histogram_fixed_plain`` on the card: raw int64
    histogram and totals bitwise, the totals-only launch bitwise, the
    dequantise kernel bitwise against ``dequantize_plain``; then the
    dequantised sums against the f32 plain sums. Returns (max abs error
    against the f32 sums, max abs error of the dequantise kernel: 0)."""
    import torch

    from xgboost_ray_tpu_torch.ops import histogram as H

    hk, tk = H.build_histogram(bins, gh, rows, seg, n_nodes, nbt, qscale=qs)
    hq, tq = H.build_histogram_fixed_plain(bins, gh, rows, seg, n_nodes, nbt,
                                           qs)
    _, tk0 = H.build_histogram(bins, gh, rows, seg, n_nodes, nbt,
                               with_hist=False, qscale=qs)
    torch.cuda.synchronize()
    check(hk.dtype == torch.int64 and torch.equal(hk, hq)
          and torch.equal(tk, tq) and torch.equal(tk0, tq),
          f"K1 ({what}) int64 sums not bitwise equal to the fixed-point "
          f"plain version")
    dk, dtk = H.dequantize(hk, qs), H.dequantize(tk, qs)
    dq, dtq = H.dequantize_plain(hq, qs), H.dequantize_plain(tq, qs)
    torch.cuda.synchronize()
    check(torch.equal(bits(dk), bits(dq)) and torch.equal(bits(dtk), bits(dtq)),
          f"K1 dequantise ({what}) not bitwise equal to its plain version")
    del hk, hq, dq
    hp, tp = H.build_histogram_plain(bins, gh, rows, seg, n_nodes, nbt)
    err = max(float((dk - hp).abs().max()), float((dtk - tp).abs().max()))
    if integer_gh:
        check(torch.equal(dk, hp) and torch.equal(dtk, tp),
              f"K1 ({what}) dequantised sums differ from the exact f32 sums "
              f"with integer gh (max err {err})")
    else:
        habs, tabs = H.build_histogram_plain(bins, gh.abs(), rows, seg,
                                             n_nodes, nbt)
        # the f32 sums' own rounding sets the tolerance: a node total adds
        # up to N / 32 values (the dequantised sums are the closer ones)
        ok = (((dk - hp).abs() <= 1e-4 * habs).all()
              and ((dtk - tp).abs() <= 1e-4 * tabs).all())
        check(bool(ok), f"K1 ({what}) dequantised beyond 1e-4 x sum|gh| of "
                        f"the f32 sums (max err {err})")
    return err, 0.0


def phase_kernels(n, records):
    import torch

    from xgboost_ray_tpu_torch.ops import histogram as H
    from xgboost_ray_tpu_torch.ops import objectives as O
    from xgboost_ray_tpu_torch.ops import split as S

    f, nbt, n_nodes = 28, 257, 32
    p = S.SplitParams()
    res = {}
    for integer_gh in (True, False):
        tag = "int" if integer_gh else "rand"
        bins, gh, order, seg = level_inputs(n, f, n_nodes, 7 if integer_gh else 8,
                                            integer_gh)
        # K1: int64 sums bitwise against the fixed-point plain version, the
        # dequantise kernel bitwise against its plain version; the
        # dequantised sums against the f32 plain sums (exact with integer
        # gh, within 1e-4 x sum|gh| with random gh)
        qs = H.quant_scales(gh, n)
        err1, err1d = hold_k1(bins, gh, order, seg, n_nodes, nbt, qs,
                              integer_gh, "level 5")
        hp, tp = H.build_histogram_plain(bins, gh, order, seg, n_nodes, nbt)
        # K1 at the root: one node, identity order (the heaviest launch of
        # the main path). Integer gh here keeps |sum| < 2**24 over all rows
        # (g in -1..1, h in 0..1), so the f32 totals are exact too.
        ident = torch.arange(n, dtype=torch.int32, device="cuda")
        seg1 = torch.tensor([0, n], dtype=torch.int32, device="cuda")
        gh1 = (torch.stack([torch.remainder(gh[:, 0], 3) - 1,
                            torch.remainder(gh[:, 1], 2)], 1).contiguous()
               if integer_gh else gh)
        qs1 = H.quant_scales(gh1, n)
        err1r, _ = hold_k1(bins, gh1, ident, seg1, 1, nbt, qs1, integer_gh,
                           "root")
        # K2 on one histogram (the plain one) through both
        sk = S.find_splits(hp, p)
        sp = S.find_splits_plain(hp, p)
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(sk, k), getattr(sp, k))
                   for k in ("feature", "split_bin", "default_left", "valid"))
        err2 = float(torch.nan_to_num((sk.gain - sp.gain).abs(), 0.0).max())
        err2 = max(err2, float((sk.node_gh - sp.node_gh).abs().max()))
        if integer_gh:
            check(same and err2 == 0.0,
                  f"K2 not bitwise with integer gh (gain err {err2})")
        else:
            check(same, "K2 split choice differs from the plain version")
            check(err2 <= 1e-4 * float(sp.gain.abs().max()) + 1e-6,
                  f"K2 gain beyond tolerance ({err2})")
        # K2's level step at level 5: 16 parents (two level-5 histograms
        # each), their smaller children, 32 nodes formed (a few inactive),
        # records written and the formed histogram kept
        g2 = torch.Generator(device="cuda").manual_seed(17)
        level = dict(
            hist=hp[0::2].contiguous(), prev_hist=hp[0::2] + hp[1::2],
            small_is_right=torch.rand(16, generator=g2, device="cuda") < 0.5,
            active=torch.arange(32, device="cuda") % 13 != 5)
        cuts = torch.sort(torch.randn(f, nbt - 2, generator=g2, device="cuda"),
                          dim=1).values
        fhm = torch.arange(f, device="cuda") % 3 != 0
        from xgboost_ray_tpu_torch.ops.grow import empty_tree
        rec_k = S.TreeRecords(empty_tree(127, "cuda"), cuts, fhm, p)
        rec_p = S.TreeRecords(empty_tree(127, "cuda"), cuts, fhm, p)
        lk = S.split_level(**level, rec=rec_k)
        lp = S.split_level_plain(**level, rec=rec_p)
        torch.cuda.synchronize()
        level_out = ([(getattr(lk.splits, k), getattr(lp.splits, k))
                      for k in lk.splits._fields]
                     + [(getattr(lk, k), getattr(lp, k))
                        for k in ("node_value", "state", "active", "hist")]
                     + list(zip(rec_k.tree, rec_p.tree)))
        check(all(torch.equal(bits(a), bits(b)) for a, b in level_out),
              "K2 level step not bitwise equal to its plain version")
        err2l = float((lk.hist - lp.hist).abs().max())
        # K2's final-level records: 64 nodes, a few inactive
        gh64 = torch.stack([torch.randn(64, generator=g2, device="cuda") * 40,
                            torch.rand(64, generator=g2, device="cuda") * 90], 1)
        act64 = torch.arange(64, device="cuda") % 7 != 3
        rec64_k = S.TreeRecords(empty_tree(127, "cuda"), cuts, fhm, p)
        rec64_p = S.TreeRecords(empty_tree(127, "cuda"), cuts, fhm, p)
        leaf_k = S.leaf_records(gh64, act64, rec64_k)
        leaf_p = S.leaf_records_plain(gh64, act64, rec64_p)
        torch.cuda.synchronize()
        check(all(torch.equal(bits(a), bits(b)) for a, b in
                  list(zip(leaf_k, leaf_p)) + list(zip(rec64_k.tree, rec64_p.tree))),
              "K2 leaf records not bitwise equal to their plain version")
        # K3 with a mix of splitting, new-leaf and inactive nodes
        gen = torch.Generator(device="cuda").manual_seed(11)
        feature = torch.randint(0, f, (n_nodes,), generator=gen,
                                device="cuda", dtype=torch.int32)
        sbin = torch.randint(0, 255, (n_nodes,), generator=gen, device="cuda",
                             dtype=torch.int32)
        dl = torch.rand(n_nodes, generator=gen, device="cuda") < 0.5
        state = torch.full((n_nodes,), H.SPLIT, dtype=torch.uint8, device="cuda")
        state[::7] = H.LEAF
        state[3::11] = H.INACTIVE
        nval = torch.randn(n_nodes, generator=gen, device="cuda")
        rvk = torch.zeros(n, device="cuda")
        rvp = torch.zeros(n, device="cuda")
        pk = H.partition_level(order, seg, bins, feature, sbin, dl, state,
                               nval, rvk, True, 256)
        pp = H.partition_level_plain(order, seg, bins, feature, sbin, dl,
                                     state, nval, rvp, True, 256)
        torch.cuda.synchronize()
        m = int(pp.small_seg[-1])
        check(torch.equal(pk.order, pp.order) and torch.equal(pk.seg, pp.seg)
              and torch.equal(pk.small_seg, pp.small_seg)
              and torch.equal(pk.small_is_right, pp.small_is_right)
              and torch.equal(pk.small_rows[:m], pp.small_rows[:m])
              and torch.equal(rvk, rvp), "K3 differs from the plain version")
        # K3 above one rank: the smaller child chosen from the children's
        # counts merged with a second rank's (here each child's count plus
        # twice its sibling's, which turns most choices round), compacted
        # into N slots
        def merge(c):
            return c + 2 * c.view(-1, 2).flip(1).reshape(-1)

        pk = H.partition_level(order, seg, bins, feature, sbin, dl, state,
                               nval, rvk, True, 256, merge_counts=merge)
        pp = H.partition_level_plain(order, seg, bins, feature, sbin, dl,
                                     state, nval, rvp, True, 256,
                                     merge_counts=merge)
        torch.cuda.synchronize()
        mw = int(pp.small_seg[-1])
        check(mw > n // 2 and pk.small_rows.shape == (n,),
              f"K3's merged choice packed {mw} of {n} rows in "
              f"{pk.small_rows.shape[0]} slots")
        check(torch.equal(pk.order, pp.order) and torch.equal(pk.seg, pp.seg)
              and torch.equal(pk.small_seg, pp.small_seg)
              and torch.equal(pk.small_is_right, pp.small_is_right)
              and torch.equal(pk.small_rows[:mw], pp.small_rows[:mw])
              and torch.equal(rvk, rvp),
              "K3 with merged counts differs from the plain version")
        # K3 leaf-value mode at the final level of a depth-6 tree: 64 nodes,
        # every row moves nowhere, rows of LEAF nodes take the node's value
        node64 = torch.randint(0, 64, (n,), generator=gen, device="cuda")
        order64 = torch.sort(node64, stable=True).indices.to(torch.int32)
        seg64 = torch.cat([torch.zeros(1, dtype=torch.int32, device="cuda"),
                           torch.cumsum(torch.bincount(node64, minlength=64),
                                        0).to(torch.int32)])
        del node64
        state64 = torch.full((64,), H.LEAF, dtype=torch.uint8, device="cuda")
        state64[5::9] = H.INACTIVE
        nval64 = torch.randn(64, generator=gen, device="cuda")
        rvk.zero_()
        rvp.zero_()
        H.partition_leaf_values(order64, seg64, state64, nval64, rvk)
        H.partition_leaf_values_plain(order64, seg64, state64, nval64, rvp)
        torch.cuda.synchronize()
        check(torch.equal(rvk, rvp), "K3 leaf mode differs from the plain version")
        # K4
        gen = torch.Generator(device="cuda").manual_seed(13)
        margin = torch.randn(n, generator=gen, device="cuda") * 2
        rv = torch.randn(n, generator=gen, device="cuda") * 0.1
        label = (torch.rand(n, generator=gen, device="cuda") > 0.5).float()
        weight = torch.ones(n, device="cuda")
        mk, mp = margin.clone(), margin.clone()
        ghk, sk4 = O.round_update(mk, rv, label, weight, True)
        ghp, sp4 = O.round_update_plain(mp, rv, label, weight, True)
        torch.cuda.synchronize()
        err4 = float((ghk - ghp).abs().max())
        ulps4 = int((bits(ghk).long() - bits(ghp).long()).abs().max())
        check(torch.equal(bits(mk), bits(mp)), "K4 margin update differs")
        if hasattr(O, "k4_plan"):  # the CUDA K4: bitwise its plain version
            check(ulps4 == 0, f"K4 gradients {ulps4} ulps from the plain "
                              f"version's")
        else:  # an older tree's Triton K4
            check(err4 <= 1e-6, f"K4 gradients beyond 1e-6 ({err4})")
        rel = float(((sk4 - sp4).abs() / sp4.abs().clamp(min=1e-12)).max())
        check(rel <= 1e-5, f"K4 metric sums beyond 1e-5 relative ({rel})")
        res[tag] = {"K1": err1, "K1root": err1r, "K1deq": err1d, "K2": err2,
                    "K2level": err2l, "K2leaf": 0.0, "K3": 0.0,
                    "K3leaf": 0.0, "K4": err4}
        emit({"phase": "kernel_vs_plain", "gh": tag, "max_abs_err": res[tag],
              "k4_gradient_ulps": ulps4, "k4_partials_rel": rel})

        if integer_gh:
            continue
        # timings on the random-gh inputs (main-path shapes)
        t = {}
        t["K1"] = (cuda_ms(lambda: H.build_histogram(bins, gh, order, seg,
                                                     n_nodes, nbt, qscale=qs)),
                   cuda_ms(lambda: H.build_histogram_fixed_plain(
                       bins, gh, order, seg, n_nodes, nbt, qs), iters=3))
        # yardstick: one int64 index_add_ of the quantised rows (the
        # quantisation and the bucket ids precomputed)
        flat = H.flat_bucket_ids(bins, order, seg, n_nodes, nbt)
        src = H.fixed_point_gh(gh[order.long()], qs)[:, None, :].expand(
            n, f, 2).reshape(-1, 2)
        out = torch.zeros((n_nodes * f * nbt, 2), dtype=torch.int64,
                          device="cuda")
        lib_k1 = cuda_ms(lambda: out.index_add_(0, flat, src), iters=3)
        del flat, src, out
        t["K1root"] = (cuda_ms(lambda: H.build_histogram(bins, gh, ident, seg1,
                                                         1, nbt, qscale=qs)),
                       cuda_ms(lambda: H.build_histogram_fixed_plain(
                           bins, gh, ident, seg1, 1, nbt, qs), iters=3))
        flat = H.flat_bucket_ids(bins, ident, seg1, 1, nbt)
        src = H.fixed_point_gh(gh, qs)[:, None, :].expand(n, f, 2).reshape(-1, 2)
        out1 = torch.zeros((f * nbt, 2), dtype=torch.int64, device="cuda")
        lib_k1root = cuda_ms(lambda: out1.index_add_(0, flat, src), iters=3)
        del flat, src, out1
        # the dequantise step at level 5's shape: the 16 parents' smaller
        # children (the main path's largest); yardstick: int64 * f32 in one
        # PyTorch call (type promotion: float(sum) * 2^-e)
        h16 = H.build_histogram(bins, gh, order, seg, n_nodes, nbt,
                                qscale=qs)[0][:16].contiguous()
        inv = qs[2:]
        t["K1deq"] = (cuda_ms(lambda: H.dequantize(h16, qs), iters=50),
                      cuda_ms(lambda: H.dequantize_plain(h16, qs), iters=10))
        lib_k1deq = cuda_ms(lambda: torch.mul(h16, inv), iters=50)
        t["K2"] = (cuda_ms(lambda: S.find_splits(hp, p)),
                   cuda_ms(lambda: S.find_splits_plain(hp, p), iters=3))
        t["K2level"] = (cuda_ms(lambda: S.split_level(**level, rec=rec_k)),
                        cuda_ms(lambda: S.split_level_plain(**level, rec=rec_p),
                                iters=3))
        t["K2leaf"] = (cuda_ms(lambda: S.leaf_records(gh64, act64, rec64_k)),
                       cuda_ms(lambda: S.leaf_records_plain(gh64, act64,
                                                            rec64_p), iters=3))
        # the level step's host issue time: enqueue only, no synchronise
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            S.split_level(**level, rec=rec_k)
        k2_host_ms = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        t["K3"] = (cuda_ms(lambda: H.partition_level(
                       order, seg, bins, feature, sbin, dl, state, nval, rvk,
                       True, 256)),
                   cuda_ms(lambda: H.partition_level_plain(
                       order, seg, bins, feature, sbin, dl, state, nval, rvp,
                       True, 256), iters=3))
        t["K3leaf"] = (cuda_ms(lambda: H.partition_leaf_values(
                           order64, seg64, state64, nval64, rvk)),
                       cuda_ms(lambda: H.partition_leaf_values_plain(
                           order64, seg64, state64, nval64, rvp), iters=3))
        # yardstick for K3's partition core only (no routing, no
        # compaction): a stable sort of the precomputed child key
        # 2 * node + go_right
        node_of_pos = H._node_of_slot(seg, n_nodes)
        pb = bins[order.long(), feature.long()[node_of_pos]].long()
        from xgboost_ray_tpu_torch.ops.grow import route_right_binned
        go = route_right_binned(pb, sbin[node_of_pos], dl[node_of_pos], 256)
        go &= state[node_of_pos] == H.SPLIT
        key = (2 * node_of_pos + go.long()).to(torch.int32)
        del node_of_pos, pb, go
        lib_k3 = cuda_ms(lambda: torch.sort(key, stable=True), iters=10)
        del key
        # K3 where every row is routed but rows are read in id order (the
        # root, one splitting node): how much of K3 the gather's locality is
        root_nodes = [torch.tensor([v], dtype=dt, device="cuda") for v, dt in
                      ((0, torch.int32), (127, torch.int32), (True, torch.bool),
                       (H.SPLIT, torch.uint8), (0.0, torch.float32))]
        k3_root_ms = cuda_ms(lambda: H.partition_level(
            ident, seg1, bins, *root_nodes, rvk, True, 256))
        dev_ms = {
            "K1": device_ms(lambda: H.build_histogram(bins, gh, order, seg,
                                                      n_nodes, nbt, qscale=qs)),
            "K1root": device_ms(lambda: H.build_histogram(bins, gh, ident,
                                                          seg1, 1, nbt,
                                                          qscale=qs)),
            "K1deq": device_ms(lambda: H.dequantize(h16, qs), iters=50),
            "K2": device_ms(lambda: S.find_splits(hp, p)),
            "K2level": device_ms(lambda: S.split_level(**level, rec=rec_k)),
            "K2leaf": device_ms(lambda: S.leaf_records(gh64, act64, rec64_k)),
            "K3": device_ms(lambda: H.partition_level(
                order, seg, bins, feature, sbin, dl, state, nval, rvk, True,
                256)),
            "K3leaf": device_ms(lambda: H.partition_leaf_values(
                order64, seg64, state64, nval64, rvk)),
        }
        # K4 with the L2 flushed by a write (device_ms); its host time a
        # call is taken last, below
        k4 = lambda: O.round_update(mk, rv, label, weight, True)  # noqa: E731
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        dev_ms["K4"] = profiled_ms(lambda: (flush.zero_(), k4()))
        k4_more = {"gradient_ulps": ulps4, "partials_rel": rel}
        del flush
        emit({"phase": "kernel_context", "k3_root_ms": k3_root_ms,
              "k3_level5_ms": t["K3"][0],
              "k2_level5_host_issue_ms": k2_host_ms,
              "k2_level5_event_ms": t["K2level"][0],
              "k2_level5_device_ms": dev_ms["K2level"]})
        t["K4"] = (cuda_ms(lambda: O.round_update(mk, rv, label, weight, True)),
                   cuda_ms(lambda: O.round_update_plain(mp, rv, label, weight,
                                                       True), iters=3))
        n_leaf_rows = int(sum(int(seg[k + 1] - seg[k])
                              for k in range(n_nodes) if int(state[k]) == H.LEAF))
        n_leaf64 = int(sum(int(seg64[k + 1] - seg64[k])
                           for k in range(64) if int(state64[k]) == H.LEAF))
        hist_bytes = n_nodes * f * nbt * 2 * 4
        cells16 = 16 * f * nbt * 2
        bounds = {
            # bins + rows + gh read once, the int64 histogram and totals
            # written once; an add per (row, feature) and plane, a multiply
            # and a conversion per row and plane
            "K1": bound_ms(n * f * 2 + n * 4 + n * 8 + 2 * hist_bytes
                           + n_nodes * 16, 2 * n * f + 4 * n),
            "K1root": bound_ms(n * f * 2 + n * 4 + n * 8 + f * nbt * 2 * 8
                               + 16, 2 * n * f + 4 * n),
            # int64 sums read, f32 written; a conversion and a multiply each
            "K1deq": bound_ms(cells16 * (8 + 4), 2 * cells16),
            # histogram read once; prefix adds + ~30 flops per candidate
            "K2": bound_ms(hist_bytes, n_nodes * f * (2 * nbt + 30 * (nbt - 2))),
            # 16 parents' and 16 children's histograms read, 32 formed ones
            # written, a cut read and ~38 bytes of records and outputs per
            # node; the subtraction, prefix adds and candidates as for K2
            "K2level": bound_ms(2 * hist_bytes + 16 + 32 + 32 * (4 + 38),
                                n_nodes * f * (3 * nbt + 30 * (nbt - 2))),
            # totals and active read; value, state, 4 records written
            "K2leaf": bound_ms(64 * (8 + 1 + 4 + 1 + 13), 64 * 12),
            # order + one bin per row read, order + compacted list +
            # leaf values written
            "K3": bound_ms(n * 4 + n * 2 + n * 4 + m * 4 + n_leaf_rows * 4, n),
            # order read and row_value written for the rows of leaf nodes
            "K3leaf": bound_ms(n_leaf64 * 8, n_leaf64),
            # margin, row_value, label, weight read; margin, gh written
            "K4": bound_ms(n * 4 * 4 + n * 4 + n * 8, 60 * n),
        }
        library = {"K1": lib_k1, "K1root": lib_k1root, "K1deq": lib_k1deq,
                   "K3": lib_k3}
        for k in t:
            records[k].update(
                ms=t[k][0], device_ms=dev_ms[k], plain_ms=t[k][1],
                bound_ms=bounds[k][0], bound_by=bounds[k][1],
                library_ms=library.get(k))
        # last: its 1,000 calls change the margins K4 updates in place
        records["K4"].update(k4_more, host_us=host_call_us(k4))
        emit({"phase": "k4_gh_mode", **{k: records["K4"][k] for k in (
            "ms", "host_us", "device_ms", "plain_ms", "bound_ms",
            "gradient_ulps", "partials_rel")}})
    for k in records:
        records[k]["max_abs_err"] = max(res["int"][k], res["rand"][k])
    return res


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def train_expect(rounds, depth):
    """Launches of each training kernel in ``rounds`` rounds at ``depth``:
    per tree K1 at every level + the final totals, each dequantised once,
    K2's level step and the full K3 at every level, K2's final records and
    K3's leaf-value mode once (the final leaves); K4 once a round and once
    at set-up; K2's bare search is off the path; B4 and K4's eval mode only
    with a held-out eval set (``evals_expect``)."""
    return {"K1": rounds * (depth + 1), "K1deq": rounds * (depth + 1),
            "K2": 0, "K2level": rounds * depth,
            "K2leaf": rounds, "K3": rounds * depth, "K3leaf": rounds,
            "K4": rounds + 1, "B4": 0, "K4eval": 0, "SMX": 0, "SMXeval": 0,
            # quantized gradients and the quantized wire: off the path
            **dict.fromkeys(QUANT_COUNTERS[2:], 0)}


def check_launches(launches, expect, what):
    for k in expect:
        got = launches.get(k, 0)  # an older tree lacks the newer counters
        check(got > 0 or expect[k] == 0,
              f"{k} never launched on {what}")
        check(got == expect[k],
              f"{k} launched {launches[k]} times on {what}, expected "
              f"{expect[k]}")


def phase_main(x, y, rounds, depth, actors):
    import torch

    import xgboost_ray_tpu_torch as xrt

    params = {"objective": "binary:logistic",
              "eval_metric": ["logloss", "error"],
              "max_depth": depth, "max_bin": 256}
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.matrix import RayShardingMode, combine_data

    dm = xrt.RayDMatrix(x, y)
    evals_result, extra = {}, {}
    keep = _KeepEngine()
    reset_kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # card 0 named: on a host of several cards train() alone would spawn a
    # rank a card (phase_ranks' NCCL path); the main path folds onto one
    bst = xrt.train(params, dm, rounds, evals=[(dm, "train")],
                    evals_result=evals_result, additional_results=extra,
                    callbacks=[keep], device="cuda:0",
                    ray_params=xrt.RayParams(num_actors=actors))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    # the engine's margins are the shards concatenated in rank order: put
    # them back in row order (INTERLEAVED sharding)
    margins = keep.engine.get_margins()[:, 0]
    sizes = [len(range(r, x.shape[0], actors)) for r in range(actors)]
    margins = combine_data(RayShardingMode.INTERLEAVED,
                           np.split(margins, np.cumsum(sizes)[:-1]))
    del keep
    expect = train_expect(rounds, depth)
    ll = evals_result["train"]["logloss"]
    check(all(np.isfinite(ll)), f"non-finite train logloss {ll}")
    check(all(b < a for a, b in zip(ll, ll[1:])),
          f"train logloss does not fall every round: {ll}")
    check_launches(launches, expect, "the main path")
    check(bst.num_boosted_rounds() == rounds, "wrong number of trees")
    rt = [r * 1e3 for r in extra["round_times_s"]]
    emit({"phase": "main_path", "rows": int(x.shape[0]), "features": int(x.shape[1]),
          "max_depth": depth, "max_bin": 256, "rounds": rounds,
          "num_actors": actors, "launches": launches, "expected": expect,
          "train_logloss": ll, "train_error": evals_result["train"]["error"],
          "round_ms": rt, "round_ms_median": float(np.median(rt)),
          "setup_s": extra["setup_time_s"], "sketch_s": extra["sketch_time_s"],
          "train_wall_s": wall, "world_size": extra["world_size"],
          "allreduce_bytes_per_round": extra["allreduce_bytes_per_round"]})
    return bst, launches, rt, margins


def same_bits(a, b):
    """Two float32 host arrays equal bit for bit."""
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def phase_determinism(runs):
    """C1: the main-path config trained twice in this process (and once
    with its rows in two shards folded onto the card) gives the same dump
    and bitwise the same margins."""
    (b1, m1), (b2, m2), (b3, m3) = runs
    d1 = b1.get_dump()
    out = {"phase": "determinism", "runs": ["num_actors=1", "num_actors=1",
                                            "num_actors=2 (folded)"],
           "dump_equal_rerun": b2.get_dump() == d1,
           "margins_bitwise_rerun": same_bits(m2, m1),
           "dump_equal_two_shards": b3.get_dump() == d1,
           "margins_bitwise_two_shards": same_bits(m3, m1),
           "margin_max_abs_diff_rerun": float(np.abs(m2 - m1).max()),
           "margin_max_abs_diff_two_shards": float(np.abs(m3 - m1).max())}
    emit(out)
    check(out["dump_equal_rerun"] and out["margins_bitwise_rerun"],
          "training the main path twice gave different models or margins")
    check(out["dump_equal_two_shards"] and out["margins_bitwise_two_shards"],
          "num_actors=2 on one card gave another model or margins than 1")
    return out


def ranks_world(data, params, rounds, depth, backend, ref_dump, ref_margins):
    """``_train_rank`` in a 2-rank world over ``backend`` (each rank on its
    INTERLEAVED shard): the ranks' report, with each rank's kernel launches
    (set to 0 just before its ``train()``) checked exactly."""
    from xgboost_ray_tpu_torch import distributed as D
    from xgboost_ray_tpu_torch.matrix import RayShardingMode, combine_data
    from xgboost_ray_tpu_torch.models.booster import RayXGBoostBooster

    t0 = time.perf_counter()
    out = D.launch_world(D._train_rank, 2, "cuda", data, params, rounds,
                         backend=backend)
    wall = time.perf_counter() - t0
    margins = combine_data(RayShardingMode.INTERLEAVED,
                           [o["margins"] for o in out])
    extra = out[0]["additional_results"]
    rt = [r * 1e3 for r in extra["round_times_s"]]
    expect = train_expect(rounds, depth)
    res = {"world_size": extra["world_size"], "backend": extra["backend"],
           "allreduce_bytes_per_round": extra["allreduce_bytes_per_round"],
           "round_ms": rt, "round_ms_median": float(np.median(rt)),
           "round_ms_median_rank1": float(np.median(
               [r * 1e3 for r in out[1]["additional_results"]["round_times_s"]])),
           "setup_s": extra["setup_time_s"],
           "launch_and_train_wall_s": wall,
           "train_logloss": out[0]["evals_result"]["train"]["logloss"],
           "launches": [o["launches"] for o in out], "expected": expect,
           "dumps_equal_one_rank": [
               RayXGBoostBooster.load_raw(o["model"]).get_dump() == ref_dump
               for o in out],
           "margins_bitwise_one_rank": same_bits(margins, ref_margins)}
    check(res["world_size"] == 2 and res["backend"] == backend,
          f"the ranks ran as {res['world_size']} over {res['backend']}")
    for r, o in enumerate(out):
        check_launches(o["launches"], expect, f"rank {r} over {backend}")
    check(all(res["dumps_equal_one_rank"]),
          f"a rank's model over {backend} differs from the 1-rank model")
    check(res["margins_bitwise_one_rank"],
          f"the 2-rank margins over {backend} are not bitwise the 1-rank "
          f"margins")
    return res


def phase_ranks(x, y, rounds, depth, ref_bst, ref_margins):
    """A6 on the card at full width: two ranks in one gloo world sharing
    the card (int64 CUDA all-reduces), each on its INTERLEAVED shard, give
    the 1-rank model and margins bit for bit, each rank's kernels launched
    as on the main path. Where there are two or more cards the same runs
    over NCCL, a card a rank, and ``train`` alone (no device named) spawns
    its NCCL ranks; with one card the NCCL path is reported as not run."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch import distributed as D

    params = {"objective": "binary:logistic",
              "eval_metric": ["logloss", "error"],
              "max_depth": depth, "max_bin": 256}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    data = D.share({"x": x, "label": y})
    share_s = time.perf_counter() - t0
    ref_dump = ref_bst.get_dump()
    res = {"phase": "ranks", "rows": int(x.shape[0]), "rounds": rounds,
           "share_s": share_s,
           **ranks_world(data, params, rounds, depth, "gloo", ref_dump,
                         ref_margins)}
    cards = torch.cuda.device_count()
    if cards >= 2:
        nccl = ranks_world(data, params, rounds, depth, "nccl", ref_dump,
                           ref_margins)
        ev, extra = {}, {}
        dm = xrt.RayDMatrix(x, y)
        bst = xrt.train(params, dm, rounds, evals=[(dm, "train")],
                        evals_result=ev, additional_results=extra,
                        ray_params=xrt.RayParams(num_actors=2))
        nccl["train_alone"] = {
            "world_size": extra["world_size"], "backend": extra["backend"],
            "dump_equal_one_rank": bst.get_dump() == ref_dump,
            "round_ms_median": float(np.median(extra["round_times_s"])) * 1e3}
        res["nccl"] = nccl
        check(nccl["train_alone"]["world_size"] == 2
              and nccl["train_alone"]["backend"] == "nccl"
              and nccl["train_alone"]["dump_equal_one_rank"],
              f"train() alone on {cards} cards: {nccl['train_alone']}")
    else:
        res["nccl"] = {"not_run": f"{cards} device"}
    del data
    emit(res)
    return res


def phase_profile(x, y, depth, round_ms, rounds=2):
    """Device busy time by kernel over ``rounds`` steady rounds of the main
    path (torch.profiler). The idle share is taken against ``round_ms``,
    the median round of the unprofiled run: the profiler slows the host
    side of a round, so its own wall time overstates the idle share (that
    figure is kept as ``device_idle_share_profiled``). A profile that stays
    blind (``profile_steps``) leaves the device figures None."""
    import torch

    import xgboost_ray_tpu_torch as xrt

    seen = {}

    class Keep:
        def after_iteration(self, engine, i, res):
            seen["engine"] = engine

    dm = xrt.RayDMatrix(x, y)
    xrt.train({"objective": "binary:logistic", "max_depth": depth}, dm, 1,
              evals=[(dm, "train")], callbacks=[Keep()],
              ray_params=xrt.RayParams(num_actors=1))
    engine = seen["engine"]
    prof, wall_ms = profile_steps(engine.step, 1, rounds)
    cuda = torch.autograd.DeviceType.CUDA
    kern = {}
    syncs = 0  # host waits on the card: scalar reads, stream/device syncs
    for e in (prof.key_averages() if prof else []):
        if e.key in ("aten::_local_scalar_dense", "cudaStreamSynchronize",
                     "cudaDeviceSynchronize", "cudaMemcpy"):
            syncs += e.count
        if e.device_type != cuda:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        kern[e.key] = (kern.get(e.key, (0.0, 0))[0] + t / 1e3,
                       kern.get(e.key, (0.0, 0))[1] + e.count)
    # K2's level step, device us per launch by tree level
    lvl = sorted((e.time_range.start, e.time_range.elapsed_us())
                 for e in (prof.events() if prof else [])
                 if e.device_type == cuda
                 and e.name.startswith("xrt_split_level_kernel"))
    by_level = ([float(np.mean([t for _, t in lvl[d::depth]]))
                 for d in range(depth)] if len(lvl) == rounds * depth else None)
    device_ms = sum(v[0] for v in kern.values())
    blind = prof is None
    launches = sum(v[1] for v in kern.values())
    kernels = sum(v[1] for k, v in kern.items()
                  if not k.startswith(("Memcpy", "Memset")))
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:20]
    out = {"phase": "profile", "rows": int(x.shape[0]), "rounds": rounds,
           "round_ms_unprofiled": round_ms,
           "device_ms_per_round": None if blind else device_ms / rounds,
           "cuda_launches_per_round": None if blind else launches / rounds,
           "kernel_launches_per_round": None if blind else kernels / rounds,
           "host_syncs_per_round": None if blind else syncs / rounds,
           "split_level_us_by_level": by_level,
           "device_idle_share": (None if round_ms is None or blind else
                                 max(0.0, 1.0 - device_ms / rounds / round_ms)),
           "wall_ms_per_round_profiled": wall_ms / rounds,
           "device_idle_share_profiled": (
               None if blind else max(0.0, 1.0 - device_ms / wall_ms)),
           "top_kernels_ms_per_round": [
               [k[:80], v[0] / rounds, v[1] / rounds] for k, v in top]}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 4: card against the CPU path
# ---------------------------------------------------------------------------


def phase_k1_time(n_rows, rounds):
    """K1's device time at level 5 and at the root, and the main path's
    median round, of the package this script is run beside."""
    import hashlib

    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.ops import histogram as H

    f, nbt = 28, 257
    out = {"phase": "k1_time", "package": os.path.dirname(xrt.__file__),
           "rows": n_rows}
    bins, gh, order, seg = level_inputs(n_rows, f, 32, 8, False)
    kw = {}
    if hasattr(H, "quant_scales"):
        qs = H.quant_scales(gh, n_rows)
        kw = {"qscale": qs}
        hk, tk = H.build_histogram(bins, gh, order, seg, 32, nbt, **kw)
        hq, tq = H.build_histogram_fixed_plain(bins, gh, order, seg, 32, nbt,
                                               qs)
        out["level5_bitwise"] = bool(torch.equal(hk, hq)
                                     and torch.equal(tk, tq))
        del hk, tk, hq, tq
    ident = torch.arange(n_rows, dtype=torch.int32, device="cuda")
    seg1 = torch.tensor([0, n_rows], dtype=torch.int32, device="cuda")
    out["k1_level5_device_ms"] = device_ms(lambda: H.build_histogram(
        bins, gh, order, seg, 32, nbt, **kw))
    out["k1_root_device_ms"] = device_ms(lambda: H.build_histogram(
        bins, gh, ident, seg1, 1, nbt, **kw))
    del bins, gh, order, seg, ident
    torch.cuda.empty_cache()
    x, y = make_higgs_like(n_rows, f, seed=0)
    dm = xrt.RayDMatrix(x, y)
    extra = {}
    bst = xrt.train({"objective": "binary:logistic",
                     "eval_metric": ["logloss"], "max_depth": 6,
                     "max_bin": 256}, dm, rounds, evals=[(dm, "train")],
                    additional_results=extra, device="cuda:0",
                    ray_params=xrt.RayParams(num_actors=1))
    rt = [r * 1e3 for r in extra["round_times_s"]]
    out.update(round_ms_median=float(np.median(rt)), round_ms=rt,
               dump_md5=hashlib.md5("".join(bst.get_dump()).encode())
               .hexdigest())
    emit(out)


def phase_cpu_vs_card(x, y, rounds=3):
    """The main path's configuration on a slice, on the card and on the CPU
    twice: with the f32 sums of the JAX package (the first tree equal,
    logloss within 1e-5, margins within 1e-3) and summing in the card's
    fixed point (``_cpu_fixed_point``), where the card's model must be the
    CPU's: dumps equal, final margins bitwise."""
    import xgboost_ray_tpu_torch as xrt

    params = {"objective": "binary:logistic", "eval_metric": ["logloss"]}
    out = {}
    for device, fixed in (("cuda", False), ("cpu", False), ("cpu", True)):
        seen = {}

        class Keep:
            def after_iteration(self, engine, i, res):
                seen["engine"] = engine

        dm = xrt.RayDMatrix(x, y)
        ev = {}
        with _cpu_fixed_point(fixed):
            bst = xrt.train(params, dm, rounds, evals=[(dm, "train")],
                            evals_result=ev, device=device,
                            callbacks=[Keep()],
                            ray_params=xrt.RayParams(num_actors=1))
        out[device, fixed] = (bst, ev["train"]["logloss"],
                              seen["engine"].get_margins()[:, 0])
    (bg, llg, mg), (bc, llc, mc) = out["cuda", False], out["cpu", False]
    bx, llx, mx = out["cpu", True]
    fixed_point = {"dump_equal": bg.get_dump() == bx.get_dump(),
                   "margins_bitwise": same_bits(mg, mx),
                   "logloss_cpu_fixed_point": llx,
                   "logloss_max_abs_diff": float(np.max(np.abs(
                       np.array(llg) - np.array(llx)))),
                   "margin_max_abs_diff": float(np.max(np.abs(mg - mx)))}
    fields = ("feature", "split_bin", "default_left", "is_leaf")
    diff = [k for k in fields
            if not np.array_equal(getattr(bg.forest, k)[0], getattr(bc.forest, k)[0])]
    if diff:
        nodes = np.nonzero(bg.forest.feature[0] != bc.forest.feature[0])[0]
        emit({"phase": "cpu_vs_card", "first_tree_differs": diff,
              "nodes": nodes.tolist(),
              "gain_card": bg.forest.gain[0][nodes].tolist(),
              "gain_cpu": bc.forest.gain[0][nodes].tolist()})
    dll = float(np.max(np.abs(np.array(llg) - np.array(llc))))
    dm_ = float(np.max(np.abs(mg - mc)))
    emit({"phase": "cpu_vs_card", "rows": int(x.shape[0]), "rounds": rounds,
          "first_tree_equal": not diff, "logloss_max_abs_diff": dll,
          "margin_max_abs_diff": dm_, "logloss_card": llg, "logloss_cpu": llc,
          "cpu_fixed_point": fixed_point})
    check(not diff, f"first tree differs between card and CPU in {diff}")
    check(dll <= 1e-5, f"per-round logloss differs by {dll} > 1e-5")
    check(dm_ <= 1e-3, f"final margins differ by {dm_} > 1e-3")
    check(fixed_point["dump_equal"] and fixed_point["margins_bitwise"],
          f"the card's model is not the CPU path's summing in the card's "
          f"fixed point: {fixed_point}")
    return {"logloss": dll, "margin": dm_, "cpu_fixed_point": fixed_point}


def phase_save_load(bst):
    import xgboost_ray_tpu_torch as xrt

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "chip_smoke_model.json")
    bst.save_model(path)
    back = xrt.RayXGBoostBooster.load_model(path)
    os.remove(path)
    same = back.save_raw() == bst.save_raw()
    emit({"phase": "save_load", "save_raw_equal": same})
    check(same, "save_raw bytes differ after save_model/load_model")


# ---------------------------------------------------------------------------
# phase 6: predict and serve
# ---------------------------------------------------------------------------


#: B8's launch counters by (layout, mapping): the kernel table's rows
B8_PLAN_ROWS = {("heap", "rows"): "B8margin", ("node_array", "rows"):
                "B8margin_na", ("heap", "windows"): "B8serve",
                ("node_array", "windows"): "B8serve_na"}


def b8_counters():
    """B8's launch counts: margins (and values) by layout and mapping, leaf
    indices of the heap's rows mapping (each a kernel table row; the serve
    rows read the heap's windows launches), values alone, and every other
    launch (``B8other``: leaf indices of another plan)."""
    from xgboost_ray_tpu_torch.ops import predict as PR

    m, leaf = PR.predict_margin, PR.predict_leaf_index
    out = {key: m.launches_by_plan[plan]
           for plan, key in B8_PLAN_ROWS.items()}
    out["B8leaf"] = leaf.launches_by_plan["heap", "rows"]
    out["B8other"] = m.launches + leaf.launches - sum(out.values())
    out["B8value"] = m.launches_by_mode["value"]
    # the softmax pass's transform mode after B8 (K-output values; absent
    # in a tree of the package from before it)
    out["SMXtransform"] = getattr(_softmax_transform(), "launches", 0)
    return out


def _softmax_transform():
    from xgboost_ray_tpu_torch.ops import objectives as O

    return getattr(O, "softmax_transform", None)


def reset_b8_counters():
    from xgboost_ray_tpu_torch.ops import predict as PR

    for fn in (PR.predict_margin, PR.predict_leaf_index):
        fn.launches = 0
        fn.launches_by_layout = dict.fromkeys(PR.LAYOUTS, 0)
        fn.launches_by_plan = dict.fromkeys(PR.PLANS, 0)
    PR.predict_margin.launches_by_mode = dict.fromkeys(("margin", "value"), 0)
    if hasattr(PR.predict_margin, "launches_by_value_fn"):  # not in an older
        PR.predict_margin.launches_by_value_fn = dict.fromkeys(
            PR.predict_margin.launches_by_value_fn, 0)
    if _softmax_transform() is not None:
        _softmax_transform().launches = 0


def b8_expect(**counts):
    """B8's counters (and the softmax transform's) all 0 but ``counts``."""
    return {**dict.fromkeys((*B8_PLAN_ROWS.values(), "B8leaf", "B8other",
                             "B8value", "SMXtransform"), 0), **counts}


def logloss_of_values(p, y):
    p = np.asarray(p, np.float64)
    y = np.asarray(y, np.float64)
    return float(-np.mean(y * np.log(p) + (1.0 - y) * np.log1p(-p)))


def phase_train_model(x, y, rounds):
    """The served model: ``train()`` for ``rounds`` rounds, keeping the
    engine's final margins (the after_iteration hook of the last round)."""
    import torch

    import xgboost_ray_tpu_torch as xrt

    kept = {}

    class KeepMargins:
        def after_iteration(self, engine, i, res):
            if i == rounds - 1:
                kept["margin"] = engine.get_margins()[:, 0]

    dm = xrt.RayDMatrix(x, y)
    ev, extra = {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = xrt.train({"objective": "binary:logistic", "eval_metric": ["logloss"],
                     "max_depth": 6, "max_bin": 256}, dm, rounds,
                    evals=[(dm, "train")], evals_result=ev,
                    additional_results=extra, callbacks=[KeepMargins()],
                    ray_params=xrt.RayParams(num_actors=1))
    torch.cuda.synchronize()
    ll = ev["train"]["logloss"]
    check(bst.num_trees == rounds, "wrong number of trees")
    check(all(np.isfinite(ll)), "non-finite train logloss")
    rt = [r * 1e3 for r in extra["round_times_s"]]
    emit({"phase": "served_model", "rows": int(x.shape[0]), "rounds": rounds,
          "train_wall_s": time.perf_counter() - t0,
          "round_ms_median": float(np.median(rt)),
          "train_logloss_first_last": [ll[0], ll[-1]]})
    return bst, kept["margin"], ll[-1]


def predict_chunks(bst, n_rows, row_bytes):
    """B8 launches of one ``RayXGBoostBooster.predict`` over ``n_rows``
    rows: one per device chunk."""
    return len(list(bst._chunks(n_rows, row_bytes)))


def phase_predict(bst, x, y, train_margin, last_ll):
    """``predict()`` over every row on the card (two ranks), checked
    against training's margins and logloss; B8's counters are set to 0
    just before the two calls and read just after."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.ops.objectives import sigmoid

    n, f = x.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xd = torch.from_numpy(x).to("cuda")
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    del xd
    rp = xrt.RayParams(num_actors=2)
    dm = xrt.RayDMatrix(x)
    t0 = time.perf_counter()
    dm.load_data(2)  # the loader's share of predict(), timed apart
    load_s = time.perf_counter() - t0
    reset_b8_counters()
    t0 = time.perf_counter()
    margin = xrt.predict(bst, dm, ray_params=rp, output_margin=True)
    margin_s = time.perf_counter() - t0
    del dm
    t0 = time.perf_counter()
    value = xrt.predict(bst, xrt.RayDMatrix(x), ray_params=rp)
    value_s = time.perf_counter() - t0
    launches = b8_counters()
    chunks = predict_chunks(bst, n, 4 * (f + 2 * bst.num_outputs))
    # every row goes through the rows mapping; the values through the
    # kernel's fused sigmoid
    expect = b8_expect(B8margin=2 * chunks, B8value=chunks)
    check(margin.shape == (n,) and value.shape == (n,),
          "predict returned the wrong shape")
    check(bool(np.isfinite(margin).all()), "non-finite predicted margins")
    diff = np.abs(margin.astype(np.float64) - train_margin.astype(np.float64))
    n_over = int((diff > 1e-3).sum())
    ll = logloss_of_values(value, y)
    same_values = bool(np.array_equal(
        value, sigmoid(torch.from_numpy(margin)[:, None])[:, 0].numpy()))
    out = {"phase": "predict", "rows": int(n),
           "trees": bst.num_trees, "num_actors": 2,
           "predict_value_wall_s": value_s, "matrix_load_s": load_s,
           "predict_margin_wall_after_load_s": margin_s,
           "h2d_copy_s": h2d_s, "rows_over_1e-3": n_over,
           "max_abs_margin_diff_vs_training": float(diff.max()),
           "logloss_predicted": ll, "train_logloss_last": last_ll,
           "logloss_abs_diff": abs(ll - last_ll),
           "values_are_sigmoid_of_margins": same_values,
           "b8_launches": launches, "b8_launches_expected": expect}
    emit(out)
    check(n_over == 0, f"{n_over} rows' predicted margins differ from "
                       f"training's by more than 1e-3 (max {diff.max()})")
    check(abs(ll - last_ll) <= 1e-5,
          f"predicted logloss {ll} vs last train-logloss {last_ll}")
    check(same_values, "values are not the sigmoid of the margins")
    check(launches == expect, f"B8 launches of predict(): {launches}, "
                              f"expected {expect} (one per chunk and call)")
    return out


def phase_predict_leaf(bst, x):
    """``predict(..., pred_leaf=True)`` over two of the booster's leaf
    chunks (two ranks); B8's counters set to 0 just before, read just
    after. Checked against the plain walk on the CPU on the first rows."""
    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.models import booster as B

    f = x.shape[1]
    row_bytes = 4 * (f + bst.num_trees)
    chunk = max(1, B._CHUNK_BYTES // row_bytes)
    n = min(x.shape[0], 2 * chunk)
    xs = x[:n]
    dm = xrt.RayDMatrix(xs)
    dm.load_data(2)
    reset_b8_counters()
    t0 = time.perf_counter()
    leaf = xrt.predict(bst, dm, ray_params=xrt.RayParams(num_actors=2),
                       pred_leaf=True)
    wall_s = time.perf_counter() - t0
    launches = b8_counters()
    del dm
    expect = b8_expect(B8leaf=predict_chunks(bst, n, row_bytes))
    ref = bst.predict(xs[:4096], pred_leaf=True, device="cpu")
    same = bool(leaf.shape == (n, bst.num_trees) and leaf.dtype == np.int32
                and np.array_equal(leaf[:4096], ref))
    del leaf
    out = {"phase": "predict_leaf", "rows": int(n), "trees": bst.num_trees,
           "chunk_rows": chunk, "num_actors": 2, "wall_s": wall_s,
           "first_4096_rows_equal_plain_cpu": same,
           "b8_launches": launches, "b8_launches_expected": expect}
    emit(out)
    check(same, "predict(pred_leaf=True) differs from the plain CPU walk")
    check(launches == expect, f"B8 launches of predict(pred_leaf=True): "
                              f"{launches}, expected {expect}")
    return out


def _post_json(url, doc, timeout=30.0):
    import urllib.request

    req = urllib.request.Request(url, json.dumps(doc).encode("utf-8"),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _probe(handle, bst, q):
    """Every served kind of ``q`` against ``booster.predict`` on the card
    and against the plain walk on the CPU, bitwise."""
    ok = {}
    for kind, kw in (("value", {}), ("margin", {"output_margin": True}),
                     ("leaf", {"pred_leaf": True})):
        r = _post_json(handle.url + "/predict",
                       {"data": q.tolist(), "kind": kind})
        for where, dev in (("card", None), ("cpu", "cpu")):
            ref = bst.predict(q, device=dev, **kw)
            got = np.asarray(r["predictions"], ref.dtype)
            ok[f"{kind}_{where}"] = bool(got.shape == ref.shape
                                         and np.array_equal(got, ref))
    return ok


def _closed_loop(handle, x, clients, req_rows_max, warm_s, duration_s,
                 mid=None):
    """``clients`` threads send 1-``req_rows_max``-row value requests to
    ``handle``. After ``warm_s`` the clients are parked until every request
    is answered; the serve metrics and B8's counters are set to 0 and the
    clients resume for ``duration_s``, then are parked again and the
    counters read: every launch of the window is one of its batches.
    ``mid``, where given, is called half-way through the window. Returns
    (snapshot at the end of the window, snapshot once parked, launches,
    client errors)."""
    import threading
    import urllib.request

    n_rows = x.shape[0]
    stop = threading.Event()
    go = threading.Event()
    go.set()
    parked = threading.Semaphore(0)
    errors = []

    def client(seed):
        rng = np.random.RandomState(seed)
        while not stop.is_set():
            if not go.is_set():
                parked.release()
                go.wait()
                continue
            n = int(rng.randint(1, req_rows_max + 1))
            lo = int(rng.randint(0, n_rows - n))
            body = json.dumps({"data": x[lo:lo + n].tolist()}).encode()
            req = urllib.request.Request(
                handle.url + "/predict", body,
                {"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=30.0) as r:
                    r.read()
            except Exception as exc:  # noqa: BLE001 - counted
                errors.append(repr(exc))

    def park():
        go.clear()
        for _ in range(clients):
            check(parked.acquire(timeout=60.0), "a serve client hung")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    try:
        for t in threads:
            t.start()
        time.sleep(warm_s)
        park()
        handle.metrics.reset()
        reset_b8_counters()
        del errors[:]
        go.set()
        if mid is not None:
            time.sleep(duration_s / 2)
            mid()
            time.sleep(duration_s / 2)
        else:
            time.sleep(duration_s)
        snap = handle.metrics.snapshot()
        park()
        parked_snap = handle.metrics.snapshot()
        launches = b8_counters()
    finally:
        stop.set()
        go.set()
        for t in threads:
            t.join(10.0)
    return snap, parked_snap, launches, errors


def phase_serve(bst, x, layout="heap", clients=16, max_batch=256,
                max_delay_ms=2.0, req_rows_max=32, warm_s=1.5,
                duration_s=6.0):
    """The closed loop of ``bench.py``'s serve section on the card, for a
    server of the given forest layout."""
    from xgboost_ray_tpu_torch import serve

    handle = serve.create_server(bst, max_batch=max_batch,
                                 max_delay_ms=max_delay_ms, layout=layout)
    builds_after_warmup = serve.compile_count()
    try:
        probe = _probe(handle, bst, x[:37])
        snap, parked, launches, errors = _closed_loop(
            handle, x, clients, req_rows_max, warm_s, duration_s)
        builds = serve.compile_count() - builds_after_warmup
        batch_device_ms = None
        if layout == "heap":
            with handle.registry.lease() as entry:
                q32 = x[:32]
                batch_device_ms = device_ms(
                    lambda: entry.predictor.predict(q32, "value"), iters=20)
        probe_after = _probe(handle, bst, x[37:74])
    finally:
        handle.shutdown()
    # every batch: one value launch (the sigmoid fused) of the windows
    # mapping in the server's layout
    expect = b8_expect(**{B8_PLAN_ROWS[layout, "windows"]: parked["batches"],
                          "B8value": parked["batches"]})
    out = {"phase": "serve", "layout": layout, "trees": bst.num_trees,
           "clients": clients, "max_batch": max_batch,
           "max_delay_ms": max_delay_ms, "req_rows_max": req_rows_max,
           "warm_s": warm_s, "duration_s": duration_s,
           "client_errors": len(errors), "errors_sample": errors[:3],
           "probe_bitwise": probe, "probe_bitwise_after_load": probe_after,
           "builds_after_warmup": builds,
           "b8_device_ms_per_batch_32_rows": batch_device_ms,
           "b8_launches": launches, "batches_once_parked": parked["batches"],
           **{k: snap[k] for k in (
               "requests", "rows", "errors", "qps", "rows_per_s", "batches",
               "mean_batch_rows", "padding_waste", "latency_p50_ms",
               "latency_p95_ms", "latency_p99_ms", "latency_mean_ms",
               "recompile_count")}}
    emit(out)
    check(len(errors) == 0, f"{len(errors)} client errors: {errors[:3]}")
    check(all(probe.values()) and all(probe_after.values()),
          f"served probes not bitwise equal to booster.predict and the "
          f"plain CPU walk: {probe}, {probe_after}")
    check(builds == 0 and snap["recompile_count"] == 0,
          f"{builds} kernel builds after warmup")
    check(snap["requests"] > 0, "no request served in the measured window")
    check(launches == expect, f"B8 launches in the serve window ({layout}): "
                              f"{launches}, expected one per batch {expect}")
    return out


SERVE_ROWS = (8, 32, 256)  # serve buckets timed as rows of the kernel table
#: SM counts that make B8's launch plan take each mapping at any batch
#: size: on one SM every batch fills the card in rows; on a vast card none
SMS_FOR = {"rows": 1, "windows": 1 << 30}


def b8_visits(fo, xq):
    """Node visits the rows of ``xq`` need through ``fo``: a leaf at heap
    index h was reached after floor(log2(h + 1)) compares."""
    import torch

    from xgboost_ray_tpu_torch.ops import predict as PR

    h = PR.predict_leaf_index(fo, xq)
    return int(torch.floor(torch.log2(h.double() + 1)).sum())


def phase_b8(bst, x, records, slice_rows=262_144):
    """B8 against its plain version (bitwise) on a slice, at every serve
    bucket, one row and a size for each rows-per-CTA choice, in both
    layouts and every mode (margins, values, leaf indices) and mapping;
    then timed at the main path's shapes: margins over every row (the
    predict() launch), leaf indices over the booster's predict_leaf chunk,
    and margins at 8, 32 and 256 rows (serve buckets)."""
    import torch

    from xgboost_ray_tpu_torch.models import booster as B
    from xgboost_ray_tpu_torch.ops import predict as PR

    # this tree's B8 has the value mode and mappings; an older tree's B8
    # (copied this script into it for a one-call comparison) has neither
    new = hasattr(PR, "launch_plan")
    value_kw = {"transform": bst.params.objective}
    m0 = bst.base_score_margin_np()
    n, f = x.shape
    t_trees = bst.num_trees
    fo = {lay: bst.device_forest("cuda", lay) for lay in PR.LAYOUTS}
    sm_count = getattr(PR, "_sm_count", None)

    def sms_as(sms):
        """Make the launch plan read ``sms`` SMs (None: the card's own)."""
        if new:
            PR._sm_count = sm_count if sms is None else (lambda index: sms)

    def plan(m):
        if not new:
            return f"R{PR.rows_per_block(m, 1, torch.device('cuda'))}"
        p = PR.launch_plan(m, 1, fo["heap"], False, torch.device("cuda"))
        return (f"windows R{p.rows_per_block}" if p.mapping == "windows"
                else f"rows tile {p.trees_per_tile}")

    def hold(xq, what):
        """Every mode of B8 on xq, both layouts (and each mapping), against
        the plain version on the card: bitwise. Returns max abs errors."""
        errs = {}
        for lay in PR.LAYOUTS:
            mp = PR.predict_margin_plain(fo[lay], xq, base0=m0)
            lp = PR.predict_leaf_index_plain(fo[lay], xq)
            vp = (PR.predict_margin_plain(fo[lay], xq, base0=m0, **value_kw)
                  if new else None)
            for mapping in PR.MAPPINGS if new else (None,):
                sms_as(SMS_FOR.get(mapping))
                mk = PR.predict_margin(fo[lay], xq, base0=m0)
                lk = PR.predict_leaf_index(fo[lay], xq)
                torch.cuda.synchronize()
                check(torch.equal(bits(mk), bits(mp)),
                      f"B8 margins ({lay}, {mapping}, {what}) not bitwise "
                      f"equal to the plain version")
                check(torch.equal(lk, lp),
                      f"B8 leaf indices ({lay}, {mapping}, {what}) not "
                      f"equal to the plain version")
                errs[lay] = max(errs.get(lay, 0.0),
                                float((mk - mp).abs().max()))
                if new:
                    vk = PR.predict_margin(fo[lay], xq, base0=m0, **value_kw)
                    torch.cuda.synchronize()
                    check(torch.equal(bits(vk), bits(vp)),
                          f"B8 values ({lay}, {mapping}, {what}) not "
                          f"bitwise equal to the plain version")
        sms_as(None)
        return errs

    xs = torch.from_numpy(x[:slice_rows]).to("cuda")
    errs = hold(xs, f"{xs.shape[0]} rows")
    emit({"phase": "b8_vs_plain", "rows": int(xs.shape[0]), "trees": t_trees,
          "plan": plan(xs.shape[0]), "max_abs_err": errs, "leaf_equal": True,
          "values_bitwise": new})
    del xs

    # the shapes serving gives B8: every bucket of a max_batch-256 server,
    # one row, and a size for each other rows-per-CTA choice
    ctas = 4 * PR._sm_count(torch.cuda.current_device())
    sizes = (1, 8, 16, 32, 64, 128, 256, 2 * ctas, 4 * ctas, 8 * ctas)
    plans, bucket_errs = {}, {}
    for i, m in enumerate(sizes):
        lo = (i * 7919) % (n - m)
        bucket_errs[m] = hold(torch.from_numpy(x[lo:lo + m]).to("cuda"),
                              f"{m} rows")
        plans[m] = plan(m)
    emit({"phase": "b8_buckets_vs_plain", "trees": t_trees,
          "plan_by_rows": plans, "bitwise": True, "values_bitwise": new})
    if new:
        want = {"windows R1", "windows R2", "windows R4", "windows R8"}
        check(want <= set(plans.values()) and plan(slice_rows).startswith(
            "rows"), f"not every mapping was checked: {plans}")

    xd = torch.from_numpy(x).to("cuda")
    n_leaf = min(n, max(1, B._CHUNK_BYTES // (4 * (f + t_trees))))
    visits, visits_leaf = 0, None
    for lo in range(0, n, n_leaf):
        visits += b8_visits(fo["heap"], xd[lo:lo + n_leaf])
        if visits_leaf is None:  # the leaf timing's rows: the first chunk
            visits_leaf = visits
    heap = bst.forest.feature.shape[1]
    # the forest as the heap's six separate fields, 18 bytes a node: the
    # count the B8 rows have always used, whatever the kernel reads
    forest_bytes = t_trees * heap * (4 + 4 + 4 + 1 + 1 + 4)
    out_m = torch.empty((n, 1), device="cuda")
    xl = xd[:n_leaf]
    out_l = torch.empty((n_leaf, t_trees), dtype=torch.int32, device="cuda")
    kernel = {
        "B8margin": lambda: PR.predict_margin(fo["heap"], xd, base0=m0,
                                              out=out_m),
        "B8margin_na": lambda: PR.predict_margin(fo["node_array"], xd,
                                                 base0=m0, out=out_m),
        "B8leaf": lambda: PR.predict_leaf_index(fo["heap"], xl, out=out_l),
    }
    plain = {
        "B8margin": lambda: PR.predict_margin_plain(fo["heap"], xd, base0=m0),
        "B8margin_na": lambda: PR.predict_margin_plain(fo["node_array"], xd,
                                                       base0=m0),
        "B8leaf": lambda: PR.predict_leaf_index_plain(fo["heap"], xl),
    }
    margin_bound = bound_ms(n * f * 4 + n * 4 + forest_bytes,
                            visits + 2 * n * t_trees)
    t = {key: dict(bound=margin_bound, max_abs_err=errs[lay])
         for key, lay in (("B8margin", "heap"), ("B8margin_na", "node_array"))}
    t["B8leaf"] = dict(
        bound=bound_ms(n_leaf * f * 4 + n_leaf * t_trees * 4 + forest_bytes,
                       visits_leaf), max_abs_err=0.0)
    for m in SERVE_ROWS:  # a serve bucket's batch, bound counted alike
        xq = xd[1000:1000 + m]
        oq = torch.empty((m, 1), device="cuda")
        key = f"B8serve{m}"
        kernel[key] = (lambda xq=xq, oq=oq: PR.predict_margin(
            fo["heap"], xq, base0=m0, out=oq))
        plain[key] = (lambda xq=xq: PR.predict_margin_plain(
            fo["heap"], xq, base0=m0))
        t[key] = dict(bound=bound_ms(m * f * 4 + m * 4 + forest_bytes,
                                     b8_visits(fo["heap"], xq)
                                     + 2 * m * t_trees),
                      max_abs_err=bucket_errs[m]["heap"], plan=plan(m))
    for key, fn in kernel.items():
        t[key]["device_ms"] = device_ms(
            fn, iters=50 if key.startswith("B8serve") else 5)
    if new:  # the value mode at full size (the fused sigmoid's cost)
        t["B8margin"]["value_device_ms"] = device_ms(
            lambda: PR.predict_margin(fo["heap"], xd, base0=m0, out=out_m,
                                      **value_kw), iters=5)
    for key, fn in kernel.items():
        small = key.startswith("B8serve")
        t[key]["ms"] = cuda_ms(fn, iters=50 if small else 5, warmup=1)
    for key, fn in plain.items():
        t[key]["plain_ms"] = cuda_ms(fn, iters=1, warmup=0)
    for key, v in t.items():
        records[key].update(ms=v["ms"], device_ms=v["device_ms"],
                            plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
                            bound_by=v["bound"][1], library_ms=None,
                            max_abs_err=v["max_abs_err"])
    emit({"phase": "b8_timing", "rows_margin": n, "rows_leaf": n_leaf,
          "trees": t_trees, "node_visits": visits,
          "visits_per_row_tree": visits / (n * t_trees),
          "plan": {"margin": plan(n)},
          **{k: {kk: (vv if kk != "bound" else list(vv))
                 for kk, vv in v.items()} for k, v in t.items()}})
    return t


def phase_late_profile(bst, x):
    """Whether torch.profiler sees B8's full-size margins launch late in the
    process (after phases 2-6); recorded, not checked."""
    import torch

    from xgboost_ray_tpu_torch.ops import predict as PR

    xd = torch.from_numpy(x).to("cuda")
    fo = bst.device_forest("cuda")
    m0 = bst.base_score_margin_np()
    try:
        ms = device_ms(lambda: PR.predict_margin(fo, xd, base0=m0), iters=3,
                       blind="raise")
    except SmokeFailure as exc:
        ms, seen = None, str(exc)[:300]
    else:
        seen = "device time recorded"
    out = {"phase": "late_profile", "b8_margin_device_ms": ms,
           "profiler": seen}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 8: held-out eval sets (B4), early stopping, warm start, C2
# ---------------------------------------------------------------------------

#: the HIGGS protocol's test set: "the last 500,000 examples are used as a
#: test set" (UCI HIGGS description)
TEST_ROWS = 500_000


def evals_expect(rounds, depth):
    """Launches of a ``train()`` with one held-out eval set: the main
    path's, plus one B4 walk and one K4 eval-mode pass a round."""
    return {**train_expect(rounds, depth), "B4": rounds,
            "K4": 2 * rounds + 1, "K4eval": rounds}


def b4_work(tree, bins, depth, missing_bin, cat=None):
    """(distinct 32-byte sectors of ``bins`` the walk reads, node visits)
    of one B4 walk on this data: the bytes and operations of its bound. A
    tree of [T, heap] fields is a launch over T trees: the sectors of all
    T walks together. ``cat`` [F] bool: the categorical features, routed
    one-vs-rest."""
    import torch

    n, f = bins.shape
    trees = ([type(tree)(*[a[t] for a in tree])
              for t in range(tree.feature.shape[0])]
             if tree.feature.dim() == 2 else [tree])
    rows = torch.arange(n, device=bins.device)
    addrs, visits = [], 0
    for tr in trees:
        idx = torch.zeros(n, dtype=torch.int64, device=bins.device)
        for _ in range(depth):
            live = ~tr.is_leaf[idx]
            feat = tr.feature[idx].clamp(0, f - 1).long()
            addrs.append(((rows * f + feat) * bins.element_size())[live] // 32)
            visits += int(live.sum())
            bv = bins.gather(1, feat[:, None])[:, 0].int()
            present = bv > tr.split_bin[idx]
            if cat is not None:
                present = torch.where(cat[feat], bv != tr.split_bin[idx],
                                      present)
            right = torch.where(bv == missing_bin, ~tr.default_left[idx],
                                present)
            idx = torch.where(live, 2 * idx + 1 + right.long(), idx)
    return int(torch.unique(torch.cat(addrs)).numel()), visits


def b4_mappings(forest, bins, depth, flush):
    """B4 on each mapping of its launch plan (``ops/grow.walk_plan``), each
    held bitwise against the plain version and timed (device time L2
    flushed, events), beside the plan's own choice and the bytes a
    tiled walk reads (every byte of the bins, the row values written, the
    forest's 13 bytes a node). Empty for a tree of the package without
    launch plans (the first B4, one mapping)."""
    import torch

    from xgboost_ray_tpu_torch.ops import grow as G

    if not hasattr(G, "walk_plan"):
        return {}
    n, f = bins.shape
    t = forest.feature.shape[0] if forest.feature.dim() == 2 else 1
    heap = forest.feature.shape[-1]
    ref = G.predict_tree_binned_plain(forest, bins, depth, 256)
    tiled_bytes = n * f * bins.element_size() + t * n * 4 + t * heap * 13
    out = {"plan": G.walk_plan(f, bins.element_size(), t, depth)._asdict(),
           "tiled_bytes_read": tiled_bytes,
           "tiled_bytes_ms": bound_ms(tiled_bytes, 0)[0]}
    for mapping in G.WALK_MAPPINGS:
        plan = G.walk_plan(f, bins.element_size(), t, depth, mapping)

        def fn(plan=plan):
            return G.predict_tree_binned(forest, bins, depth, 256, plan=plan)

        check(torch.equal(bits(fn()), bits(ref)),
              f"B4 ({mapping} mapping) differs from its plain version")
        out[mapping] = {"shared_bytes": plan.shared_bytes,
                        "rows_per_tile": plan.rows_per_tile,
                        "trees_per_group": plan.trees_per_group,
                        "ms": cuda_ms(fn, iters=20),
                        "device_ms": profiled_ms(
                            lambda: (flush.zero_(), fn()))}
    return out


def phase_evals(x, y, records, rounds=10, depth=6, es_rounds=15):
    """The HIGGS protocol with its test set: the first rows train, the last
    ``TEST_ROWS`` are ``evals=[(dtrain, "train"), (dtest, "test")]``. Round
    times without and with the test set in turns (without, with, with,
    without), each run's launches counted from 0 and checked exactly; B4
    bitwise against its plain version for every tree over the test rows
    and timed, K4's eval mode against its plain version and timed; the
    test margins within 1e-4 of ``booster.predict(x_test,
    output_margin=True)``; early stopping over ``es_rounds``; a warm start
    (5 + 5 rounds) against the uninterrupted run and against itself; and
    ROADMAP C2: a weighted sketch of every row twice and from two shards
    folded, bitwise the same cuts."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.ops import binning as BN
    from xgboost_ray_tpu_torch.ops import grow as G
    from xgboost_ray_tpu_torch.ops import objectives as O

    n_test = min(TEST_ROWS, x.shape[0] // 10)
    xt, yt, xv, yv = x[:-n_test], y[:-n_test], x[-n_test:], y[-n_test:]
    params = {"objective": "binary:logistic",
              "eval_metric": ["error", "logloss"],  # early stopping: logloss
              "max_depth": depth, "max_bin": 256}

    def run(n_rounds, held_out=True, **kw):
        dtrain = xrt.RayDMatrix(xt, yt)
        evals = [(dtrain, "train")]
        if held_out:
            evals.append((xrt.RayDMatrix(xv, yv), "test"))
        keep, ev, extra = _KeepEngine(), {}, {}
        reset_kernel_launches()
        torch.cuda.synchronize()
        bst = xrt.train(params, dtrain, n_rounds, evals=evals,
                        evals_result=ev, additional_results=extra,
                        callbacks=[keep], device="cuda:0",
                        ray_params=xrt.RayParams(num_actors=1), **kw)
        torch.cuda.synchronize()
        out = {"bst": bst, "ev": ev, "launches": kernel_launches(),
               "round_ms": [r * 1e3 for r in extra["round_times_s"]],
               "setup_s": extra["setup_time_s"], "engine": keep.engine,
               "margins": keep.engine.get_margins()[:, 0]}
        if held_out:
            out["test_margins"] = keep.engine.evals[1].margins.cpu().numpy()[:, 0]
        return out

    res = {"phase": "evals", "train_rows": int(xt.shape[0]),
           "test_rows": int(n_test), "rounds": rounds}
    from xgboost_ray_tpu_torch.ops import _build

    builds = _build.compile_count()
    timed = {False: [], True: []}
    for held_out in (False, True, True, False):
        r = run(rounds, held_out)
        check_launches(r["launches"], evals_expect(rounds, depth) if held_out
                       else train_expect(rounds, depth),
                       f"train() {'with' if held_out else 'without'} the "
                       f"test set")
        timed[held_out].append(r)
        if held_out and len(timed[True]) == 1:
            kept = r  # its engine: B4 and K4 are held and timed on it
        else:
            r.pop("engine")
    # kernel builds during the four runs (a tree with a Triton K4 compiles
    # its eval variant in the first run with the test set)
    res["kernel_builds_during_runs"] = _build.compile_count() - builds
    if hasattr(O, "k4_plan"):
        check(res["kernel_builds_during_runs"] == 0,
              f"{res['kernel_builds_during_runs']} kernel builds during "
              f"train() after the build phase")
    first, again = timed[True]
    check(first["bst"].get_dump() == again["bst"].get_dump()
          and same_bits(first["test_margins"], again["test_margins"])
          and first["ev"] == again["ev"],
          "train() with the test set twice gave other models, test margins "
          "or eval histories")
    ev = first["ev"]
    ll = ev["test"]["logloss"]
    check(all(np.isfinite(ll)) and ll[-1] < ll[0],
          f"test logloss does not fall: {ll}")
    pred = first["bst"].predict(xv, output_margin=True)
    margin_err = float(np.abs(first["test_margins"] - pred).max())
    check(margin_err <= 1e-4, f"test margins differ from the booster's "
                              f"predicted margins by {margin_err} > 1e-4")
    res.update(
        eval_history=ev, launches=first["launches"],
        expected=evals_expect(rounds, depth),
        round_ms_without_test=[r["round_ms"] for r in timed[False]],
        round_ms_with_test=[r["round_ms"] for r in timed[True]],
        round_ms_median_without_test=[float(np.median(r["round_ms"]))
                                      for r in timed[False]],
        round_ms_median_with_test=[float(np.median(r["round_ms"]))
                                   for r in timed[True]],
        first_round_ms_with_test=[r["round_ms"][0] for r in timed[True]],
        setup_s_with_test=[r["setup_s"] for r in timed[True]],
        test_margin_max_abs_diff_to_predict=margin_err)
    del timed, again

    # B4 and K4's eval mode against their plain versions, then timed, on
    # the kept run's test bins and trees
    engine = kept.pop("engine")
    es = engine.evals[1]
    err_b4 = 0.0
    for t, tree in enumerate(engine.trees):
        got = G.predict_tree_binned(tree, es.bins, depth, 256)
        ref = G.predict_tree_binned_plain(tree, es.bins, depth, 256)
        check(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
              f"B4 differs from its plain version on tree {t}")
        err_b4 = max(err_b4, float((got - ref).abs().max()))
    tree = engine.trees[-1]
    walk = lambda: G.predict_tree_binned(tree, es.bins, depth, 256)  # noqa: E731
    # on the path the test set's 28 MB of bins and 10 MB of K4 inputs are
    # cold: the round before streamed ~0.6 GB of training bins through the
    # 50 MB L2. device_ms writes 64 MB between launches (a fill kernel,
    # which device_ms does not count)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    sectors, visits = b4_work(tree, es.bins, depth, 256)
    heap = tree.feature.shape[0]
    b4_bound = bound_ms(sectors * 32 + n_test * 4 + heap * 13, visits)
    records["B4"].update(
        launches=first["launches"]["B4"], max_abs_err=err_b4,
        ms=cuda_ms(walk, iters=20),
        device_ms=profiled_ms(lambda: (flush.zero_(), walk())),
        plain_ms=cuda_ms(lambda: G.predict_tree_binned_plain(
            tree, es.bins, depth, 256), iters=3),
        bound_ms=b4_bound[0], bound_by=b4_bound[1], library_ms=None,
        mappings=b4_mappings(tree, es.bins, depth, flush),
        host_us=host_call_us(walk))
    value = walk()
    m0 = es.margins.view(-1).clone()
    mk, mp = m0.clone(), m0.clone()
    _, sk = O.round_update(mk, value, es.label, es.weight, True,
                           with_gh=False)
    _, sp = O.round_update_plain(mp, value, es.label, es.weight, True,
                                 with_gh=False)
    check(torch.equal(mk, mp), "K4's eval mode: margins differ")
    rel = float(((sk - sp).abs() / sp.abs().clamp_min(1e-30)).max())
    check(rel <= 1e-5, f"K4's eval mode: metric sums beyond 1e-5 ({rel})")
    k4e = lambda: O.round_update(mk, value, es.label, es.weight, True,  # noqa: E731
                                 with_gh=False)
    # margin, row value, label, weight read, margin written: 20 B a row
    k4_bound = bound_ms(n_test * 4 * 5, 45 * n_test)
    _kernel_record(
        records, "K4eval", k4e,
        lambda: O.round_update_plain(mp, value, es.label, es.weight, True,
                                     with_gh=False),
        k4_bound, flush, first["launches"]["K4eval"],
        float((sk - sp).abs().max()))
    records["K4eval"].update(partials_rel=rel)
    res.update(b4_sectors=sectors, b4_visits=visits,
               b4_visits_per_row=visits / n_test,
               b4={k: records["B4"][k] for k in (
                   "ms", "host_us", "device_ms", "plain_ms", "bound_ms",
                   "bound_by", "mappings")},
               k4_eval={k: records["K4eval"][k] for k in (
                   "ms", "host_us", "device_ms", "plain_ms", "bound_ms",
                   "max_abs_err", "partials_rel")})
    del engine, es, tree, value, m0, mk, mp, walk, k4e, flush
    torch.cuda.empty_cache()

    # early stopping on the test logloss
    es_run = run(es_rounds, early_stopping_rounds=3)
    hist = es_run["ev"]["test"]["logloss"]
    best = es_run["bst"].best_iteration
    res["early_stopping"] = {"rounds_run": len(hist), "best_iteration": best,
                             "best_score": es_run["bst"].best_score,
                             "test_logloss": hist}
    check(best == int(np.argmin(hist)), f"best_iteration {best} is not the "
                                        f"argmin of the test logloss {hist}")
    check(len(hist) in (es_rounds, best + 4)
          and es_run["bst"].num_boosted_rounds() == len(hist),
          f"early stopping ran {len(hist)} rounds (best {best})")
    del es_run

    # warm start: half the rounds, then the rest from them, twice
    half = rounds // 2
    five = run(half)
    warm = [run(rounds - half, xgb_model=five["bst"]) for _ in range(2)]
    dump = warm[0]["bst"].get_dump()
    res["warm_start"] = {
        "trees": warm[0]["bst"].num_trees,
        "init_trees_equal_uninterrupted":
            dump[:half] == first["bst"].get_dump()[:half],
        "rerun_dump_equal": warm[1]["bst"].get_dump() == dump,
        "rerun_margins_bitwise": same_bits(warm[0]["margins"],
                                           warm[1]["margins"])
        and same_bits(warm[0]["test_margins"], warm[1]["test_margins"]),
        "margin_max_abs_diff_to_uninterrupted": float(
            np.abs(warm[0]["margins"] - first["margins"]).max()),
        "test_margin_max_abs_diff_to_uninterrupted": float(
            np.abs(warm[0]["test_margins"] - first["test_margins"]).max()),
        "test_logloss": warm[0]["ev"]["test"]["logloss"]}
    ws = res["warm_start"]
    check(ws["trees"] == rounds
          and warm[0]["bst"].num_boosted_rounds() == rounds,
          f"the warm start has {ws['trees']} trees, not {rounds}")
    check(ws["init_trees_equal_uninterrupted"],
          "the warm start's init trees differ from the uninterrupted run's")
    check(ws["rerun_dump_equal"] and ws["rerun_margins_bitwise"],
          "the warm start repeated gave another model or other margins")
    del five, warm, first, kept
    torch.cuda.empty_cache()

    # C2: the weighted sketch of every row, twice and from two shards
    rng = np.random.RandomState(1)
    w = rng.uniform(0.05, 3.0, x.shape[0]).astype(np.float32)
    xd, wd = torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()
    cuts = [BN.sketch_and_bin(xd, wd, 256)[1] for _ in range(2)]
    order = torch.cat([torch.arange(r, x.shape[0], 2, device="cuda")
                       for r in range(2)])
    cuts.append(BN.sketch_and_bin(xd[order], wd[order], 256)[1])
    mn, mx = BN.feature_min_max(xd)
    f32 = [BN.sketch_histogram(v, mn, mx, u) for v, u in
           ((xd, wd), (xd, wd), (xd[order], wd[order]))]
    res["c2"] = {
        "rows": int(x.shape[0]),
        "cuts_bitwise_rerun": same_bits(cuts[0].cpu().numpy(),
                                        cuts[1].cpu().numpy()),
        "cuts_bitwise_two_shards": same_bits(cuts[0].cpu().numpy(),
                                             cuts[2].cpu().numpy()),
        # the f32 sums the card took before (recorded, not checked)
        "f32_sketch_bitwise_rerun": bool(torch.equal(f32[0], f32[1])),
        "f32_sketch_bitwise_two_shards": bool(torch.equal(f32[0], f32[2])),
        "f32_cuts_bitwise_two_shards": bool(torch.equal(
            BN.cuts_from_sketch(mn, mx, f32[0], 256),
            BN.cuts_from_sketch(mn, mx, f32[2], 256)))}
    check(res["c2"]["cuts_bitwise_rerun"]
          and res["c2"]["cuts_bitwise_two_shards"],
          f"the weighted sketch's cuts moved: {res['c2']}")
    del xd, wd, order, cuts, f32
    torch.cuda.empty_cache()
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 9: multiclass at Covertype's width (multi:softprob, K = 7)
# ---------------------------------------------------------------------------

#: UCI Covertype (Blackard & Dean): 581,012 rows x 54 features (10
#: continuous, then 4 wilderness-area and 40 soil-type one-hot columns), 7
#: classes of these counts
COVERTYPE_CLASS_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367,
                          20_510)
COVERTYPE_ROWS = sum(COVERTYPE_CLASS_COUNTS)
#: the held-out rows: the last 116,202 (the first 464,810 train)
COVERTYPE_TEST = 116_202


def make_covertype_like(n_rows, seed=0):
    """Covertype's layout from a numpy seed: f32 [n_rows, 54] (10
    continuous columns at the data set's means and spreads, a 4-column
    wilderness one-hot and a 40-column soil one-hot, exactly one 1 in each
    group of every row) and f32 labels 0-6: the rows ranked by a seeded
    score of their features plus noise, cut into blocks of Covertype's
    class counts (scaled to ``n_rows``), so trees learn them."""
    rng = np.random.RandomState(seed)
    loc = np.array([2959, 156, 14, 269, 46, 2350, 212, 223, 143, 1980],
                   np.float32)
    scale = np.array([280, 112, 7.5, 212, 58, 1559, 27, 20, 38, 1324],
                     np.float32)
    z = rng.standard_normal((n_rows, 10)).astype(np.float32)
    wild = rng.choice(4, n_rows, p=[0.45, 0.05, 0.44, 0.06])
    soil = rng.choice(40, n_rows, p=rng.dirichlet(np.full(40, 0.5)))
    x = np.zeros((n_rows, 54), np.float32)
    x[:, :10] = z * scale + loc
    x[np.arange(n_rows), 10 + wild] = 1.0
    x[np.arange(n_rows), 14 + soil] = 1.0
    score = (z @ rng.standard_normal(10).astype(np.float32)
             + rng.standard_normal(4)[wild] + rng.standard_normal(40)[soil]
             + 0.5 * rng.standard_normal(n_rows))
    counts = np.floor(np.array(COVERTYPE_CLASS_COUNTS) * n_rows
                      / sum(COVERTYPE_CLASS_COUNTS)).astype(np.int64)
    counts[np.argmax(counts)] += n_rows - counts.sum()
    order = np.argsort(score, kind="stable")
    y = np.empty(n_rows, np.float32)
    start = 0
    for c in rng.permutation(7):
        y[order[start:start + counts[c]]] = c
        start += counts[c]
    return x, y


class _cpu_fixed_point:
    """With ``on``, a ``train()`` on the CPU sums K1's histograms in the
    card's int64 fixed point (``build_histogram_fixed_plain``, its
    dequantise step's plain version, the round's scales from
    ``quant_scales``) instead of the f32 sums of the JAX package."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        if not self.on:
            return self
        from xgboost_ray_tpu_torch import engine as E
        from xgboost_ray_tpu_torch.ops import grow as G
        from xgboost_ray_tpu_torch.ops import histogram as H

        try:  # the lossguide grower (not in an older tree)
            from xgboost_ray_tpu_torch.ops import grow_lossguide as LG
        except ImportError:
            LG = None

        def fixed(bins, gh, rows, seg, n_nodes, nbt, with_hist=True,
                  qscale=None):
            if not gh.is_floating_point():  # quantized gradients: int32
                return H.build_histogram_plain(bins, gh, rows, seg, n_nodes,
                                               nbt, with_hist)
            return H.build_histogram_fixed_plain(bins, gh, rows, seg, n_nodes,
                                                 nbt, qscale, with_hist)

        self.saved = [(G, "build_histogram", G.build_histogram),
                      (G, "dequantize", G.dequantize),
                      (E.TorchEngine, "_scales", E.TorchEngine._scales)]
        G.build_histogram, G.dequantize = fixed, H.dequantize_plain
        if LG is not None:
            self.saved += [(LG, "build_histogram", LG.build_histogram),
                           (LG, "dequantize", LG.dequantize)]
            LG.build_histogram, LG.dequantize = fixed, H.dequantize_plain
        E.TorchEngine._scales = _gh_absmax_scales
        if hasattr(E.TorchEngine, "_tree_scales"):  # a sampled tree's
            self.saved.append((E.TorchEngine, "_tree_scales",
                               E.TorchEngine._tree_scales))
            E.TorchEngine._tree_scales = sampling_fixed_point_scales
        return self

    def __exit__(self, *exc):
        for obj, name, value in getattr(self, "saved", ()):
            setattr(obj, name, value)


def multiclass_expect(rounds, depth, k, held_out):
    """Launches of a ``train()`` of K classes: per tree the binary path's
    (``train_expect`` over rounds x K trees), one training-mode softmax
    pass a round and round 0's in place of K4; with a held-out set one B4
    launch over the round's K trees and one eval-mode pass a round."""
    out = {**train_expect(rounds * k, depth), "K4": 0, "SMX": rounds + 1}
    if held_out:
        out.update(B4=rounds, SMX=2 * rounds + 1, SMXeval=rounds)
    return out


#: K4 variants timed by ``--k4-variants``: edits of ``csrc/objective.cu``
#: (old text, new text, how many times the old text occurs)
K4_VARIANTS = {
    "built": [],
    # the CTAs' quadruples left in the partials: no ticket, no last CTA
    "no_final_sum": [(
        "    last = xrt_ticket(a.ticket, gridDim.x - 1) == gridDim.x - 1;",
        "    last = false;", 1)],
    # evict-first loads of the read-once inputs (row value, label, weight)
    "streaming_loads": [("__ldg(", "__ldcs(", 6)],
    # evict-first stores of the margins and the gradients
    "streaming_stores": [
        ("    reinterpret_cast<float4*>(a.margin)[q] = mo;",
         "    __stcs(reinterpret_cast<float4*>(a.margin) + q, mo);", 1),
        ("      gh[l] = stage[l];\n      gh[32 + l] = stage[32 + l];",
         "      __stcs(gh + l, stage[l]);\n"
         "      __stcs(gh + 32 + l, stage[32 + l]);", 1)],
}


#: B15 variants timed by ``--b15-variants``: edits of ``csrc/shap.cu``
#: (old text, new text, how many times the old text occurs)
_B15_RECURRENCE = """  float acc = q[N];
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    rr[k] = acc;
    acc = q[k] - z * acc;
  }
"""
_B15_QUOTIENTS = """  const float den = fmaxf(z, 1e-12f);
  if (fast) {
#pragma unroll
    for (int k = 0; k < N; ++k) rq[k] = xrt_qdiv(q[k], den, y);
  } else {
    const bool pos = z > 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) rq[k] = pos ? q[k] / den : 0.f;
  }
"""
_B15_PAIR_LOOP = "#pragma unroll 1\n        for (int j = 0; j < L.m; ++j) {"
_B15_SAABAS_FOLD = """#pragma unroll
  for (int j = 0; j < XRT_SAABAS_MAX_DEPTH; ++j) {
    if (j < a.max_depth) {
      const unsigned f = (half[j >> 1] >> (16 * (j & 1))) & XRT_SAABAS_PAD;
      if (f != XRT_SAABAS_PAD) {
        float* c = acc_k + (int)f * pitch;
        *c = *c + credit[j] * sc;
      }
    }
  }
"""
B15_VARIANTS = {
    "built": [],
    # the compiler's IEEE division in place of the 5-instruction quotient
    "compiler_division": [(
        "  const float q0 = __fmul_rn(a, y);\n"
        "  const float q1 = __fmaf_rn(__fmaf_rn(-d, q0, a), y, q0);\n"
        "  return __fmaf_rn(__fmaf_rn(-d, q1, a), y, q1);",
        "  return a / d;", 1)],
    # each UNWIND branch only where a lane of the warp takes it (a vote)
    "warp_votes": [(
        _B15_RECURRENCE + _B15_QUOTIENTS,
        "  const unsigned active = __activemask();\n"
        "  if (__any_sync(active, one)) {\n" + _B15_RECURRENCE + "  }\n"
        "  if (__any_sync(active, !one)) {\n" + _B15_QUOTIENTS + "  }\n",
        1)],
    # the interactions' loop over the other element unrolled
    "pair_loop_unrolled_2": [(_B15_PAIR_LOOP, _B15_PAIR_LOOP.replace(
        "unroll 1", "unroll 2"), 1)],
    "pair_loop_unrolled_4": [(_B15_PAIR_LOOP, _B15_PAIR_LOOP.replace(
        "unroll 1", "unroll 4"), 1)],
    # the Saabas rows mapping's fold reading every accumulator of a leaf
    # before writing any (its features are distinct) in place of a pair at
    # a time
    "saabas_batched_fold": [(_B15_SAABAS_FOLD, _B15_SAABAS_FOLD.replace(
        "        float* c = acc_k + (int)f * pitch;\n"
        "        *c = *c + credit[j] * sc;\n",
        "        at[j] = (int)f * pitch;\n"
        "        v[j] = acc_k[at[j]];\n").replace(
        "#pragma unroll\n  for (int j = 0;",
        "  int at[XRT_SAABAS_MAX_DEPTH];\n  float v[XRT_SAABAS_MAX_DEPTH];\n"
        "#pragma unroll\n  for (int j = 0;").replace(
        "    if (j < a.max_depth) {",
        "    at[j] = -1;\n    if (j < a.max_depth) {") + (
        "#pragma unroll\n  for (int j = 0; j < XRT_SAABAS_MAX_DEPTH; ++j)\n"
        "    if (at[j] >= 0) acc_k[at[j]] = v[j] + credit[j] * sc;\n"), 1)],
}


def saabas_small_walls(bst, x, reps=7):
    """``predict(pred_contribs=True, approx_contribs=True)`` at 37 and
    4,096 rows, the booster's call and ``predict()`` through the facade,
    with the plan's mapping (lanes) and with the rows mapping forced
    (``LANES_ROWS_PER_SM["saabas"] = 0``), in turns: host clock, ms, every
    reading, and the mappings' outputs bitwise each other."""
    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.ops import shap as SH

    rp = xrt.RayParams(num_actors=2)
    keep = SH.LANES_ROWS_PER_SM["saabas"]
    walls = {}
    try:
        for n in (37, 4096):
            xq = np.ascontiguousarray(x[:n])
            calls = {
                "booster": lambda: bst.predict(
                    xq, pred_contribs=True, approx_contribs=True),
                "predict": lambda: xrt.predict(
                    bst, xrt.RayDMatrix(xq), ray_params=rp,
                    pred_contribs=True, approx_contribs=True)}
            for entry, call in calls.items():
                outs = {}
                for i in range(2 * reps + 2):
                    m = ("lanes", "rows", "rows", "lanes")[i % 4]
                    SH.LANES_ROWS_PER_SM["saabas"] = keep if m == "lanes" else 0
                    SH.reset_launches()
                    t0 = time.perf_counter()
                    got = call()
                    ms = (time.perf_counter() - t0) * 1e3
                    check(set(k[1] for k in SH.LAUNCHES_BY_MAPPING) == {m},
                          f"B15 Saabas at {n} rows took "
                          f"{dict(SH.LAUNCHES_BY_MAPPING)}, not {m}")
                    if i >= 2:  # the first of each mapping warms it
                        walls.setdefault(f"{entry}/{n}/{m}", []).append(ms)
                    outs.setdefault(m, got)
                check(np.array_equal(outs["lanes"], outs["rows"]),
                      f"B15 Saabas {entry} at {n} rows: lanes and rows "
                      f"differ")
    finally:
        SH.LANES_ROWS_PER_SM["saabas"] = keep
    return {k: {"median_ms": float(np.median(v)), "ms": v}
            for k, v in walls.items()}


def phase_b15_variants(bst, x):
    """B15 as built against edits of its source (``B15_VARIANTS``) and a
    shared-memory budget that keeps every rows-mapping buffer on chip, in
    turns (every variant, then every variant in reverse order), events of
    one call: exact TreeSHAP over 1,048,576 rows and interaction values over
    65,536 and Saabas over 1,048,576 (the rows mapping, phase 11's shapes);
    every output bitwise the built kernel's. Then the Saabas rows mapping
    with 256 or 128 rows a CTA
    and 8, 4 or 2 trees a tile over 1,048,576 rows, in turns and bitwise;
    its lanes mapping at 1, 2, 4 and 8 rows a CTA over 37 to 16,384 rows;
    then the mappings' times across batch sizes, Saabas's too (where
    ``shap_plan`` switches). A measurement only: the package launches the
    kernel as built."""
    import ctypes

    import torch
    from xgboost_ray_tpu_torch.ops import _build
    from xgboost_ray_tpu_torch.ops import shap as SH

    with open(os.path.join(_build.CSRC_DIR, "shap.cu")) as f:
        src = f.read()
    vdir = os.path.join(_build.BUILD_DIR, "b15_variants")
    os.makedirs(vdir, exist_ok=True)
    procs = {}
    for name, edits in B15_VARIANTS.items():
        text = src
        for old, new, count in edits:
            check(text.count(old) == count,
                  f"B15 variant {name}: {old!r} occurs {text.count(old)} "
                  f"times, not {count}")
            text = text.replace(old, new)
        cu = os.path.join(vdir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-o", os.path.join(vdir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        check(proc.returncode == 0, f"B15 variant {name}: nvcc failed: {out}")
        ptxas[name] = {k: [v.get("registers"), v.get("spill_stores", 0)]
                       for k, v in ptxas_report(out).items()
                       if "rows" in k or "lanes" in k}
        lib = ctypes.CDLL(os.path.join(vdir, f"{name}.so"))
        for fn, (argtypes, restype) in _build.SIGNATURES["shap"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    table = _build._libraries()
    built = table["shap"]
    sf = bst.shap_forest("cuda")
    sc = bst.tree_scales(sf)
    xd = torch.from_numpy(np.ascontiguousarray(x[:SHAP_ROWS])).cuda()
    cases = {"exact": (SH.predict_contribs_exact, xd),
             "interactions": (SH.predict_interactions,
                              xd[:SHAP_INTER_ROWS].contiguous())}
    if hasattr(SH, "saabas_layout"):
        cases["saabas"] = (SH.predict_contribs, xd)
    budget = SH._ROWS_SHARED_MAX
    runs = [(name, lib, budget) for name, lib in libs.items()]
    runs.append(("rows_shared_112k", libs["built"], 112 << 10))
    res = {"card": CARD, "ptxas": ptxas, "ms": {}, "bitwise": {}}
    refs = {}
    try:
        for order in (runs, runs[::-1]):
            for name, lib, bud in order:
                table["shap"] = lib
                SH._ROWS_SHARED_MAX = bud
                for mode, (kern, xin) in cases.items():
                    got = kern(sf, xin, sc, mapping="rows")
                    torch.cuda.synchronize()
                    ref = refs.setdefault(mode, got)
                    same = bool(torch.equal(got, ref))
                    res["bitwise"][f"{name}/{mode}"] = same
                    check(same, f"B15 variant {name} differs in {mode}")
                    del got
                    res["ms"].setdefault(f"{name}/{mode}", []).append(
                        cuda_ms(lambda: kern(sf, xin, sc, mapping="rows"),
                                iters=1, warmup=0))
    finally:
        table["shap"] = built
        SH._ROWS_SHARED_MAX = budget
    del refs
    if hasattr(SH, "saabas_layout"):
        # the Saabas rows mapping's rows a CTA and trees a tile over
        # phase 11's 1,048,576 rows, in turns, bitwise the plan's choice
        ref = SH.predict_contribs(sf, xd, sc, mapping="rows")
        combos = [(r, tt) for r in (256, 128) for tt in (8, 4, 2)]
        keep = SH.SAABAS_ROWS, SH.SAABAS_TILE_TREES
        res["saabas_rows_tiles"] = {}
        try:
            for order in (combos, combos[::-1]):
                for r, tt in order:
                    SH.SAABAS_ROWS, SH.SAABAS_TILE_TREES = (r,), (tt,)
                    got = SH.predict_contribs(sf, xd, sc, mapping="rows")
                    check(torch.equal(got, ref), f"B15 Saabas with {r} rows "
                                                 f"and {tt} trees a tile "
                                                 f"differs")
                    del got
                    res["saabas_rows_tiles"].setdefault(
                        f"{r}x{tt}", []).append(cuda_ms(
                            lambda: SH.predict_contribs(sf, xd, sc,
                                                        mapping="rows"),
                            iters=3, warmup=1))
        finally:
            SH.SAABAS_ROWS, SH.SAABAS_TILE_TREES = keep
        del ref
        # the lanes mapping's rows a CTA across batch sizes
        keep = SH.SAABAS_LANES_ROWS, SH._SAABAS_LANES_CTAS_PER_SM
        res["saabas_lanes_rows"] = {}
        try:
            SH._SAABAS_LANES_CTAS_PER_SM = 0
            for n in (37, 1024, 4096, 16384):
                xq = xd[:n].contiguous()
                ref = SH.predict_contribs(sf, xq, sc, mapping="rows")
                for rc in (1, 2, 4, 8):
                    SH.SAABAS_LANES_ROWS = (rc,)
                    check(torch.equal(SH.predict_contribs(
                        sf, xq, sc, mapping="lanes"), ref),
                        f"B15 Saabas lanes with {rc} rows a CTA differs")
                    res["saabas_lanes_rows"][f"{n}/{rc}"] = cuda_ms(
                        lambda: SH.predict_contribs(sf, xq, sc,
                                                    mapping="lanes"),
                        iters=5, warmup=1)
        finally:
            SH.SAABAS_LANES_ROWS, SH._SAABAS_LANES_CTAS_PER_SM = keep
    # the mappings across batch sizes: a rows-mapping CTA walks the whole
    # forest however few its rows; the lanes mapping's time grows with n
    sizes = {"exact": (37, 1024, 8192, 16384, 32768),
             "interactions": (37, 1024, 16384, 32768, 65536)}
    if hasattr(SH, "saabas_layout"):
        sizes["saabas"] = (37, 1024, 4096, 8192, 16384, 24576, 32768,
                           65536, 131072)
    res["by_batch"] = {}
    for mode, ns in sizes.items():
        kern = cases[mode][0]
        for n in ns:
            xq = xd[:n].contiguous()
            res["by_batch"][f"{mode}/{n}"] = {m: cuda_ms(
                lambda: kern(sf, xq, sc, mapping=m), iters=3, warmup=1)
                for m in ("rows", "lanes")}
    if hasattr(SH, "saabas_layout"):
        res["saabas_small_walls"] = saabas_small_walls(bst, x)
    res["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    emit({"phase": "b15_variants", **res})
    return res


def phase_k4_variants(n_eval=500_000, n_gh=11_000_000):
    """K4 as built against edits of its source (``K4_VARIANTS``), each
    compiled by ``nvcc`` as the package builds it and launched directly, in
    turns (every variant, then every variant in reverse order): the eval
    mode over HIGGS's 500,000 test rows and the gh mode over 11M rows,
    device us with the L2 flushed by a write (W), by a read (R) and warm.
    Margins and gradients must be bitwise the built kernel's, and the
    partials too where a variant still sums them. A measurement only: the
    package launches the kernel as built."""
    import ctypes

    import torch
    from xgboost_ray_tpu_torch.ops import _build
    from xgboost_ray_tpu_torch.ops import objectives as O

    with open(os.path.join(_build.CSRC_DIR, "objective.cu")) as f:
        src = f.read()
    vdir = os.path.join(_build.BUILD_DIR, "k4_variants")
    os.makedirs(vdir, exist_ok=True)
    procs = {}
    for name, edits in K4_VARIANTS.items():
        text = src
        for old, new, count in edits:
            check(text.count(old) == count,
                  f"K4 variant {name}: {old!r} occurs {text.count(old)} "
                  f"times, not {count}")
            text = text.replace(old, new)
        cu = os.path.join(vdir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
             "-o", os.path.join(vdir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        check(proc.returncode == 0, f"K4 variant {name}: nvcc failed: {out}")
        ptxas[name] = list(dict.fromkeys(
            ln.split(":", 1)[-1].strip() for ln in out.splitlines()
            if "registers" in ln or "spill" in ln))
        lib = ctypes.CDLL(os.path.join(vdir, f"{name}.so"))
        lib.xrt_k4.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.xrt_k4.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda", 0)
    stream = _build.stream_ptr(dev)
    ticket, part = O._k4_workspace(0, stream)
    sms = O._k4_sms(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rbuf = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    res = {"card": CARD, "ptxas": ptxas}
    for mode, n in (("eval", n_eval), ("gh", n_gh)):
        m0 = torch.randn(n, device=dev, generator=g)
        rv = torch.randn(n, device=dev, generator=g) * 0.1
        label = (torch.rand(n, device=dev, generator=g) > 0.5).float()
        weight = torch.ones(n, device=dev)
        m = m0.clone()
        gh = (torch.empty((n, 2), device=dev) if mode == "gh" else None)
        out = torch.empty(4, dtype=torch.float64, device=dev)
        plan = O.k4_plan(n, sms)

        def call(lib, m=m, rv=rv, label=label, weight=weight, gh=gh,
                 out=out, plan=plan):
            a = O._k4_args(plan, m, rv, label, weight, gh, part, ticket, out,
                           True, 1.0)
            check(lib.xrt_k4(ctypes.byref(a), stream) == 0,
                  "K4 variant launch failed")

        ref = {}
        for name, lib in libs.items():
            m.copy_(m0)
            out.fill_(float("nan"))
            call(lib)
            got = (m.clone(), None if gh is None else gh.clone(), out.clone())
            if not ref:
                ref = {"m": got[0], "gh": got[1], "out": got[2]}
                continue
            check(torch.equal(bits(got[0]), bits(ref["m"])),
                  f"K4 variant {name} ({mode}): margins differ")
            if gh is not None:
                check(torch.equal(bits(got[1]), bits(ref["gh"])),
                      f"K4 variant {name} ({mode}): gradients differ")
            if name != "no_final_sum":
                check(torch.equal(got[2], ref["out"]),
                      f"K4 variant {name} ({mode}): partials differ")
        times = {name: [] for name in libs}
        order = list(libs) + list(reversed(libs))
        for name in order:
            lib = libs[name]
            times[name].append({
                "W": profiled_ms(lambda: (flush.zero_(), call(lib))),
                "R": profiled_ms(lambda: (rbuf.sum(), call(lib))),
                "warm": profiled_ms(lambda: call(lib))})
        res[mode] = {"rows": n, "grid": plan.grid, "times_ms": times}
        del m0, rv, label, weight, m, gh
    emit({"phase": "k4_variants", **res})
    return res


def _kernel_record(records, key, fn, plain, bound, flush, launches, err,
                   library=None, iters=None):
    """Time ``fn`` (events, and device time with the L2 flushed by a
    write) beside its plain version, then the host time a call (last: its
    300 calls change the margins a pass updates in place, and with them
    its device time); fill ``records[key]``.
    ``plain`` is the plain version, or the ms of its one run
    (``timed_once``) where it is too slow to loop. A slow kernel passes
    ``iters``: that many calls a time, and no host time (1,000 calls of
    B13 would take seconds)."""
    slow = iters is not None
    n, k = (iters, iters) if slow else (20, 10)
    records[key].update(
        launches=launches, max_abs_err=err,
        ms=cuda_ms(fn, iters=n, warmup=1 if slow else 2),
        device_ms=profiled_ms(lambda: (flush.zero_(), fn()), iters=k),
        plain_ms=cuda_ms(plain, iters=3) if callable(plain) else plain,
        bound_ms=bound[0], bound_by=bound[1], library_ms=library)
    if not slow:
        records[key]["host_us"] = host_call_us(fn)


def phase_k1_k2_f54(n, records, launches):
    """K1 and K2's level step at Covertype's 54 features (K1 in two feature
    tiles of 27) and the phase's training rows, level 5 (32 nodes): K1
    bitwise against its fixed-point plain version, K2 bitwise against its
    plain version, both timed."""
    import torch

    from xgboost_ray_tpu_torch.ops import histogram as H
    from xgboost_ray_tpu_torch.ops import split as S
    from xgboost_ray_tpu_torch.ops.grow import empty_tree

    f, nbt, n_nodes = 54, 257, 32
    bins, gh, order, seg = level_inputs(n, f, n_nodes, 9, False)
    qs = H.quant_scales(gh, n)
    err1, _ = hold_k1(bins, gh, order, seg, n_nodes, nbt, qs, False,
                      "level 5, F = 54")
    hp, _ = H.build_histogram_plain(bins, gh, order, seg, n_nodes, nbt)
    g2 = torch.Generator(device="cuda").manual_seed(19)
    level = dict(
        hist=hp[0::2].contiguous(), prev_hist=hp[0::2] + hp[1::2],
        small_is_right=torch.rand(16, generator=g2, device="cuda") < 0.5,
        active=torch.arange(32, device="cuda") % 13 != 5)
    cuts = torch.sort(torch.randn(f, nbt - 2, generator=g2, device="cuda"),
                      dim=1).values
    fhm = torch.arange(f, device="cuda") % 3 != 0
    p = S.SplitParams()
    rec_k = S.TreeRecords(empty_tree(127, "cuda"), cuts, fhm, p)
    rec_p = S.TreeRecords(empty_tree(127, "cuda"), cuts, fhm, p)
    lk = S.split_level(**level, rec=rec_k)
    lp = S.split_level_plain(**level, rec=rec_p)
    torch.cuda.synchronize()
    pairs = ([(getattr(lk.splits, k), getattr(lp.splits, k))
              for k in lk.splits._fields]
             + [(getattr(lk, k), getattr(lp, k))
                for k in ("node_value", "state", "active", "hist")]
             + list(zip(rec_k.tree, rec_p.tree)))
    check(all(torch.equal(bits(a), bits(b)) for a, b in pairs),
          "K2 level step at F = 54 not bitwise equal to its plain version")
    flat = H.flat_bucket_ids(bins, order, seg, n_nodes, nbt)
    src = H.fixed_point_gh(gh[order.long()], qs)[:, None, :].expand(
        n, f, 2).reshape(-1, 2)
    out = torch.zeros((n_nodes * f * nbt, 2), dtype=torch.int64,
                      device="cuda")
    lib_k1 = cuda_ms(lambda: out.index_add_(0, flat, src), iters=3)
    del flat, src, out
    hist_bytes = n_nodes * f * nbt * 2 * 4
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    _kernel_record(
        records, "K1f54",
        lambda: H.build_histogram(bins, gh, order, seg, n_nodes, nbt,
                                  qscale=qs),
        lambda: H.build_histogram_fixed_plain(bins, gh, order, seg, n_nodes,
                                              nbt, qs),
        bound_ms(n * f * 2 + n * 4 + n * 8 + 2 * hist_bytes + n_nodes * 16,
                 2 * n * f + 4 * n), flush, launches["K1"], err1, lib_k1)
    _kernel_record(
        records, "K2levelf54", lambda: S.split_level(**level, rec=rec_k),
        lambda: S.split_level_plain(**level, rec=rec_p),
        bound_ms(2 * hist_bytes + 16 + 32 + 32 * (4 + 38),
                 n_nodes * f * (3 * nbt + 30 * (nbt - 2))),
        flush, launches["K2level"], float((lk.hist - lp.hist).abs().max()))
    del bins, gh, order, seg, hp, level, flush
    torch.cuda.empty_cache()


def hold_softmax_update(m0, rv, lab, w, with_gh, what):
    """The softmax pass's training (``with_gh``) or eval mode on copies of
    the margins ``m0`` against its plain version on the same card tensors:
    margins and gradients bitwise (0 ulps), partial sums within 1e-5
    relative. Returns (max abs err, partials' relative err, ulps)."""
    import torch

    from xgboost_ray_tpu_torch.ops import objectives as O

    mk, mp = m0.clone(), m0.clone()
    ghk, sk = O.softmax_update(mk, rv, lab, w, with_gh)
    ghp, sp = O.softmax_update_plain(mp, rv, lab, w, with_gh)
    torch.cuda.synchronize()
    check(torch.equal(bits(mk), bits(mp)), f"softmax pass ({what}): "
                                           f"margins differ")
    rel = float(((sk - sp).abs() / sp.abs().clamp_min(1e-30)).max())
    check(rel <= 1e-5, f"softmax pass ({what}): partial sums beyond "
                       f"1e-5 relative ({rel})")
    err = float((sk - sp).abs().max())
    ulps = 0
    if with_gh:
        ulps = int((bits(ghk).long() - bits(ghp).long()).abs().max())
        err = max(err, float((ghk - ghp).abs().max()))
        check(ulps == 0, f"softmax pass ({what}): gradients {ulps} ulps "
                         f"from the plain version's")
    return err, rel, ulps


def phase_multiclass(records, rounds=10, depth=6, es_rounds=15,
                     cmp_rows=50_000, cmp_rounds=3):
    """Covertype's configuration: ``multi:softprob``, K = 7, depth 6, 256
    bins, ``eval_metric`` merror then mlogloss, 464,810 rows train and the
    last 116,202 are the test set. ``train()`` without and with the test
    set in turns (without, with, with, without), each run's launches
    counted from 0 and checked exactly; determinism (the two runs with the
    test set, and a run with the rows in two shards folded, equal dumps and
    bitwise margins); the test mlogloss falls and the test margins equal
    ``booster.predict(x_test, output_margin=True)`` within 1e-4; the
    softmax pass (each mode) and B4 over a round's 7 trees against their
    plain versions on the phase's own tensors, timed; K1 and K2 at 54
    features; a profile of two rounds; ``predict()`` over every row
    (values bitwise the plain transform of B8's margins, rows summing to
    1; ``multi:softmax`` the argmax classes); a server of the model
    (probes bitwise, no build after warmup, a short closed loop with no
    client error); early stopping on the test mlogloss; a 5 + 5 warm
    start twice; the card against the CPU path on ``cmp_rows`` rows."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch import serve
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.matrix import RayShardingMode, combine_data
    from xgboost_ray_tpu_torch.ops import grow as G
    from xgboost_ray_tpu_torch.ops import objectives as O

    k = 7
    t_phase = time.perf_counter()
    x, y = make_covertype_like(COVERTYPE_ROWS, seed=0)
    xt, yt = x[:-COVERTYPE_TEST], y[:-COVERTYPE_TEST]
    xv, yv = x[-COVERTYPE_TEST:], y[-COVERTYPE_TEST:]
    n_train = xt.shape[0]
    params = {"objective": "multi:softprob", "num_class": k,
              "eval_metric": ["merror", "mlogloss"],  # stops on mlogloss
              "max_depth": depth, "max_bin": 256}

    def run(n_rounds, held_out=True, actors=1, rows=None, device="cuda:0",
            **kw):
        xr, yr = (xt, yt) if rows is None else (xt[:rows], yt[:rows])
        dtrain = xrt.RayDMatrix(xr, yr)
        evals = [(dtrain, "train")]
        if held_out:
            evals.append((xrt.RayDMatrix(xv, yv), "test"))
        keep, ev, extra = _KeepEngine(), {}, {}
        reset_kernel_launches()
        if device != "cpu":
            torch.cuda.synchronize()
        bst = xrt.train(params, dtrain, n_rounds, evals=evals,
                        evals_result=ev, additional_results=extra,
                        callbacks=[keep], device=device,
                        ray_params=xrt.RayParams(num_actors=actors), **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        launches = kernel_launches()
        m = keep.engine.get_margins()
        sizes = [len(range(r, xr.shape[0], actors)) for r in range(actors)]
        out = {"bst": bst, "ev": ev, "launches": launches,
               "round_ms": [r * 1e3 for r in extra["round_times_s"]],
               "setup_s": extra["setup_time_s"], "engine": keep.engine,
               "margins": combine_data(RayShardingMode.INTERLEAVED,
                                       np.split(m, np.cumsum(sizes)[:-1]))}
        if held_out:
            out["test_margins"] = keep.engine.evals[1].margins.cpu().numpy()
        return out

    res = {"phase": "multiclass", "rows": int(COVERTYPE_ROWS),
           "train_rows": int(n_train), "test_rows": int(COVERTYPE_TEST),
           "features": int(x.shape[1]), "classes": k, "rounds": rounds,
           "max_depth": depth, "class_counts": np.bincount(
               y.astype(np.int64), minlength=k).tolist()}
    timed = {False: [], True: []}
    for held_out in (False, True, True, False):
        r = run(rounds, held_out)
        check_launches(r["launches"],
                       multiclass_expect(rounds, depth, k, held_out),
                       f"multiclass train() {'with' if held_out else 'without'}"
                       f" the test set")
        check(r["bst"].num_trees == rounds * k,
              f"{r['bst'].num_trees} trees, not {rounds * k}")
        timed[held_out].append(r)
        if held_out and len(timed[True]) == 1:
            kept = r
        else:
            r.pop("engine")
    first, again = timed[True]
    folded = run(rounds, held_out=False, actors=2)
    folded.pop("engine")
    base = timed[False][0]
    det = {"dump_equal_rerun": first["bst"].get_dump()
           == again["bst"].get_dump(),
           "margins_bitwise_rerun": same_bits(first["margins"],
                                              again["margins"])
           and same_bits(first["test_margins"], again["test_margins"]),
           "evals_equal_rerun": first["ev"] == again["ev"],
           "dump_equal_two_shards": folded["bst"].get_dump()
           == base["bst"].get_dump(),
           "margins_bitwise_two_shards": same_bits(folded["margins"],
                                                   base["margins"]),
           "dump_equal_with_and_without_test_set": first["bst"].get_dump()
           == base["bst"].get_dump()}
    res["determinism"] = det
    check(all(det.values()), f"multiclass determinism: {det}")
    ev = first["ev"]
    ll = ev["test"]["mlogloss"]
    check(all(np.isfinite(ll)) and ll[-1] < ll[0],
          f"test mlogloss does not fall: {ll}")
    pred = first["bst"].predict(xv, output_margin=True)
    margin_err = float(np.abs(first["test_margins"] - pred).max())
    check(margin_err <= 1e-4, f"multiclass test margins differ from the "
                              f"booster's predicted margins by {margin_err}")
    res.update(
        eval_history=ev, launches=first["launches"],
        expected=multiclass_expect(rounds, depth, k, True),
        round_ms_without_test=[r["round_ms"] for r in timed[False]],
        round_ms_with_test=[r["round_ms"] for r in timed[True]],
        round_ms_median_without_test=[float(np.median(r["round_ms"]))
                                      for r in timed[False]],
        round_ms_median_with_test=[float(np.median(r["round_ms"]))
                                   for r in timed[True]],
        setup_s=[r["setup_s"] for r in timed[False] + timed[True]],
        test_margin_max_abs_diff_to_predict=margin_err)
    bst = first["bst"]
    del timed, again, folded, base

    # the softmax pass (each mode) and B4 over a round's 7 trees against
    # their plain versions on the kept run's tensors, then timed
    engine = kept.pop("engine")
    es = engine.evals[1]
    err_b4 = 0.0
    for t, forest in enumerate(engine.trees):
        got = G.predict_tree_binned(forest, es.bins, depth, 256)
        ref = G.predict_tree_binned_plain(forest, es.bins, depth, 256)
        check(got.shape == (k, COVERTYPE_TEST)
              and torch.equal(bits(got), bits(ref)),
              f"B4 over round {t}'s {k} trees differs from its plain version")
        err_b4 = max(err_b4, float((got - ref).abs().max()))
    forest = engine.trees[-1]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    sectors, visits = b4_work(forest, es.bins, depth, 256)
    heap = forest.feature.shape[1]
    _kernel_record(
        records, "B4k", lambda: G.predict_tree_binned(forest, es.bins, depth,
                                                      256),
        lambda: G.predict_tree_binned_plain(forest, es.bins, depth, 256),
        bound_ms(sectors * 32 + COVERTYPE_TEST * 4 * k + k * heap * 13,
                 visits), flush, first["launches"]["B4"], err_b4)
    records["B4k"]["mappings"] = b4_mappings(forest, es.bins, depth, flush)
    rv_test = G.predict_tree_binned(forest, es.bins, depth, 256)
    rv_train = G.predict_tree_binned(forest, engine.bins, depth, 256)
    label, weight = engine.label, engine.weight

    m_train = engine.margins.clone()
    err_t, rel_t, ulps_t = hold_softmax_update(
        m_train, rv_train, label, weight, True, "training mode")
    err_e, rel_e, _ = hold_softmax_update(es.margins, rv_test, es.label,
                                          es.weight, False, "eval mode")
    n_tr, n_te = n_train, COVERTYPE_TEST
    # bytes: margins read and written, the K row values, label and weight
    # read, the [K, N, 2] gradients written; ~64 flops a (row, class)
    _kernel_record(
        records, "SMX", lambda: O.softmax_update(m_train, rv_train, label,
                                                 weight),
        lambda: O.softmax_update_plain(m_train.clone(), rv_train, label,
                                       weight),
        bound_ms(n_tr * (12 * k + 8 + 8 * k), 64 * k * n_tr), flush,
        first["launches"]["SMX"], err_t)
    m_test = es.margins.clone()
    _kernel_record(
        records, "SMXeval", lambda: O.softmax_update(
            m_test, rv_test, es.label, es.weight, with_gh=False),
        lambda: O.softmax_update_plain(m_test.clone(), rv_test, es.label,
                                       es.weight, with_gh=False),
        bound_ms(n_te * (12 * k + 8), 40 * k * n_te), flush,
        first["launches"]["SMXeval"], err_e)
    emit({"phase": "multiclass_kernels", **{
        key: {f: records[key].get(f) for f in (
            "launches", "max_abs_err", "ms", "host_us", "device_ms",
            "plain_ms", "bound_ms", "mappings")}
        for key in ("B4k", "SMX", "SMXeval")}})
    res["kernels"] = {"softmax_training_partials_rel": rel_t,
                      "softmax_training_gradient_ulps": ulps_t,
                      "softmax_eval_partials_rel": rel_e,
                      "b4_sectors": sectors, "b4_visits": visits,
                      "b4_visits_per_row_and_tree": visits / n_te / k}

    # a profile of two rounds with the test set: device time by kernel
    prof, wall_ms = profile_steps(engine.step, rounds, 2)
    kern, host = {}, {}
    for e in (prof.key_averages() if prof else []):
        if e.device_type != torch.autograd.DeviceType.CUDA:
            # host time by op (where a round's host time goes)
            host[e.key] = host.get(e.key, 0.0) + e.self_cpu_time_total / 2e3
            continue
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        kern[e.key] = (kern.get(e.key, (0.0, 0))[0] + t / 1e3 / 2,
                       kern.get(e.key, (0.0, 0))[1] + e.count / 2)
    dev_round = sum(v[0] for v in kern.values())
    med_with = float(np.median(res["round_ms_median_with_test"]))
    blind = prof is None
    res["profile"] = {
        "device_ms_per_round": None if blind else dev_round,
        "cuda_launches_per_round": (
            None if blind else sum(v[1] for v in kern.values())),
        "round_ms_unprofiled": med_with,
        "device_idle_share": (
            None if blind else max(0.0, 1.0 - dev_round / med_with)),
        "wall_ms_per_round_profiled": wall_ms / 2,
        "top_kernels_ms_per_round": [
            [key[:80], v[0], v[1]] for key, v in
            sorted(kern.items(), key=lambda kv: -kv[1][0])[:16]],
        "host_ms_per_round": sum(host.values()),
        "top_host_ops_ms_per_round": [
            [key[:60], v] for key, v in
            sorted(host.items(), key=lambda kv: -kv[1])[:12]]}
    del engine, es, kept, m_train, m_test, rv_test, rv_train, label, weight
    del forest, flush
    torch.cuda.empty_cache()

    # K1 and K2 at 54 features
    phase_k1_k2_f54(n_train, records, first["launches"])

    # predict() over every row (num_actors=2), B8 and the softmax pass's
    # counters set to 0 just before and read just after
    rp = xrt.RayParams(num_actors=2)
    reset_b8_counters()
    t0 = time.perf_counter()
    values = xrt.predict(bst, xrt.RayDMatrix(x), ray_params=rp)
    value_s = time.perf_counter() - t0
    launches = b8_counters()
    chunks = predict_chunks(bst, x.shape[0], 4 * (x.shape[1] + 2 * k))
    expect = b8_expect(B8margin=chunks, SMXtransform=chunks)
    margins = bst.predict(x, output_margin=True)
    plain = O.softmax_transform_plain(torch.from_numpy(margins), True).numpy()
    row_sum_err = float(np.abs(values.astype(np.float64).sum(1) - 1).max())
    soft = xrt.RayXGBoostBooster.load_raw(bst.save_raw())
    soft.params.objective = "multi:softmax"
    classes = soft.predict(x)
    pred = {"rows": int(x.shape[0]), "trees": bst.num_trees,
            "predict_value_wall_s": value_s, "launches": launches,
            "expected": expect, "values_bitwise_plain_transform":
                same_bits(values, plain),
            "row_sum_max_abs_err": row_sum_err,
            "softmax_classes_are_argmax": bool(np.array_equal(
                classes, np.argmax(plain, axis=1).astype(np.float32)))}
    res["predict"] = pred
    check(values.shape == (x.shape[0], k), f"predict() gave {values.shape}")
    check(pred["values_bitwise_plain_transform"], "predicted values are not "
          "the plain transform of B8's margins bit for bit")
    check(row_sum_err <= 1e-6, f"probabilities sum to 1 within {row_sum_err}")
    check(pred["softmax_classes_are_argmax"], "multi:softmax classes are not "
          "the first argmax of the probabilities")
    check(launches == expect, f"predict() launches {launches}, expected "
                              f"{expect}")
    # the transform mode on every row's margins, timed (library yardstick:
    # torch.softmax, which the port never calls)
    md = torch.from_numpy(margins).cuda()
    got = O.softmax_transform(md, True)
    check(torch.equal(bits(got.cpu()), bits(torch.from_numpy(plain))),
          "softmax pass (transform mode) differs from its plain version")
    got_c = O.softmax_transform(md, False)
    check(torch.equal(got_c.cpu(), O.softmax_transform_plain(
        torch.from_numpy(margins), False)), "softmax pass (classes) differs")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    n_all = x.shape[0]
    _kernel_record(
        records, "SMXtransform", lambda: O.softmax_transform(md, True),
        lambda: O.softmax_transform_plain(md, True),
        bound_ms(n_all * 8 * k, 40 * k * n_all), flush,
        launches["SMXtransform"], 0.0,
        library=cuda_ms(lambda: torch.softmax(md, 1), iters=20))
    # the yardstick's device time, measured as the kernel's
    records["SMXtransform"]["library_device_ms"] = device_ms(
        lambda: (flush.zero_(), torch.softmax(md, 1)), only="softmax")
    del md, got, got_c, flush, values, plain, margins, classes, soft
    torch.cuda.empty_cache()

    # a server of the model: probes bitwise, no build after warmup, a short
    # closed loop (every batch one B8 margin launch and one transform)
    handle = serve.create_server(bst, max_batch=256, max_delay_ms=2.0)
    builds0 = serve.compile_count()
    try:
        probe = _probe(handle, bst, xv[:37])
        snap, parked, slaunch, errors = _closed_loop(
            handle, xv, 8, 32, 0.5, 2.0)
        builds = serve.compile_count() - builds0
    finally:
        handle.shutdown()
    sexpect = b8_expect(B8serve=parked["batches"],
                        SMXtransform=parked["batches"])
    res["serve"] = {"probe_bitwise": probe, "builds_after_warmup": builds,
                    "client_errors": len(errors), "launches": slaunch,
                    "expected": sexpect,
                    **{kk: snap[kk] for kk in (
                        "requests", "batches", "qps", "mean_batch_rows",
                        "latency_p50_ms", "latency_p99_ms")}}
    check(all(probe.values()), f"multiclass serve probes not bitwise: {probe}")
    check(builds == 0, f"{builds} kernel builds after warmup")
    check(len(errors) == 0, f"{len(errors)} client errors: {errors[:3]}")
    check(slaunch == sexpect, f"serve launches {slaunch}, expected {sexpect}")

    # early stopping on the test mlogloss
    es_run = run(es_rounds, early_stopping_rounds=3)
    hist = es_run["ev"]["test"]["mlogloss"]
    best = es_run["bst"].best_iteration
    res["early_stopping"] = {"rounds_run": len(hist), "best_iteration": best,
                             "best_score": es_run["bst"].best_score,
                             "test_mlogloss": hist}
    check(best == int(np.argmin(hist)), f"best_iteration {best} is not the "
                                        f"argmin of the test mlogloss {hist}")
    check(len(hist) in (es_rounds, best + 4)
          and es_run["bst"].num_trees == k * len(hist),
          f"early stopping ran {len(hist)} rounds (best {best})")
    del es_run

    # a 5 + 5 warm start, twice
    half = rounds // 2
    five = run(half)
    warm = [run(rounds - half, xgb_model=five["bst"]) for _ in range(2)]
    dump = warm[0]["bst"].get_dump()
    ws = {"trees": warm[0]["bst"].num_trees,
          "init_trees_equal_uninterrupted":
              dump[:half * k] == bst.get_dump()[:half * k],
          "rerun_dump_equal": warm[1]["bst"].get_dump() == dump,
          "rerun_margins_bitwise": same_bits(warm[0]["margins"],
                                             warm[1]["margins"])
          and same_bits(warm[0]["test_margins"], warm[1]["test_margins"]),
          "margin_max_abs_diff_to_uninterrupted": float(
              np.abs(warm[0]["margins"] - first["margins"]).max())}
    res["warm_start"] = ws
    check(ws["trees"] == rounds * k, f"the warm start has {ws['trees']} trees")
    check(ws["init_trees_equal_uninterrupted"] and ws["rerun_dump_equal"]
          and ws["rerun_margins_bitwise"], f"multiclass warm start: {ws}")
    del five, warm, first
    torch.cuda.empty_cache()

    # the card against the CPU path on a cut of the rows. Phase 4's rule
    # (the first round's trees equal, per-round mlogloss within 1e-5,
    # margins within 1e-3) is held against the CPU path summing K1's
    # histograms in the card's fixed point (``build_histogram_fixed_plain``;
    # every other kernel's plain version as it is): there the whole model
    # must be the card's. The CPU path's own f32 sums (the JAX package's)
    # are recorded beside it: a rare class's trees split on gains below the
    # f32 sums' rounding, so their trees differ from the exact sums' while
    # the mlogloss stays within 1e-3.
    cmp = {}
    for device in ("cuda:0", "cpu-fixed", "cpu"):
        with _cpu_fixed_point(device == "cpu-fixed"):
            r = run(cmp_rounds, held_out=False, rows=cmp_rows,
                    device=device.replace("-fixed", ""))
        cmp[device] = (r["bst"], r["ev"]["train"]["mlogloss"], r["margins"])
    fields = ("feature", "split_bin", "default_left", "is_leaf")
    card = cmp["cuda:0"]
    res["cpu_vs_card"] = {"rows": cmp_rows, "rounds": cmp_rounds}
    for key, name in (("cpu-fixed", "cpu_fixed_point"), ("cpu", "cpu_f32")):
        bc, llc, mc = cmp[key]
        res["cpu_vs_card"][name] = {
            "first_round_trees_differ_in": [
                f for f in fields if not np.array_equal(
                    getattr(card[0].forest, f)[:k], getattr(bc.forest, f)[:k])],
            "dump_equal": card[0].get_dump() == bc.get_dump(),
            "mlogloss_max_abs_diff": float(np.max(np.abs(
                np.array(card[1]) - np.array(llc)))),
            "margin_max_abs_diff": float(np.max(np.abs(card[2] - mc))),
            "mlogloss_card": card[1], "mlogloss_cpu": llc}
    fx, f32 = res["cpu_vs_card"]["cpu_fixed_point"], res["cpu_vs_card"]["cpu_f32"]
    emit({"phase": "multiclass_cpu_vs_card", **res["cpu_vs_card"]})
    check(not fx["first_round_trees_differ_in"],
          f"the first round's trees differ between the card and the CPU "
          f"(fixed-point sums) in {fx['first_round_trees_differ_in']}")
    check(fx["mlogloss_max_abs_diff"] <= 1e-5,
          f"per-round mlogloss differs by {fx['mlogloss_max_abs_diff']}")
    check(fx["margin_max_abs_diff"] <= 1e-3,
          f"final margins differ by {fx['margin_max_abs_diff']} > 1e-3")
    check(f32["mlogloss_max_abs_diff"] <= 1e-3,
          f"per-round mlogloss of the CPU's f32 sums differs by "
          f"{f32['mlogloss_max_abs_diff']} > 1e-3")
    res["k33"] = phase_k33(xt)
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


def phase_k33(x, rows=10_000, rounds=3, depth=6, k=33):
    """``multi:softprob`` at K = 33 classes (the softmax pass's path above
    32 classes, whose class sum is the reference's window-32 tree) on the
    first ``rows`` rows of ``x``, labels a seeded score's 33 quantiles:
    ``train()`` on the card, launches checked, against the CPU path summing
    in the card's fixed point: there the whole model must be the card's
    (equal dumps, margins bitwise). Then the wide pass's four modes on the
    card run's own margins, labels and last round's row values, each
    bitwise its plain version on the same tensors (partial sums within
    1e-5 relative)."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.ops import grow as G
    from xgboost_ray_tpu_torch.ops import objectives as O

    rng = np.random.RandomState(33)
    xs = x[:rows]
    score = xs @ rng.standard_normal(xs.shape[1]).astype(np.float32) / (
        xs.std(0) + 1e-6).sum() + 0.2 * rng.standard_normal(rows)
    y = np.empty(rows, np.float32)
    y[np.argsort(score, kind="stable")] = np.arange(rows) * k // rows
    params = {"objective": "multi:softprob", "num_class": k,
              "eval_metric": ["merror", "mlogloss"], "max_depth": depth,
              "max_bin": 256}
    out, engines = {}, {}
    for device in ("cuda:0", "cpu"):
        keep, ev = _KeepEngine(), {}
        dm = xrt.RayDMatrix(xs, y)
        reset_kernel_launches()
        with _cpu_fixed_point(device == "cpu"):
            bst = xrt.train(params, dm, rounds, evals=[(dm, "train")],
                            evals_result=ev, callbacks=[keep], device=device,
                            ray_params=xrt.RayParams(num_actors=1))
        if device != "cpu":
            torch.cuda.synchronize()
        out[device] = (bst, ev["train"]["mlogloss"],
                       keep.engine.get_margins(), kernel_launches())
        engines[device] = keep.engine
    card, cpu = out["cuda:0"], out["cpu"]
    fields = ("feature", "split_bin", "default_left", "is_leaf")
    res = {"rows": rows, "classes": k, "rounds": rounds,
           "launches": card[3],
           "expected": multiclass_expect(rounds, depth, k, False),
           "first_round_trees_differ_in": [
               f for f in fields if not np.array_equal(
                   getattr(card[0].forest, f)[:k],
                   getattr(cpu[0].forest, f)[:k])],
           "dump_equal": card[0].get_dump() == cpu[0].get_dump(),
           "margins_bitwise": same_bits(card[2], cpu[2]),
           "mlogloss_card": card[1], "mlogloss_cpu_fixed_point": cpu[1],
           "mlogloss_max_abs_diff": float(np.max(np.abs(
               np.array(card[1]) - np.array(cpu[1])))),
           "margin_max_abs_diff": float(np.max(np.abs(card[2] - cpu[2])))}
    emit({"phase": "multiclass_k33", **res})
    check_launches(card[3], res["expected"], "multiclass train() at K = 33")
    check(not res["first_round_trees_differ_in"],
          f"K = 33: the first round's trees differ between the card and the "
          f"CPU (fixed-point sums) in {res['first_round_trees_differ_in']}")
    check(res["mlogloss_max_abs_diff"] <= 1e-5,
          f"K = 33: per-round mlogloss differs by "
          f"{res['mlogloss_max_abs_diff']}")
    check(res["margin_max_abs_diff"] <= 1e-3,
          f"K = 33: final margins differ by {res['margin_max_abs_diff']}")
    check(res["dump_equal"] and res["margins_bitwise"],
          "K = 33: the card's model is not the CPU path's (fixed-point "
          "sums): dumps equal "
          f"{res['dump_equal']}, margins bitwise {res['margins_bitwise']}")
    check(card[1][-1] < card[1][0], f"K = 33: mlogloss does not fall: "
                                    f"{card[1]}")

    # the wide pass on the card run's tensors: its margins plus the last
    # round's row values (B4 over its 33 trees) in training and eval mode,
    # then both transforms of the margins, each against its plain version
    eng = engines["cuda:0"]
    rv = G.predict_tree_binned(eng.trees[-1], eng.bins, depth, 256)
    wide = {}
    for with_gh, mode in ((True, "training"), (False, "eval")):
        err, rel, ulps = hold_softmax_update(
            eng.margins, rv, eng.label, eng.weight, with_gh,
            f"K = 33, {mode} mode")
        wide[mode] = {"max_abs_err": err, "partials_rel": rel,
                      "gradient_ulps": ulps}
    for prob, mode in ((True, "prob"), (False, "class")):
        got = O.softmax_transform(eng.margins, prob)
        ref = O.softmax_transform_plain(eng.margins, prob)
        check(torch.equal(bits(got), bits(ref)),
              f"softmax pass (K = 33, transform mode {mode}) differs from "
              f"its plain version")
        wide[mode] = {"bitwise": True}
    res["wide_pass"] = wide
    emit({"phase": "multiclass_k33_wide_pass", **wide})
    del engines, eng, rv
    return res


class HookRecorder:
    """A distributed callback recording ``(hook, rank)`` of every hook it
    receives (``after_round`` with the round's iteration); sent to the
    ranks of a world and returned by them."""

    def __init__(self):
        self.calls = []

    def on_init(self, actor, *args, **kwargs):
        self.calls.append(("on_init", actor.rank))

    def before_data_loading(self, actor, data, *args, **kwargs):
        self.calls.append(("before_data_loading", actor.rank))

    def after_data_loading(self, actor, data, *args, **kwargs):
        self.calls.append(("after_data_loading", actor.rank))

    def before_train(self, actor, *args, **kwargs):
        self.calls.append(("before_train", actor.rank))

    def after_round(self, actor, record, *args, **kwargs):
        self.calls.append(("after_round", actor.rank, record["iteration"]))

    def after_train(self, actor, result, *args, **kwargs):
        self.calls.append(("after_train", actor.rank))


def hook_order(rank, rounds):
    """The JAX package's hook order for one rank that loads one matrix."""
    return ([("on_init", rank), ("before_data_loading", rank),
             ("after_data_loading", rank), ("before_train", rank)]
            + [("after_round", rank, i) for i in range(rounds)]
            + [("after_train", rank)])


def custom_expect(rounds, depth, k=1, held_out=False):
    """Launches of a ``train()`` with a custom objective: the built-in
    run's tree kernels, and every round pass in its no-gradient mode (no
    set-up pass): K4 (or with K outputs the softmax pass) once a round over
    the training set, and once more over a held-out set."""
    passes = rounds * (2 if held_out else 1)
    out = {**train_expect(rounds * k, depth), "K4": 0, "K4eval": 0,
           "SMX": 0, "SMXeval": 0, "B4": rounds if held_out else 0}
    out.update({"SMX": passes, "SMXeval": passes} if k > 1
               else {"K4": passes, "K4eval": passes})
    return out


def _np_softmax(m):
    e = np.exp(m - m.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def sq_objective(y_true, y_pred):
    """A squared-error objective in numpy f32 (sklearn's convention)."""
    g = (y_pred - y_true).astype(np.float32)
    return g, np.ones_like(g)


def softmax_objective(preds, dtrain):
    """The softmax objective in numpy (``train(obj=...)``'s convention)."""
    p = _np_softmax(preds.astype(np.float64))
    y = np.eye(preds.shape[1])[dtrain.get_label().astype(np.int64)]
    return ((p - y).astype(np.float32),
            np.maximum(2.0 * p * (1.0 - p), 1e-16).astype(np.float32))


def mlogloss_metric(preds, dmat):
    """mlogloss in numpy f64 (``custom_metric``'s convention)."""
    m = preds.astype(np.float64)
    mx = m.max(axis=1, keepdims=True)
    lse = mx[:, 0] + np.log(np.exp(m - mx).sum(axis=1))
    y = dmat.get_label().astype(np.int64)
    return "my_mlogloss", float(np.mean(lse - m[np.arange(len(y)), y]))


def phase_facade(x, y, records, rounds=10, depth=6, es_rounds=15,
                 grid_rows=50_000, dev="cuda:0"):
    """Phase 10, the facade at full width: the sklearn estimators against
    ``train()`` on the HIGGS split (dumps equal, launches equal, predict /
    predict_proba / apply / feature importances from the booster, early
    stopping, the label encoding's time against the JAX module's per-row
    dict loop) and on Covertype's labels 1..7; a custom squared-error
    objective against ``reg:squarederror`` over every row (the same model
    bit for bit, no gradient-mode launch; K4's no-gradient mode at the
    training shape held against its plain version and timed); a custom
    softmax objective and mlogloss metric at Covertype's shape (the softmax
    pass's no-gradient mode held and timed); pickling; CSV (and Parquet
    where pyarrow imports) files of Covertype's test rows loaded centrally
    and by two gloo ranks, each rank's distributed callbacks' hooks in the
    JAX package's order; the tune report callback; and, where scikit-learn
    imports, ``clone`` and a ``GridSearchCV``."""
    import pickle
    import shutil
    import tempfile

    import pandas as pd
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch import distributed as D
    from xgboost_ray_tpu_torch import tune
    from xgboost_ray_tpu_torch.data_sources.csv import read_csv_file
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.ops import grow as G
    from xgboost_ray_tpu_torch.ops import objectives as O
    from xgboost_ray_tpu_torch.sklearn import (
        _SKLEARN_INSTALLED,
        RayXGBClassifier,
        RayXGBRegressor,
    )

    t_phase = time.perf_counter()
    res = {"phase": "facade", "sklearn_installed": _SKLEARN_INSTALLED,
           "rounds": rounds, "max_depth": depth}
    n_test = min(TEST_ROWS, x.shape[0] // 10)
    xt, yt, xv, yv = x[:-n_test], y[:-n_test], x[-n_test:], y[-n_test:]
    params = {"objective": "binary:logistic",
              "eval_metric": ["error", "logloss"], "max_depth": depth,
              "max_bin": 256}
    est_kw = dict(max_depth=depth, max_bin=256, device=dev)

    def counted(fn):
        """(fn(), its launches counted from 0, its wall seconds)."""
        reset_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, kernel_launches(), time.perf_counter() - t0

    def train_ref(p, xr, yr, n_rounds, evals_xy=None, **kw):
        dtrain = xrt.RayDMatrix(xr, yr)
        evals = [(dtrain, "train")]
        if evals_xy is not None:
            evals.append((xrt.RayDMatrix(*evals_xy), "test"))
        ev, extra = {}, {}
        bst = xrt.train(p, dtrain, n_rounds, evals=evals, evals_result=ev,
                        additional_results=extra, device=dev,
                        ray_params=xrt.RayParams(num_actors=1), **kw)
        return bst, ev, extra

    # 1. the binary classifier against train() with the test set
    (ref, ref_ev, ref_extra), ref_launches, ref_wall = counted(
        lambda: train_ref(params, xt, yt, rounds, (xv, yv)))
    t0 = time.perf_counter()
    classes, codes = np.unique(yt, return_inverse=True)
    unique_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loop = {c: i for i, c in enumerate(classes)}
    loop_codes = np.asarray([loop[v] for v in yt], dtype=np.float32)
    loop_s = time.perf_counter() - t0
    check(np.array_equal(codes.astype(np.float32), loop_codes),
          "np.unique's codes differ from the per-row dict loop's")
    del loop_codes
    clf = RayXGBClassifier(n_estimators=rounds,
                           eval_metric=["error", "logloss"], **est_kw)
    _, fit_launches, fit_wall = counted(
        lambda: clf.fit(xt, yt, eval_set=[(xv, yv)]))
    bst = clf.get_booster()
    check(bst.get_dump(with_stats=True) == ref.get_dump(with_stats=True),
          "RayXGBClassifier's model differs from train()'s")
    check(fit_launches == ref_launches,
          f"RayXGBClassifier.fit launched {fit_launches}, train() "
          f"{ref_launches}")
    check_launches(fit_launches, evals_expect(rounds, depth),
                   "RayXGBClassifier.fit")
    check(clf.evals_result()["validation_0"] == ref_ev["test"],
          "RayXGBClassifier's test history differs from train()'s")
    proba = clf.predict_proba(xv)
    value = bst.predict(xv, device=dev)
    check(same_bits(proba[:, 1], value),
          "predict_proba[:, 1] is not bitwise booster.predict")
    check(np.array_equal(clf.predict(xv),
                         clf.classes_[(value > 0.5).astype(int)]),
          "predict is not (p > 0.5) mapped through classes_")
    check(np.array_equal(clf.apply(xv),
                         bst.predict(xv, pred_leaf=True, device=dev)),
          "apply is not predict(pred_leaf=True)")
    score = bst.get_score(importance_type="gain")
    gains = np.array([score.get(f"f{i}", 0.0) for i in range(x.shape[1])])
    check(np.array_equal(clf.feature_importances_, gains / gains.sum()),
          "feature_importances_ is not the normalised gain")
    test_ll = clf.evals_result()["validation_0"]["logloss"]
    res["binary"] = {
        "train_rows": int(xt.shape[0]), "test_rows": int(n_test),
        "dump_equal_train": True, "launches": fit_launches,
        "fit_wall_s": fit_wall, "train_wall_s": ref_wall,
        "train_setup_s": ref_extra["setup_time_s"],
        "label_encoding_np_unique_s": unique_s,
        "label_encoding_dict_loop_s": loop_s,
        "test_logloss": test_ll}

    # 2. early stopping through the estimator
    es = RayXGBClassifier(n_estimators=es_rounds, early_stopping_rounds=3,
                          eval_metric=["error", "logloss"], **est_kw)
    es.fit(xt, yt, eval_set=[(xv, yv)])
    hist = es.evals_result()["validation_0"]["logloss"]
    best = es.best_iteration
    check(best == int(np.argmin(hist)),
          f"best_iteration {best} is not the argmin of the test logloss")
    check(len(hist) == min(es_rounds, best + 4),
          f"stopped after {len(hist)} rounds, best {best}")
    check(same_bits(es.predict_proba(xv)[:, 1], es.get_booster().predict(
        xv, iteration_range=(0, best + 1), device=dev)),
          "predict after early stopping does not use rounds [0, best + 1)")
    res["early_stopping"] = {"rounds_run": len(hist), "best_iteration": best,
                             "best_score": es.best_score}
    del es

    # 6. pickle (of step 1's estimator)
    back = pickle.loads(pickle.dumps(clf))
    check(same_bits(back.predict_proba(xv), proba),
          "an unpickled estimator predicts otherwise")
    res["pickle_bitwise"] = True
    del clf, back, bst, ref, proba, value
    torch.cuda.empty_cache()

    # 4. a custom squared-error objective over every row
    keeps = {}

    def fit_reg(objective):
        keeps[objective if isinstance(objective, str) else "custom"] = keep = (
            _KeepEngine())
        reg = RayXGBRegressor(n_estimators=rounds, base_score=0.5,
                              objective=objective, **est_kw)
        return reg.fit(x, y, callbacks=[keep])

    custom, custom_launches, custom_wall = counted(
        lambda: fit_reg(sq_objective))
    builtin, builtin_launches, builtin_wall = counted(
        lambda: fit_reg("reg:squarederror"))
    eng = keeps["custom"].engine
    margins = eng.get_margins()[:, 0]
    builtin_margins = keeps["reg:squarederror"].engine.get_margins()[:, 0]
    same_model = (custom.get_booster().get_dump(with_stats=True)
                  == builtin.get_booster().get_dump(with_stats=True))
    if not same_model:
        # the built-in gradient flushes a subnormal m - y (C5); numpy does
        # not: count the rows whose gradients differ at the final margins
        g_np = sq_objective(y, margins)[0]
        g_plain = O.grad_hess(torch.from_numpy(margins), torch.from_numpy(y),
                              torch.ones(len(y)), False)[0].numpy()
        res["custom_gradient_rows_differ"] = int(
            np.sum(g_np.view(np.int32) != g_plain.view(np.int32)))
        emit(res)
    check(same_model, "the custom squared error trains another model than "
                      "reg:squarederror")
    check(same_bits(margins, builtin_margins),
          "the custom objective's final margins are not the built-in's")
    check_launches(custom_launches, custom_expect(rounds, depth),
                   "the custom objective's fit")
    check_launches(builtin_launches, train_expect(rounds, depth),
                   "reg:squarederror's fit")
    rt_c = [r * 1e3 for r in custom.additional_results_["round_times_s"]]
    rt_b = [r * 1e3 for r in builtin.additional_results_["round_times_s"]]
    res["custom_objective"] = {
        "rows": int(x.shape[0]), "same_model_bitwise": True,
        "launches": custom_launches, "builtin_launches": builtin_launches,
        "round_ms_median": float(np.median(rt_c)),
        "builtin_round_ms_median": float(np.median(rt_b)),
        "round_ms": rt_c, "builtin_round_ms": rt_b,
        "fit_wall_s": custom_wall, "builtin_fit_wall_s": builtin_wall}
    # what a custom round adds: the margins' copy to the host, the user's
    # objective, the gradients' copy to the card (medians of 5)
    parts = {"margins_to_host_ms": [], "objective_ms": [],
             "gradients_to_card_ms": []}
    for _ in range(5):
        t0 = time.perf_counter()
        m_host = eng.get_margins()[:, 0]
        t1 = time.perf_counter()
        g, h = sq_objective(y, m_host)
        t2 = time.perf_counter()
        eng._user_gh(g, h)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(dt * 1e3)
    res["custom_objective"]["round_parts_ms"] = {
        k: float(np.median(v)) for k, v in parts.items()}
    del m_host, g, h
    # K4's no-gradient mode over the training rows, against its plain
    # version on the same card tensors
    rv = G.predict_tree_binned(eng.trees[-1], eng.bins, depth, 256)
    m0 = eng.margins.view(-1).clone()
    mk, mp = m0.clone(), m0.clone()
    gh, sk = O.round_update(mk, rv, eng.label, eng.weight, False,
                            with_gh=False)
    _, sp = O.round_update_plain(mp, rv, eng.label, eng.weight, False,
                                 with_gh=False)
    check(gh is None and torch.equal(bits(mk), bits(mp)),
          "K4's no-gradient mode at the training shape: margins differ")
    rel = float(((sk - sp).abs() / sp.abs().clamp_min(1e-30)).max())
    check(rel <= 1e-5, f"K4's no-gradient mode at the training shape: "
                       f"partials beyond 1e-5 relative ({rel})")
    n = int(m0.shape[0])
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    _kernel_record(
        records, "K4nograd",
        lambda: O.round_update(mk, rv, eng.label, eng.weight, False,
                               with_gh=False),
        lambda: O.round_update_plain(mp, rv, eng.label, eng.weight, False,
                                     with_gh=False),
        # margin, row value, label, weight read, margin written: 20 B a row
        bound_ms(n * 4 * 5, 45 * n), flush, custom_launches["K4eval"],
        float((sk - sp).abs().max()))
    records["K4nograd"]["partials_rel"] = rel
    del custom, builtin, keeps, eng, rv, m0, mk, mp, margins, builtin_margins
    torch.cuda.empty_cache()

    # 3. the multiclass classifier on Covertype's labels 1..7
    k = 7
    xc, yc = make_covertype_like(COVERTYPE_ROWS, seed=0)
    xct, yct = xc[:-COVERTYPE_TEST], yc[:-COVERTYPE_TEST]
    xcv, ycv = xc[-COVERTYPE_TEST:], yc[-COVERTYPE_TEST:]
    mc_params = {"objective": "multi:softprob", "num_class": k,
                 "max_depth": depth, "max_bin": 256}
    (mref, _, _), mref_launches, _ = counted(lambda: train_ref(
        mc_params, xct, yct, rounds))
    mclf = RayXGBClassifier(n_estimators=rounds, **est_kw)
    _, mfit_launches, mfit_wall = counted(lambda: mclf.fit(xct, yct + 1))
    check(list(mclf.classes_) == list(range(1, k + 1))
          and mclf.n_classes_ == k,
          f"classes_ {mclf.classes_}, n_classes_ {mclf.n_classes_}")
    check(mclf.get_booster().get_dump(with_stats=True)
          == mref.get_dump(with_stats=True),
          "RayXGBClassifier's multiclass model differs from train()'s")
    check(mfit_launches == mref_launches,
          f"multiclass fit launched {mfit_launches}, train() {mref_launches}")
    mproba = mclf.predict_proba(xcv)
    mpred = mclf.predict(xcv)
    check(np.array_equal(mpred, mclf.classes_[mproba.argmax(axis=1)])
          and set(np.unique(mpred)) <= set(range(1, k + 1)),
          "multiclass predict is not the classes_ of predict_proba's argmax")
    res["multiclass"] = {"rows": int(xct.shape[0]), "classes": k,
                         "launches": mfit_launches, "fit_wall_s": mfit_wall,
                         "dump_equal_train": True}
    del mref, mclf, mproba, mpred

    # 5. a custom softmax objective and mlogloss metric, Covertype's shape
    keep = _KeepEngine()
    (mc_bst, mc_ev, mc_extra), mc_launches, _ = counted(lambda: train_ref(
        dict(mc_params, eval_metric=["mlogloss"]), xct, yct, rounds,
        (xcv, ycv), obj=softmax_objective, custom_metric=mlogloss_metric,
        callbacks=[keep]))
    check_launches(mc_launches, custom_expect(rounds, depth, k, True),
                   "the custom softmax objective's train()")
    for name in ("train", "test"):
        got, want = mc_ev[name]["my_mlogloss"], mc_ev[name]["mlogloss"]
        check(np.allclose(got, want, rtol=0, atol=1e-5),
              f"custom mlogloss on {name} {got} is not the built-in {want}")
    check(mc_ev["test"]["mlogloss"][-1] < mc_ev["test"]["mlogloss"][0],
          f"the custom softmax objective did not learn: {mc_ev['test']}")
    eng = keep.engine
    rv = G.predict_tree_binned(eng.trees[-1], eng.bins, depth, 256)
    err_s, rel_s, _ = hold_softmax_update(
        eng.margins, rv, eng.label, eng.weight, False,
        "no-gradient mode over the training rows")
    m_train = eng.margins.clone()
    n_tr = int(m_train.shape[0])
    _kernel_record(
        records, "SMXnograd", lambda: O.softmax_update(
            m_train, rv, eng.label, eng.weight, with_gh=False),
        lambda: O.softmax_update_plain(m_train.clone(), rv, eng.label,
                                       eng.weight, with_gh=False),
        bound_ms(n_tr * (12 * k + 8), 40 * k * n_tr), flush,
        mc_launches["SMXeval"], err_s)
    records["SMXnograd"]["partials_rel"] = rel_s
    res["custom_multiclass"] = {
        "launches": mc_launches, "history": mc_ev,
        "round_ms_median": float(np.median(mc_extra["round_times_s"])) * 1e3}
    del keep, eng, rv, m_train, mc_bst, flush
    torch.cuda.empty_cache()

    # 7 + 8. files, the 2-rank world's hooks, the tune callback
    os.makedirs(OUT_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="facade_", dir=OUT_DIR)
    try:
        frame_cols = [f"f{i}" for i in range(xcv.shape[1])]
        paths = []
        for i, part in enumerate(np.array_split(np.arange(COVERTYPE_TEST), 4)):
            df = pd.DataFrame(xcv[part], columns=frame_cols)
            df["label"] = ycv[part]
            paths.append(os.path.join(tmp, f"part{i}.csv"))
            df.to_csv(paths[-1], index=False, float_format="%.9g")
        file_params = dict(mc_params, eval_metric=["mlogloss"])
        (np_bst, _, _), _, _ = counted(lambda: train_ref(
            file_params, xcv, ycv, rounds))
        read_csv_file.reads.update(native=0, pandas=0)
        sess = tune.init_session(os.path.join(tmp, "trial"))
        try:
            central = xrt.RayDMatrix(paths, label="label", distributed=False)
            c_bst = xrt.train(file_params, central, rounds,
                              evals=[(central, "train")], device=dev,
                              ray_params=xrt.RayParams(num_actors=1))
        finally:
            tune.shutdown_session()
        reads = dict(read_csv_file.reads)
        check(reads == {"native": 4, "pandas": 0},
              f"the central CSV load's parsers: {reads}")
        check(c_bst.get_dump() == np_bst.get_dump(),
              "the central CSV model differs from the numpy-input model")
        check([r["training_iteration"] for r in sess.results]
              == list(range(1, rounds + 1))
              and all("train-mlogloss" in r for r in sess.results),
              f"the tune callback reported {sess.results}")
        t0 = time.perf_counter()
        out = D.launch_world(
            D._train_rank, 2, "cuda", {"source": paths, "label": "label"},
            file_params, rounds, {"distributed_callbacks": [HookRecorder()]})
        world_s = time.perf_counter() - t0
        for r, o in enumerate(out):
            check(xrt.RayXGBoostBooster.load_raw(o["model"]).get_dump()
                  == np_bst.get_dump(),
                  f"rank {r}'s distributed CSV model differs from the "
                  f"numpy-input model")
            check(o["csv_reads"] == {"native": 2, "pandas": 0},
                  f"rank {r} read its CSV files with {o['csv_reads']}")
            calls = o["distributed_callbacks"][0].calls
            check(calls == hook_order(r, rounds),
                  f"rank {r}'s hooks: {calls}")
            check(o["additional_results"]["world_size"] == 2
                  and o["additional_results"]["backend"] == "gloo",
                  f"rank {r}: {o['additional_results']['backend']}")
        res["files"] = {
            "csv_files": 4, "rows": int(COVERTYPE_TEST),
            "features": int(xcv.shape[1]), "central_reads": reads,
            "rank_reads": [o["csv_reads"] for o in out],
            "world_wall_s": world_s, "hooks_in_order": True,
            "tune_reports": len(sess.results)}
        try:
            import pyarrow  # noqa: F401
        except ImportError:
            emit({"parquet": "not installed"})
            res["files"]["parquet"] = "not installed"
        else:
            pq = []
            for i, src in enumerate(paths):
                pq.append(os.path.join(tmp, f"part{i}.parquet"))
                pd.read_csv(src).to_parquet(pq[-1])
            p_bst = xrt.train(file_params, xrt.RayDMatrix(pq, label="label"),
                              rounds, device=dev,
                              ray_params=xrt.RayParams(num_actors=1))
            check(p_bst.get_dump() == np_bst.get_dump(),
                  "the Parquet model differs from the numpy-input model")
            res["files"]["parquet"] = "equal"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    if _SKLEARN_INSTALLED:
        from sklearn.base import clone
        from sklearn.model_selection import GridSearchCV

        est = RayXGBClassifier(n_estimators=3, device=dev)
        check(clone(est).get_params()["device"] == dev,
              "clone lost the device")
        gs = GridSearchCV(est, {"max_depth": [2, 3]}, cv=2,
                          error_score="raise")
        gs.fit(x[:grid_rows], y[:grid_rows])
        res["grid_search"] = {"rows": grid_rows,
                              "best_params": gs.best_params_,
                              "best_score": float(gs.best_score_)}
    res["phase_wall_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 11: SHAP on the card (B15)
# ---------------------------------------------------------------------------

#: rows of each SHAP path of phase 11
SHAP_ROWS = 1 << 20  # HIGGS contributions, exact and Saabas (122 MB out)
SHAP_INTER_ROWS = 1 << 16  # HIGGS interactions (220 MB out)
SHAP_COV_INTER_ROWS = 4096  # Covertype interactions
SHAP_PLAIN_ROWS = 4096  # each entry point against its plain version
#: rounds of the forest the plain interactions run over (its D^2 loops of
#: PyTorch calls take minutes over all 500 trees)
SHAP_PLAIN_INTER_ROUNDS = 50
F32_EPS = float(np.finfo(np.float32).eps)


def shap_counters():
    from xgboost_ray_tpu_torch.ops import shap as SH

    return dict(SH.LAUNCHES_BY_MODE)


def shap_sum_bound(bst, sf, m, n_feat, interactions=False):
    """The f32 bound a row's contributions must sum to its margin within:
    each of a tree's SHAP values is at most twice its largest |leaf value|
    B_t (a Shapley value averages differences of expectations over leaves),
    so the terms summed over the T trees and F + 1 columns are at most
    sum_t 2 D_t B_t, with D_t the tree's split features ((D_t + 1)^2 cells
    of interaction values, a diagonal cell a row's remainder: 2 (D_t + 1)^2
    B_t); every add rounds once (relative eps) and an output takes at most
    T + C adds (C its columns: F + 2, or (F + 1)^2 + 1), plus the margin's
    own T adds, so |sum phi - m| <= eps (2 T + C) (terms + |m|)."""
    fo = bst.forest
    big = np.where(fo.is_leaf, np.abs(fo.value), 0.0).max(axis=1)
    d_t = sf.n_feats.cpu().numpy().astype(np.float64)
    scale = 1.0 if bst.tree_weights is None else np.abs(bst.tree_weights)
    per_tree = 2 * (d_t + 1) ** 2 if interactions else 2 * d_t
    terms = float((per_tree * big * scale).sum())
    cols = (n_feat + 1) ** 2 + 1 if interactions else n_feat + 2
    return F32_EPS * (2 * bst.num_trees + cols) * (terms + np.abs(m))


def _shap_record(records, key, fn, plain, bound, launches, err, fn4096):
    """B15's row of the kernel table: events and device time (L2 flushed
    by a write) at the main path's shape, the kernel (events and the same
    device time) and its plain version at ``SHAP_PLAIN_ROWS`` rows; beside the operations bound the unfused
    ceiling (B15 builds with --fmad=false, so every multiply and add is an
    instruction of its own: half the f32 rate)."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    # one call a reading: a launch takes up to seconds at these shapes
    records[key].update(
        launches=launches, max_abs_err=err, ms=cuda_ms(fn, iters=1,
                                                      warmup=0),
        device_ms=profiled_ms(lambda: (flush.zero_(), fn()), iters=1),
        ms_plain_rows=cuda_ms(fn4096, iters=2, warmup=1),
        device_ms_plain_rows=profiled_ms(lambda: (flush.zero_(), fn4096()),
                                         iters=3),
        plain_ms=cuda_ms(plain, iters=1, warmup=0), plain_rows=SHAP_PLAIN_ROWS,
        bound_ms=bound[0], bound_by=bound[1], library_ms=None,
        unfused_ceiling_ms=(2 * bound[0] if bound[1] == "operations"
                            else bound[0]))


def b15_kernel_names(mode, mapping):
    """The ``-Xptxas -v`` name of the B15 kernel a launch of ``mode`` takes
    in ``mapping`` (Saabas: its variant without categorical splits)."""
    if mode == "saabas":
        return {"rows": "xrt_shap_saabas_rows_kernel<false>",
                "lanes": "xrt_shap_saabas_lanes_kernel<false>"}.get(
                    mapping, "xrt_shap_saabas_kernel<16>")
    inter = str(mode == "interactions").lower()
    if mapping == "deep":
        return f"xrt_shap_{mode}_kernel<16>"
    return f"xrt_shap_{mapping}_kernel<{inter}>"


def shap_build_report():
    """Registers, shared memory and spills of every B15 instantiation
    (``-Xptxas -v``, from the log the build keeps)."""
    from xgboost_ray_tpu_torch.ops import _build

    report = ptxas_report(_build.build_log("shap"))
    return {"kernels": {k: v for k, v in report.items()
                        if k.startswith("xrt_shap")}}


def train_covertype_model(rounds=10, depth=6):
    """Phase 9's Covertype model (``multi:softprob``, K = 7, 70 trees,
    F = 54) and its 116,202 test rows."""
    import xgboost_ray_tpu_torch as xrt

    x, y = make_covertype_like(COVERTYPE_ROWS, seed=0)
    xt, yt = x[:-COVERTYPE_TEST], y[:-COVERTYPE_TEST]
    bst = xrt.train({"objective": "multi:softprob", "num_class": 7,
                     "max_depth": depth, "max_bin": 256},
                    xrt.RayDMatrix(xt, yt), rounds,
                    ray_params=xrt.RayParams(num_actors=1))
    check(bst.num_trees == 7 * rounds, "wrong Covertype forest")
    return bst, x[-COVERTYPE_TEST:]


def shap_probe_times(bst, q, repeats=7):
    """A serve ``contribs`` batch of ``len(q)`` rows: the predictor's call
    (``serve.CompiledPredictor``, what a replica's flusher runs: copy-in,
    padding to the bucket, one B15 exact launch, copy-out; host clock,
    median of ``repeats``) and its B15 launch alone (events) on the
    bucket's buffers."""
    import torch

    from xgboost_ray_tpu_torch import serve
    from xgboost_ray_tpu_torch.ops import shap as SH

    pred = serve.CompiledPredictor(bst)
    pred.predict(q, "contribs")
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict(q, "contribs")
        walls.append((time.perf_counter() - t0) * 1e3)
    sf, sc = pred._shap_tables()
    bucket = next(k[0] for k in pred._buffers if k[1] == "contribs")
    xb, ob, scratch = pred._bucket_buffers(bucket, "contribs")
    out = {"rows": len(q), "bucket": bucket,
           "predictor_ms_median": float(np.median(walls)),
           "predictor_ms": walls,
           "b15_ms": cuda_ms(lambda: SH.predict_contribs_exact(
               sf, xb, sc, out=ob, scratch=scratch), iters=5, warmup=1)}
    if hasattr(SH, "shap_plan"):
        out["mapping"] = SH.shap_plan(
            sf, "exact", bucket, bst.num_features, 1,
            torch.cuda.get_device_properties(0).multi_processor_count).mapping
    return out


def phase_shap(bst, x, records):
    """Phase 11: SHAP through ``predict()`` and the booster on the card with
    B15, each path with B15's counters set to 0 just before it and read
    just after; every entry point against its plain version; reruns and
    row independence bitwise; sums to B8's margins within the f32 bound."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.ops import shap as SH

    t_phase = time.perf_counter()
    n = SHAP_ROWS
    xs = np.ascontiguousarray(x[:n])
    f = xs.shape[1]
    rp = xrt.RayParams(num_actors=2)
    res = {"phase": "shap", "trees": bst.num_trees, "rows": n,
           "interaction_rows": SHAP_INTER_ROWS}
    t0 = time.perf_counter()
    sf = bst.shap_forest("cuda")
    res["tables_s"] = time.perf_counter() - t0
    res["leaves"] = int(sf.n_leaves.sum())
    res["max_leaves"] = sf.max_leaves
    res["max_tree_features"] = sf.max_feats
    margin = bst.predict(xs, output_margin=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunks = {mode: predict_chunks(
        bst, n, 4 * (f + int(np.prod(SH.out_shape(1, f, 1, mode)[1:]))
                     + SH.scratch_floats(sf, f, 1, mode, n, sms)))
        for mode in ("exact", "saabas")}
    # the Saabas kernel's mappings and walk tables (not in an older tree)
    saabas_mapped = hasattr(SH, "saabas_layout")
    if saabas_mapped:
        res["saabas_table_bytes"] = sf.saabas_tab.numel() * 4

    # the main paths: predict() over 1M rows, exact then Saabas, then the
    # interaction values over 65,536 rows
    by_mapping = hasattr(SH, "LAUNCHES_BY_MAPPING")  # not in an older tree
    SH.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact = xrt.predict(bst, xrt.RayDMatrix(xs), ray_params=rp,
                        pred_contribs=True)
    res["exact_wall_s"] = time.perf_counter() - t0
    got = shap_counters()
    check(got == {"saabas": 0, "exact": chunks["exact"], "interactions": 0},
          f"B15 launches of predict(pred_contribs): {got}, expected "
          f"{chunks['exact']} exact (one a chunk)")
    main_launches = dict(got)
    main_mapping = {}
    if by_mapping:
        main_mapping["exact"] = {k[1]: v for k, v in
                                 SH.LAUNCHES_BY_MAPPING.items()}
    SH.reset_launches()
    t0 = time.perf_counter()
    approx = xrt.predict(bst, xrt.RayDMatrix(xs), ray_params=rp,
                         pred_contribs=True, approx_contribs=True)
    res["saabas_wall_s"] = time.perf_counter() - t0
    got = shap_counters()
    check(got == {"saabas": chunks["saabas"], "exact": 0, "interactions": 0},
          f"B15 launches of approx_contribs: {got}")
    main_launches["saabas"] = got["saabas"]
    if by_mapping:
        main_mapping["saabas"] = {k[1]: v for k, v in
                                  SH.LAUNCHES_BY_MAPPING.items()}
    ni = SHAP_INTER_ROWS
    SH.reset_launches()
    t0 = time.perf_counter()
    inter = xrt.predict(bst, xrt.RayDMatrix(xs[:ni]), ray_params=rp,
                        pred_interactions=True)
    res["interactions_wall_s"] = time.perf_counter() - t0
    got = shap_counters()
    check(got == {"saabas": 0, "exact": 0, "interactions": 1},
          f"B15 launches of pred_interactions: {got}")
    main_launches["interactions"] = 1
    if by_mapping:
        main_mapping["interactions"] = {k[1]: v for k, v in
                                        SH.LAUNCHES_BY_MAPPING.items()}
        res["launches_by_mapping"] = main_mapping
        for mode, cnt in main_mapping.items():
            check(sum(cnt.values()) == main_launches[mode],
                  f"B15 {mode} launches by mapping {cnt} do not add up")
    check(exact.shape == (n, f + 1) and approx.shape == (n, f + 1)
          and inter.shape == (ni, f + 1, f + 1), "SHAP outputs' shapes")
    check(all(bool(np.isfinite(a).all()) for a in (exact, approx, inter)),
          "non-finite SHAP values")
    res["output_mb"] = {"exact": exact.nbytes / 1e6,
                        "interactions": inter.nbytes / 1e6}

    # rows sum to B8's margin within the stated f32 bound
    bound = shap_sum_bound(bst, sf, margin, f)
    bound_i = shap_sum_bound(bst, sf, margin[:ni], f, interactions=True)
    sums = {"exact": np.abs(exact.sum(1, dtype=np.float64) - margin),
            "saabas": np.abs(approx.sum(1, dtype=np.float64) - margin),
            "interactions": np.abs(inter.sum((1, 2), dtype=np.float64)
                                   - margin[:ni])}
    res["sum_err_max"] = {k: float(v.max()) for k, v in sums.items()}
    res["sum_bound_min"] = [float(bound.min()), float(bound_i.min())]
    for k, v in sums.items():
        b = bound_i if k == "interactions" else bound
        check(bool((v <= b).all()), f"{k} rows do not sum to the margin: "
                                    f"{float(v.max())} > bound")
    rows_err = np.abs(inter.sum(2, dtype=np.float64) - exact[:ni]).max(1)
    res["interaction_rows_vs_exact_max"] = float(rows_err.max())
    check(bool((rows_err <= bound_i).all()),
          "interaction rows do not sum to the exact contributions")

    # the booster's own call, reruns, and rows at other batch sizes; the
    # booster's Saabas call timed (the predict() wall less it: the matrix,
    # the actors and the shards' concatenation)
    same = {"booster_exact": np.array_equal(
        bst.predict(xs, pred_contribs=True), exact)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    same["booster_saabas"] = np.array_equal(
        bst.predict(xs, pred_contribs=True, approx_contribs=True), approx)
    res["saabas_booster_s"] = time.perf_counter() - t0
    same["rerun_exact"] = np.array_equal(
        xrt.predict(bst, xrt.RayDMatrix(xs), ray_params=rp,
                    pred_contribs=True), exact)
    same["rerun_interactions"] = np.array_equal(
        bst.predict(xs[:ni], pred_interactions=True), inter)
    for b in (8, 256):
        same[f"exact_batch_{b}"] = np.array_equal(
            bst.predict(xs[77:77 + b], pred_contribs=True),
            exact[77:77 + b])
        same[f"saabas_batch_{b}"] = np.array_equal(
            bst.predict(xs[77:77 + b], pred_contribs=True,
                        approx_contribs=True), approx[77:77 + b])
        same[f"interactions_batch_{b}"] = np.array_equal(
            bst.predict(xs[77:77 + b], pred_interactions=True),
            inter[77:77 + b])
    res["bitwise"] = same
    check(all(same.values()), f"B15 reruns / row independence: {same}")

    # each entry point against its plain version on the card (bitwise: the
    # kernel runs the plain version's f32 operations in its order, both
    # unfused); the plain interactions over the first 50 rounds
    sc = bst.tree_scales(sf)
    sc50 = bst.tree_scales(sf, ntree_limit=SHAP_PLAIN_INTER_ROUNDS)
    xp = torch.from_numpy(xs[:SHAP_PLAIN_ROWS]).cuda()
    cases = {"saabas": (SH.predict_contribs, SH.predict_contribs_plain, sc),
             "exact": (SH.predict_contribs_exact,
                       SH.predict_contribs_exact_plain, sc),
             "interactions": (SH.predict_interactions,
                              SH.predict_interactions_plain, sc50)}
    errs = {}
    mapped = [m for m in cases if by_mapping
              and (m != "saabas" or saabas_mapped)]
    for mode, (kern, plain, scm) in cases.items():
        a = kern(sf, xp, scm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = plain(sf, xp, scm)
        torch.cuda.synchronize()
        res[f"plain_{mode}_s"] = time.perf_counter() - t0
        errs[mode] = float((a - b).abs().max())
        check(torch.equal(a, b), f"B15 {mode} differs from its plain "
                                 f"version: max |d| {errs[mode]}")
        for m in SH.MAPPINGS if mode in mapped else ():
            # each mapping, bitwise the plain version
            check(torch.equal(kern(sf, xp, scm, mapping=m), b),
                  f"B15 {mode} in the {m} mapping differs from its plain "
                  f"version")
    res["plain_trees"] = {"saabas": bst.num_trees, "exact": bst.num_trees,
                          "interactions": SHAP_PLAIN_INTER_ROUNDS}

    # Covertype (multi:softprob, K = 7, F = 54): exact over the test rows,
    # interactions over 4,096
    t0 = time.perf_counter()
    cov, xv = train_covertype_model()
    res["covertype_train_s"] = time.perf_counter() - t0
    sfc = cov.shap_forest("cuda")
    mc = cov.predict(xv, output_margin=True)
    SH.reset_launches()
    cexact = cov.predict(xv, pred_contribs=True)
    capprox = cov.predict(xv, pred_contribs=True, approx_contribs=True)
    cinter = cov.predict(xv[:SHAP_COV_INTER_ROWS], pred_interactions=True)
    got = shap_counters()
    check(got == {"saabas": 1, "exact": 1, "interactions": 1},
          f"B15 launches of the Covertype paths: {got}")
    check(capprox.shape == (COVERTYPE_TEST, 7, 55)
          and bool(np.isfinite(capprox).all()), "Covertype Saabas output")
    check(cexact.shape == (COVERTYPE_TEST, 7, 55)
          and cinter.shape == (SHAP_COV_INTER_ROWS, 7, 55, 55),
          "Covertype SHAP shapes")
    cb = shap_sum_bound(cov, sfc, np.abs(mc).max(1), 54)[:, None]
    cbi = shap_sum_bound(cov, sfc, np.abs(mc[:SHAP_COV_INTER_ROWS]).max(1),
                         54, interactions=True)[:, None]
    ce = np.abs(cexact.sum(2, dtype=np.float64) - mc)
    ca = np.abs(capprox.sum(2, dtype=np.float64) - mc)
    ci = np.abs(cinter.sum((2, 3), dtype=np.float64)
                - mc[:SHAP_COV_INTER_ROWS])
    res["covertype"] = {"exact_rows": COVERTYPE_TEST,
                        "interaction_rows": SHAP_COV_INTER_ROWS,
                        "exact_mb": cexact.nbytes / 1e6,
                        "sum_err_max": [float(ce.max()), float(ci.max()),
                                        float(ca.max())]}
    check(bool((ce <= cb).all() and (ci <= cbi).all()
               and (ca <= cb).all()),
          f"Covertype contributions do not sum to the margins: "
          f"{float(ce.max())}, {float(ci.max())}, {float(ca.max())}")
    xcp = torch.from_numpy(np.ascontiguousarray(xv[:SHAP_PLAIN_ROWS])).cuda()
    scc = cov.tree_scales(sfc)
    a = SH.predict_contribs_exact(sfc, xcp, scc)
    check(torch.equal(a, SH.predict_contribs_exact_plain(sfc, xcp, scc)),
          "B15 exact differs from its plain version at K = 7, F = 54")
    # Saabas over the test rows (the plan's mapping: rows), each mapping
    # at 4,096 rows, all bitwise the plain version
    xcd = torch.from_numpy(np.ascontiguousarray(xv)).cuda()
    cplain = SH.predict_contribs_plain(sfc, xcd, scc)
    check(torch.equal(SH.predict_contribs(sfc, xcd, scc), cplain),
          "B15 Saabas differs from its plain version at K = 7, F = 54")
    if saabas_mapped:
        res["covertype"]["saabas_mapping"] = SH.shap_plan(
            sfc, "saabas", COVERTYPE_TEST, 54, 7, sms).mapping
        for m in SH.MAPPINGS:
            check(torch.equal(SH.predict_contribs(sfc, xcp, scc, mapping=m),
                              cplain[:SHAP_PLAIN_ROWS]),
                  f"B15 Saabas in the {m} mapping differs from its plain "
                  f"version at K = 7, F = 54")
    del xcd, cplain

    # times at the main path's shapes, bounds from this forest's leaves
    xd = torch.from_numpy(xs).cuda()
    xi = xd[:ni].contiguous()
    def scratch_for(mode, rows):  # what the plan of the call keeps off chip
        return torch.empty((SH.scratch_floats(sf, f, 1, mode, rows, sms)
                            * rows,), device="cuda")

    outs = {"exact": (torch.empty((n, 1, f + 1), device="cuda"),
                      scratch_for("exact", n), xd),
            "saabas": (torch.empty((n, 1, f + 1), device="cuda"),
                       scratch_for("saabas", n), xd),
            "interactions": (
                torch.empty((ni, 1, f + 1, f + 1), device="cuda"),
                scratch_for("interactions", ni), xi)}
    res["scratch_bytes"] = {k: v[1].numel() * 4 for k, v in outs.items()}
    ptxas = shap_build_report() if by_mapping else None
    for mode, (kern, plain, scm) in cases.items():
        out, scratch, xin = outs[mode]
        rows = xin.shape[0]
        nbytes = xin.numel() * 4 + out.numel() * 4
        ops = SH.leaf_ops(sf, mode) * rows
        tight = mode == "saabas" and hasattr(SH, "saabas_ops")
        if tight:  # the leaf each row reaches (not in an older tree)
            loose_ms = bound_ms(nbytes, ops)[0]
            ops = SH.saabas_ops(sf, xin)
        key = {"saabas": "B15saabas", "exact": "B15exact",
               "interactions": "B15interactions"}[mode]
        _shap_record(
            records, key,
            lambda: kern(sf, xin, sc, out=out, scratch=scratch),
            lambda: plain(sf, xp, scm),
            bound_ms(nbytes, ops), main_launches[mode], errs[mode],
            lambda: kern(sf, xp, scm))
        records[key]["rows"] = rows
        records[key]["ops_per_row"] = ops / rows
        if tight:  # the thread-a-row kernel's count, for comparison
            records[key]["leaf_ops_per_row"] = SH.leaf_ops(sf, mode)
            records[key]["leaf_ops_bound_ms"] = loose_ms
        records[key]["bytes_bound_ms"] = nbytes / H100_BYTES_PER_S * 1e3
        records[key]["plain_trees"] = res["plain_trees"][mode]
        if mode not in mapped:
            continue
        mapping = SH.shap_plan(sf, mode, rows, f, 1, sms).mapping
        records[key]["mapping"] = mapping
        records[key]["mapping_plain_rows"] = SH.shap_plan(
            sf, mode, SHAP_PLAIN_ROWS, f, 1, sms).mapping
        records[key]["ptxas"] = ptxas["kernels"].get(
            b15_kernel_names(mode, mapping), "not in the ptxas log")
        # the other mappings at the same shape, held to the main one's bits
        ref = kern(sf, xin, sc, out=out, scratch=scratch).clone()
        other = {}
        for m in SH.MAPPINGS:
            got = kern(sf, xin, sc, mapping=m)
            torch.cuda.synchronize()
            other[m] = {"ms": cuda_ms(lambda: kern(sf, xin, sc, mapping=m),
                                      iters=1, warmup=0),
                        "bitwise": bool(torch.equal(got, ref)),
                        "ptxas": ptxas["kernels"].get(
                            b15_kernel_names(mode, m), "not in the log")}
            del got
            check(other[m]["bitwise"], f"B15 {mode}: the {m} mapping "
                                       f"differs from {mapping}")
        records[key]["mappings"] = other
        del ref
    if ptxas is not None:
        res["b15_build"] = ptxas
        spills = {k: v for k, v in ptxas["kernels"].items()
                  if v.get("spill_stores", 0) and not k.endswith("<16>")}
        check(not spills, f"B15 kernels of forests up to depth 8 spill: "
                          f"{spills}")
    res["kernels"] = {k: records[k] for k in SHAP_KERNELS}
    del xd, xi, outs
    res["probe37"] = shap_probe_times(bst, x[:37])
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 12: the replica pool, autoscaler, canary and xgboost JSON
# ---------------------------------------------------------------------------


def _probe_kinds(handle, bst, q, kinds):
    """Each of ``kinds`` served for ``q`` against ``booster.predict`` on the
    card and on the CPU, bitwise; and B15's launches for the served
    requests alone (read before the references launch it again)."""
    ok = {}
    refs = {"value": {}, "margin": {"output_margin": True},
            "leaf": {"pred_leaf": True}, "contribs": {"pred_contribs": True}}
    served, walls = {}, {}
    for kind in kinds:
        t0 = time.perf_counter()
        served[kind] = _post_json(handle.url + "/predict",
                                  {"data": q.tolist(), "kind": kind})
        walls[kind] = (time.perf_counter() - t0) * 1e3
    ok["b15_launches"] = shap_counters()["exact"]
    ok["request_ms"] = walls
    for kind in kinds:
        r = served[kind]
        for where, dev in (("card", None), ("cpu", "cpu")):
            ref = bst.predict(q, device=dev, **refs[kind])
            got = np.asarray(r["predictions"], ref.dtype)
            ok[f"{kind}_{where}"] = bool(got.shape == ref.shape
                                         and np.array_equal(got, ref))
    return ok


def _serve_window(bst, x, n_replicas, warm_s, duration_s, mid=None):
    """A closed loop of 16 clients against ``create_server(bst,
    n_replicas=...)``; ``mid`` is called half-way through the window."""
    from xgboost_ray_tpu_torch import serve
    from xgboost_ray_tpu_torch.ops import shap as SH

    builds0 = serve.compile_count()
    handle = serve.create_server(bst, max_batch=256, max_delay_ms=2.0,
                                 n_replicas=n_replicas)
    warm_builds = serve.compile_count() - builds0
    after_warm = serve.compile_count()
    try:
        SH.reset_launches()
        probe = _probe_kinds(handle, bst, x[:37],
                             ("value", "margin", "leaf", "contribs"))
        contribs_launches = probe.pop("b15_launches")
        request_ms = probe.pop("request_ms")
        snap, parked, launches, errors = _closed_loop(
            handle, x, 16, 32, warm_s, duration_s, mid=(
                None if mid is None else lambda: mid(handle)))
        probe_after = _probe_kinds(handle, bst, x[37:74],
                                   ("value", "contribs"))
        probe_after.pop("b15_launches")
        request_ms_after = probe_after.pop("request_ms")
        builds = serve.compile_count() - after_warm
        replicas = handle.metrics.snapshot().get("replicas", 1)
    finally:
        handle.shutdown()
    out = {"n_replicas": n_replicas, "client_errors": len(errors),
           "errors_sample": errors[:3], "probe_bitwise": probe,
           "probe_bitwise_after_load": probe_after,
           "builds_at_start": warm_builds, "builds_after_warmup": builds,
           "contribs_probe_launches": contribs_launches,
           "probe_request_ms": request_ms,
           "probe_request_ms_after_load": request_ms_after,
           "b8_value_launches": launches["B8value"],
           "batches_once_parked": parked["batches"], "replicas": replicas,
           **{k: snap[k] for k in ("requests", "qps", "batches",
                                   "mean_batch_rows", "latency_p50_ms",
                                   "latency_p95_ms", "latency_p99_ms")}}
    check(len(errors) == 0, f"{len(errors)} client errors at n_replicas="
                            f"{n_replicas}: {errors[:3]}")
    check(all(probe.values()) and all(probe_after.values()),
          f"served probes not bitwise booster.predict: {probe} "
          f"{probe_after}")
    check(builds == 0, f"{builds} kernel builds after warmup")
    # one probe per kind: contribs is one B15 exact launch per batch
    check(contribs_launches == 1, f"contribs probe launched B15 "
                                  f"{contribs_launches} times")
    check(launches["B8value"] == parked["batches"],
          f"B8 value launches {launches['B8value']} != batches "
          f"{parked['batches']}")
    return out


def phase_serve_pool(bst, x, y):
    """Phase 12: the replica pool on the one card (1 and 4 replicas under
    the closed loop, a replica killed under load and rejoined), the
    autoscaler's cycle read back from the trace, the canary (rollback of a
    shuffled-label model, promotion of a ``refresh``-ed one) and the
    xgboost-JSON round trip with a ``POST /models`` hot swap."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch import obs, serve

    t_phase = time.perf_counter()
    res = {"phase": "serve_pool", "trees": bst.num_trees}
    tracer = obs.Tracer(capacity=1 << 16, enabled=True, trace_dir="", rank=0)
    obs.set_default_tracer(tracer)
    try:
        # the 37-row contribs probe: the predictor's call and its B15 launch
        res["contribs_probe"] = shap_probe_times(bst, x[:37])
        res["one"] = _serve_window(bst, x, 1, 1.0, 3.0)
        res["four"] = _serve_window(bst, x, 4, 1.0, 3.0)

        killed = {}

        def kill_and_rejoin(handle):
            router = handle.batcher
            victim = router.replica_slots()[0]
            router.kill(victim)
            time.sleep(1.0)
            killed["victim"] = victim
            killed["live_after_kill"] = router.live_replicas()
            killed["rejoined"] = router.rejoin()
            killed["live_after_rejoin"] = router.live_replicas()

        res["kill"] = _serve_window(bst, x, 4, 0.5, 3.0, mid=kill_and_rejoin)
        res["kill"].update(killed)
        check(killed.get("live_after_kill") == 3
              and killed.get("live_after_rejoin") == 4,
              f"replica kill / rejoin: {killed}")
        recs = tracer.records()
        down = [r["attrs"] for r in recs if r["name"] == "serve.replica_down"
                and r["attrs"].get("reason") == "killed"]
        check(len(down) == 1 and down[0]["replica"] == killed["victim"],
              "the kill is not on the trace")

        # the autoscaler: one up / down cycle, read back from the trace
        metrics = serve.ServeMetrics(recompile_count_fn=serve.compile_count)
        reg = serve.ModelRegistry(metrics=metrics, warm_kinds=("value",))
        reg.load(bst)
        seq0 = max((r["seq"] for r in tracer.records()), default=0)
        router = serve.Router(reg, n_replicas=1, metrics=metrics)
        scaler = serve.AutoScaler(router, metrics, min_replicas=1,
                                  max_replicas=2, p99_high_ms=50.0,
                                  p99_low_ms=5.0, up_after=2, down_after=3)
        try:
            ticks = []
            for _ in range(10):
                metrics.observe_request(0.2, 1)
            ticks += [scaler.tick(), scaler.tick()]
            metrics.reset()
            for _ in range(10):
                metrics.observe_request(0.0005, 1)
            ticks += [scaler.tick(), scaler.tick(), scaler.tick()]
        finally:
            router.shutdown()
        recs = [r for r in tracer.records() if r["seq"] > seq0]
        scale = [r["attrs"] for r in recs if r["name"] == "serve.scale"]
        live, replay = 0, []
        for r in recs:
            if r["name"] == "serve.replica_up":
                live += 1
            elif r["name"] == "serve.replica_down":
                live -= 1
            if r["name"] in ("serve.replica_up", "serve.replica_down"):
                replay.append(live == r["attrs"]["live"])
        res["autoscaler"] = {"ticks": ticks, "scale_events": scale,
                             "membership_replayed": all(replay)}
        check(ticks == [0, 1, 0, 0, -1] and [e["direction"] for e in scale]
              == ["up", "down"] and scale[0]["to_replicas"] == 2
              and scale[1]["to_replicas"] == 1 and all(replay) and live == 0,
              f"autoscaler cycle not on the trace: {res['autoscaler']}")

        # the canary: a shuffled-label model rolls back, a refreshed one
        # (trained on the card, warm-started with xgb_model) is promoted
        h = serve.create_server(bst, max_batch=256, n_replicas=2)
        try:
            ctl = serve.CanaryController(h.registry, metrics=h.metrics)
            xc, yc = x[:200_000], y[:200_000]
            rng = np.random.RandomState(7)
            params = {"objective": "binary:logistic", "max_depth": 6,
                      "max_bin": 256}
            t0 = time.perf_counter()
            bad = xrt.train(params, xrt.RayDMatrix(x[:1_000_000],
                                                   rng.permutation(
                                                       y[:1_000_000])),
                            20, ray_params=xrt.RayParams(num_actors=1))
            v_bad = ctl.publish(bad, xc, yc, shadow_x=x[:4096])
            good = serve.refresh(bst, params,
                                 xrt.RayDMatrix(x[:1_000_000],
                                                y[:1_000_000]),
                                 5, ray_params=xrt.RayParams(num_actors=1))
            v_good = ctl.publish(good, xc, yc)
            res["canary_s"] = time.perf_counter() - t0
            r = _post_json(h.url + "/predict", {"data": x[:9].tolist()})
            served_good = (r["model_version"] == 2 and np.array_equal(
                np.asarray(r["predictions"], np.float32),
                good.predict(x[:9])))
            snap = h.metrics.snapshot()
        finally:
            h.shutdown()
        res["canary"] = {
            "rollback": {k: v_bad[k] for k in (
                "promoted", "reason", "version", "live_metric",
                "candidate_metric", "shadow_mean_abs_delta")},
            "promote": {k: v_good[k] for k in (
                "promoted", "reason", "version", "live_metric",
                "candidate_metric")},
            "refreshed_trees": good.num_trees, "served_refreshed": served_good,
            "metrics": {k: snap[k] for k in ("canary_promotions",
                                             "canary_rollbacks")}}
        names = [r["name"] for r in tracer.records()]
        check(v_bad["promoted"] is False and v_good["promoted"] is True
              and good.num_trees == bst.num_trees + 5 and served_good
              and snap["canary_rollbacks"] == 1
              and snap["canary_promotions"] == 1
              and "serve.rollback" in names and "serve.promote" in names,
              f"canary: {res['canary']}")

        # xgboost JSON: export, import bitwise, POST /models hot swap
        os.makedirs(OUT_DIR, exist_ok=True)
        path = os.path.abspath(os.path.join(OUT_DIR, "served.xgb.json"))
        t0 = time.perf_counter()
        bst.export_xgboost_json(path)
        back = xrt.RayXGBoostBooster.import_xgboost_json(path)
        res_x = {"export_import_s": time.perf_counter() - t0,
                 "file_mb": os.path.getsize(path) / 1e6}
        xs = x[:1_000_000]
        res_x["margin_bitwise"] = bool(np.array_equal(
            back.predict(xs, output_margin=True),
            bst.predict(xs, output_margin=True)))
        res_x["value_bitwise"] = bool(np.array_equal(back.predict(xs),
                                                     bst.predict(xs)))
        res_x["contribs_bitwise"] = bool(np.array_equal(
            back.predict(xs[:4096], pred_contribs=True),
            bst.predict(xs[:4096], pred_contribs=True)))
        h = serve.create_server(bad, max_batch=256, n_replicas=2)
        try:
            r = _post_json(h.url + "/models", {"path": path}, timeout=300.0)
            q = _post_json(h.url + "/predict",
                           {"data": x[:9].tolist(), "kind": "margin"})
            res_x["hot_swap_version"] = r["model_version"]
            res_x["hot_swap_bitwise"] = bool(
                q["model_version"] == 2 and np.array_equal(
                    np.asarray(q["predictions"], np.float32),
                    bst.predict(x[:9], output_margin=True)))
        finally:
            h.shutdown()
        os.remove(path)
        res["xgboost_json"] = res_x
        check(all(res_x[k] for k in ("margin_bitwise", "value_bitwise",
                                     "contribs_bitwise", "hot_swap_bitwise")),
              f"xgboost JSON round trip: {res_x}")
        problems = obs.validate_trace_records(tracer.records(),
                                              known_names=obs.TRACE_NAMES)
        res["trace_records"] = len(tracer.records())
        check(not problems, f"trace records invalid: {problems[:3]}")
    finally:
        obs.set_default_tracer(None)
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 13: the row-elementwise objectives, the AFT pass and the AUC metrics
# ---------------------------------------------------------------------------

#: reg:tweedie's variance power and reg:quantileerror's alphas of phase 13
OBJ_RHO = 1.5
QUANTILE_ALPHAS = (0.1, 0.5, 0.9)

#: phase 13's runs: (key, params, label kind); each trains with its default
#: metric, the binary ones with auc and aucpr besides
OBJ_RUNS = (
    ("absolute", {"objective": "reg:absoluteerror"}, "reg"),
    ("pseudohuber", {"objective": "reg:pseudohubererror"}, "reg"),
    ("squaredlog", {"objective": "reg:squaredlogerror"}, "reg"),
    ("poisson", {"objective": "count:poisson"}, "count"),
    ("gamma", {"objective": "reg:gamma"}, "gamma"),
    ("tweedie", {"objective": "reg:tweedie",
                 "tweedie_variance_power": OBJ_RHO}, "tweedie"),
    ("hinge", {"objective": "binary:hinge",
               "eval_metric": ["error", "auc", "aucpr"]}, "bin"),
    ("logitraw", {"objective": "binary:logitraw",
                  "eval_metric": ["logloss", "auc", "aucpr"]}, "bin"),
    ("quantile", {"objective": "reg:quantileerror",
                  "quantile_alpha": list(QUANTILE_ALPHAS)}, "reg"),
    ("aft_normal", {"objective": "survival:aft",
                    "aft_loss_distribution": "normal",
                    "aft_loss_distribution_scale": 1.0}, "aft"),
    ("aft_logistic", {"objective": "survival:aft",
                      "aft_loss_distribution": "logistic",
                      "aft_loss_distribution_scale": 1.0}, "aft"),
)

#: training rows of phase 13's runs whose kernel no row of the kernel
#: table times (their launches and holds are checked all the same)
OBJ_CUT_ROWS = 2_000_000

#: the kernel table's rows of phase 13, by the run whose kernel they time
OBJECTIVE_KERNELS = ("K4loglink", "K4rest", "K4quantile", "AFTnormal",
                     "AFTlogistic", "B9a", "B9atest", "B8exp")


def objective_labels(x, y, seed=0):
    """Phase 13's labels over the HIGGS-shaped rows, made from ``seed``:
    the log-mean ``lin`` a function of three features (clipped to +-3);
    non-negative regression targets ``|lin + 0.5 e|``; Poisson counts of
    mean ``e^lin``; Gamma targets (shape 2) of that mean; compound
    Poisson-Gamma targets with zeros (``N ~ Poisson(0.8 e^lin)``, a Gamma of
    shape 2N); the HIGGS labels; for AFT log-normal event times ``e^(lin +
    0.5 e)``, 30 % right-censored (lower a uniform share of the time, upper
    +inf), 10 % interval-censored ([0.7 t, 1.3 t]), the rest uncensored."""
    rng = np.random.default_rng(seed + 13)
    n = x.shape[0]
    lin = np.clip(0.4 * x[:, 0] - 0.3 * x[:, 1] + 0.2 * x[:, 2], -3.0, 3.0)
    mu = np.exp(lin)
    noise = rng.standard_normal(n)
    counts = rng.poisson(0.8 * mu)
    tweedie = np.zeros(n)
    pos = counts > 0
    tweedie[pos] = rng.gamma(2.0 * counts[pos], 0.6)
    t = np.exp(lin + 0.5 * noise)
    u = rng.uniform(size=n)
    lower, upper = t.copy(), t.copy()
    right = u < 0.3
    lower[right] = t[right] * rng.uniform(0.2, 1.0, int(right.sum()))
    upper[right] = np.inf
    interval = (u >= 0.3) & (u < 0.4)
    lower[interval] = t[interval] * 0.7
    upper[interval] = t[interval] * 1.3

    def f32(a):
        return np.ascontiguousarray(a, dtype=np.float32)

    return ({"reg": f32(np.abs(lin + 0.5 * noise)), "count": f32(counts),
             "gamma": f32(rng.gamma(2.0, mu / 2.0)), "tweedie": f32(tweedie),
             "bin": y, "lower": f32(lower), "upper": f32(upper)},
            {"right_censored": float(right.mean()),
             "interval_censored": float(interval.mean()),
             "tweedie_zeros": float((tweedie == 0).mean())})


def objectives_expect(rounds, depth, k=1, auc=False):
    """Launches of a ``train()`` of ``rounds`` rounds at ``depth`` with the
    test set: per tree (K a round for K quantiles) the main path's K1-K3,
    K4 once a round (its K-output kernel for K quantiles, its AFT modes for
    survival:aft) and once at set-up, one B4 and one K4 eval-mode pass a
    round over the test set; with auc / aucpr one B9a launch a set a
    round."""
    base = train_expect(rounds * k, depth)
    return {**base, "K4": 2 * rounds + 1, "B4": rounds, "K4eval": rounds,
            "B9a": 2 * rounds if auc else 0}


def hold_k4(engine, obj_metrics, rng, what, records=None, key=None,
            flush=None, launches=0):
    """K4 (its mode of the engine's objective, the AFT pass, or the
    K-output kernel) over the engine's training rows and final margins
    against its plain version on the same card tensors: margins and
    gradients bitwise (0 ulps), the partial sums within 1e-5 relative;
    with ``key``, timed into ``records[key]``. Returns the hold's
    summary."""
    import torch

    from xgboost_ray_tpu_torch.ops import objectives as O

    obj = engine.k4_objective
    n, k = engine.margins.shape
    rv = torch.from_numpy((rng.standard_normal((k, n)) * 0.05).astype(
        np.float32)).cuda()
    lab, w, lo, hi = engine.label, engine.weight, engine.lower, engine.upper
    m0 = engine.margins.clone()
    mk, mp = m0.clone(), m0.clone()
    if k > 1:
        def kern():
            return O.round_update_multi(mk, rv, lab, w, obj,
                                        metrics=obj_metrics)

        def plain():
            return O.round_update_multi_plain(mp, rv, lab, w, obj,
                                              metrics=obj_metrics)
    else:
        def kern():
            return O.round_update(mk.view(-1), rv.view(-1), lab, w, obj,
                                  metrics=obj_metrics, lower=lo, upper=hi)

        def plain():
            return O.round_update_plain(mp.view(-1), rv.view(-1), lab, w, obj,
                                        metrics=obj_metrics, lower=lo,
                                        upper=hi)
    ghk, sk = kern()
    ghp, sp = plain()
    torch.cuda.synchronize()
    check(torch.equal(bits(mk), bits(mp)), f"K4 ({what}): margins differ")
    ulps = int((bits(ghk).long() - bits(ghp).long()).abs().max())
    nan_same = torch.equal(torch.isnan(ghk), torch.isnan(ghp))
    check(nan_same and torch.equal(bits(ghk), bits(ghp)),
          f"K4 ({what}): gradients {ulps} ulps from the plain version's")
    live = sp != 0
    rel = float(((sk - sp).abs()[live] / sp.abs()[live].clamp_min(1e-30)
                 ).max()) if bool(live.any()) else 0.0
    check(rel <= 1e-5, f"K4 ({what}): partial sums beyond 1e-5 relative "
                       f"({rel})")
    err = max(float((ghk - ghp).abs().nan_to_num().max()),
              float((sk - sp).abs().max()))
    out = {"rows": n, "outputs": k, "gh_ulps": ulps, "partials_rel": rel,
           "max_abs_err": err}
    if key is not None:
        cols = 4 * k  # margin read + written, row value, gh pair (2 words)
        nbytes = n * (4 * (2 * k + k + 2 * k) + 8)
        if lo is not None:
            nbytes += 8 * n  # the two bounds
        flops = {"AFTnormal": 160, "AFTlogistic": 120}.get(key, 60) * n * k
        _kernel_record(records, key, kern, plain, bound_ms(nbytes, flops),
                       flush, launches, err)
        records[key].update(partials_rel=rel, bytes_per_row=nbytes // n,
                            columns=cols)
    return out


def phase_objectives(x, y, records, rounds=10, depth=6, es_rounds=15,
                     compare_rows=50_000):
    """Phase 13 at full width: every row-elementwise objective trained at
    the HIGGS shape and split (``OBJ_RUNS``; 10,500,000 rows train, or
    ``OBJ_CUT_ROWS`` for the runs no kernel row times, the last 500,000
    the test set, ``evals=[(dtrain, "train"), (dtest,
    "test")]``, depth 6, 256 bins, 10 rounds), each run's launches counted
    from 0 and checked exactly, no kernel build in any of them; each K4
    mode, the AFT pass and the K-output kernel against their plain versions
    over the run's rows (bitwise margins and gradients); B9a against its
    plain version (bitwise) over the training and the test margins; auc
    bitwise on a rerun and in a 2-rank gloo world; early stopping on the
    test auc; the card's model equal to the fixed-point CPU path's on
    ``compare_rows`` rows for count:poisson (K4), survival:aft (the AFT
    pass) and the quantiles (K4's K-output kernel); ``predict()`` and a
    served ``value`` probe of the Poisson and the quantile model (B8's
    exp fused, and the K-output identity)."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch import distributed as D
    from xgboost_ray_tpu_torch import serve
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.ops import _build
    from xgboost_ray_tpu_torch.ops import metrics as M
    from xgboost_ray_tpu_torch.ops import objectives as O
    from xgboost_ray_tpu_torch.ops import predict as PR

    n = x.shape[0]
    n_train = n - TEST_ROWS
    t0 = time.perf_counter()
    labels, shares = objective_labels(x, y)
    res = {"phase": "objectives", "rows": n, "train_rows": n_train,
           "test_rows": TEST_ROWS, "rounds": rounds, "max_depth": depth,
           "labels_s": time.perf_counter() - t0, **shares, "runs": {}}
    rng = np.random.default_rng(13)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def matrices(kind, rows=None):
        lo_, hi_ = (0, n_train) if rows is None else (0, rows)
        if kind == "aft":
            def dm(a, b):
                return xrt.RayDMatrix(
                    x[a:b], label_lower_bound=labels["lower"][a:b],
                    label_upper_bound=labels["upper"][a:b])
        else:
            def dm(a, b):
                return xrt.RayDMatrix(x[a:b], labels[kind][a:b])
        return dm(lo_, hi_), (dm(n_train, n) if rows is None else None)

    def train(params, kind, n_rounds, train_rows=None, **kw):
        dtrain, dtest = matrices(kind)
        if train_rows is not None:
            dtrain = matrices(kind, train_rows)[0]
        ev, extra = {}, {}
        keep = _KeepEngine()
        builds = _build.compile_count()
        reset_kernel_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        bst = xrt.train({"max_depth": depth, "max_bin": 256, **params},
                        dtrain, n_rounds,
                        evals=[(dtrain, "train"), (dtest, "test")],
                        evals_result=ev, additional_results=extra,
                        callbacks=[keep], device="cuda:0",
                        ray_params=xrt.RayParams(num_actors=1), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = kernel_launches()
        check(_build.compile_count() == builds,
              f"{params['objective']}: a kernel build inside train()")
        return {"bst": bst, "ev": ev, "launches": launches, "wall_s": wall,
                "round_ms": [r * 1e3 for r in extra["round_times_s"]],
                "engine": keep.engine}

    timed = {"poisson": "K4loglink", "squaredlog": "K4rest",
             "quantile": "K4quantile", "aft_normal": "AFTnormal",
             "aft_logistic": "AFTlogistic"}
    runs = {}
    for key, params, kind in OBJ_RUNS:
        # the runs no kernel row times train on a cut of the rows
        r = train(params, kind, rounds,
                  None if key in timed or key == "logitraw"
                  else OBJ_CUT_ROWS)
        eng = r.pop("engine")
        k = eng.n_outputs
        auc = any(m in ("auc", "aucpr") for m in eng.metric_names)
        expect = objectives_expect(rounds, depth, k, auc)
        for name in expect:
            check(r["launches"][name] == expect[name],
                  f"{key}: {name} launched {r['launches'][name]} times, "
                  f"expected {expect[name]}")
        hist = {s: {m: v for m, v in ms.items()} for s, ms in r["ev"].items()}
        for s, ms in hist.items():
            for m, v in ms.items():
                check(all(np.isfinite(v)), f"{key}: non-finite {s}-{m} {v}")
        hold = hold_k4(eng, eng.device_metrics, rng, key, records,
                       timed.get(key), flush, r["launches"]["K4"])
        out = {"objective": params["objective"], "outputs": k,
               "launches": r["launches"], "expected": expect,
               "history": hist, "round_ms": r["round_ms"],
               "round_ms_median": float(np.median(r["round_ms"])),
               "train_wall_s": r["wall_s"], "k4_hold": hold}
        if key == "logitraw":
            # B9a over the training and the test margins, and a rerun
            es = [e for e in eng.evals if not e.is_train][0]
            for rec, (m, lab, w, scale) in (
                    ("B9a", (eng.margins, eng.label, eng.weight,
                             eng.auc_scale)),
                    ("B9atest", (es.margins, es.label, es.weight,
                                 es.auc_scale))):
                score = M.auc_score(m)

                def kern(score=score, lab=lab, w=w, scale=scale):
                    return M.auc_histogram(score, lab, w, scale)

                def plain(score=score, lab=lab, w=w, scale=scale):
                    return M.auc_histogram_plain(score, lab, w, scale)
                hk, hp = kern(), plain()
                check(torch.equal(hk, hp),
                      f"B9a ({rec}): histogram differs from the plain one")
                check(torch.equal(kern(), hk), f"B9a ({rec}): a rerun differs")
                bins = M.auc_bins(score)
                q = torch.round(w.double() * scale)
                rows = score.shape[0]
                _kernel_record(records, rec, kern, plain,
                               bound_ms(12 * rows + 2 * M.AUC_BINS * 8,
                                        30 * rows),
                               flush, r["launches"]["B9a"], 0.0,
                               library=cuda_ms(lambda: torch.bincount(
                                   bins, q, minlength=M.AUC_BINS)))
                records[rec].update(rows=rows)
            rerun = train(params, kind, rounds)
            rerun.pop("engine")
            out["auc_rerun_bitwise"] = all(
                rerun["ev"][s][m] == r["ev"][s][m] for s in r["ev"]
                for m in ("auc", "aucpr"))
            check(out["auc_rerun_bitwise"], "auc / aucpr differ on a rerun")
        del eng
        torch.cuda.empty_cache()
        res["runs"][key] = out
        runs[key] = r

    # 2 gloo ranks sharing the card: the auc history is the 1-rank run's
    logitraw = dict(OBJ_RUNS[[k for k, _, _ in OBJ_RUNS].index("logitraw")][1],
                    max_depth=depth, max_bin=256)
    wr = 3
    data = D.share({"x": x[:n_train], "label": labels["bin"][:n_train]})
    test = dict(D.share({"x": x[n_train:], "label": labels["bin"][n_train:]}),
                sharding="INTERLEAVED")
    t = time.perf_counter()
    out = D.launch_world(D._train_rank, 2, "cuda", data, logitraw, wr,
                         {"eval_names": ["train", "test"],
                          "eval_data": [None, test]}, backend="gloo")
    one = runs["logitraw"]["ev"]
    two = out[0]["evals_result"]
    res["auc_two_ranks"] = {
        "rounds": wr, "wall_s": time.perf_counter() - t,
        "bitwise": all(two[s][m] == one[s][m][:wr] for s in one
                       for m in ("auc", "aucpr")),
        "auc_test_two_ranks": two["test"]["auc"],
        "auc_test_one_rank": one["test"]["auc"][:wr]}
    del data, test, out
    check(res["auc_two_ranks"]["bitwise"],
          f"auc over 2 gloo ranks differs from 1 rank: "
          f"{res['auc_two_ranks']}")

    # early stopping on the test auc (maximised)
    es_run = train({"objective": "binary:logistic",
                    "eval_metric": ["logloss", "auc"]}, "bin", es_rounds,
                   early_stopping_rounds=3)
    es_run.pop("engine")
    hist = es_run["ev"]["test"]["auc"]
    best = es_run["bst"].best_iteration
    res["early_stopping_auc"] = {"rounds_run": len(hist),
                                 "best_iteration": best,
                                 "best_score": es_run["bst"].best_score,
                                 "test_auc": hist}
    check(best == int(np.argmax(hist)),
          f"best_iteration {best} is not the argmax of the test auc {hist}")
    check(len(hist) in (es_rounds, best + 4),
          f"early stopping ran {len(hist)} rounds (best {best})")

    # the card against the CPU path summing in its fixed point
    fixed = {}
    for key in ("poisson", "aft_normal", "quantile"):
        params, kind = [(p, kd) for k_, p, kd in OBJ_RUNS if k_ == key][0]
        got = {}
        for device in ("cuda", "cpu"):
            keep = _KeepEngine()
            dm, _ = matrices(kind, compare_rows)
            with _cpu_fixed_point(device == "cpu"):
                b = xrt.train({"max_depth": depth, "max_bin": 256, **params},
                              dm, 3, device=device, callbacks=[keep],
                              ray_params=xrt.RayParams(num_actors=1))
            got[device] = (b.get_dump(), keep.engine.get_margins())
        fixed[key] = {"dump_equal": got["cuda"][0] == got["cpu"][0],
                      "margins_bitwise": same_bits(got["cuda"][1],
                                                   got["cpu"][1])}
    res["cpu_fixed_point"] = {"rows": compare_rows, "rounds": 3, **fixed}
    check(all(v["dump_equal"] and v["margins_bitwise"]
              for v in fixed.values()),
          f"the card's model is not the fixed-point CPU path's: {fixed}")

    # predict() and a served value probe: Poisson (B8's exp fused) and the
    # quantiles (K outputs, the identity)
    served = {}
    xt = x[n_train:]
    for key in ("poisson", "quantile"):
        bst = runs[key]["bst"]
        reset_b8_counters()
        t = time.perf_counter()
        vals = xrt.predict(bst, xrt.RayDMatrix(xt),
                           ray_params=xrt.RayParams(num_actors=1))
        wall = time.perf_counter() - t
        launches = (PR.predict_margin.launches,
                    dict(PR.predict_margin.launches_by_value_fn))
        margins = bst.predict(xt, output_margin=True)
        if key == "poisson":
            ref = O.value_transform(torch.from_numpy(margins), "exp").numpy()
            check(launches == (1, {"sigmoid": 0, "exp": 1, "hinge": 0}),
                  f"predict() of the Poisson model: B8 launches {launches}")
            records["B8exp"]["launches"] = launches[0]
        else:
            ref = margins
            check(launches[0] == 1,
                  f"predict() of the quantile model: B8 launches {launches}")
        check(vals.shape == ref.shape and same_bits(vals, ref),
              f"predict() of the {key} model: values not the transform of "
              f"its margins")
        handle = serve.create_server(bst, max_batch=64, max_delay_ms=1.0)
        try:
            probe = _probe(handle, bst, xt[:37])
        finally:
            handle.shutdown()
        check(all(probe.values()), f"served {key} probe: {probe}")
        served[key] = {"predict_wall_s": wall, "b8_launches": launches,
                       "values_shape": list(vals.shape), "probe": probe}
    res["predict"] = served
    # B8's value mode with the exp over the test rows, timed
    bst = runs["poisson"]["bst"]
    fo = bst.device_forest(torch.device("cuda"))
    xd = torch.from_numpy(np.ascontiguousarray(xt)).cuda()
    m0 = float(bst.base_score_margin_np())

    def b8exp():
        return PR.predict_margin(fo, xd, None, base0=m0,
                                 transform="count:poisson")

    def b8plain():
        return PR.predict_margin_plain(fo, xd, None, base0=m0,
                                       transform="count:poisson")
    vk, vp = b8exp(), b8plain()
    check(same_bits(vk.cpu().numpy(), vp.cpu().numpy()),
          "B8's exp values differ from the plain version's")
    _kernel_record(records, "B8exp", b8exp, b8plain,
                   bound_ms(xt.shape[0] * (28 + 1) * 4,
                            xt.shape[0] * bst.num_trees * 12),
                   flush, records["B8exp"]["launches"], 0.0)
    records["B8exp"].update(rows=xt.shape[0], trees=bst.num_trees)
    del runs, fo, xd, flush
    torch.cuda.empty_cache()
    emit(res)
    return res


#: phase 14's MSLR-WEB30K shape (BASELINE.md target 4: 30,000 training
#: queries of about 120 documents, 136 features) and its test fold's share
#: (MSLR's folds split 3 : 1 : 1)
MSLR_QUERIES = 30_000
MSLR_TEST_QUERIES = 10_000
MSLR_GROUP = 120
MSLR_FEATURES = 136
RANK_DEPTH = 8
RANK_METRICS = ["ndcg@10", "map@10"]
RANK_OBJECTIVES = ("rank:ndcg", "rank:pairwise", "rank:map")
#: the kernel table's rows of phase 14
RANKING_KERNELS = ("B13", "B13pair", "B9r", "B9rmap", "B14")


def make_mslr_like(n_groups, group_size, n_features, seed=0):
    """The MSLR-WEB30K-shaped recipe of tests/release/benchmark_ranking.py:
    query sizes a normal of mean ``group_size`` and sd a quarter of it,
    clipped at 4; features standard normal; relevance 0-4 from a noisy
    score of three features."""
    rng = np.random.RandomState(seed)
    sizes = np.clip(
        rng.normal(group_size, group_size / 4, n_groups).astype(int), 4, None
    )
    n = int(sizes.sum())
    qid = np.repeat(np.arange(n_groups), sizes)
    x = rng.randn(n, n_features).astype(np.float32)
    score = 1.2 * x[:, 0] - 0.8 * x[:, 1] + 0.5 * x[:, 2] + rng.randn(n) * 0.7
    rel = np.clip(np.digitize(score, [-1.5, -0.3, 0.7, 1.8]), 0, 4)
    return x, rel.astype(np.float32), qid


def cox_labels(x, y):
    """Path C's labels over the HIGGS rows: phase 13's AFT times
    (``objective_labels``), an uncensored time t as t, a right-censored one
    as -lower (xgboost's convention), an interval-censored one as its lower
    bound right-censored (-lower)."""
    labels, shares = objective_labels(x, y)
    lo, hi = labels["lower"], labels["upper"]
    lab = np.where(lo == hi, lo, -lo).astype(np.float32)
    return lab, {**shares, "event_share": float((lab > 0).mean())}


def ranking_expect(rounds, depth, metrics=2):
    """Launches of a ranking ``train()`` with the test set: per tree the
    main path's K1-K3; K4 in its eval mode only, once a round a set (no
    set-up pass); B13 once a round and at set-up; B9r once a set a round
    for each ndcg / map metric; B4 once a round over the test set."""
    base = train_expect(rounds, depth)
    return {**base, "K4": 2 * rounds, "K4eval": 2 * rounds, "B4": rounds,
            "B13": rounds + 1, "B9r": 2 * metrics * rounds, "B14": 0,
            "B9a": 0}


def cox_expect(rounds, depth):
    """Launches of a survival:cox ``train()`` with the test set and
    cox-nloglik: K4's eval mode once a round a set, B14 once a round and at
    set-up (the training gradients and metric) and once a round for the
    test set's metric, B4 once a round."""
    base = train_expect(rounds, depth)
    return {**base, "K4": 2 * rounds, "K4eval": 2 * rounds, "B4": rounds,
            "B13": 0, "B9r": 0, "B14": 2 * rounds + 1, "B9a": 0}


def timed_once(fn):
    """(fn(), its ms by CUDA events): a plain version's one run."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _rank_edge_sets():
    """B13 / B9r edge cases on the card: groups of 1, 2 and 1,300
    documents and one larger than the shared staging (2,500), all scores
    equal (round 0), every label equal, zero weights."""
    rng = np.random.default_rng(14)
    sizes = [1, 2, 1300, 2500, 37, 5, 60]
    n = int(sum(sizes))
    qid = np.repeat(np.arange(len(sizes)), sizes)
    m = rng.standard_normal(n).astype(np.float32)
    y = rng.integers(0, 5, n).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[::9] = 0.0
    cases = {"mixed": (m, y, w)}
    cases["tied_scores"] = (np.zeros(n, np.float32), y, w)
    cases["equal_labels"] = (m, np.full(n, 2.0, np.float32), w)
    return qid, cases


def _cox_edge_sets():
    """B14 edge cases: every row censored, ties in time, and w = 0 rows
    holding the largest margin."""
    rng = np.random.default_rng(15)
    n = 5000
    t = (np.round(rng.exponential(2.0, n) * 4) / 4 + 0.25).astype(np.float32)
    m = rng.standard_normal(n).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[::7] = 0.0
    m[::7] = 60.0
    lab = np.where(rng.uniform(size=n) < 0.3, -t, t).astype(np.float32)
    return {"ties_and_zero_weights": (m, lab, w),
            "all_censored": (m, -t, w)}


def phase_ranking(x_higgs, y_higgs, records, rounds=10, depth=RANK_DEPTH,
                  cut_queries=300, cox_cut=200_000, cox_depth=6,
                  cut_rounds=2):
    """Phase 14: learning to rank (path R) and survival:cox (path C) at full
    width through ``train()``, ``predict()``, serve and ``RayXGBRanker``,
    B13 / B9r / B14 against their plain versions, launches exact, the
    models equal to the fixed-point CPU path's, 2 gloo ranks."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch import distributed as D
    from xgboost_ray_tpu_torch import serve
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.ops import _build
    from xgboost_ray_tpu_torch.ops import cox as CX
    from xgboost_ray_tpu_torch.ops import grow as G
    from xgboost_ray_tpu_torch.ops import metrics as M
    from xgboost_ray_tpu_torch.ops import objectives as O
    from xgboost_ray_tpu_torch.ops import predict as PR
    from xgboost_ray_tpu_torch.ops import ranking as R
    from xgboost_ray_tpu_torch.sklearn import RayXGBRanker

    t_phase = time.perf_counter()
    res = {"phase": "ranking"}
    steps = res["step_s"] = {}

    def lap(name, since):
        steps[name] = time.perf_counter() - since
        return time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    # ---- path R: MSLR-WEB30K's shape ------------------------------------
    t0 = time.perf_counter()
    x, rel, qid = make_mslr_like(MSLR_QUERIES, MSLR_GROUP, MSLR_FEATURES, 0)
    xt, relt, qidt = make_mslr_like(MSLR_TEST_QUERIES, MSLR_GROUP,
                                    MSLR_FEATURES, 1)
    sizes = np.bincount(qid)
    res["mslr"] = {"docs": int(x.shape[0]), "queries": MSLR_QUERIES,
                   "test_docs": int(xt.shape[0]),
                   "test_queries": MSLR_TEST_QUERIES,
                   "features": MSLR_FEATURES, "largest_query":
                   int(sizes.max()), "mean_query": float(sizes.mean()),
                   "data_s": time.perf_counter() - t0}

    def train(params, dtrain, dtest, n_rounds, test_name="test"):
        ev, extra = {}, {}
        keep = _KeepEngine()
        builds = _build.compile_count()
        reset_kernel_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        bst = xrt.train(params, dtrain, n_rounds,
                        evals=[(dtrain, "train"), (dtest, test_name)],
                        evals_result=ev, additional_results=extra,
                        callbacks=[keep], device="cuda:0",
                        ray_params=xrt.RayParams(num_actors=1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = kernel_launches()
        check(_build.compile_count() == builds,
              f"{params['objective']}: a kernel build inside train()")
        return {"bst": bst, "ev": ev, "launches": launches, "wall_s": wall,
                "setup_s": extra["setup_time_s"],
                "round_ms": [r * 1e3 for r in extra["round_times_s"]],
                "engine": keep.engine}

    dtrain = xrt.RayDMatrix(x, rel, qid=qid)
    dtest = xrt.RayDMatrix(xt, relt, qid=qidt)
    rank_params = {"eval_metric": RANK_METRICS, "max_depth": depth,
                   "eta": 0.1, "max_bin": 256}
    runs = {}
    for name in RANK_OBJECTIVES:
        r = train({"objective": name, **rank_params}, dtrain, dtest, rounds)
        expect = ranking_expect(rounds, depth)
        check_launches(r["launches"], expect, f"{name} at MSLR's shape")
        for s, ms in r["ev"].items():
            for m, v in ms.items():
                check(all(np.isfinite(v)) and all(0 <= u <= 1 for u in v),
                      f"{name}: {s}-{m} not in [0, 1]: {v}")
        res[name] = {"launches": r["launches"], "expected": expect,
                     "history": r["ev"], "round_ms": r["round_ms"],
                     "round_ms_median": float(np.median(r["round_ms"])),
                     "setup_s": r["setup_s"], "train_wall_s": r["wall_s"]}
        runs[name] = r
    hist = runs["rank:ndcg"]["ev"]["test"]["ndcg@10"]
    check(hist[-1] > hist[0], f"rank:ndcg: test ndcg@10 did not rise {hist}")
    t0 = lap("data_and_trains", t_phase)

    # B13 (both modes) and B9r (both metrics) against their plain versions
    # on one round's inputs at full size
    eng = runs["rank:ndcg"]["engine"]
    m_now = eng.margins.view(-1)
    lay = eng.groups
    for key, name in (("B13", "rank:ndcg"), ("B13pair", "rank:pairwise")):
        def kern(name=name):
            return R.rank_grad_hess(m_now, eng.label, eng.weight, lay, name)

        def plain(name=name):
            return R.rank_grad_hess_plain(m_now, eng.label, eng.weight, lay,
                                          name)
        gk = kern()
        gp, plain_ms = timed_once(plain)
        check(torch.equal(bits(gk), bits(gp)),
              f"{key}: gradients differ from the plain version's "
              f"({float((gk - gp).abs().max())})")
        check(torch.equal(bits(kern()), bits(gk)), f"{key}: a rerun differs")
        nbytes = eng.n_rows * (3 * 4 + 8) + (lay.n_groups + 1) * 8
        _kernel_record(records, key, kern, plain_ms,
                       bound_ms(nbytes, R.pair_operations(
                           lay, eng.label, name != "rank:pairwise")),
                       flush, runs[name]["launches"]["B13"], 0.0, iters=5)
        records[key].update(docs=eng.n_rows, queries=lay.n_groups,
                            width=lay.width)
    for key, kind in (("B9r", "ndcg"), ("B9rmap", "map")):
        def kern(kind=kind):
            return M.rank_metric_contrib(kind, m_now, eng.label, lay, 10)

        def plain(kind=kind):
            return M.rank_metric_plain(kind, m_now, eng.label, lay, 10)
        ok = kern()
        op, plain_ms = timed_once(plain)
        check(torch.equal(ok.cpu(), op.cpu()),
              f"{key}: ({ok.tolist()}) differs from the plain version "
              f"({op.tolist()})")
        _kernel_record(records, key, kern, plain_ms,
                       bound_ms(eng.n_rows * 8 + lay.n_groups * 12,
                                R.rank_metric_operations(lay, kind, 10)),
                       flush, runs["rank:ndcg"]["launches"]["B9r"], 0.0,
                       iters=5)
        records[key].update(docs=eng.n_rows, queries=lay.n_groups)
    # the edge cases, each mode and metric
    eq, ecases = _rank_edge_sets()
    elay = R.GroupLayout(torch.from_numpy(R.shard_group_offsets([eq])).cuda(),
                         int(np.bincount(eq).max()))
    edges = {}
    for case, (m, y, w) in ecases.items():
        mt, yt, wt = (torch.from_numpy(a).cuda() for a in (m, y, w))
        for name in RANK_OBJECTIVES:
            same = torch.equal(
                bits(R.rank_grad_hess(mt, yt, wt, elay, name)),
                bits(R.rank_grad_hess_plain(mt, yt, wt, elay, name)))
            edges[f"{case}_{name}"] = same
        for kind in ("ndcg", "map"):
            for k in (None, 3):
                edges[f"{case}_{kind}@{k}"] = torch.equal(
                    M.rank_metric_contrib(kind, mt, yt, elay, k).cpu(),
                    M.rank_metric_plain(kind, mt, yt, elay, k).cpu())
    res["b13_b9r_edges"] = {"sizes": np.bincount(eq).tolist(), **edges}
    check(all(edges.values()), f"B13 / B9r edge cases: {edges}")
    t0 = lap("b13_b9r_holds", t0)

    # K1 at F = 136 (level 7: 128 nodes, over the first 1,000,000 rows) and
    # B4's 511-node heap against their plain versions once (K2 at 128 and K3
    # at 256 nodes are held by the fixed-point CPU path's models below)
    k1_rows = min(eng.n_rows, 1_000_000)
    gen = torch.Generator(device="cuda").manual_seed(14)
    node = torch.randint(0, 128, (k1_rows,), generator=gen, device="cuda")
    order = torch.sort(node, stable=True).indices.to(torch.int32)
    seg = torch.cat([torch.zeros(1, device="cuda", dtype=torch.long),
                     torch.cumsum(torch.bincount(node, minlength=128), 0)]
                    ).to(torch.int32)
    k1_err, _ = hold_k1(eng.bins[:k1_rows], eng.gh[0, :k1_rows].contiguous(),
                        order, seg, 128, 257, eng.qscale[0], False,
                        "F=136, 128 nodes")
    es = [e for e in eng.evals if not e.is_train][0]
    tree = eng.trees[-1]
    b4k = G.predict_tree_binned(tree, es.bins, depth, 256)
    b4p = G.predict_tree_binned_plain(tree, es.bins, depth, 256)
    check(torch.equal(bits(b4k), bits(b4p)),
          "B4 at depth 8 (511-node heap) differs from its plain version")
    res["depth8_f136"] = {"k1_rows": k1_rows, "k1_level7_err": k1_err,
                          "b4_bitwise": True,
                          "bins_dtype": str(eng.bins.dtype)}
    del node, order, seg
    t0 = lap("k1_b4_holds", t0)

    # predict() over the test rows (B8's margins: the ranking value is the
    # margin) against the engine's test margins; a served probe
    bst = runs["rank:ndcg"]["bst"]
    reset_b8_counters()
    t = time.perf_counter()
    pred = xrt.predict(bst, xrt.RayDMatrix(xt),
                       ray_params=xrt.RayParams(num_actors=1))
    pwall = time.perf_counter() - t
    b8n = PR.predict_margin.launches
    diff = float(np.abs(pred - es.margins.cpu().numpy()[:, 0]).max())
    check(diff <= 1e-3, f"rank:ndcg predict() is {diff} from the test "
                        f"margins")
    handle = serve.create_server(bst, max_batch=64, max_delay_ms=1.0)
    try:
        probe = _probe(handle, bst, xt[:37])
    finally:
        handle.shutdown()
    check(all(probe.values()), f"served rank:ndcg probe: {probe}")
    res["predict"] = {"rows": int(xt.shape[0]), "wall_s": pwall,
                      "b8_launches": b8n, "max_diff_to_train_margins": diff,
                      "probe": probe}
    del eng, es, m_now, lay
    runs = {k: {kk: vv for kk, vv in v.items() if kk != "engine"}
            for k, v in runs.items()}
    torch.cuda.empty_cache()

    # RayXGBRanker over the same data: train()'s model and history
    est = RayXGBRanker(n_estimators=rounds, max_depth=depth,
                       objective="rank:ndcg", learning_rate=0.1, max_bin=256,
                       eval_metric=RANK_METRICS, device="cuda:0")
    reset_kernel_launches()
    t = time.perf_counter()
    est.fit(x, rel, qid=qid, eval_set=[(xt, relt)], eval_qid=[qidt])
    fit_wall = time.perf_counter() - t
    ref = runs["rank:ndcg"]
    same_model = est.get_booster().get_dump() == ref["bst"].get_dump()
    ev = est.evals_result()
    same_hist = ev["validation_0"] == ref["ev"]["test"]
    res["ranker"] = {"fit_wall_s": fit_wall, "model_equal": same_model,
                     "history_equal": same_hist,
                     "launches": kernel_launches()}
    check(same_model and same_hist,
          "RayXGBRanker's model or history differs from train()'s")
    del est, dtrain, dtest
    torch.cuda.empty_cache()
    t0 = lap("predict_serve_ranker", t0)

    # the card's models against the fixed-point CPU path's on a cut, both at
    # num_actors=2 (two shards folded: each shard's queries its own groups),
    # then 2 gloo ranks sharing the card against the same CPU run
    cut = int(np.searchsorted(qid, cut_queries))
    xc, rc, qc = x[:cut], rel[:cut], qid[:cut]
    x_cox = x_higgs[:cox_cut]
    lab_cox, _ = cox_labels(x_cox, y_higgs[:cox_cut])
    cox_params = {"objective": "survival:cox", "eval_metric": ["cox-nloglik"],
                  "max_depth": cox_depth, "max_bin": 256}
    fixed, cpu2 = {}, {}
    for name in RANK_OBJECTIVES + ("survival:cox",):
        cox = name == "survival:cox"
        params = cox_params if cox else {"objective": name, **rank_params}
        got = {}
        for device in ("cuda:0", "cpu"):
            keep = _KeepEngine()
            dm = (xrt.RayDMatrix(x_cox, lab_cox) if cox
                  else xrt.RayDMatrix(xc, rc, qid=qc))
            ev = {}
            with _cpu_fixed_point(device == "cpu"):
                b = xrt.train(params, dm, cut_rounds, device=device,
                              callbacks=[keep], evals=[(dm, "train")],
                              evals_result=ev,
                              ray_params=xrt.RayParams(num_actors=2))
            got[device] = (b.get_dump(), keep.engine.get_margins(), ev)
        card, cpu = got["cuda:0"], got["cpu"]
        fixed[name] = {"dump_equal": card[0] == cpu[0],
                       "margins_bitwise": same_bits(card[1], cpu[1])}
        if cox:
            fixed[name]["history_equal"] = card[2] == cpu[2]
        cpu2[name] = cpu
    t0 = lap("cpu_fixed_point", t0)
    res["cpu_fixed_point"] = {"queries": cut_queries, "docs": cut,
                              "cox_rows": cox_cut, "rounds": cut_rounds,
                              "num_actors": 2, **fixed}
    check(all(v["dump_equal"] and v["margins_bitwise"]
              for v in fixed.values()) and fixed["survival:cox"][
                  "history_equal"],
          f"the card's models are not the fixed-point CPU path's: {fixed}")

    two = {}
    t = time.perf_counter()
    with D.World(2, "cuda", backend="gloo") as w:
        for name in RANK_OBJECTIVES + ("survival:cox",):
            if name == "survival:cox":
                data = D.share({"x": x_cox, "label": lab_cox})
                params = cox_params
            else:
                data = D.share({"x": xc, "label": rc, "qid": qc})
                params = {"objective": name, **rank_params}
            out = w.run(D._train_rank, data, params, cut_rounds,
                        {"sharding": "INTERLEAVED"})
            dump = xrt.RayXGBoostBooster.load_raw(out[0]["model"]).get_dump()
            ref_dump, _, ref_ev = cpu2[name]
            hist = out[0]["evals_result"]["train"]
            rel_err = max(abs(a - b) / max(abs(b), 1e-30)
                          for m in hist for a, b in zip(hist[m],
                                                        ref_ev["train"][m]))
            two[name] = {
                "dump_equal": dump == ref_dump,
                "history": hist, "history_rel_to_cpu": rel_err,
                "launches_rank0": out[0]["launches"],
                "allreduce_bytes_per_round": out[0]["additional_results"][
                    "allreduce_bytes_per_round"]}
            tol = 0.0 if name == "survival:cox" else 1e-9
            check(two[name]["dump_equal"] and rel_err <= tol,
                  f"{name} over 2 gloo ranks differs from the fixed-point "
                  f"CPU path at num_actors=2: {two[name]}")
    cox_gather = 4 * cox_cut // 2  # (n - 1) / n of the gathered margins
    check(two["survival:cox"]["allreduce_bytes_per_round"] >= cox_gather,
          "survival:cox over 2 ranks: no margin all-gather in the round's "
          "bytes")
    res["two_ranks"] = {"wall_s": time.perf_counter() - t, **two}
    t0 = lap("two_ranks", t0)
    del x, rel, qid, xt, relt, qidt, xc, rc, qc, runs
    torch.cuda.empty_cache()

    # ---- path C: survival:cox at the HIGGS shape and split ---------------
    n = x_higgs.shape[0]
    n_train = n - TEST_ROWS
    t0 = time.perf_counter()
    lab, shares = cox_labels(x_higgs, y_higgs)
    res["cox"] = {"rows": n_train, "test_rows": TEST_ROWS,
                  "labels_s": time.perf_counter() - t0, **shares}
    ctrain = xrt.RayDMatrix(x_higgs[:n_train], lab[:n_train])
    ctest = xrt.RayDMatrix(x_higgs[n_train:], lab[n_train:])
    r = train({**cox_params, "max_depth": 6}, ctrain, ctest, rounds)
    expect = cox_expect(rounds, 6)
    check_launches(r["launches"], expect, "survival:cox at HIGGS shape")
    for s, ms in r["ev"].items():
        check(all(np.isfinite(ms["cox-nloglik"])),
              f"survival:cox: {s} cox-nloglik not finite")
    eng = r.pop("engine")
    res["cox"].update(launches=r["launches"], expected=expect,
                      history=r["ev"], round_ms=r["round_ms"],
                      round_ms_median=float(np.median(r["round_ms"])),
                      setup_s=r["setup_s"], train_wall_s=r["wall_s"])
    cox = eng.cox
    m_now = eng.margins.view(-1)

    def kern():
        return CX.cox_round(m_now, cox.label, cox.weight, cox.setup,
                            with_metric=True)

    def plain():
        return CX.cox_round_plain(m_now, cox.label, cox.weight, cox.setup,
                                  with_metric=True)
    gk, sk = kern()
    (gp, sp), plain_ms = timed_once(plain)
    check(torch.equal(bits(gk), bits(gp)) and torch.equal(sk.cpu(), sp.cpu()),
          f"B14: gradients or metric sums differ from the plain version's "
          f"({float((gk - gp).abs().max())}, {sk.tolist()} {sp.tolist()})")
    neg_t = -cox.label.abs()
    _kernel_record(records, "B14", kern, plain_ms,
                   bound_ms(CX.cox_round_bytes(n_train, n_train, True),
                            60 * n_train),
                   flush, r["launches"]["B14"], 0.0,
                   library=cuda_ms(lambda: torch.sort(neg_t, stable=True),
                                   iters=5, warmup=1), iters=5)
    records["B14"].update(rows=n_train, setup_sort="torch.sort(stable)")
    cedges = {}
    for case, (m, lb, w) in _cox_edge_sets().items():
        mt, lt, wt = (torch.from_numpy(a).cuda() for a in (m, lb, w))
        su = CX.cox_setup(lt)
        (a, sa), (b, sb) = (CX.cox_round(mt, lt, wt, su, with_metric=True),
                            CX.cox_round_plain(mt, lt, wt, su,
                                               with_metric=True))
        cedges[case] = bool(torch.equal(bits(a), bits(b))
                            and torch.equal(sa.cpu(), sb.cpu()))
    res["b14_edges"] = cedges
    check(all(cedges.values()), f"B14 edge cases: {cedges}")

    # predict(): the hazard ratio exp(margin), B8's exp fused; C7: finite up
    # to 88.72
    bst = r["bst"]
    xct = x_higgs[n_train:]
    reset_b8_counters()
    vals = xrt.predict(bst, xrt.RayDMatrix(xct),
                       ray_params=xrt.RayParams(num_actors=1))
    launches = dict(PR.predict_margin.launches_by_value_fn)
    margins = bst.predict(xct, output_margin=True)
    want = O.value_transform(torch.from_numpy(margins), "exp").numpy()
    check(same_bits(vals, want) and np.isfinite(vals).all(),
          "survival:cox predict(): values not exp of the margins")
    fo = bst.device_forest(torch.device("cuda"))
    big = torch.linspace(80.0, 89.0, 901, device="cuda")[:, None]
    xb = torch.zeros((901, 28), device="cuda")
    vb = PR.predict_margin(fo, xb, big, transform="survival:cox")[:, 0]
    vpb = PR.predict_margin_plain(fo, xb, big, transform="survival:cox")[:, 0]
    mb = PR.predict_margin(fo, xb, big)[:, 0]
    finite = bool(torch.isfinite(vb[mb <= 88.72]).all())
    above = bool(torch.isinf(vb[mb > 88.723]).all())
    check(finite and above and torch.equal(bits(vb), bits(vpb)),
          "B8's exp at margins 80 .. 89: not finite up to 88.72, inf above, "
          "and bitwise its plain version")
    res["cox_predict"] = {"b8_launches_by_value_fn": launches,
                          "finite_to_88_72": finite, "inf_above": above}
    del eng, cox, m_now, fo, ctrain, ctest
    torch.cuda.empty_cache()
    lap("cox_path", t0)
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 15: stochastic boosting and random forests (B12r, B12f, K2's masked
# level step, K4's T-tree add)
# ---------------------------------------------------------------------------

#: phase 15's configurations at the HIGGS split (10 rounds, depth 6)
SAMPLING_RUNS = (
    ("S1", {"objective": "binary:logistic", "subsample": 0.8,
            "colsample_bytree": 0.8, "colsample_bynode": 0.8,
            "eval_metric": ["logloss", "error@0.3", "error@0.7", "auc"]}),
    ("S2", {"objective": "binary:logistic",
            "sampling_method": "gradient_based", "top_rate": 0.2,
            "other_rate": 0.1, "colsample_bylevel": 0.7}),
    ("S3", {"objective": "binary:logistic", "colsample_bynode": 0.5}),
)
#: the kernel table's rows of phase 15
SAMPLING_KERNELS = ("B12r", "B12rgoss", "B12f", "K2masked", "K4trees")
RF_TREES = 100
RF_DEPTH = 8
#: int32 operations an H100 SXM issues a second: 64 INT32 lanes an SM
#: (Hopper white paper) x 132 SMs x 1.98 GHz boost
H100_INT32_OPS = 64 * 132 * 1.98e9
#: integer operations of one threefry2x32 draw: 20 rounds of add, rotate
#: (a funnel shift) and xor, 6 key injections of two adds, the final xor
THREEFRY_OPS = 20 * 3 + 6 * 2 + 1


def sampling_bound_ms(nbytes, int_ops):
    """``bound_ms`` for integer work: bytes over the memory rate against
    int32 operations over the card's int32 rate."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = int_ops / H100_INT32_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sampling_fixed_point_scales(engine, gh_sel):
    """A sampled tree's fixed-point scales on the CPU path that sums in the
    card's fixed point (``_cpu_fixed_point``)."""
    from xgboost_ray_tpu_torch.ops import histogram as H

    return H.quant_scales(gh_sel, engine.sample_rows_global, engine.coll.max)


def sampling_expect(params, rounds, depth, held_out=True, trees=1):
    """Exact launches of a binary ``train()`` of ``rounds`` rounds with
    ``params``' sampling: per tree the main path's K1-K3, B12r once a block
    (uniform) or twice (GOSS), B12f once a tree for bytree and once a level
    for bylevel and for bynode, K2 masked on every level any mask covers;
    K4 a round and round 0's, with a held-out set one eval-mode K4 and one
    B4 a round; a sampled round walks its trees over the training rows (one
    B4 a round); T > 1 trees take K4's T-tree add."""
    n_trees = rounds * trees
    out = train_expect(n_trees, depth)
    out["K4"] = rounds + 1 + (rounds if held_out else 0)
    out["K4eval"] = rounds if held_out else 0
    goss = params.get("sampling_method") == "gradient_based"
    sampled = goss or params.get("subsample", 1.0) < 1.0
    out["B12r"] = n_trees * (2 if goss else 1) if sampled else 0
    per_tree = ((1 if params.get("colsample_bytree", 1.0) < 1.0 else 0)
                + depth * ((params.get("colsample_bylevel", 1.0) < 1.0)
                           + (params.get("colsample_bynode", 1.0) < 1.0)))
    out["B12f"] = n_trees * per_tree
    out["K2masked"] = n_trees * depth if per_tree else 0
    out["B4"] = rounds * ((1 if sampled else 0) + (1 if held_out else 0))
    out["K4trees"] = ((rounds + (rounds if held_out else 0))
                      if trees > 1 else 0)
    return out


def phase_sampling(x, y, records, rounds=10, depth=6, compare_rows=50_000):
    """Phase 15 at full width: ``train()`` at the HIGGS split (10,500,000
    rows train, the last 500,000 the test set, depth 6, 10 rounds, seed 7)
    unsampled (the main path) and with S1 (uniform rows 0.8, bytree and
    bynode 0.8, error@t at two thresholds), S2 (GOSS 0.2 / 0.1, bylevel
    0.7) and S3 (bynode 0.5 over feature weights, a quarter of them 0),
    each run's launches counted from 0 and checked exactly; B12r (both
    policies), B12f, K2's masked level step and K4's T-tree add bitwise
    their plain versions at the runs' shapes and timed; each configuration
    against the CPU path summing in the card's fixed point on a
    ``compare_rows``-row cut (2 rounds; dumps equal); S4
    ``RayXGBRFClassifier(n_estimators=100, max_depth=8)`` fit on the
    training rows, ``predict_proba`` on the test rows (B8), and a 6-tree
    forest against the fixed-point CPU path; S5 a sampled Covertype
    ``multi:softprob`` with ``logloss`` and ``auc``; S6 S1 over 2 gloo ranks
    against one rank at ``num_actors=2``. The logloss falls in every
    run."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch import distributed as D
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.ops import _build
    from xgboost_ray_tpu_torch.ops import grow as G
    from xgboost_ray_tpu_torch.ops import histogram as H
    from xgboost_ray_tpu_torch.ops import objectives as O
    from xgboost_ray_tpu_torch.ops import predict as PR
    from xgboost_ray_tpu_torch.ops import random as R
    from xgboost_ray_tpu_torch.ops import sampling as SM
    from xgboost_ray_tpu_torch.ops import split as S
    from xgboost_ray_tpu_torch.sklearn import RayXGBRFClassifier

    t_phase = time.perf_counter()
    n = x.shape[0]
    n_train = n - TEST_ROWS
    f = x.shape[1]
    rng = np.random.default_rng(15)
    fw = rng.random(f).astype(np.float32)
    fw[rng.permutation(f)[:f // 4]] = 0.0
    res = {"phase": "sampling", "rows": n, "train_rows": n_train,
           "test_rows": TEST_ROWS, "rounds": rounds, "max_depth": depth,
           "feature_weights_zero": int((fw == 0).sum()), "runs": {},
           "steps_s": {}}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def lap(name, since):
        res["steps_s"][name] = time.perf_counter() - since
        return time.perf_counter()

    def train(params, rows=None, weights=None, n_rounds=rounds,
              device="cuda:0", actors=1, held_out=True):
        hi = n_train if rows is None else rows
        dtrain = xrt.RayDMatrix(x[:hi], y[:hi], feature_weights=weights)
        evals = [(dtrain, "train")]
        if held_out:
            evals.append((xrt.RayDMatrix(x[n_train:], y[n_train:]), "test"))
        ev, extra = {}, {}
        keep = _KeepEngine()
        builds = _build.compile_count()
        reset_kernel_launches()
        if device != "cpu":
            torch.cuda.synchronize()
        t = time.perf_counter()
        bst = xrt.train({"max_depth": depth, "max_bin": 256, "seed": 7,
                         **params}, dtrain, n_rounds, evals=evals,
                        evals_result=ev, additional_results=extra,
                        callbacks=[keep], device=device,
                        ray_params=xrt.RayParams(num_actors=actors))
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(_build.compile_count() == builds,
              "phase 15: a kernel build inside train()")
        return {"bst": bst, "ev": ev, "launches": kernel_launches(),
                "wall_s": wall, "engine": keep.engine,
                "round_ms": [r * 1e3 for r in extra["round_times_s"]]}

    def falls(ev, key):
        ll = ev["test"]["logloss"]
        check(all(np.isfinite(ll)) and ll[-1] < ll[0],
              f"{key}: the test logloss does not fall: {ll}")
        return ll

    # the main path and S1-S3 in turns; each run's launches checked
    base = train({"objective": "binary:logistic"})
    base.pop("engine")
    res["main_path_round_ms_median"] = float(np.median(base["round_ms"]))
    res["main_path_round_ms"] = base["round_ms"]
    engines = {}
    for key, params in SAMPLING_RUNS:
        r = train(params, weights=fw if key == "S3" else None)
        engines[key] = r.pop("engine")
        expect = sampling_expect(params, rounds, depth)
        for k, v in expect.items():
            check(r["launches"][k] == v,
                  f"{key}: {k} launched {r['launches'][k]} times, expected "
                  f"{v}")
        out = {"params": params, "launches": r["launches"],
               "expected": expect, "round_ms": r["round_ms"],
               "round_ms_median": float(np.median(r["round_ms"])),
               "train_wall_s": r["wall_s"],
               "test_logloss": falls(r["ev"], key)}
        if key == "S1":
            out["test_error_at"] = {m: r["ev"]["test"][m]
                                    for m in ("error@0.3", "error@0.7")}
            check(r["ev"]["test"]["error@0.3"] != r["ev"]["test"]["error@0.7"],
                  "S1: error@0.3 and error@0.7 are the same sums")
        if key == "S3":
            used = set(np.asarray(r["bst"].forest.feature).ravel().tolist())
            out["zero_weight_features_split"] = sorted(
                used & set(np.flatnonzero(fw == 0).tolist()))
            check(not out["zero_weight_features_split"],
                  f"S3: a feature of weight 0 was split on: {used}")
        res["runs"][key] = out
        if key == "S1":
            for k in ("B12r", "B12f", "K2masked"):
                records[k]["launches"] = r["launches"][k]
        if key == "S2":
            records["B12rgoss"]["launches"] = r["launches"]["B12r"]
        del r
    t0 = lap("main_path_and_s1_s3", t_phase)
    emit({"phase": "sampling_rounds", "card": CARD,
          "main_path_round_ms_median": res["main_path_round_ms_median"],
          **{k: res["runs"][k]["round_ms_median"] for k, _ in SAMPLING_RUNS}})

    # B12r against its plain version at the runs' shape (the engine's next
    # gradients over the 10.5M training rows)
    e1, e2, e3 = engines["S1"], engines["S2"], engines["S3"]
    key = R.fold_in(R.fold_in(R.prng_key(7), rounds), G.SALT_SUBSAMPLE)
    for rec, eng in (("B12r", e1), ("B12rgoss", e2)):
        gh = eng.gh[0]
        spec = eng.samp_spec
        m = SM.row_budget(n_train, spec)
        cut = SM.goss_counts(n_train, spec)[0] if rec == "B12rgoss" else m

        def kern(gh=gh, spec=spec):
            return SM.sample_rows(gh, n_train, key, spec)

        def plain(gh=gh, spec=spec):
            return SM.sample_rows_plain(gh, n_train, key, spec)
        (rk, gk), (rp, gp) = kern(), plain()
        torch.cuda.synchronize()
        for sl in (slice(0, cut), slice(cut, m)):
            ok = torch.argsort(rk[sl].long(), stable=True)
            op = torch.argsort(rp[sl].long(), stable=True)
            check(torch.equal(rk[sl][ok], rp[sl][op]),
                  f"{rec}: the selected rows differ from the plain version's")
            check(torch.equal(bits(gk[sl][ok]), bits(gp[sl][op])),
                  f"{rec}: gh_sel differs from the plain version's")
        again = kern()
        check(torch.equal(again[0], rk) and torch.equal(bits(again[1]),
                                                        bits(gk)),
              f"{rec}: a rerun differs")
        u = R.uniform(key, (n_train,), device="cuda")
        # the function's own work: a draw a row (GOSS: its sampled stage;
        # the top stage's score is 5 operations a row), the selected rows
        # and gradients written, GOSS's gradients read once
        if rec == "B12r":
            lib = cuda_ms(lambda u=u, m=m: torch.topk(u, m), iters=3)
            nbytes, ops = m * 12, n_train * THREEFRY_OPS
        else:
            score = SM.goss_score(gh)
            top_n, rand_n = SM.goss_counts(n_train, spec)
            lib = cuda_ms(lambda: (torch.topk(score, top_n),
                                   torch.topk(u, rand_n)), iters=3)
            nbytes = n_train * 8 + m * 12
            ops = n_train * (THREEFRY_OPS + 5)
        _kernel_record(records, rec, kern, plain,
                       sampling_bound_ms(nbytes, ops),
                       flush, records[rec]["launches"], 0.0, library=lib,
                       iters=5)
        records[rec].update(rows=n_train, selected=m)
        del rk, gk, rp, gp, again, u
    # B12f: a level's bynode masks (64 x 28) over S3's weights, and S1's
    # Bernoulli ones
    log_fw = e3.log_fw
    nkey = R.fold_in(R.fold_in(key, G.SALT_BYNODE), 5)
    for lw, rate in ((log_fw, 0.5), (None, 0.8)):
        mk = G.sample_feature_mask(nkey, f, rate, lw, 64, device="cuda")
        mp = G.sample_feature_mask_plain(nkey, f, rate, lw, 64,
                                         device="cuda")
        check(torch.equal(mk, mp), "B12f: masks differ from the plain ones")
    _kernel_record(
        records, "B12f",
        lambda: G.sample_feature_mask(nkey, f, 0.5, log_fw, 64,
                                      device="cuda"),
        lambda: G.sample_feature_mask_plain(nkey, f, 0.5, log_fw, 64,
                                            device="cuda"),
        sampling_bound_ms(f * 4 + 64 * f, 64 * f * (THREEFRY_OPS + f)),
        flush, records["B12f"]["launches"], 0.0)
    # K2's masked level step at level 5 (32 nodes) of the main path's
    # shape, a node mask [32, 28]
    nbt, n_nodes = 257, 32
    bins, ghl, order, seg = level_inputs(n_train, f, n_nodes, 9, False)
    hp, _ = H.build_histogram_plain(bins, ghl, order, seg, n_nodes, nbt)
    del bins, ghl, order, seg
    g2 = torch.Generator(device="cuda").manual_seed(21)
    level = dict(
        hist=hp[0::2].contiguous(), prev_hist=hp[0::2] + hp[1::2],
        small_is_right=torch.rand(16, generator=g2, device="cuda") < 0.5,
        active=torch.arange(32, device="cuda") % 13 != 5,
        feature_mask=G.sample_feature_mask(nkey, f, 0.5, None, n_nodes,
                                           device="cuda"))
    cuts = torch.sort(torch.randn(f, nbt - 2, generator=g2, device="cuda"),
                      dim=1).values
    p = S.SplitParams()
    rec_k = S.TreeRecords(G.empty_tree(127, "cuda"), cuts, None, p)
    rec_p = S.TreeRecords(G.empty_tree(127, "cuda"), cuts, None, p)
    lk = S.split_level(**level, rec=rec_k)
    lp = S.split_level_plain(**level, rec=rec_p)
    torch.cuda.synchronize()
    pairs = ([(getattr(lk.splits, k), getattr(lp.splits, k))
              for k in lk.splits._fields]
             + [(getattr(lk, k), getattr(lp, k))
                for k in ("node_value", "state", "active", "hist")]
             + list(zip(rec_k.tree, rec_p.tree)))
    check(all(torch.equal(bits(a), bits(b)) for a, b in pairs),
          "K2's masked level step not bitwise equal to its plain version")
    hist_bytes = n_nodes * f * nbt * 2 * 4
    _kernel_record(
        records, "K2masked", lambda: S.split_level(**level, rec=rec_k),
        lambda: S.split_level_plain(**level, rec=rec_p),
        bound_ms(2 * hist_bytes + 16 + 32 + 32 * (4 + 38) + n_nodes * f,
                 n_nodes * f * (3 * nbt + 30 * (nbt - 2))),
        flush, records["K2masked"]["launches"], 0.0)
    del hp, level, lk, lp
    torch.cuda.empty_cache()
    t0 = lap("b12_k2_holds", t0)

    # S4: the random forest (100 parallel trees, depth 8) fit and predict
    builds = _build.compile_count()
    reset_kernel_launches()
    PR.predict_margin.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    clf = RayXGBRFClassifier(n_estimators=RF_TREES, max_depth=RF_DEPTH,
                             random_state=7, device="cuda:0")
    clf.fit(x[:n_train], y[:n_train])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    rf_launches = kernel_launches()
    t = time.perf_counter()
    proba = clf.predict_proba(x[n_train:])
    predict_s = time.perf_counter() - t
    b8 = PR.predict_margin.launches
    check(_build.compile_count() == builds, "S4: a kernel build in fit")
    pe = np.clip(proba[:, 1], 1e-7, 1 - 1e-7)
    yt = y[n_train:]
    rf_ll = float(-np.mean(yt * np.log(pe) + (1 - yt) * np.log(1 - pe)))
    check(proba.shape == (TEST_ROWS, 2) and np.isfinite(proba).all()
          and rf_ll < np.log(2.0), f"S4: predict_proba {proba.shape}, "
                                   f"test logloss {rf_ll}")
    rf_expect = sampling_expect({"subsample": 0.8, "colsample_bynode": 0.8},
                                1, RF_DEPTH, held_out=False, trees=RF_TREES)
    for k, v in rf_expect.items():
        check(rf_launches[k] == v,
              f"S4: {k} launched {rf_launches[k]} times, expected {v}")
    check(b8 >= 1, "S4: predict_proba launched no B8")
    records["K4trees"]["launches"] = rf_launches["K4trees"]
    res["S4"] = {"n_estimators": RF_TREES, "max_depth": RF_DEPTH,
                 "fit_s": fit_s, "predict_proba_s": predict_s,
                 "b8_launches": b8, "launches": rf_launches,
                 "test_logloss": rf_ll}
    emit({"phase": "sampling_forest", **res["S4"]})
    # K4's T-tree add at the forest's shape: the 100 trees' values over the
    # training rows
    del clf, proba
    torch.cuda.empty_cache()
    g3 = torch.Generator(device="cuda").manual_seed(23)
    m0 = torch.randn(n_train, generator=g3, device="cuda")
    rv = torch.randn((RF_TREES, n_train), generator=g3, device="cuda")
    lab = (torch.rand(n_train, generator=g3, device="cuda") < 0.5).float()
    w = torch.ones(n_train, device="cuda")
    mk, mp = m0.clone(), m0.clone()
    ghk, sk = O.round_update(mk, rv, lab, w, True)
    ghp, sp = O.round_update_plain(mp, rv, lab, w, True)
    torch.cuda.synchronize()
    check(torch.equal(bits(mk), bits(mp)) and torch.equal(bits(ghk),
                                                          bits(ghp)),
          "K4's T-tree add: margins or gradients differ from the plain ones")
    rel = float(((sk - sp).abs() / sp.abs().clamp_min(1e-30)).max())
    check(rel <= 1e-5, f"K4's T-tree add: partial sums {rel} relative off")
    _kernel_record(
        records, "K4trees",
        lambda: O.round_update(mk, rv, lab, w, True),
        lambda: O.round_update_plain(mp, rv, lab, w, True),
        bound_ms(n_train * (4 * RF_TREES + 16 + 4 + 8),
                 n_train * (2 * RF_TREES + 40)),
        flush, records["K4trees"]["launches"], float((sk - sp).abs().max()),
        iters=5)
    records["K4trees"].update(trees=RF_TREES, rows=n_train)
    del m0, rv, lab, w, mk, mp, ghk, ghp
    torch.cuda.empty_cache()
    t0 = lap("s4_forest_and_k4_hold", t0)

    # every configuration against the fixed-point CPU path on a cut
    cmp = {}
    cmp_runs = list(SAMPLING_RUNS) + [
        ("S4cut", {"objective": "binary:logistic", "subsample": 0.8,
                   "colsample_bynode": 0.8, "num_parallel_tree": 6,
                   "learning_rate": 1.0, "reg_lambda": 1e-5,
                   "max_depth": RF_DEPTH})]
    for key, params in cmp_runs:
        nr = 1 if key == "S4cut" else 2
        weights = fw if key == "S3" else None
        card = train(params, rows=compare_rows, weights=weights, n_rounds=nr,
                     held_out=False)
        with _cpu_fixed_point(True):
            cpu = train(params, rows=compare_rows, weights=weights,
                        n_rounds=nr, device="cpu", held_out=False)
        same = (card["bst"].get_dump(with_stats=True)
                == cpu["bst"].get_dump(with_stats=True))
        cmp[key] = {"rows": compare_rows, "rounds": nr, "dumps_equal": same}
        check(same, f"{key}: the card's model differs from the fixed-point "
                    f"CPU path's on {compare_rows} rows")
        del card, cpu
    res["cpu_fixed_point"] = cmp
    t0 = lap("cpu_fixed_point", t0)

    # S5: a sampled Covertype multi:softprob with logloss and auc
    xc, yc = make_covertype_like(COVERTYPE_ROWS)
    nc = COVERTYPE_ROWS - COVERTYPE_TEST
    s5p = {"objective": "multi:softprob", "num_class": 7, "subsample": 0.8,
           "eval_metric": ["mlogloss", "logloss", "auc"], "max_depth": depth,
           "max_bin": 256, "seed": 7}
    dtr = xrt.RayDMatrix(xc[:nc], yc[:nc])
    dte = xrt.RayDMatrix(xc[nc:], yc[nc:])
    ev = {}
    reset_kernel_launches()
    t = time.perf_counter()
    xrt.train(s5p, dtr, rounds, evals=[(dtr, "train"), (dte, "test")],
              evals_result=ev, device="cuda:0",
              ray_params=xrt.RayParams(num_actors=1))
    s5_wall = time.perf_counter() - t
    s5l = kernel_launches()
    mll = ev["test"]["mlogloss"]
    check(mll[-1] < mll[0] and all(np.isfinite(ev["test"]["auc"])),
          f"S5: test mlogloss {mll}, auc {ev['test']['auc']}")
    check(s5l["B12r"] == rounds * 7 and s5l["SMX"] == 2 * rounds + 1,
          f"S5: launches {s5l}")
    cut = 100_000
    with _cpu_fixed_point(False):
        card5 = xrt.train(dict(s5p), xrt.RayDMatrix(xc[:cut], yc[:cut]), 2,
                          device="cuda:0",
                          ray_params=xrt.RayParams(num_actors=1))
    with _cpu_fixed_point(True):
        cpu5 = xrt.train(dict(s5p), xrt.RayDMatrix(xc[:cut], yc[:cut]), 2,
                         device="cpu", ray_params=xrt.RayParams(num_actors=1))
    s5_same = (card5.get_dump(with_stats=True)
               == cpu5.get_dump(with_stats=True))
    check(s5_same, "S5: the card's model differs from the fixed-point CPU "
                   "path's")
    res["S5"] = {"rows": COVERTYPE_ROWS, "train_wall_s": s5_wall,
                 "launches": s5l, "test_mlogloss": mll,
                 "test_logloss_column0": ev["test"]["logloss"],
                 "test_auc_column1": ev["test"]["auc"],
                 "cut_rows": cut, "cut_dumps_equal_cpu_fixed_point": s5_same}
    del xc, yc, dtr, dte, card5, cpu5
    t0 = lap("s5_covertype", t0)

    # S6: S1 over 2 gloo ranks sharing the card, against one rank at
    # num_actors=2 (the same two blocks)
    wr = 3
    s1 = dict(SAMPLING_RUNS[0][1], max_depth=depth, max_bin=256, seed=7)
    one = train(SAMPLING_RUNS[0][1], n_rounds=wr, actors=2, held_out=False)
    data = D.share({"x": x[:n_train], "label": y[:n_train]})
    t = time.perf_counter()
    out = D.launch_world(D._train_rank, 2, "cuda", data, s1, wr,
                         {"num_actors": 2}, backend="gloo")
    two = xrt.RayXGBoostBooster.load_raw(out[0]["model"])
    same = (two.get_dump(with_stats=True)
            == one["bst"].get_dump(with_stats=True))
    res["S6"] = {"rounds": wr, "wall_s": time.perf_counter() - t,
                 "ranks_equal": out[0]["model"] == out[1]["model"],
                 "equals_one_rank": same,
                 "launches_rank0": out[0]["launches"]}
    check(same and res["S6"]["ranks_equal"],
          "S6: 2 gloo ranks differ from one rank at num_actors=2")
    check(out[0]["launches"]["B12r"] == wr,
          f"S6: rank 0 launched B12r {out[0]['launches']['B12r']} times")
    del data, out, one, engines, e1, e2, e3
    torch.cuda.empty_cache()
    lap("s6_two_ranks", t0)
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 16: monotone and interaction constraints (K2's constrained level
# step) and parallel trees of K outputs (the T-tree modes of the softmax
# pass and of K4's K-output kernel)
# ---------------------------------------------------------------------------

#: M1's signs over the 28 HIGGS columns: +1 on four, -1 on three
HIGGS_MONOTONE = tuple({0: 1, 2: 1, 4: 1, 5: 1, 1: -1, 3: -1, 6: -1}.get(i, 0)
                       for i in range(28))
#: M2's groups, covering all 28 columns (0 and 2 in two groups each)
HIGGS_GROUPS = [[0, 1, 4, 8, 9, 10, 11, 12], [2, 3, 13, 14, 15, 16, 17, 18],
                [5, 6, 7, 19, 20, 21, 22, 23], [0, 2, 24, 25, 26, 27]]
#: phase 16's binary configurations at the HIGGS split (10 rounds, depth 6)
CONSTRAINT_RUNS = (
    ("M1", {"objective": "binary:logistic",
            "monotone_constraints": HIGGS_MONOTONE}),
    ("M2", {"objective": "binary:logistic",
            "interaction_constraints": HIGGS_GROUPS}),
    ("M3", {"objective": "binary:logistic",
            "monotone_constraints": HIGGS_MONOTONE,
            "interaction_constraints": HIGGS_GROUPS,
            "colsample_bynode": 0.8}),
)
#: P1 (Covertype's shape, K = 7, T = 4) and P2 (three quantiles, T = 2)
FOREST_P1 = {"objective": "multi:softprob", "num_class": 7,
             "num_parallel_tree": 4, "subsample": 0.8,
             "colsample_bynode": 0.8}
QUANTILE_P2 = {"objective": "reg:quantileerror",
               "quantile_alpha": [0.1, 0.5, 0.9], "num_parallel_tree": 2}
#: the kernel table's rows of phase 16
CONSTRAINT_KERNELS = ("K2cons", "K2consmasked", "SMXtrees", "K4multitrees")


def constraints_expect(params, rounds, depth, held_out=True):
    """Exact launches of a binary ``train()`` with constraints: the
    sampling phase's count (``sampling_expect``) and K2's constrained
    level step at every level of every tree."""
    out = sampling_expect(params, rounds, depth, held_out)
    out["K2cons"] = rounds * depth
    return out


def forest_expect(rounds, depth, k, t, sampled, softmax):
    """Exact launches of a ``train()`` of K outputs and T parallel trees an
    output with the test set: the main path's K1-K3 per tree; the round
    pass (the softmax pass, or K4's K-output kernel) a round, at set-up and
    over the test set, in its T-tree mode on both sets; B4 over the test
    set, and over the training rows where rows are sampled (B12r a tree,
    B12f and K2 masked a level under ``colsample_bynode``)."""
    n_trees = rounds * k * t
    out = train_expect(n_trees, depth)
    out.update(B12r=n_trees if sampled else 0,
               B12f=n_trees * depth if sampled else 0,
               K2masked=n_trees * depth if sampled else 0, K2cons=0,
               B4=rounds * (2 if sampled else 1))
    if softmax:
        out.update(K4=0, K4eval=0, K4trees=0, SMX=2 * rounds + 1,
                   SMXeval=rounds, SMXtrees=2 * rounds)
    else:
        out.update(K4=2 * rounds + 1, K4eval=rounds, K4trees=2 * rounds,
                   SMX=0, SMXeval=0, SMXtrees=0)
    return out


def tree_paths(forest):
    """The feature sets of every root-to-leaf path of every tree of a
    forest's [T, heap] arrays."""
    feature = np.asarray(forest.feature)
    is_leaf = np.asarray(forest.is_leaf)
    paths = []
    for t in range(feature.shape[0]):
        stack = [(0, frozenset())]
        while stack:
            i, used = stack.pop()
            if is_leaf[t, i] or feature[t, i] < 0:
                paths.append(used)
                continue
            used = used | {int(feature[t, i])}
            stack += [(2 * i + 1, used), (2 * i + 2, used)]
    return paths


def monotone_grid(bst, x, signs, rows=200, points=64):
    """The card's margins along a grid in each constrained feature (the
    other features from ``rows`` rows): the steps against each sign, and
    the features the model moved on. A sum of monotone terms in a fixed
    order rounds monotonically, so any step against the sign is a
    fault."""
    grid = np.linspace(-3.0, 3.0, points, dtype=np.float32)
    base = x[:rows]
    wrong, moved = {}, []
    for fi, sign in enumerate(signs):
        if not sign:
            continue
        xg = np.repeat(base, points, axis=0)
        xg[:, fi] = np.tile(grid, rows)
        m = np.asarray(bst.predict(xg, output_margin=True)).reshape(rows,
                                                                    points)
        steps = np.diff(m, axis=1) * sign
        if (steps < 0).any():
            wrong[fi] = float(steps.min())
        if (steps > 0).any():
            moved.append(fi)
    return wrong, moved


def phase_constraints(x, y, records, rounds=10, depth=6,
                      compare_rows=50_000):
    """Phase 16 at full width. Path M at the HIGGS split (10,500,000 rows
    train, the last 500,000 the test set, depth 6, 10 rounds, seed 7): M1
    monotone (+1 on four features, -1 on three), M2 interaction groups
    covering all 28 features, M3 both with ``colsample_bynode`` 0.8; each
    run's launches counted from 0 and checked exactly, the test logloss
    falling, the card's margins along a grid in each constrained feature
    monotone exactly, every root-to-leaf path inside one group; K2's
    constrained level step at level 5 (unmasked and masked) bitwise its
    plain version, timed beside the unconstrained one; every
    configuration (2 rounds) equal to the fixed-point CPU path on a
    ``compare_rows``-row cut. Path P: P1 Covertype's shape
    ``multi:softprob`` with T = 4, ``subsample`` and ``colsample_bynode``
    0.8; P2 ``reg:quantileerror`` at alphas 0.1 / 0.5 / 0.9 with T = 2 at
    the HIGGS split; the softmax pass and K4's K-output kernel in their
    T-tree modes bitwise their plain versions at the runs' shapes, timed
    and counted; each model equal to the fixed-point CPU path on a cut."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.ops import _build
    from xgboost_ray_tpu_torch.ops import grow as G
    from xgboost_ray_tpu_torch.ops import histogram as H
    from xgboost_ray_tpu_torch.ops import objectives as O
    from xgboost_ray_tpu_torch.ops import split as S

    t_phase = time.perf_counter()
    n = x.shape[0]
    n_train = n - TEST_ROWS
    f = x.shape[1]
    res = {"phase": "constraints", "rows": n, "train_rows": n_train,
           "test_rows": TEST_ROWS, "rounds": rounds, "max_depth": depth,
           "runs": {}, "steps_s": {}}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def lap(name, since):
        res["steps_s"][name] = time.perf_counter() - since
        return time.perf_counter()

    def train(params, xs, ys, n_test, n_rounds=rounds, device="cuda:0",
              held_out=True):
        hi = xs.shape[0] - n_test
        dtrain = xrt.RayDMatrix(xs[:hi], ys[:hi])
        evals = [(dtrain, "train")]
        if held_out:
            evals.append((xrt.RayDMatrix(xs[hi:], ys[hi:]), "test"))
        ev, extra = {}, {}
        keep = _KeepEngine()
        builds = _build.compile_count()
        reset_kernel_launches()
        if device != "cpu":
            torch.cuda.synchronize()
        t = time.perf_counter()
        bst = xrt.train({"max_depth": depth, "max_bin": 256, "seed": 7,
                         **params}, dtrain, n_rounds, evals=evals,
                        evals_result=ev, additional_results=extra,
                        callbacks=[keep], device=device,
                        ray_params=xrt.RayParams(num_actors=1))
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(_build.compile_count() == builds,
              "phase 16: a kernel build inside train()")
        return {"bst": bst, "ev": ev, "launches": kernel_launches(),
                "wall_s": wall, "engine": keep.engine,
                "round_ms": [r * 1e3 for r in extra["round_times_s"]]}

    def same_on_cpu(key, params, xs, ys, nr=2):
        card = train(params, xs, ys, 0, n_rounds=nr, held_out=False)
        with _cpu_fixed_point(True):
            cpu = train(params, xs, ys, 0, n_rounds=nr, device="cpu",
                        held_out=False)
        same = (card["bst"].get_dump(with_stats=True)
                == cpu["bst"].get_dump(with_stats=True))
        check(same, f"{key}: the card's model differs from the fixed-point "
                    f"CPU path's on {xs.shape[0]} rows")
        return {"rows": int(xs.shape[0]), "rounds": nr, "dumps_equal": same}

    def exact(launches, expect, key):
        for k, v in expect.items():
            check(launches[k] == v,
                  f"{key}: {k} launched {launches[k]} times, expected {v}")

    def falls(hist, key):
        check(all(np.isfinite(hist)) and hist[-1] < hist[0],
              f"{key}: the test loss does not fall: {hist}")
        return hist

    # path M: M1-M3 at full size, each run's launches checked
    groups = [frozenset(g) for g in HIGGS_GROUPS]
    for key, params in CONSTRAINT_RUNS:
        r = train(params, x, y, TEST_ROWS)
        expect = constraints_expect(params, rounds, depth)
        exact(r["launches"], expect, key)
        out = {"launches": r["launches"], "expected": expect,
               "round_ms": r["round_ms"],
               "round_ms_median": float(np.median(r["round_ms"])),
               "train_wall_s": r["wall_s"],
               "test_logloss": falls(r["ev"]["test"]["logloss"], key)}
        signs = params.get("monotone_constraints")
        if signs:
            wrong, moved = monotone_grid(r["bst"], x[n_train:], signs)
            out.update(grid_steps_against_sign=wrong, grid_moved=moved)
            check(not wrong, f"{key}: margins step against the sign: {wrong}")
            check(moved, f"{key}: no constrained feature moves the margins")
        if "interaction_constraints" in params:
            paths = tree_paths(r["bst"].forest)
            outside = [sorted(p) for p in paths
                       if not any(p <= g for g in groups)]
            out.update(paths=len(paths), paths_outside_groups=outside[:5],
                       deepest_path=max(len(p) for p in paths))
            check(not outside, f"{key}: paths outside every group: "
                               f"{outside[:5]}")
        res["runs"][key] = out
        if key == "M1":
            records["K2cons"]["launches"] = r["launches"]["K2cons"]
        if key == "M3":
            records["K2consmasked"]["launches"] = r["launches"]["K2cons"]
        del r
    t0 = lap("m1_m3", t_phase)
    emit({"phase": "constraints_rounds", "card": CARD,
          **{k: res["runs"][k]["round_ms_median"]
             for k, _ in CONSTRAINT_RUNS}})

    # K2's constrained level step at level 5 (32 nodes) of the main path's
    # shape under M3's constraints, the ancestors a random tree's, the
    # bounds random (infinite, crossing and equal ones among them)
    nbt, n_nodes = 257, 32
    bins, ghl, order, seg = level_inputs(n_train, f, n_nodes, 16, False)
    hp, _ = H.build_histogram_plain(bins, ghl, order, seg, n_nodes, nbt)
    del bins, ghl, order, seg
    g2 = torch.Generator(device="cuda").manual_seed(31)
    lo = torch.randn(n_nodes, generator=g2, device="cuda") * 0.2 - 0.1
    hi_b = lo + torch.rand(n_nodes, generator=g2, device="cuda") * 0.3
    lo[::3] = float("-inf")
    hi_b[1::4] = float("inf")
    lo[2], hi_b[2] = 0.2, -0.2
    hi_b[-1] = lo[-1]
    level = dict(
        hist=hp[0::2].contiguous(), prev_hist=hp[0::2] + hp[1::2],
        small_is_right=torch.rand(16, generator=g2, device="cuda") < 0.5,
        active=torch.arange(32, device="cuda") % 13 != 5,
        bounds=(lo, hi_b))
    mask = G.sample_feature_mask((7, 16), f, 0.8, None, n_nodes,
                                 device="cuda")
    cuts = torch.sort(torch.randn(f, nbt - 2, generator=g2, device="cuda"),
                      dim=1).values
    p = S.SplitParams()
    cons = S.TreeConstraints(HIGGS_MONOTONE,
                             tuple(tuple(g) for g in HIGGS_GROUPS), f, "cuda")
    tree0 = G.empty_tree(127, "cuda")
    top = torch.randint(0, f, (31,), generator=g2, device="cuda",
                        dtype=torch.int32)
    top[torch.rand(31, generator=g2, device="cuda") < 0.15] = -1
    tree0.feature[:31] = top
    hold = {}
    for rec_key, fmask in (("K2cons", None), ("K2consmasked", mask)):
        rec_k = S.TreeRecords(G.Tree(*[t.clone() for t in tree0]), cuts,
                              None, p, cons)
        rec_p = S.TreeRecords(G.Tree(*[t.clone() for t in tree0]), cuts,
                              None, p, cons)
        lk = S.split_level(**level, rec=rec_k, feature_mask=fmask)
        lp = S.split_level_plain(**level, rec=rec_p, feature_mask=fmask)
        torch.cuda.synchronize()
        pairs = ([(getattr(lk.splits, k), getattr(lp.splits, k))
                  for k in lk.splits._fields]
                 + [(getattr(lk, k), getattr(lp, k))
                    for k in ("node_value", "state", "active", "hist")]
                 + list(zip(lk.bounds, lp.bounds))
                 + list(zip(rec_k.tree, rec_p.tree)))
        check(all(torch.equal(bits(a), bits(b)) for a, b in pairs),
              f"{rec_key}: K2's constrained level step not bitwise equal to "
              f"its plain version")
        hist_bytes = n_nodes * f * nbt * 2 * 4
        # per candidate and direction the constrained gain adds two leaf
        # weights (a division each), four clamps and two fused
        # score_given_weight terms to the unconstrained one's ~30 ops
        _kernel_record(
            records, rec_key,
            lambda fm=fmask, rk=rec_k: S.split_level(**level, rec=rk,
                                                     feature_mask=fm),
            lambda fm=fmask, rp=rec_p: S.split_level_plain(
                **level, rec=rp, feature_mask=fm),
            bound_ms(2 * hist_bytes + 16 + 32 + 32 * (4 + 38) + 32 * 16
                     + (n_nodes * f if fmask is not None else 0),
                     n_nodes * f * (3 * nbt + 62 * (nbt - 2))),
            flush, records[rec_key]["launches"], 0.0)
        rec_u = S.TreeRecords(G.empty_tree(127, "cuda"), cuts, None, p)
        plain_level = {k: v for k, v in level.items() if k != "bounds"}
        # the unconstrained step on the same inputs, in turns with it
        times = []
        for _ in range(2):
            times.append(cuda_ms(lambda fm=fmask, rk=rec_k: S.split_level(
                **level, rec=rk, feature_mask=fm), iters=20))
            times.append(cuda_ms(lambda fm=fmask: S.split_level(
                **plain_level, rec=rec_u, feature_mask=fm), iters=20))
        hold[rec_key] = {"constrained_ms": times[0::2],
                         "unconstrained_ms": times[1::2]}
        records[rec_key]["unconstrained_ms"] = times[1::2]
    res["k2_level5"] = hold
    emit({"phase": "constraints_k2", **hold})
    del hp, level, lk, lp
    torch.cuda.empty_cache()
    t0 = lap("k2_holds", t0)

    # path P: P1 (Covertype's shape, K = 7, T = 4) and P2 (three quantiles,
    # T = 2) at full size, each run's launches checked
    xc, yc = make_covertype_like(COVERTYPE_ROWS)
    p1 = train(FOREST_P1, xc, yc, COVERTYPE_TEST)
    exact(p1["launches"], forest_expect(rounds, depth, 7, 4, True, True),
          "P1")
    res["runs"]["P1"] = {
        "launches": p1["launches"], "round_ms": p1["round_ms"],
        "round_ms_median": float(np.median(p1["round_ms"])),
        "train_wall_s": p1["wall_s"], "trees": p1["bst"].num_trees,
        "test_mlogloss": falls(p1["ev"]["test"]["mlogloss"], "P1")}
    records["SMXtrees"]["launches"] = p1["launches"]["SMXtrees"]
    rng = np.random.default_rng(16)
    yq = (0.4 * x[:, 0] - 0.3 * x[:, 1] + 0.2 * x[:, 2]
          + 0.5 * rng.standard_normal(n)).astype(np.float32)
    p2 = train(QUANTILE_P2, x, yq, TEST_ROWS)
    exact(p2["launches"], forest_expect(rounds, depth, 3, 2, False, False),
          "P2")
    res["runs"]["P2"] = {
        "launches": p2["launches"], "round_ms": p2["round_ms"],
        "round_ms_median": float(np.median(p2["round_ms"])),
        "train_wall_s": p2["wall_s"], "trees": p2["bst"].num_trees,
        "test_quantile": falls(p2["ev"]["test"]["quantile"], "P2")}
    records["K4multitrees"]["launches"] = p2["launches"]["K4trees"]
    del p1, p2
    torch.cuda.empty_cache()
    t0 = lap("p1_p2", t0)

    # the T-tree modes at the runs' shapes: the softmax pass over P1's
    # training rows (K = 7, T = 4), K4's K-output kernel over P2's (K = 3,
    # T = 2); margins and gradients bitwise, sums within 1e-5 relative
    g3 = torch.Generator(device="cuda").manual_seed(33)
    nc = COVERTYPE_ROWS - COVERTYPE_TEST
    for rec_key, rows, k, t in (("SMXtrees", nc, 7, 4),
                                ("K4multitrees", n_train, 3, 2)):
        m0 = torch.randn((rows, k), generator=g3, device="cuda")
        rv = torch.randn((k * t, rows), generator=g3, device="cuda") * 0.1
        w = torch.ones(rows, device="cuda")
        if rec_key == "SMXtrees":
            lab = torch.randint(0, k, (rows,), generator=g3,
                                device="cuda").float()

            def kern(m, rv=rv, lab=lab, w=w):
                return O.softmax_update(m, rv, lab, w, True)

            def plain(m, rv=rv, lab=lab, w=w):
                return O.softmax_update_plain(m, rv, lab, w, True)
            # margins read and written, K T values, label and weight, K gh
            nbytes = rows * (8 * k + 4 * k * t + 8 + 8 * k)
            ops = rows * k * (2 * t + 40)
        else:
            lab = torch.randn(rows, generator=g3, device="cuda")
            obj = O.get_objective("reg:quantileerror",
                                  quantile_alpha=[0.1, 0.5, 0.9])

            def kern(m, rv=rv, lab=lab, w=w, obj=obj):
                return O.round_update_multi(m, rv, lab, w, obj, True,
                                            ["quantile"])

            def plain(m, rv=rv, lab=lab, w=w, obj=obj):
                return O.round_update_multi_plain(m, rv, lab, w, obj, True,
                                                  ["quantile"])
            nbytes = rows * (8 * k + 4 * k * t + 8 + 8 * k)
            ops = rows * k * (2 * t + 20)
        mk, mp = m0.clone(), m0.clone()
        ghk, sk = kern(mk)
        ghp, sp = plain(mp)
        torch.cuda.synchronize()
        check(torch.equal(bits(mk), bits(mp))
              and torch.equal(bits(ghk), bits(ghp)),
              f"{rec_key}: margins or gradients differ from the plain ones")
        rel = float(((sk - sp).abs() / sp.abs().clamp_min(1e-30)).max())
        check(rel <= 1e-5, f"{rec_key}: partial sums {rel} relative off")
        _kernel_record(records, rec_key, lambda mk=mk, kern=kern: kern(mk),
                       lambda mp=mp, plain=plain: plain(mp),
                       bound_ms(nbytes, ops), flush,
                       records[rec_key]["launches"],
                       float((sk - sp).abs().max()))
        records[rec_key].update(rows=rows, outputs=k, trees=t)
        del m0, rv, lab, w, mk, mp, ghk, ghp
        torch.cuda.empty_cache()
    t0 = lap("t_tree_holds", t0)

    # every configuration against the fixed-point CPU path on a cut
    cmp = {}
    for key, params in CONSTRAINT_RUNS:
        cmp[key] = same_on_cpu(key, params, x[:compare_rows],
                               y[:compare_rows])
    cut = 20_000
    cmp["P1"] = same_on_cpu("P1", FOREST_P1, xc[:cut], yc[:cut])
    cut = 50_000
    cmp["P2"] = same_on_cpu("P2", QUANTILE_P2, x[:cut], yq[:cut])
    res["cpu_fixed_point"] = cmp
    del xc, yc, yq
    lap("cpu_fixed_point", t0)
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 17: categorical one-vs-rest splits (K2's categorical instantiation,
# K3's and B4's equality rule, category codes through load, eval sets and
# predict); phase 18: leaf-wise lossguide growth (the frontier step over
# K1-K3)
# ---------------------------------------------------------------------------

#: the airline set's columns (the ASA Data Expo 2009 on-time data, as NVIDIA
#: gbm-bench's "airline" set uses them): name -> category count, 0 numeric
AIRLINE_COLUMNS = (("Month", 12), ("DayofMonth", 31), ("DayOfWeek", 7),
                   ("UniqueCarrier", 20), ("Origin", 254), ("Dest", 254),
                   ("CRSDepTime", 0), ("CRSArrTime", 0), ("Distance", 0))
#: airports drawn for Origin and Dest; the codes of the rarest 46 (254 and
#: up: max_bin 256's limit) become NaN
AIRLINE_AIRPORTS = 300
AIRLINE_CAT = tuple(i for i, (_, k) in enumerate(AIRLINE_COLUMNS) if k)
AIRLINE_DISTANCE = 8
#: phase 17's configurations: C1 the frame, C2 the same codes as numpy
#: with feature_types, C3 C1 with colsample_bynode and a monotone sign on
#: Distance
CAT_RUNS = (
    ("C1", "frame", {"objective": "binary:logistic"}),
    ("C2", "codes", {"objective": "binary:logistic"}),
    ("C3", "frame", {"objective": "binary:logistic",
                     "colsample_bynode": 0.8,
                     "monotone_constraints": tuple(
                         1 if i == AIRLINE_DISTANCE else 0
                         for i in range(len(AIRLINE_COLUMNS)))}),
)
#: phase 18's configurations (L1 against the depthwise model of its run)
LOSSGUIDE_RUNS = (
    ("L1", "higgs", 6, {"objective": "binary:logistic",
                        "grow_policy": "lossguide", "max_leaves": 64}),
    ("L2", "higgs", 10, {"objective": "binary:logistic",
                         "grow_policy": "lossguide", "max_leaves": 255}),
    ("L3", "airline", 10, {"objective": "binary:logistic",
                           "grow_policy": "lossguide", "max_leaves": 255,
                           "subsample": 0.8, "colsample_bytree": 0.8}),
)
#: the kernel table's rows of phases 17 and 18
CATEGORICAL_KERNELS = ("K2cat", "K2catmasked", "K3cat", "B4cat")
LOSSGUIDE_KERNELS = ("LGstep",)


def _zipf(k, s, rng):
    """Draw probabilities of k categories, falling as rank^-s, shuffled
    labels kept in rank order (code 0 the most frequent)."""
    p = 1.0 / np.arange(1, k + 1) ** s
    return p / p.sum()


def make_airline_like(n_rows, seed=0):
    """A seeded airline-shaped set: (x [N, 9] f32 category codes and
    numbers, NaN for the airports cut, label [N] f32 delayed, the frame
    with the six categorical columns as pandas ``category`` columns of
    names). The delay comes from per-category effects (carrier, airports,
    month, day of week) and their interactions (carrier x month, origin x
    hour), so one-vs-rest splits bind."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    n = n_rows
    month = rng.integers(0, 12, n)
    dom = rng.integers(0, 31, n)
    dow = rng.integers(0, 7, n)
    carrier = rng.choice(20, n, p=_zipf(20, 0.8, rng))
    origin = rng.choice(AIRLINE_AIRPORTS, n, p=_zipf(AIRLINE_AIRPORTS, 1.1,
                                                      rng))
    dest = rng.choice(AIRLINE_AIRPORTS, n, p=_zipf(AIRLINE_AIRPORTS, 1.1,
                                                    rng))
    dep = rng.integers(5, 24, n) * 100 + rng.integers(0, 60, n)
    dist = rng.gamma(2.0, 400.0, n).astype(np.float32) + 50.0
    arr = (dep + (dist / 8.0).astype(np.int64) + 40) % 2400
    e_carrier = rng.normal(0, 0.5, 20)
    e_airport = rng.normal(0, 0.4, AIRLINE_AIRPORTS)
    e_month = rng.normal(0, 0.3, 12)
    e_dow = rng.normal(0, 0.2, 7)
    e_cm = rng.normal(0, 0.4, (20, 12))
    e_oh = rng.normal(0, 0.3, (AIRLINE_AIRPORTS, 24))
    score = (e_carrier[carrier] + e_airport[origin] + 0.7 * e_airport[dest]
             + e_month[month] + e_dow[dow] + e_cm[carrier, month]
             + e_oh[origin, dep // 100] + 0.0004 * (dep - 1200)
             + 0.0002 * dist - 1.0)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-score))).astype(np.float32)
    codes = [month, dom, dow, carrier, origin, dest]
    x = np.empty((n, len(AIRLINE_COLUMNS)), np.float32)
    for i, c in enumerate(codes):
        x[:, i] = c
    x[:, 4][origin >= 254] = np.nan
    x[:, 5][dest >= 254] = np.nan
    x[:, 6], x[:, 7], x[:, 8] = dep, arr, dist
    frame = {}
    for i, (name, k) in enumerate(AIRLINE_COLUMNS):
        if k:
            c = codes[i].copy()
            c[c >= k] = -1
            frame[name] = pd.Categorical.from_codes(
                c, categories=[f"{name[:2]}{j:03d}" for j in range(k)])
        else:
            frame[name] = x[:, i]
    return x, y, pd.DataFrame(frame)


def categorical_expect(params, rounds, depth, held_out=True):
    """Exact launches of a binary ``train()`` with categorical features:
    the sampling phase's count (``sampling_expect``), with K2's categorical
    instantiation at every level (constrained where signs are given), K3's
    at every routed level and B4's categorical walk wherever B4 runs."""
    out = sampling_expect(params, rounds, depth, held_out)
    out["K2cat"] = rounds * depth
    out["K3cat"] = rounds * depth
    out["B4cat"] = out["B4"]
    out["K2cons"] = (rounds * depth if params.get("monotone_constraints")
                     else 0)
    out["K2nodes"] = out["LGstep"] = 0
    return out


def lossguide_expect(params, rounds, leaves, held_out=True, cat=False):
    """Exact launches of a binary lossguide ``train()`` of ``rounds`` trees
    of ``leaves`` leaves' budget: a tree is ``leaves`` frontier steps and
    K1 / dequantise / K2 without records, ``leaves - 1`` K3 and one K3
    leaf-value pass (no level step, no final records); K4, B4 and the
    draws as ``sampling_expect`` counts them (colsample_bytree: one B12f a
    tree, no masked level step)."""
    out = sampling_expect(params, rounds, 1, held_out)
    out.update(K1=rounds * leaves, K1deq=rounds * leaves, K2level=0,
               K2leaf=0, K2=0, K2masked=0, K3=rounds * (leaves - 1),
               K3leaf=rounds, K2nodes=rounds * leaves,
               LGstep=rounds * leaves,
               K2nodescat=rounds * leaves if cat else 0,
               K3cat=rounds * (leaves - 1) if cat else 0,
               B4cat=out["B4"] if cat else 0)
    return out


def _phase_train(res, rounds, depth):
    """The ``train()`` of phases 17-18 on the card (or the CPU): launches
    counted from 0 just before it and read just after, no kernel build in
    it, the round times, the engine kept."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.distributed import _KeepEngine
    from xgboost_ray_tpu_torch.engine import (
        kernel_launches,
        reset_kernel_launches,
    )
    from xgboost_ray_tpu_torch.ops import _build

    def train(params, dtrain, dtest, n_rounds=rounds, device="cuda:0",
              tdepth=depth):
        evals = [(dtrain, "train")]
        if dtest is not None:
            evals.append((dtest, "test"))
        ev, extra = {}, {}
        keep = _KeepEngine()
        builds = _build.compile_count()
        reset_kernel_launches()
        if device != "cpu":
            torch.cuda.synchronize()
        t = time.perf_counter()
        bst = xrt.train({"max_depth": tdepth, "max_bin": 256, "seed": 7,
                         "eval_metric": ["logloss"], **params}, dtrain,
                        n_rounds, evals=evals, evals_result=ev,
                        additional_results=extra, callbacks=[keep],
                        device=device, ray_params=xrt.RayParams(num_actors=1))
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(_build.compile_count() == builds,
              f"phase {res['phase']}: a kernel build inside train()")
        return {"bst": bst, "ev": ev, "launches": kernel_launches(),
                "wall_s": wall, "engine": keep.engine,
                "round_ms": [r * 1e3 for r in extra["round_times_s"]]}

    return train


def _exact(launches, expect, key):
    for k, v in expect.items():
        got = launches.get(k, 0)  # an older tree lacks the newer counters
        check(got == v, f"{key}: {k} launched {got} times, expected {v}")


def _falls(hist, key):
    check(all(np.isfinite(hist)) and hist[-1] < hist[0],
          f"{key}: the test loss does not fall: {hist}")
    return hist


def _same_on_cpu(train, key, params, make, rounds=2, depth=None):
    """The card's model against the CPU path summing in the card's fixed
    point (``_cpu_fixed_point``), dumps with stats equal."""
    kw = {} if depth is None else {"tdepth": depth}
    card = train(params, make(), None, n_rounds=rounds, **kw)
    with _cpu_fixed_point(True):
        cpu = train(params, make(), None, n_rounds=rounds, device="cpu",
                    **kw)
    same = (card["bst"].get_dump(with_stats=True)
            == cpu["bst"].get_dump(with_stats=True))
    check(same, f"{key}: the card's model differs from the fixed-point "
                f"CPU path's")
    return {"rounds": rounds, "dumps_equal": same}


def phase_categorical(records, rounds=10, depth=6, n_rows=None,
                      compare_rows=50_000):
    """Phase 17 at full width: a seeded airline-shaped set
    (``make_airline_like``, 11,000,000 rows: the first 10,500,000 train,
    the last 500,000 the test set, the HIGGS protocol's split), depth 6, 10
    rounds. C1 ``binary:logistic`` from the pandas ``category`` frame (its
    set-up auto-encodes 11,000,000 rows), C2 the same codes as numpy with
    ``feature_types`` (its model equal to C1's), C3 C1 with
    ``colsample_bynode`` 0.8 and a monotone sign on Distance; each run's
    launches counted and checked exactly, the test logloss falling; the
    test logloss of the same columns coded as numbers recorded beside
    C1's; K2's categorical level step at level 5 (unmasked and masked),
    K3's categorical route and B4's categorical walk bitwise their plain
    versions and timed beside their numeric forms; predict on a frame of
    another category order equal to predict on the codes; pred_contribs
    rows summing to the margins within ``shap_sum_bound``; each
    configuration (2 rounds) equal to the fixed-point CPU path on a
    ``compare_rows`` cut. Returns (its record, the airline data)."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.ops import grow as G
    from xgboost_ray_tpu_torch.ops import histogram as H
    from xgboost_ray_tpu_torch.ops import split as S

    t_phase = time.perf_counter()
    n = n_rows or 11_000_000
    x, y, frame = make_airline_like(n)
    n_train = n - TEST_ROWS
    f = x.shape[1]
    ft = ["c" if k else "q" for _, k in AIRLINE_COLUMNS]
    res = {"phase": "categorical", "rows": n, "train_rows": n_train,
           "test_rows": TEST_ROWS, "rounds": rounds, "max_depth": depth,
           "features": [c for c, _ in AIRLINE_COLUMNS],
           "categories": [k for _, k in AIRLINE_COLUMNS],
           "reduced": {"Origin/Dest": f"{AIRLINE_AIRPORTS} airports drawn, "
                       f"codes >= 254 (the rarest "
                       f"{AIRLINE_AIRPORTS - 254}) NaN: max_bin 256 holds "
                       f"codes 0-254",
                       "rows": "synthetic, seeded: the airline set's "
                       "columns and category counts, not its data"},
           "nan_share_origin": float(np.isnan(x[:, 4]).mean()),
           "runs": {}, "steps_s": {}, "data_s": time.perf_counter() - t_phase}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    train = _phase_train(res, rounds, depth)

    def lap(name, since):
        res["steps_s"][name] = time.perf_counter() - since
        return time.perf_counter()

    def matrices(form, hi=n_train, lo=None):
        if form == "frame":
            tr = xrt.RayDMatrix(frame.iloc[:hi], y[:hi],
                                enable_categorical=True)
            te = (None if lo is None else
                  xrt.RayDMatrix(frame.iloc[lo:], y[lo:],
                                 enable_categorical=True))
        else:
            tr = xrt.RayDMatrix(x[:hi], y[:hi], feature_types=ft)
            te = (None if lo is None else
                  xrt.RayDMatrix(x[lo:], y[lo:], feature_types=ft))
        return tr, te

    t0 = time.perf_counter()
    keep = {}
    for key, form, params in CAT_RUNS:
        t = time.perf_counter()
        dtrain, dtest = matrices(form, lo=n_train)
        dtrain.load_data(1)
        dtest.load_data(1)
        setup = time.perf_counter() - t
        r = train(params, dtrain, dtest)
        expect = categorical_expect(params, rounds, depth)
        _exact(r["launches"], expect, key)
        res["runs"][key] = {
            "launches": r["launches"], "expected": expect,
            "round_ms": r["round_ms"],
            "round_ms_median": float(np.median(r["round_ms"])),
            "train_wall_s": r["wall_s"], "matrix_load_s": setup,
            "test_logloss": _falls(r["ev"]["test"]["logloss"], key)}
        if key == "C1":
            check(r["bst"].categories == dtrain.resolved_categories
                  and len(r["bst"].categories) == len(AIRLINE_CAT),
                  "C1: the model lost the category mapping")
            records["K2cat"]["launches"] = r["launches"]["K2cat"]
            records["K3cat"]["launches"] = r["launches"]["K3cat"]
            records["B4cat"]["launches"] = r["launches"]["B4cat"]
        if key == "C3":
            records["K2catmasked"]["launches"] = r["launches"]["K2masked"]
            wrong, moved = monotone_grid(r["bst"], x[n_train:],
                                         params["monotone_constraints"])
            check(not wrong, f"C3: margins step against the sign: {wrong}")
        keep[key] = r
        del dtrain, dtest
    check(keep["C1"]["bst"].get_dump(with_stats=True)
          == keep["C2"]["bst"].get_dump(with_stats=True),
          "C2: the codes' model differs from the frame's")
    res["c2_equals_c1"] = True
    num = train({"objective": "binary:logistic"},
                xrt.RayDMatrix(x[:n_train], y[:n_train]),
                xrt.RayDMatrix(x[n_train:], y[n_train:]))
    res["numeric_coding_test_logloss"] = num["ev"]["test"]["logloss"]
    res["numeric_coding_round_ms_median"] = float(np.median(num["round_ms"]))
    del num
    emit({"phase": "categorical_rounds", "card": CARD,
          **{k: res["runs"][k]["round_ms_median"] for k, _, _ in CAT_RUNS},
          "test_logloss_C1": res["runs"]["C1"]["test_logloss"][-1],
          "test_logloss_numeric_coding":
              res["numeric_coding_test_logloss"][-1]})
    t0 = lap("c1_c3", t0)

    # predict: a frame of another category order (translated onto the
    # model's mapping) equals the codes; contributions sum to the margins
    bst = keep["C1"]["bst"]
    test = frame.iloc[n_train:].copy()
    for name in ("UniqueCarrier", "Origin"):
        test[name] = test[name].cat.reorder_categories(
            list(test[name].cat.categories[::-1]))
    pf = xrt.predict(bst, xrt.RayDMatrix(test, enable_categorical=True),
                     ray_params=xrt.RayParams(num_actors=1))
    pc = xrt.predict(bst, xrt.RayDMatrix(x[n_train:], feature_types=ft),
                     ray_params=xrt.RayParams(num_actors=1))
    check(np.array_equal(pf, pc), "predict on a frame of another category "
                                  "order differs from predict on the codes")
    q = x[n_train:n_train + 20_000]
    m = np.asarray(bst.predict(q, output_margin=True))
    contribs = np.asarray(bst.predict(q, pred_contribs=True))
    sf = bst.shap_forest("cuda")
    bound = shap_sum_bound(bst, sf, m, f)
    gap = np.abs(contribs.sum(1) - m)
    check((gap <= bound).all(), f"pred_contribs rows miss the margins by "
                                f"{gap.max()}")
    res["predict"] = {"shuffled_order_equal": True,
                      "contribs_rows": int(q.shape[0]),
                      "contribs_max_gap": float(gap.max()),
                      "contribs_bound_max": float(np.max(bound))}
    t0 = lap("predict", t0)

    # K2's categorical level step at level 5 (16 parents, 32 nodes) of C1's
    # shape, beside the numeric one in turns
    nbt, n_nodes = 257, 32
    bins, ghl, order, seg = level_inputs(n_train, f, n_nodes, 17, False)
    hp, _ = H.build_histogram_plain(bins, ghl, order, seg, n_nodes, nbt)
    g2 = torch.Generator(device="cuda").manual_seed(41)
    level = dict(
        hist=hp[0::2].contiguous(), prev_hist=hp[0::2] + hp[1::2],
        small_is_right=torch.rand(16, generator=g2, device="cuda") < 0.5,
        active=torch.arange(32, device="cuda") % 13 != 5)
    mask = G.sample_feature_mask((7, 17), f, 0.8, None, n_nodes,
                                 device="cuda")
    cuts = torch.sort(torch.randn(f, nbt - 2, generator=g2, device="cuda"),
                      dim=1).values
    cat = G.cat_flags(AIRLINE_CAT, f, "cuda")
    p = S.SplitParams()
    hold = {}
    for rec_key, fmask in (("K2cat", None), ("K2catmasked", mask)):
        rec_k = S.TreeRecords(G.empty_tree(127, "cuda"), cuts, None, p,
                              cat=cat)
        rec_p = S.TreeRecords(G.empty_tree(127, "cuda"), cuts, None, p,
                              cat=cat)
        lk = S.split_level(**level, rec=rec_k, feature_mask=fmask)
        lp = S.split_level_plain(**level, rec=rec_p, feature_mask=fmask)
        torch.cuda.synchronize()
        pairs = ([(getattr(lk.splits, k), getattr(lp.splits, k))
                  for k in lk.splits._fields]
                 + [(getattr(lk, k), getattr(lp, k))
                    for k in ("node_value", "state", "active", "hist")]
                 + list(zip(rec_k.tree, rec_p.tree)))
        check(all(torch.equal(bits(a), bits(b)) for a, b in pairs),
              f"{rec_key}: K2's categorical level step not bitwise equal to "
              f"its plain version")
        check(bool(cat[lk.splits.feature.long()].any()),
              f"{rec_key}: no node split on a categorical feature")
        hist_bytes = n_nodes * f * nbt * 2 * 4
        _kernel_record(
            records, rec_key,
            lambda fm=fmask, rk=rec_k: S.split_level(**level, rec=rk,
                                                     feature_mask=fm),
            lambda fm=fmask, rp=rec_p: S.split_level_plain(
                **level, rec=rp, feature_mask=fm),
            bound_ms(2 * hist_bytes + 16 + 32 + 32 * (4 + 38) + f
                     + (n_nodes * f if fmask is not None else 0),
                     n_nodes * f * (3 * nbt + 30 * (nbt - 2))),
            flush, records[rec_key]["launches"], 0.0)
        rec_u = S.TreeRecords(G.empty_tree(127, "cuda"), cuts, None, p)
        times = []
        for _ in range(2):
            times.append(cuda_ms(lambda fm=fmask, rk=rec_k: S.split_level(
                **level, rec=rk, feature_mask=fm), iters=20))
            times.append(cuda_ms(lambda fm=fmask: S.split_level(
                **level, rec=rec_u, feature_mask=fm), iters=20))
        hold[rec_key] = {"categorical_ms": times[0::2],
                         "numeric_ms": times[1::2],
                         "numeric_device_ms": profiled_ms(
                             lambda fm=fmask: S.split_level(
                                 **level, rec=rec_u, feature_mask=fm))}
        records[rec_key]["numeric_ms"] = times[1::2]
    # K3's categorical route on the step's splits (categorical winners),
    # beside the numeric route of the same splits in turns
    st = lk.splits
    nval = lk.node_value
    rvk = torch.zeros(n_train, device="cuda")
    rvp = torch.zeros(n_train, device="cuda")
    args = (order, seg, bins, st.feature, st.split_bin, st.default_left,
            lk.state, nval)
    pk = H.partition_level(*args, rvk, True, nbt - 1, cat=cat)
    pp = H.partition_level_plain(*args, rvp, True, nbt - 1, cat=cat)
    torch.cuda.synchronize()
    used = int(pk.small_seg[-1])
    check(torch.equal(pk.order, pp.order) and torch.equal(pk.seg, pp.seg)
          and torch.equal(pk.small_seg, pp.small_seg)
          and torch.equal(pk.small_rows[:used], pp.small_rows[:used])
          and torch.equal(pk.small_is_right, pp.small_is_right)
          and torch.equal(bits(rvk), bits(rvp)),
          "K3cat: the categorical route differs from the plain version")
    leaf_rows = int((lk.state[H._node_of_slot(seg, n_nodes)] == H.LEAF).sum())
    k3_times = []
    for _ in range(2):
        k3_times.append(cuda_ms(lambda: H.partition_level(
            *args, rvk, True, nbt - 1, cat=cat), iters=10))
        k3_times.append(cuda_ms(lambda: H.partition_level(
            *args, rvk, True, nbt - 1), iters=10))
    key_sort = (2 * H._node_of_slot(seg, n_nodes)).to(torch.int32)
    lib_k3 = cuda_ms(lambda: torch.sort(key_sort, stable=True), iters=5)
    _kernel_record(records, "K3cat",
                   lambda: H.partition_level(*args, rvk, True, nbt - 1,
                                             cat=cat),
                   lambda: H.partition_level_plain(*args, rvp, True, nbt - 1,
                                                   cat=cat),
                   bound_ms(n_train * 4 + n_train * 2 + n_train * 4
                            + used * 4 + leaf_rows * 4, n_train),
                   flush, records["K3cat"]["launches"], 0.0, library=lib_k3)
    records["K3cat"]["numeric_ms"] = k3_times[1::2]
    hold["K3cat"] = {"categorical_ms": k3_times[0::2],
                     "numeric_ms": k3_times[1::2],
                     "numeric_device_ms": profiled_ms(
                         lambda: H.partition_level(*args, rvk, True,
                                                   nbt - 1))}
    del hp, level, lk, lp, pk, pp, bins, ghl, order, seg, rvk, rvp, args
    torch.cuda.empty_cache()
    # B4's categorical walk: C1's last round's tree over the test set
    eng = keep["C1"]["engine"]
    tb = eng.evals[1].bins
    tree = eng.trees[-1]
    wk = G.predict_tree_binned(tree, tb, depth, 256, cat=cat)
    wp = G.predict_tree_binned_plain(tree, tb, depth, 256, cat=cat)
    torch.cuda.synchronize()
    check(torch.equal(bits(wk), bits(wp)),
          "B4cat: the categorical walk differs from the plain version")
    b4_times = []
    for _ in range(2):
        b4_times.append(cuda_ms(lambda: G.predict_tree_binned(
            tree, tb, depth, 256, cat=cat), iters=20))
        b4_times.append(cuda_ms(lambda: G.predict_tree_binned(
            tree, tb, depth, 256), iters=20))
    sectors, visits = b4_work(tree, tb, depth, 256, cat)
    _kernel_record(records, "B4cat",
                   lambda: G.predict_tree_binned(tree, tb, depth, 256,
                                                 cat=cat),
                   lambda: G.predict_tree_binned_plain(tree, tb, depth, 256,
                                                       cat=cat),
                   bound_ms(sectors * 32 + 4 * tb.shape[0] + 13 * 127,
                            visits * 4),
                   flush, records["B4cat"]["launches"], 0.0)
    records["B4cat"]["numeric_ms"] = b4_times[1::2]
    hold["B4cat"] = {"categorical_ms": b4_times[0::2],
                     "numeric_ms": b4_times[1::2],
                     "numeric_device_ms": profiled_ms(
                         lambda: G.predict_tree_binned(tree, tb, depth,
                                                       256))}
    res["holds"] = hold
    emit({"phase": "categorical_kernels", "card": CARD, **hold})
    del keep, eng, tb, tree, wk, wp
    torch.cuda.empty_cache()
    t0 = lap("kernel_holds", t0)

    # every configuration against the fixed-point CPU path on a cut
    cmp = {}
    cut = min(compare_rows, n)
    for key, form, params in CAT_RUNS:
        cmp[key] = _same_on_cpu(train, key, params,
                                lambda form=form: matrices(form, hi=cut)[0])
    res["cpu_fixed_point"] = dict(cmp, rows=cut)
    lap("cpu_fixed_point", t0)
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res, (x, y, frame)


def phase_lossguide(x, y, records, airline=None, rounds=10,
                    compare_rows=50_000):
    """Phase 18 at full width. L1 the HIGGS split (10,500,000 rows train,
    the last 500,000 the test set), depth 6, ``max_leaves`` 64 (the full
    budget), against the depthwise model of the same data: the same leaf
    structure, margins within 1e-4; L2 the HIGGS split at depth 10 and
    ``max_leaves`` 255, where the budget binds (every tree at most 255
    leaves, some deeper than 6); L3 phase 17's airline set with
    ``max_leaves`` 255, depth 10, ``subsample`` and ``colsample_bytree``
    0.8. Each run's launches counted and checked exactly (a tree's
    launches recorded), the test logloss falling; the host syncs of one
    tree counted (``torch.cuda.set_sync_debug_mode``); the frontier-step
    kernel bitwise its plain version on a live frontier and timed; each
    run (2 rounds) equal to the fixed-point CPU path on a
    ``compare_rows`` cut."""
    import warnings

    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch.ops import grow as G
    from xgboost_ray_tpu_torch.ops import grow_lossguide as LG
    from xgboost_ray_tpu_torch.ops import histogram as H
    from xgboost_ray_tpu_torch.ops import split as S

    t_phase = time.perf_counter()
    if airline is None:
        airline = make_airline_like(x.shape[0])
    xa, ya, _ = airline
    n = x.shape[0]
    n_train = n - TEST_ROWS
    ft = ["c" if k else "q" for _, k in AIRLINE_COLUMNS]
    res = {"phase": "lossguide", "rows": n, "train_rows": n_train,
           "test_rows": TEST_ROWS, "rounds": rounds, "runs": {},
           "steps_s": {}}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    train = _phase_train(res, rounds, 6)

    def lap(name, since):
        res["steps_s"][name] = time.perf_counter() - since
        return time.perf_counter()

    def data(kind, hi=n_train, lo=None):
        xs, ys, types = ((x, y, None) if kind == "higgs"
                         else (xa, ya, ft))
        tr = xrt.RayDMatrix(xs[:hi], ys[:hi], feature_types=types)
        te = (None if lo is None else
              xrt.RayDMatrix(xs[lo:], ys[lo:], feature_types=types))
        return tr, te

    t0 = time.perf_counter()
    keep = {}
    for key, kind, depth, params in LOSSGUIDE_RUNS:
        r = train(params, *data(kind, lo=n_train), tdepth=depth)
        leaves = params["max_leaves"]
        expect = lossguide_expect(params, rounds, leaves,
                                  cat=kind == "airline")
        _exact(r["launches"], expect, key)
        counts = [int(c) for c in np.asarray(r["bst"].forest.is_leaf).sum(1)]
        check(max(counts) <= leaves, f"{key}: a tree of more than {leaves} "
                                     f"leaves: {counts}")
        slots = [np.nonzero(t)[0] for t in np.asarray(r["bst"].forest.is_leaf)]
        deepest = [int(np.floor(np.log2(s + 1)).max()) for s in slots]
        tree_ms = float(np.median(r["round_ms"]))
        res["runs"][key] = {
            "max_depth": depth, "max_leaves": leaves,
            "launches": r["launches"], "expected": expect,
            "launches_a_tree": {k: v // rounds for k, v in expect.items()
                                if v},
            "round_ms": r["round_ms"], "round_ms_median": tree_ms,
            "step_ms": tree_ms / max(leaves - 1, 1),
            "train_wall_s": r["wall_s"], "leaves": counts,
            "deepest_leaf": deepest,
            "test_logloss": _falls(r["ev"]["test"]["logloss"], key)}
        if key == "L2":
            check(max(deepest) > 6, f"L2: no leaf below depth 6: {deepest}")
        if key == "L1":
            records["LGstep"]["launches"] = r["launches"]["LGstep"]
        keep[key] = r
    # L1 against the depthwise model of the same run
    dw = train({"objective": "binary:logistic"}, *data("higgs", lo=n_train))
    a, b = keep["L1"]["bst"].forest, dw["bst"].forest
    same = {k: bool(np.array_equal(getattr(a, k), getattr(b, k)))
            for k in ("feature", "split_bin", "is_leaf", "default_left")}
    check(all(same.values()), f"L1: the leaf structure differs from the "
                              f"depthwise model's: {same}")
    # the first tree's gains: a later tree grows on margins whose final
    # leaves differ in their last bits (K2's readout against K1's totals)
    internal = ~np.asarray(a.is_leaf[0]) & (np.asarray(a.feature[0]) >= 0)
    xt = x[n_train:]
    ma = np.asarray(keep["L1"]["bst"].predict(xt, output_margin=True))
    mb = np.asarray(dw["bst"].predict(xt, output_margin=True))
    gap = float(np.abs(ma - mb).max())
    check(gap <= 1e-4, f"L1: margins {gap} from the depthwise model's")
    res["l1_vs_depthwise"] = {
        "structure_equal": same, "margin_max_gap": gap,
        "margins_bitwise": bool(np.array_equal(ma, mb)),
        "first_tree_gains_bitwise": bool(np.array_equal(
            np.asarray(a.gain[0])[internal], np.asarray(b.gain[0])[internal])),
        "leaf_values_bitwise": bool(np.array_equal(
            np.asarray(a.value), np.asarray(b.value))),
        "depthwise_round_ms_median": float(np.median(dw["round_ms"]))}
    del dw
    emit({"phase": "lossguide_rounds", "card": CARD,
          **{k: res["runs"][k]["round_ms_median"]
             for k, _, _, _ in LOSSGUIDE_RUNS},
          "l1_vs_depthwise": res["l1_vs_depthwise"]})
    t0 = lap("l1_l3", t0)

    # one L2 tree built directly: the host syncs it makes, and a live
    # frontier for the frontier step's hold
    eng = keep["L2"]["engine"]
    cfg = eng.cfg
    gh = eng.gh[0]
    qs = eng.qscale[0]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            LG.build_tree_lossguide(eng.bins, gh, eng.cuts, cfg,
                                    feat_has_missing=eng.feat_has_missing,
                                    qscale=qs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    res["host_syncs_a_tree"] = len(syncs)
    res["host_sync_kinds"] = sorted(set(s[:200] for s in syncs))[:5]
    # the frontier step on a live frontier: L2's root and one step
    leaves = cfg.max_leaves
    nbt = cfg.max_bin + 1
    frs, recs = [], []
    for _ in range(2):
        tree = G.empty_tree(cfg.heap_size, "cuda")
        rec = S.TreeRecords(tree, eng.cuts, eng.feat_has_missing, cfg.split)
        fr = LG.new_frontier(leaves, n_train, x.shape[1], nbt, "cuda")
        frs.append(fr)
        recs.append(rec)
    order = torch.arange(n_train, dtype=torch.int32, device="cuda")
    root_seg = torch.tensor([0, n_train], dtype=torch.int32, device="cuda")
    hist, _ = LG.build_histogram(eng.bins, gh, order, root_seg, 1, nbt,
                                 qscale=qs)
    sp = S.split_nodes(LG.dequantize(hist, qs), None, None, recs[0],
                       frs[0].store[0:1])
    frs[1].store.copy_(frs[0].store)
    LG.frontier_step(frs[0], recs[0], sp, None, 0, True, False)
    LG.frontier_step_plain(frs[1], recs[1], sp, None, 0, True, False)
    part = H.partition_level(order, frs[0].seg, eng.bins, frs[0].feature,
                             frs[0].split_bin, frs[0].default_left,
                             frs[0].state, frs[0].value,
                             torch.zeros(n_train, device="cuda"), True, 256)
    small, _ = LG.build_histogram(eng.bins, gh, part.small_rows,
                                  part.small_seg[1:3], 1, nbt, qscale=qs)
    sp2 = S.split_nodes(LG.dequantize(small, qs), frs[0].parent,
                        part.small_is_right[1:2], recs[0],
                        frs[0].store[1:3])
    frs[1].store.copy_(frs[0].store)
    args = (sp2, part.seg, 1, True, False)
    # what a step writes (not the store it reads, nor the parent buffer it
    # overwrites with the same entry's histogram), restored before each
    # timed call
    small_fields = [i for i, k in enumerate(LG.Frontier._fields)
                    if k not in ("store", "parent")]
    snap = [[fr[i].clone() for i in small_fields] for fr in frs]
    tsnap = [tuple(t.clone() for t in rec.tree) for rec in recs]
    LG.frontier_step(frs[0], recs[0], *args)
    LG.frontier_step_plain(frs[1], recs[1], *args)
    torch.cuda.synchronize()
    ok = (all(torch.equal(bits(a), bits(b)) for a, b in zip(frs[0], frs[1]))
          and all(torch.equal(bits(a), bits(b))
                  for a, b in zip(recs[0].tree, recs[1].tree)))
    check(ok, "LGstep: the frontier step differs from its plain version")
    # the last launch of a tree (finish) on the same frontier
    fin = [LG.Frontier(*[t.clone() for t in fr]) for fr in frs]
    LG.frontier_step(fin[0], recs[0], sp2, part.seg, 1, False, True)
    LG.frontier_step_plain(fin[1], recs[1], sp2, part.seg, 1, False, True)
    torch.cuda.synchronize()
    check(all(torch.equal(bits(a), bits(b)) for a, b in zip(fin[0], fin[1])),
          "LGstep: the finishing step differs from its plain version")

    def restore(i):
        for j, src in zip(small_fields, snap[i]):
            frs[i][j].copy_(src)
        for dst, src in zip(recs[i].tree, tsnap[i]):
            dst.copy_(src)

    n_ent = 2 * leaves - 1
    hist_bytes = x.shape[1] * nbt * 8
    _kernel_record(records, "LGstep",
                   lambda: (restore(0), LG.frontier_step(frs[0], recs[0],
                                                         *args)),
                   lambda: (restore(1), LG.frontier_step_plain(
                       frs[1], recs[1], *args)),
                   bound_ms(n_ent * 22 + 2 * hist_bytes + 64, n_ent * 4),
                   flush, records["LGstep"]["launches"], 0.0)
    # ms (events) includes the restore copies; device_ms the kernel alone
    records["LGstep"]["ms_includes_restore"] = True
    del frs, recs, fin, snap, tsnap, part, small, hist, eng
    torch.cuda.empty_cache()
    t0 = lap("frontier_hold", t0)

    cmp = {}
    cut = min(compare_rows, n)
    for key, kind, depth, params in LOSSGUIDE_RUNS:
        cmp[key] = _same_on_cpu(train, key, params,
                                lambda kind=kind: data(kind, hi=cut)[0],
                                depth=depth)
    res["cpu_fixed_point"] = dict(cmp, rows=cut)
    lap("cpu_fixed_point", t0)
    del keep
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 19: quantized gradients and the quantized histogram wire
# ---------------------------------------------------------------------------

#: phase 19's runs: (key, params, ranks); Q0 the f32 main path of the call
QUANT_RUNS = (
    ("Q0", {}, 1),
    ("Q1", {"gh_precision": "int8"}, 1),
    ("Q2", {"gh_precision": "int16"}, 1),
    ("Q3", {"hist_quant": "int8"}, 1),
    ("Q4", {"gh_precision": "int8", "hist_quant": "int8_block"}, 2),
    ("Q5", {"gh_precision": "int8", "hist_quant": "int8",
            "grow_policy": "lossguide", "max_leaves": 64}, 1),
)
#: the kernel table's rows of phase 19
QUANT_KERNELS = ("B10", "K1int", "K1form", "B11q", "B11acc", "B11deq")
QUANT_COUNTERS = ("K1", "K1deq", "K1int", "K1form", "B10", "B11q", "B11acc",
                  "B11deq")


def _wire_launches(mode, world):
    """(B11q, B11acc, B11deq) of one merge on a quantized wire."""
    if mode.endswith("_block"):
        return (2, 0, 2) if world == 1 else (world, world - 1, 1)
    return (3, 0, 2) if world == 1 else (3, 1, 1)


def quantized_expect(params, rounds, depth, n_features, nbt=257, world=1,
                     held_out=True):
    """Exact launches a rank of a binary ``train()`` with ``params``'
    quantization (one device block a rank): per tree B10 once; K1 (int64
    fixed point) or its integer instantiation at every level, plus a
    totals-only pass over every node where a sibling level's histogram
    takes the quantized wire and at the final level; the dequantise step
    (f32 gradients: the merged sums, the local sums before a wire, the
    exact totals) or the form-and-dequantise step (integer gradients: a
    level's formation, the exact totals); B11's kernels per quantized
    merge (``_wire_launches``). Lossguide: the root, then ``max_leaves -
    1`` steps whose histogram the wire decides on the reference's two
    nodes, one K1 launch a step (the smaller child, or both children and
    their totals on the quantized wire); the rest as ``sampling_expect``
    and ``lossguide_expect``."""
    from xgboost_ray_tpu_torch.ops.histogram import wire_quantized

    mode = params.get("hist_quant", "none")
    min_bytes = params.get("hist_quant_min_bytes", 32768)
    gh_int = params.get("gh_precision", "float32") != "float32"
    k1 = "K1int" if gh_int else "K1"
    c = dict.fromkeys(QUANT_COUNTERS, 0)
    per_node = n_features * nbt * 2

    def merge(qw, exact_totals):
        """One histogram's merge (and its exact totals where quantized)."""
        if qw:
            q, a, d = _wire_launches(mode, world)
            c["B11q"] += q
            c["B11acc"] += a
            c["B11deq"] += d
            c["K1deq"] += 0 if gh_int else 1  # the local sums, dequantised
            if exact_totals:
                c["K1form" if gh_int else "K1deq"] += 1
        elif not gh_int:
            c["K1deq"] += 1

    leaves = params.get("max_leaves", 0)
    if params.get("grow_policy") == "lossguide":
        out = lossguide_expect(params, rounds, leaves, held_out)
        q_root = wire_quantized(mode, per_node, min_bytes)
        q_step = wire_quantized(mode, 2 * per_node, min_bytes)
        c[k1] += 1
        merge(q_root, True)
        c["K1form"] += 1 if gh_int else 0  # the search's dequantisation
        for _ in range(leaves - 1):
            c[k1] += 1
            merge(q_step, True)
            c["K1form"] += 1 if gh_int else 0
    else:
        out = sampling_expect(params, rounds, depth, held_out)
        for d in range(depth):
            built = (1 << d) // 2 if d else 1
            qw = wire_quantized(mode, built * per_node, min_bytes)
            c[k1] += 1 + (1 if qw and d else 0)
            merge(qw, True)
            c["K1form"] += 1 if gh_int else 0  # the level's formation
        c[k1] += 1
        c["K1form" if gh_int else "K1deq"] += 1
    c["B10"] = 1 if gh_int else 0
    out.update({k: v * rounds for k, v in c.items()})
    return out


def _gh_absmax_scales(engine):
    """The round's fixed-point scales on the CPU path that sums in the
    card's fixed point, the merged absmax kept for B10 as the engine keeps
    it (``TorchEngine._round_absmax``)."""
    from xgboost_ray_tpu_torch.ops import histogram as H

    if not hasattr(H, "gh_absmax"):  # an older tree
        return H.quant_scales(engine.gh, engine.n_global, engine.coll.max)
    engine.gh_absmax = engine.coll.max(H.gh_absmax(engine.gh))
    return H.scales_for(engine.gh_absmax, engine.n_global)


def _quant_holds(eng, records, flush, n_rows):
    """B10, K1's integer instantiation, the form-and-dequantise step and
    B11's kernels against their plain versions on the card, at the HIGGS
    split's shapes, and timed (``_kernel_record``)."""
    import torch

    from xgboost_ray_tpu_torch.ops import histogram as H
    from xgboost_ray_tpu_torch.ops import objectives as O
    from xgboost_ray_tpu_torch.ops.grow import SALT_SR
    from xgboost_ray_tpu_torch.ops.random import fold_in

    res = {}
    gh = eng.gh[0]
    amax = eng.gh_absmax[0]
    n = gh.shape[0]
    key = fold_in((0, 7), SALT_SR)
    # B10 at int8 and int16 over the training rows, as a 2-block layout's
    # two ranks (each block its key), zero rows kept zero
    ghz = gh.clone()
    ghz[::1000] = 0.0
    half = n // 2
    qmax16 = O.gh_qmax("int16", n)
    for mode in ("int8", "int16"):
        for lo, hi, d in ((0, half, 0), (half, n, 1)):
            part = ghz[lo:hi]
            qc, sc = O.quantize_gh(part, mode, fold_in(key, d), amax, n)
            qp = O.quantize_gh_plain(part, O.gh_qmax(mode, n), sc,
                                     fold_in(key, d), qc.dtype)
            torch.cuda.synchronize()
            check(torch.equal(qc, qp), f"B10 ({mode}, block {d}) differs "
                                       f"from its plain version")
            check(bool((qc[::1000] == 0).all()), f"B10 ({mode}): a zero row "
                                                 f"does not stay zero")
    res["b10_qmax_int16"] = qmax16
    q8, s8 = O.quantize_gh(gh, "int8", key, amax, n)
    qmax8 = O.gh_qmax("int8", n)
    _kernel_record(
        records, "B10", lambda: O.quantize_gh(gh, "int8", key, amax, n),
        lambda: O.quantize_gh_plain(gh, qmax8, s8, key, torch.int8),
        sampling_bound_ms(n * (8 + 2), 2 * n * (THREEFRY_OPS + 8)), flush,
        records["B10"]["launches"], 0.0)
    # K1's integer instantiation: level 5 (32 nodes) and the root, F = 28
    # over the training rows' bins, and F = 54 on a cut of 2M rows
    nbt = 257
    bins = eng.bins
    f = bins.shape[1]
    node = torch.randint(0, 32, (n,), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(5))
    order = torch.sort(node, stable=True).indices.to(torch.int32)
    seg = torch.cat([torch.zeros(1, dtype=torch.long, device="cuda"),
                     torch.cumsum(torch.bincount(node, minlength=32), 0)]
                    ).to(torch.int32)
    ident = torch.arange(n, dtype=torch.int32, device="cuda")
    seg1 = torch.tensor([0, n], dtype=torch.int32, device="cuda")
    for rows, sg, nn, what in ((order, seg, 32, "level 5"),
                               (ident, seg1, 1, "root")):
        hc, tc = H.build_histogram(bins, q8, rows, sg, nn, nbt)
        hp, tp = H.build_histogram_plain(bins, q8, rows, sg, nn, nbt)
        torch.cuda.synchronize()
        check(torch.equal(hc, hp) and torch.equal(tc, tp),
              f"K1int ({what}, F = {f}) differs from its plain version")
    n54 = min(2_000_000, n)
    b54, _, o54, s54 = level_inputs(n54, 54, 32, 3, True)
    q54 = q8[:n54]
    hc, tc = H.build_histogram(b54, q54, o54, s54, 32, nbt)
    hp, tp = H.build_histogram_plain(b54, q54, o54, s54, 32, nbt)
    check(torch.equal(hc, hp) and torch.equal(tc, tp),
          "K1int (level 5, F = 54) differs from its plain version")
    del b54, o54, s54, hc, hp
    flat = H.flat_bucket_ids(bins, order, seg, 32, nbt)
    src = q8.to(torch.int32)[order.long()][:, None, :].expand(
        n, f, 2).reshape(-1, 2)
    out = torch.zeros((32 * f * nbt, 2), dtype=torch.int32, device="cuda")
    lib_k1int = cuda_ms(lambda: out.index_add_(0, flat, src), iters=3)
    del flat, src, out
    hist_bytes = 32 * f * nbt * 2 * 4
    _kernel_record(
        records, "K1int",
        lambda: H.build_histogram(bins, q8, order, seg, 32, nbt),
        lambda: H.build_histogram_plain(bins, q8, order, seg, 32, nbt),
        sampling_bound_ms(n * f * 2 + n * 4 + n * 2 + hist_bytes + 32 * 8,
                          2 * n * f), flush, records["K1int"]["launches"],
        0.0, library=lib_k1int)
    # the form-and-dequantise step at level 5: 16 parents, their smaller
    # children (int32 sums), formed and dequantised with the totals
    small = H.build_histogram(bins, q8, order, seg, 32, nbt)[0][:16]
    small = small.contiguous()
    prev = (small * 2 + 1).contiguous()
    sir = torch.arange(16, device="cuda") % 3 == 0
    for args in ((small, prev, sir, s8, torch.int32, True),
                 (small, None, None, s8, torch.int32, True),
                 (small.float(), prev, sir, s8, torch.float32, False)):
        c = H.form_dequantize(*args)
        p = H.form_dequantize_plain(*args)
        torch.cuda.synchronize()
        check(all((a is None and b is None) or torch.equal(bits(a), bits(b))
                  for a, b in zip(c, p)),
              "K1form differs from its plain version")
    cells = 16 * f * nbt * 2
    _kernel_record(
        records, "K1form",
        lambda: H.form_dequantize(small, prev, sir, s8, torch.int32, True),
        lambda: H.form_dequantize_plain(small, prev, sir, s8, torch.int32,
                                        True),
        bound_ms(cells * 4 * 2 + 2 * cells * 4 * 2 + 16, 2 * cells * 3),
        flush, records["K1form"]["launches"], 0.0)
    # B11 on a level-5 HIGGS histogram (16 smaller children x 28 x 257 x
    # 2) in every mode at hist_quant_block 64, 512 and 4096
    hl = H.dequantize_gh_sums(small, s8) if hasattr(
        H, "dequantize_gh_sums") else small.float() * s8
    hl = hl.contiguous()
    v = hl.numel()
    for mode in ("int8", "int16"):
        qmax, qdt = H._QMAX[mode], H._QDTYPE[mode]
        hr = hl.view(16 * f, nbt * 2)
        checks = [
            (lambda: H.wire_quantize(hr, nbt * 2, qmax, qdt,
                                     absmax_only=True),
             lambda: H.wire_quantize_plain(hr, nbt * 2, qmax, qdt,
                                           absmax_only=True)),
            (lambda: H.wire_quantize(hr, nbt * 2, qmax, qdt, inband=True),
             lambda: H.wire_quantize_plain(hr, nbt * 2, qmax, qdt,
                                           inband=True))]
        q_r, s_r = H.wire_quantize_plain(hr, nbt * 2, qmax, qdt)
        recv = torch.stack([q_r, q_r.flip(0)])
        checks.append((lambda: H.wire_accumulate(recv, s_r),
                       lambda: H.wire_accumulate_plain(recv, s_r)))
        checks.append((lambda: H.wire_dequantize(q_r, nbt * 2, nbt * 2, s_r),
                       lambda: H.wire_dequantize_plain(q_r, nbt * 2,
                                                       nbt * 2, s_r)))
        for block in (64, 512, 4096):
            flat = hl.view(1, -1)
            pay = H.wire_quantize_plain(flat, block, qmax, qdt, inband=True)
            checks += [
                (lambda b=block: H.wire_quantize(flat, b, qmax, qdt,
                                                 inband=True),
                 lambda b=block: H.wire_quantize_plain(flat, b, qmax, qdt,
                                                       inband=True)),
                (lambda b=block, p=pay: H.wire_accumulate(
                    p.view(-1), flat.view(-1), b),
                 lambda b=block, p=pay: H.wire_accumulate_plain(
                    p.view(-1), flat.view(-1), b)),
                (lambda b=block, p=pay: H.wire_dequantize(p, v, b),
                 lambda b=block, p=pay: H.wire_dequantize_plain(p, v, b))]
        for kern, plain in checks:
            a, b = kern(), plain()
            torch.cuda.synchronize()
            same = (all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))
                    if isinstance(a, tuple) else torch.equal(bits(a),
                                                             bits(b)))
            check(same, f"B11 ({mode}) differs from its plain version")
    flat = hl.view(1, -1)
    pay = H.wire_quantize_plain(flat, 512, 127, torch.int8, inband=True)
    sw = -(-v // 512) * 4
    _kernel_record(
        records, "B11q",
        lambda: H.wire_quantize(flat, 512, 127, torch.int8, inband=True),
        lambda: H.wire_quantize_plain(flat, 512, 127, torch.int8,
                                      inband=True),
        bound_ms(v * 4 + v + sw, 4 * v), flush,
        records["B11q"]["launches"], 0.0)
    _kernel_record(
        records, "B11acc",
        lambda: H.wire_accumulate(pay.view(-1), flat.view(-1), 512),
        lambda: H.wire_accumulate_plain(pay.view(-1), flat.view(-1), 512),
        bound_ms(v + sw + v * 4 + v * 4, 2 * v), flush,
        records["B11acc"]["launches"], 0.0)
    _kernel_record(
        records, "B11deq", lambda: H.wire_dequantize(pay, v, 512),
        lambda: H.wire_dequantize_plain(pay, v, 512),
        bound_ms(v + sw + v * 4, 2 * v), flush,
        records["B11deq"]["launches"], 0.0)
    del hl, small, prev, pay, q8, node, order, ident, ghz
    torch.cuda.empty_cache()
    return res


def _quant_world(world, data, params, rounds, options):
    """One ``train()`` in the 2-rank ``world``: rank 0's result, the ranks'
    models checked equal."""
    from xgboost_ray_tpu_torch import distributed as D

    out = world.run(D._train_rank, data, params, rounds, options)
    check(out[0]["model"] == out[1]["model"],
          "Q4: the ranks' models differ")
    return out


def phase_quantized(x, y, records, rounds=10, depth=6, compare_rows=50_000,
                    lossguide_rows=50_000):
    """Phase 19 at full width: the HIGGS split (10,500,000 rows train, the
    last 500,000 the test set), depth 6, 10 rounds, ``logloss`` on the test
    set. Q0 the f32 main path of the call; Q1 ``gh_precision="int8"``; Q2
    ``"int16"`` (qmax 204 at these rows); Q3 ``hist_quant="int8"`` at one
    rank; Q4 int8 gradients on the ``int8_block`` wire as 2 gloo ranks
    sharing the card (the NCCL wire needs a call of two or more cards:
    ``--ranks-only`` there); Q5 L1's lossguide (64 leaves) with int8
    gradients on the int8 wire. Each run's launches counted and checked
    exactly (``quantized_expect``), the test logloss falling and recorded
    beside Q0's, ``hist_allreduce_bytes_per_round`` and
    ``gh_plane_bytes_per_shard`` against their formulas. Q1 (2 rounds on a
    ``compare_rows`` cut) and Q5 (``lossguide_rows``) equal the port's CPU
    path bit for bit with no fixed-point patch, Q4 the CPU path's 2-rank
    gloo world; Q3 the fixed-point CPU path (``_cpu_fixed_point``).
    Then B10, K1's integer instantiation, the form-and-dequantise step and
    B11's kernels against their plain versions and timed
    (``_quant_holds``)."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch import distributed as D
    from xgboost_ray_tpu_torch.ops import objectives as O

    t_phase = time.perf_counter()
    n = x.shape[0]
    n_train = n - TEST_ROWS
    f = x.shape[1]
    res = {"phase": "quantized", "card": CARD, "rows": n,
           "train_rows": n_train, "test_rows": TEST_ROWS, "rounds": rounds,
           "runs": {}, "steps_s": {}}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    train = _phase_train(res, rounds, depth)
    # both worlds boot while the one-rank runs go: the card's (Q4) and the
    # CPU's (Q4's CPU path)
    world_gpu = D.World(2, "cuda", backend="gloo")
    world_cpu = D.World(2, "cpu")
    cut = min(compare_rows, n_train)
    try:
        t0 = time.perf_counter()
        data = D.share({"x": x[:n_train], "label": y[:n_train]})
        test = D.share({"x": x[n_train:], "label": y[n_train:]})
        cut_data = D.share({"x": x[:cut], "label": y[:cut]})
        opts = {"device": "cuda", "num_actors": 2,
                "eval_names": ["train", "test"],
                "eval_data": [None, dict(test, sharding="INTERLEAVED")]}
        res["steps_s"]["share"] = time.perf_counter() - t0
        keep = {}
        ref_ll = None
        for key, extra, ranks in QUANT_RUNS:
            params = {"objective": "binary:logistic", **extra}
            tdepth = depth
            t0 = time.perf_counter()
            if ranks == 1:
                r = train(params, xrt.RayDMatrix(x[:n_train], y[:n_train]),
                          xrt.RayDMatrix(x[n_train:], y[n_train:]),
                          tdepth=tdepth)
                launches, ev, extra_res = r["launches"], r["ev"], None
                bytes_round = None
                keep[key] = r
                round_ms = r["round_ms"]
            else:
                out = _quant_world(world_gpu, data, dict(
                    params, max_depth=tdepth, max_bin=256, seed=7,
                    eval_metric=["logloss"]), rounds, opts)
                launches = out[0]["launches"]
                ev = out[0]["evals_result"]
                extra_res = out[0]["additional_results"]
                round_ms = [s * 1e3 for s in extra_res["round_times_s"]]
            expect = quantized_expect(params, rounds, tdepth, f, world=ranks)
            _exact(launches, expect, key)
            ll = _falls(ev["test"]["logloss"], key)
            if key == "Q0":
                ref_ll = ll[-1]
            run = {"params": params, "ranks": ranks, "launches": {
                       k: launches[k] for k in expect},
                   "round_ms": round_ms,
                   "round_ms_median": float(np.median(round_ms)),
                   "test_logloss": ll, "test_logloss_f32_main_path": ref_ll,
                   "wall_s": time.perf_counter() - t0}
            if extra_res is not None:
                run["hist_allreduce_bytes_per_round"] = extra_res[
                    "hist_allreduce_bytes_per_round"]
                run["gh_plane_bytes_per_shard"] = extra_res[
                    "gh_plane_bytes_per_shard"]
            else:
                eng = r["engine"]
                run["hist_allreduce_bytes_per_round"] = (
                    eng.hist_allreduce_bytes_per_round)
                run["gh_plane_bytes_per_shard"] = (
                    eng.gh_plane_bytes_per_shard())
            slots = -(-n_train // ranks)
            itemsize = O.gh_plane_itemsize(params.get("gh_precision",
                                                      "float32"))
            check(run["gh_plane_bytes_per_shard"] == slots * 2 * itemsize,
                  f"{key}: gh_plane_bytes_per_shard "
                  f"{run['gh_plane_bytes_per_shard']}, expected "
                  f"{slots * 2 * itemsize}")
            if ranks == 1:
                # one rank: no wire; the card's round-scale MAX moves
                # nothing at world 1 either
                check(run["hist_allreduce_bytes_per_round"] == 0,
                      f"{key}: bytes on one rank")
            else:
                run["bytes_expected"] = quant_world_bytes(params, tdepth, f)
                check(run["hist_allreduce_bytes_per_round"]
                      == run["bytes_expected"],
                      f"{key}: hist_allreduce_bytes_per_round "
                      f"{run['hist_allreduce_bytes_per_round']}, expected "
                      f"{run['bytes_expected']}")
            if key == "Q2":
                # 204 at the HIGGS split's 10,500,000 rows
                run["qmax"] = O.gh_qmax("int16", n_train)
                check(run["qmax"] == min(32767, (2 ** 31 - 1) // n_train),
                      f"Q2: qmax {run['qmax']}")
            res["runs"][key] = run
        for k in QUANT_KERNELS:  # Q4's: its rank 0's
            records[k]["launches"] = sum(
                res["runs"][q]["launches"].get(k, 0) for q, _, _ in QUANT_RUNS)
        emit({"phase": "quantized_rounds", "card": CARD,
              **{k: res["runs"][k]["round_ms_median"]
                 for k, _, _ in QUANT_RUNS},
              "test_logloss": {k: res["runs"][k]["test_logloss"][-1]
                               for k, _, _ in QUANT_RUNS}})
        t0 = time.perf_counter()
        res.update(_quant_holds(keep["Q1"]["engine"], records, flush,
                                n_train))
        res["steps_s"]["holds"] = time.perf_counter() - t0
        keep.clear()
        torch.cuda.empty_cache()
        # the CPU paths on cuts (2 rounds)
        t0 = time.perf_counter()
        cmp = {}
        runs = {k: v for k, v, _ in QUANT_RUNS}
        for key, rows in (("Q1", cut), ("Q5", min(lossguide_rows, n_train))):
            # quantized gradients: the CPU path as it is, no patch
            params = dict(runs[key], objective="binary:logistic")
            card = train(params, xrt.RayDMatrix(x[:rows], y[:rows]), None,
                         n_rounds=2)
            cpu = train(params, xrt.RayDMatrix(x[:rows], y[:rows]), None,
                        n_rounds=2, device="cpu")
            same = (card["bst"].get_dump(with_stats=True)
                    == cpu["bst"].get_dump(with_stats=True))
            check(same, f"{key}: the card's model differs from the CPU "
                        f"path's")
            cmp[key] = {"rows": rows, "rounds": 2, "dumps_equal_cpu": same}
        q4 = dict(QUANT_RUNS[4][1], objective="binary:logistic",
                  max_depth=depth, max_bin=256, seed=7)
        outs = [_quant_world(w, cut_data, q4, 2, {"device": dev})
                for w, dev in ((world_gpu, "cuda"), (world_cpu, "cpu"))]
        same = outs[0][0]["model"] == outs[1][0]["model"]
        check(same, "Q4: the card's 2-rank model differs from the CPU "
                    "path's 2-rank world")
        cmp["Q4"] = {"rows": cut, "rounds": 2,
                     "models_equal_cpu_world": same}
        cmp["Q3"] = dict(_same_on_cpu(
            train, "Q3", dict(runs["Q3"], objective="binary:logistic"),
            lambda: xrt.RayDMatrix(x[:cut], y[:cut])), rows=cut)
        res["cpu_paths"] = cmp
        res["steps_s"]["cpu_paths"] = time.perf_counter() - t0
    finally:
        world_gpu.close()
        world_cpu.close()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


def phase_quant_nccl(x, y, rounds, depth=6):
    """Phase 19's Q4 (int8 gradients on the ``int8_block`` wire) as 2 NCCL
    ranks, a card each, against the same run as 2 gloo ranks (a card each
    too: the same kernels, another transport): the same model, each rank's
    launches and bytes as ``quantized_expect`` / ``quant_world_bytes``
    count them. With one card: reported as not run."""
    import torch

    from xgboost_ray_tpu_torch import distributed as D

    cards = torch.cuda.device_count()
    if cards < 2:
        emit({"phase": "quant_nccl", "not_run": f"{cards} device"})
        return None
    params = {"objective": "binary:logistic", "gh_precision": "int8",
              "hist_quant": "int8_block", "max_depth": depth, "max_bin": 256,
              "seed": 7, "eval_metric": ["logloss"]}
    data = D.share({"x": x, "label": y})
    res = {"phase": "quant_nccl", "rows": int(x.shape[0]), "card": CARD}
    models = {}
    for backend in ("nccl", "gloo"):
        t0 = time.perf_counter()
        out = D.launch_world(D._train_rank, 2, "cuda", data, params, rounds,
                             backend=backend)
        extra = out[0]["additional_results"]
        check(extra["backend"] == backend, f"Q4 over {extra['backend']}")
        expect = quantized_expect(params, rounds, depth, x.shape[1], world=2,
                                  held_out=False)
        for r, o in enumerate(out):
            _exact(o["launches"], expect, f"Q4 {backend} rank {r}")
        nbytes = quant_world_bytes(params, depth, x.shape[1])
        check(extra["hist_allreduce_bytes_per_round"] == nbytes,
              f"Q4 {backend}: bytes {extra['hist_allreduce_bytes_per_round']}"
              f", expected {nbytes}")
        models[backend] = out[0]["model"]
        rt = [t * 1e3 for t in extra["round_times_s"]]
        res[backend] = {"round_ms": rt, "round_ms_median": float(np.median(rt)),
                        "hist_allreduce_bytes_per_round": nbytes,
                        "wall_s": time.perf_counter() - t0}
    check(models["nccl"] == models["gloo"],
          "Q4: the NCCL ranks' model differs from the gloo ranks'")
    res["models_equal"] = True
    emit(res)
    return res


def quant_world_bytes(params, depth, n_features, nbt=257, world=2):
    """``hist_allreduce_bytes_per_round`` of one binary tree at ``world``
    ranks on the card (ring factor 2 (n - 1) / n for all-reduces): the
    round's scales' MAX of (max|g|, max|h|) (f32 [1, 2]); per level the
    merged histogram (int32 with integer gradients, else int64; on a
    quantized wire its bytes), the children's row counts (int64, levels
    below the root), the exact totals where quantized (int32 / int64
    [n, 2]); the final totals."""
    import torch

    from xgboost_ray_tpu_torch.ops import histogram as H

    mode = params.get("hist_quant", "none")
    min_bytes = params.get("hist_quant_min_bytes", 32768)
    gh_int = params.get("gh_precision", "float32") != "float32"
    item = 4 if gh_int else 8
    ring = 2 * (world - 1) / world
    total = int(ring * 2 * 4)
    for d in range(depth):
        built = (1 << d) // 2 if d else 1
        cells = built * n_features * nbt * 2
        if H.wire_quantized(mode, cells, min_bytes):
            counter = H.AllreduceBytes(world)

            class _Count:
                world, rank, bytes = 2, 0, counter

                def sum(self, t):
                    counter.add_allreduce(t)
                    return t

                def max(self, t):
                    counter.add_allreduce(t)
                    return t

                def all_to_all(self, t):
                    counter.add_all_to_all(t)
                    return t

                def ring_exchange(self, t):
                    counter.add_ppermute(t)
                    return t

                def all_gather(self, t):
                    out = torch.cat([t] * world)
                    counter.add_allgather(out)
                    return out

            H.quantized_hist_allreduce(
                torch.zeros((built, n_features, nbt, 2)), mode, _Count(), 0,
                params.get("hist_quant_block", 512))
            total += counter.total + int(ring * (1 << d) * 2 * item)
        else:
            total += int(ring * cells * item)
        if d:
            total += int(ring * (1 << d) * 8)
    total += int(ring * (1 << depth) * 2 * item)
    return total


# ---------------------------------------------------------------------------
# phase 20: dart and gblinear (B4w, B16)
# ---------------------------------------------------------------------------

DART_RUNS = (
    ("D1", {"objective": "binary:logistic", "booster": "dart",
            "rate_drop": 0.1}, "higgs"),
    ("D2", {"objective": "binary:logistic", "booster": "dart",
            "rate_drop": 0.1, "sample_type": "weighted",
            "normalize_type": "forest", "one_drop": 1, "skip_drop": 0.5},
     "higgs"),
    ("D3", {"objective": "multi:softprob", "num_class": 7, "booster": "dart",
            "rate_drop": 0.1, "eval_metric": ["mlogloss"]}, "covertype"),
)
LINEAR_PARAMS = {"booster": "gblinear", "eta": 0.5, "reg_lambda": 0.01,
                 "reg_alpha": 0.001}
LINEAR_RUNS = (
    ("G1", {"objective": "reg:squarederror", "eval_metric": ["rmse"]},
     "higgs", False),
    ("G2", {"objective": "binary:logistic", "eval_metric": ["logloss"]},
     "higgs", True),
    ("G3", {"objective": "multi:softprob", "num_class": 7,
            "eval_metric": ["mlogloss"]}, "covertype", True),
)
DART_GBLINEAR_KERNELS = ("B4w", "B16")


def dart_expect(rounds, depth, k, held_out=True):
    """Launches of a dart ``train()`` with the training set (and a held-out
    set) among its evals: per tree the gbtree path's (``train_expect`` over
    rounds x K trees); per round the round pass over B4w's margins under
    the drops (the gradients), and its eval mode over each set's margins
    under the round's weights (K4, or the softmax pass with K outputs); B4w
    over the training rows twice and once a held-out set, but for the first
    round's margins under the drops (no tree yet: no launch); no set-up
    pass."""
    sets = 1 + held_out
    out = {**train_expect(rounds * k, depth), "B4": 0, "B4w": rounds *
           (1 + sets) - 1, "K4": 0, "K4eval": 0, "SMX": 0, "SMXeval": 0}
    gh, ev = ("K4", "K4eval") if k == 1 else ("SMX", "SMXeval")
    out.update({gh: rounds * (1 + sets), ev: rounds * sets})
    return out


def linear_expect(rounds, k, held_out, n_features, world=1):
    """Launches of a gblinear ``train()`` with the training set (and a
    held-out set) among its evals: per round the round pass's gradients
    (K4, or the softmax pass with K outputs) and its eval mode over each
    set's new margins; B16 once a round at world 1, else once for the
    bias's sums and once a coordinate (F + 2); no tree kernel."""
    sets = 1 + held_out
    gh, ev = ("K4", "K4eval") if k == 1 else ("SMX", "SMXeval")
    out = dict.fromkeys(("K1", "K1deq", "K2level", "K2leaf", "K3", "K3leaf",
                         "B4", "B4w", "K4", "K4eval", "SMX", "SMXeval"), 0)
    out.update({gh: rounds * (1 + sets), ev: rounds * sets,
                "B16": rounds * (1 if world == 1 else n_features + 2)})
    return out


def _linear_same(train, key, params, make, rounds=2):
    """A gblinear model on the card twice and on the CPU path: weights and
    bias bitwise (the margins' elementwise sums, K4's gradients and B16
    are bitwise their plain versions; nothing needs a patch)."""
    runs = [train(params, make(), None, n_rounds=rounds, device=dev)
            for dev in ("cuda:0", "cuda:0", "cpu")]
    w = [(r["bst"].weights, r["bst"].bias) for r in runs]
    rerun = all(np.array_equal(a, b) for a, b in zip(w[0], w[1]))
    same = all(np.array_equal(a, b) for a, b in zip(w[0], w[2]))
    check(rerun, f"{key}: a rerun on the card differs")
    check(same, f"{key}: the card's weights differ from the CPU path's")
    return {"rounds": rounds, "rerun_bitwise": rerun, "weights_equal": same}


def _dart_same(train, key, params, make, rounds=2):
    """A dart model on the card twice and on the CPU path summing in the
    card's fixed point: dumps with stats and tree weights equal."""
    card = [train(params, make(), None, n_rounds=rounds) for _ in range(2)]
    with _cpu_fixed_point(True):
        cpu = train(params, make(), None, n_rounds=rounds, device="cpu")

    def model(r):
        return (r["bst"].get_dump(with_stats=True),
                r["bst"].tree_weights.tolist())

    rerun = model(card[0]) == model(card[1])
    same = model(card[0]) == model(cpu)
    check(rerun, f"{key}: a rerun on the card differs")
    check(same, f"{key}: the card's model differs from the fixed-point CPU "
                f"path's")
    return {"rounds": rounds, "rerun_bitwise": rerun, "dumps_equal": same}


def _dart_linear_holds(d_eng, g_eng, records, flush, launches):
    """B4w over the D1 engine's forest (every slot so far, its final
    weights) on the training rows, and B16 over the G1 engine's rows at its
    final weights and gradients: bitwise their plain versions (the plain
    versions on the card: the same torch operations as on the CPU), each
    timed with its bound; B16 also in the world mode's launches with an
    identity all-reduce."""
    import torch

    from xgboost_ray_tpu_torch.ops import grow as G
    from xgboost_ray_tpu_torch.ops import linear as L

    out = {}
    bins, base = d_eng.bins, d_eng.margins_static
    n, f = bins.shape
    t = d_eng.dart_t
    w = torch.from_numpy(d_eng.dart_weights).cuda()
    fo = d_eng.dart_forest

    def b4w():
        return G.predict_forest_weighted(fo, t, bins, base, w,
                                         d_eng.cfg.max_depth,
                                         d_eng.cfg.max_bin)

    got = b4w()
    want, plain_ms = timed_once(lambda: G.predict_forest_weighted_plain(
        fo, t, bins, base, w, d_eng.cfg.max_depth, d_eng.cfg.max_bin))
    check(torch.equal(bits(got), bits(want)),
          "B4w not bitwise its plain version")
    check(all(torch.equal(bits(b4w()), bits(got)) for _ in range(2)),
          "B4w reruns differ")
    heap = fo.feature.shape[1]
    k = base.shape[1]
    b4w_bytes = (n * f * bins.element_size() + 2 * n * k * 4 + t * 4
                 + t * heap * 13)
    _kernel_record(records, "B4w", b4w, plain_ms,
                   bound_ms(b4w_bytes, 2 * n * t), flush, launches["B4w"],
                   float((got - want).abs().max()), None, iters=5)
    records["B4w"]["bytes"] = b4w_bytes
    out["B4w"] = {"rows": n, "trees": t, "bitwise_plain": True}

    xt, gw, gb = g_eng.xt, g_eng.w, g_eng.b
    m = g_eng._margins(xt, g_eng.user_margin)
    z = torch.zeros((1, m.shape[0]), dtype=torch.float32, device="cuda")
    gh0 = g_eng._update(m, z, g_eng.label, g_eng.weight)[0].contiguous()
    p = g_eng.params
    lam, alp = p.reg_lambda * g_eng.sum_w, p.reg_alpha * g_eng.sum_w
    gh_k = gh0.clone()
    wk, bk = L.linear_round(xt, gh_k, gw, gb, p.learning_rate, lam, alp)
    gh_p = gh0.clone()
    (wp, bp), plain_ms = timed_once(lambda: L.linear_round_plain(
        xt, gh_p, gw, gb, p.learning_rate, lam, alp))
    gh_s = gh0.clone()
    ws, bs = L.linear_round(xt, gh_s, gw, gb, p.learning_rate, lam, alp,
                            lambda s: s)
    same = all(torch.equal(bits(a), bits(b)) for a, b in (
        (wk, wp), (bk, bp), (gh_k, gh_p), (ws, wp), (bs, bp), (gh_s, gh_p)))
    check(same, "B16 not bitwise its plain version")
    reruns = []
    for _ in range(2):
        g2 = gh0.clone()
        reruns.append(L.linear_round(xt, g2, gw, gb, p.learning_rate, lam,
                                     alp))
    check(all(torch.equal(bits(a[0]), bits(wk)) for a in reruns),
          "B16 reruns differ")
    nr, nf = xt.shape[1], xt.shape[0]
    kk = gh0.shape[0]
    gh_t = gh0.clone()
    # each input read once, each output written once; the cyclic pass
    # itself reads (g, h) and writes g a coordinate (``per_pass``)
    b16_bytes = 4 * nr * nf + 8 * nr * kk + 4 * nr * kk + 8 * nf * kk
    pass_bytes = 8 * nr * kk + (nf + 1) * 12 * nr * kk + 4 * nr * nf
    g_col = gh0[0, :, 0].contiguous()
    lib = cuda_ms(lambda: torch.mv(xt, g_col), iters=5)
    _kernel_record(records, "B16",
                   lambda: L.linear_round(xt, gh_t, gw, gb, p.learning_rate,
                                          lam, alp),
                   plain_ms, bound_ms(b16_bytes, 5 * nr * nf * kk), flush,
                   launches["B16"], float((wk - wp).abs().max()), lib,
                   iters=5)
    records["B16"]["bound_ms_per_pass"] = bound_ms(pass_bytes, 0)[0]
    records["B16"]["bytes"] = b16_bytes
    records["B16"]["bytes_per_pass"] = pass_bytes
    out["B16"] = {"rows": nr, "features": nf, "outputs": kk,
                  "bitwise_plain": same, "world_mode_bitwise": same}
    del gh_k, gh_p, gh_s, gh_t, gh0, m
    return out


def phase_dart_gblinear(x, y, records, rounds=10, depth=6,
                        compare_rows=50_000):
    """Phase 20 at full width: dart and gblinear through ``train()`` and
    ``predict()`` on the card. D1 dart ``binary:logistic`` at the HIGGS
    split (10,500,000 rows train, the last 500,000 the test set), depth 6,
    10 rounds, ``rate_drop`` 0.1; D2 D1 with weighted drops, forest
    normalisation, ``one_drop`` and ``skip_drop`` 0.5; D3 dart
    ``multi:softprob`` at Covertype's shape (K = 7); G1 gblinear
    ``reg:squarederror`` at the HIGGS split (``eta`` 0.5, ``lambda`` 0.01,
    ``alpha`` 0.001), G2 ``binary:logistic`` with the test set, G3
    ``multi:softprob`` at Covertype's 54 features, G4 G1 as 2 gloo ranks
    sharing the card. Each run's launches checked exactly
    (``dart_expect`` / ``linear_expect``), its loss falling; B4w and B16
    bitwise their plain versions, on reruns and timed
    (``_dart_linear_holds``); the models on ``compare_rows`` rows (2
    rounds) equal the port's CPU path (dart: summing in the card's fixed
    point) and reruns; G4 the CPU path's 2-rank world; a gblinear model's
    xgboost JSON predicts bitwise; ``predict()`` equals the booster's own
    call."""
    import torch

    import xgboost_ray_tpu_torch as xrt
    from xgboost_ray_tpu_torch import distributed as D
    from xgboost_ray_tpu_torch.linear import RayLinearBooster

    t_phase = time.perf_counter()
    n = x.shape[0]
    n_train = n - TEST_ROWS
    f = x.shape[1]
    res = {"phase": "dart_gblinear", "card": CARD, "rows": n,
           "train_rows": n_train, "test_rows": TEST_ROWS, "rounds": rounds,
           "runs": {}, "steps_s": {}}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    train = _phase_train(res, rounds, depth)
    world_gpu = D.World(2, "cuda", backend="gloo")
    world_cpu = D.World(2, "cpu")
    t0 = time.perf_counter()
    xc, yc = make_covertype_like(COVERTYPE_ROWS, seed=0)
    nc = COVERTYPE_ROWS - COVERTYPE_TEST
    sets = {"higgs": (x[:n_train], y[:n_train], x[n_train:], y[n_train:]),
            "covertype": (xc[:nc], yc[:nc], xc[nc:], yc[nc:])}
    res["steps_s"]["data"] = time.perf_counter() - t0
    cut = min(compare_rows, n_train)
    keep = {}
    try:
        totals = {"B4w": 0, "B16": 0}
        for key, params, data in DART_RUNS:
            xt_, yt_, xv, yv = sets[data]
            k = params.get("num_class", 1)
            t0 = time.perf_counter()
            r = train(params, xrt.RayDMatrix(xt_, yt_),
                      xrt.RayDMatrix(xv, yv))
            _exact(r["launches"], dart_expect(rounds, depth, k), key)
            metric = next(iter(r["ev"]["test"]))
            hist = _falls(r["ev"]["test"][metric], key)
            tw = r["bst"].tree_weights
            check(tw is not None and tw.shape == (rounds * k,)
                  and np.all(tw > 0) and np.all(tw <= 1),
                  f"{key}: tree weights {tw}")
            totals["B4w"] += r["launches"]["B4w"]
            res["runs"][key] = {
                "params": params, "launches": {
                    kk: r["launches"][kk] for kk in
                    dart_expect(rounds, depth, k)},
                "round_ms": r["round_ms"],
                "round_ms_median": float(np.median(r["round_ms"])),
                "test_" + metric: hist, "wall_s": time.perf_counter() - t0,
                "tree_weights": tw.tolist()}
            if key == "D1":
                keep["D1"] = r
        for key, params, data, held in LINEAR_RUNS:
            xt_, yt_, xv, yv = sets[data]
            k = params.get("num_class", 1)
            t0 = time.perf_counter()
            r = train({**LINEAR_PARAMS, **params}, xrt.RayDMatrix(xt_, yt_),
                      xrt.RayDMatrix(xv, yv) if held else None)
            check(isinstance(r["bst"], RayLinearBooster),
                  f"{key}: not a gblinear model")
            _exact(r["launches"], linear_expect(rounds, k, held,
                                                xt_.shape[1]), key)
            s = "test" if held else "train"
            metric = params["eval_metric"][0]
            hist = _falls(r["ev"][s][metric], key)
            totals["B16"] += r["launches"]["B16"]
            res["runs"][key] = {
                "params": {**LINEAR_PARAMS, **params},
                "launches": {kk: r["launches"][kk] for kk in linear_expect(
                    rounds, k, held, xt_.shape[1])},
                "round_ms": r["round_ms"],
                "round_ms_median": float(np.median(r["round_ms"])),
                f"{s}_{metric}": hist, "wall_s": time.perf_counter() - t0}
            if key in ("G1", "G2"):
                keep[key] = r
        # G4: G1 as 2 gloo ranks sharing the card
        t0 = time.perf_counter()
        g1 = {**LINEAR_PARAMS, **LINEAR_RUNS[0][1]}
        data = D.share({"x": x[:n_train], "label": y[:n_train]})
        out = world_gpu.run(D._train_rank, data, g1, rounds,
                            {"device": "cuda", "num_actors": 2})
        check(out[0]["model"] == out[1]["model"],
              "G4: the ranks' models differ")
        _exact(out[0]["launches"], linear_expect(rounds, 1, False, f,
                                                 world=2), "G4")
        g4 = RayLinearBooster.load_raw(out[0]["model"])
        g1w = keep["G1"]["bst"].weights
        res["runs"]["G4"] = {
            "params": g1, "ranks": 2,
            "launches": {kk: out[0]["launches"][kk] for kk in linear_expect(
                rounds, 1, False, f, world=2)},
            "round_ms": [s * 1e3 for s in
                         out[0]["additional_results"]["round_times_s"]],
            "max_abs_weight_diff_vs_G1": float(np.abs(g4.weights
                                                      - g1w).max()),
            "wall_s": time.perf_counter() - t0}
        res["runs"]["G4"]["round_ms_median"] = float(np.median(
            res["runs"]["G4"]["round_ms"]))
        del data
        for kk in DART_GBLINEAR_KERNELS:
            records[kk]["launches"] = totals[kk]
        emit({"phase": "dart_gblinear_rounds", "card": CARD,
              **{kk: v["round_ms_median"] for kk, v in res["runs"].items()}})
        # predict() against the booster's own call; a gblinear model's
        # xgboost JSON round trip
        t0 = time.perf_counter()
        xv = x[n_train:]
        for key in ("D1", "G2"):
            bst = keep[key]["bst"]
            own = bst.predict(xv)
            via = xrt.predict(bst, xrt.RayDMatrix(xv),
                              ray_params=xrt.RayParams(num_actors=2))
            check(np.array_equal(own, via),
                  f"{key}: predict() differs from the booster's own call")
            check(np.isfinite(own).all() and own.shape == (xv.shape[0],),
                  f"{key}: predictions")
        g2 = keep["G2"]["bst"]
        back = RayLinearBooster.import_xgboost_json(g2.export_xgboost_json())
        check(np.array_equal(back.predict(xv), g2.predict(xv)),
              "G2: the xgboost JSON round trip predicts otherwise")
        res["predict_checks"] = {"predict_equals_booster": True,
                                 "xgboost_json_round_trip_bitwise": True}
        res["steps_s"]["predict"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res.update(_dart_linear_holds(keep["D1"]["engine"],
                                      keep["G1"]["engine"], records, flush,
                                      totals))
        res["steps_s"]["holds"] = time.perf_counter() - t0
        keep.clear()
        torch.cuda.empty_cache()
        # the CPU paths on cuts (2 rounds), each card run twice
        t0 = time.perf_counter()
        cmp = {}
        ccut = min(compare_rows, nc)
        for key, params, data in DART_RUNS:
            xt_, yt_, _, _ = sets[data]
            rows = cut if data == "higgs" else ccut
            if key == "D2":
                continue  # D1's kernels and path; its drops are the host's
            cmp[key] = dict(_dart_same(
                train, key, params,
                lambda: xrt.RayDMatrix(xt_[:rows], yt_[:rows])), rows=rows)
        for key, params, data, _ in LINEAR_RUNS:
            xt_, yt_, _, _ = sets[data]
            rows = cut if data == "higgs" else ccut
            cmp[key] = dict(_linear_same(
                train, key, {**LINEAR_PARAMS, **params},
                lambda: xrt.RayDMatrix(xt_[:rows], yt_[:rows])), rows=rows)
        cut_data = D.share({"x": x[:cut], "label": y[:cut]})
        outs = [world.run(D._train_rank, cut_data, g1, 2, {"device": dev})
                for world, dev in ((world_gpu, "cuda"), (world_cpu, "cpu"))]
        same = outs[0][0]["model"] == outs[1][0]["model"]
        check(same, "G4: the card's 2-rank model differs from the CPU "
                    "path's 2-rank world")
        cmp["G4"] = {"rows": cut, "rounds": 2, "models_equal_cpu_world": same}
        res["cpu_paths"] = cmp
        res["steps_s"]["cpu_paths"] = time.perf_counter() - t0
    finally:
        world_gpu.close()
        world_cpu.close()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


def profiled_ms(fn, iters=10):
    """``device_ms`` where ``torch.profiler`` records the kernel, None where
    it records no device time (``PERF.md`` §7)."""
    try:
        return device_ms(fn, iters=iters, blind="raise")
    except SmokeFailure:
        return None


KERNELS = {
    "K1": dict(name="K1 histogram build + node totals, int64 fixed point "
               "(level 5: 32 nodes)",
               route="cuda", source="xgboost_ray_tpu_torch/csrc/histogram.cu",
               replaces="46abde5^:xgboost_ray_tpu/ops/hist_pallas.py:105"),
    "K1root": dict(name="K1 histogram build + node totals, int64 fixed point "
                   "(root: 1 node, "
                   "identity order)", route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/histogram.cu",
                   replaces="46abde5^:xgboost_ray_tpu/ops/hist_pallas.py:105"),
    "K1deq": dict(name="K1 dequantise: merged int64 sums -> the f32 "
                  "histogram K2 reads (level 5: 16 parents' smaller "
                  "children)", route="cuda",
                  source="xgboost_ray_tpu_torch/csrc/histogram.cu",
                  replaces="46abde5^:xgboost_ray_tpu/ops/hist_pallas.py:105"),
    "K2": dict(name="K2 node totals + split search alone (find_splits, "
               "level 5: 32 nodes)", route="cuda",
               source="xgboost_ray_tpu_torch/csrc/split.cu",
               replaces="xgboost_ray_tpu/ops/split.py:79"),
    "K2level": dict(name="K2 level step: sibling formation + totals + split "
                    "search + tree records (level 5: 16 parents, 32 nodes)",
                    route="cuda", source="xgboost_ray_tpu_torch/csrc/split.cu",
                    replaces="xgboost_ray_tpu/ops/grow.py:570"),
    "K2leaf": dict(name="K2 final-level records (64 nodes)", route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/split.cu",
                   replaces="xgboost_ray_tpu/ops/grow.py:765"),
    "K3": dict(name="K3 routing + stable partition + small-child compaction",
               route="cuda", source="xgboost_ray_tpu_torch/csrc/partition.cu",
               replaces="xgboost_ray_tpu/ops/histogram.py:558"),
    "K3leaf": dict(name="K3 leaf-value mode (final level: 64 nodes)",
                   route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/partition.cu",
                   replaces="xgboost_ray_tpu/ops/grow.py:782"),
    "K4": dict(name="K4 margin update + metric partials + gradients "
               "(11,000,000 rows)", route="cuda",
               source="xgboost_ray_tpu_torch/csrc/objective.cu",
               replaces="xgboost_ray_tpu/ops/objectives.py:88"),
    "B8margin": dict(name="B8 forest walk: margins, heap layout (every row "
                     "of predict(), 500 trees)", route="cuda",
                     source="xgboost_ray_tpu_torch/csrc/predict.cu",
                     replaces="xgboost_ray_tpu/ops/predict.py:52"),
    "B8margin_na": dict(name="B8 forest walk: margins, node-array layout "
                        "(every row, 500 trees; predict() walks the heap, "
                        "so no launch on the main path)", route="cuda",
                        source="xgboost_ray_tpu_torch/csrc/predict.cu",
                        replaces="xgboost_ray_tpu/ops/node_array.py:141"),
    "B8leaf": dict(name="B8 forest walk: leaf indices, heap layout (one "
                   "predict_leaf chunk, 500 trees)", route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/predict.cu",
                   replaces="xgboost_ray_tpu/ops/predict.py:512"),
    "B4": dict(name="B4 binned tree walk: one depth-6 tree over the 500,000 "
               "test rows (int16 bins, 28 features)", route="cuda",
               source="xgboost_ray_tpu_torch/csrc/walk.cu",
               replaces="xgboost_ray_tpu/ops/grow.py:786"),
    "K4eval": dict(name="K4 eval mode: margin update + metric partials, no "
                   "gradients (500,000 test rows)", route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/objective.cu",
                   replaces="xgboost_ray_tpu/engine.py:1427"),
    "SMX": dict(name="softmax pass, training mode: margins += a round's 7 "
                "row values, mlogloss / merror / weight partials, [K, N, 2] "
                "gradients (464,810 Covertype rows x 7 classes)",
                route="cuda",
                source="xgboost_ray_tpu_torch/csrc/softmax.cu",
                replaces="xgboost_ray_tpu/ops/objectives.py:107"),
    "SMXeval": dict(name="softmax pass, eval mode: margins += the round's "
                    "row values, partials, no gradients (116,202 test rows "
                    "x 7 classes)", route="cuda",
                    source="xgboost_ray_tpu_torch/csrc/softmax.cu",
                    replaces="xgboost_ray_tpu/ops/metrics.py:55"),
    "SMXtransform": dict(name="softmax pass, transform mode: probabilities "
                         "from B8's margins (every one of 581,012 rows x 7 "
                         "classes)", route="cuda",
                         source="xgboost_ray_tpu_torch/csrc/softmax.cu",
                         replaces="xgboost_ray_tpu/ops/objectives.py:115"),
    "B4k": dict(name="B4 binned tree walk: a round's 7 depth-6 trees in one "
                "launch over the 116,202 test rows (int16 bins, 54 features)",
                route="cuda", source="xgboost_ray_tpu_torch/csrc/walk.cu",
                replaces="xgboost_ray_tpu/ops/grow.py:786"),
    "K1f54": dict(name="K1 histogram build + node totals, int64 fixed point, "
                  "at 54 features (two tiles of 27; level 5: 32 nodes, "
                  "464,810 rows)", route="cuda",
                  source="xgboost_ray_tpu_torch/csrc/histogram.cu",
                  replaces="46abde5^:xgboost_ray_tpu/ops/hist_pallas.py:105"),
    "K2levelf54": dict(name="K2 level step at 54 features (level 5: 16 "
                       "parents, 32 nodes)", route="cuda",
                       source="xgboost_ray_tpu_torch/csrc/split.cu",
                       replaces="xgboost_ray_tpu/ops/grow.py:570"),
    "K4nograd": dict(name="K4 eval mode over the training rows: margin "
                     "update + metric partials, no gradients (a custom "
                     "objective's round pass, 11,000,000 rows)",
                     route="cuda",
                     source="xgboost_ray_tpu_torch/csrc/objective.cu",
                     replaces="xgboost_ray_tpu/engine.py:1427"),
    "SMXnograd": dict(name="softmax pass, eval mode over the training rows: "
                      "margins += the round's row values, partials, no "
                      "gradients (a custom objective's round pass, 464,810 "
                      "Covertype rows x 7 classes)", route="cuda",
                      source="xgboost_ray_tpu_torch/csrc/softmax.cu",
                      replaces="xgboost_ray_tpu/ops/metrics.py:55"),
    "B15exact": dict(name="B15 exact TreeSHAP: contributions [N, 1, 29] "
                     "(predict(pred_contribs=True) over 1,048,576 HIGGS "
                     "rows, 500 trees)", route="cuda",
                     source="xgboost_ray_tpu_torch/csrc/shap.cu",
                     replaces="xgboost_ray_tpu/ops/predict.py:299"),
    "B15saabas": dict(name="B15 Saabas contributions (approx_contribs over "
                      "1,048,576 HIGGS rows, 500 trees)", route="cuda",
                      source="xgboost_ray_tpu_torch/csrc/shap.cu",
                      replaces="xgboost_ray_tpu/ops/predict.py:82"),
    "B15interactions": dict(name="B15 SHAP interaction values [N, 1, 29, "
                            "29] (pred_interactions over 65,536 HIGGS rows, "
                            "500 trees)", route="cuda",
                            source="xgboost_ray_tpu_torch/csrc/shap.cu",
                            replaces="xgboost_ray_tpu/ops/predict.py:449"),
    "K4loglink": dict(name="K4 objective family, log-link class: "
                      "count:poisson margins + gradients + poisson-nloglik "
                      "partials (10,500,000 rows)", route="cuda",
                      source="xgboost_ray_tpu_torch/csrc/objective.cu",
                      replaces="xgboost_ray_tpu/ops/objectives.py:162"),
    "K4rest": dict(name="K4 objective family, the other one-output class: "
                   "reg:squaredlogerror margins + gradients + rmsle partials "
                   "(10,500,000 rows)", route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/objective.cu",
                   replaces="xgboost_ray_tpu/ops/objectives.py:242"),
    "K4quantile": dict(name="K4's K-output kernel: reg:quantileerror, 3 "
                       "alphas ([N, 3] margins, [3, N, 2] gradients, "
                       "pinball partials; 10,500,000 rows)", route="cuda",
                       source="xgboost_ray_tpu_torch/csrc/objective.cu",
                       replaces="xgboost_ray_tpu/ops/objectives.py:131"),
    "AFTnormal": dict(name="AFT pass (K4's AFT mode), normal: gradients "
                      "over the label bounds + aft-nloglik partials "
                      "(10,500,000 rows)", route="cuda",
                      source="xgboost_ray_tpu_torch/csrc/objective.cu",
                      replaces="xgboost_ray_tpu/ops/survival.py:49"),
    "AFTlogistic": dict(name="AFT pass (K4's AFT mode), logistic: gradients "
                        "over the label bounds + aft-nloglik partials "
                        "(10,500,000 rows)", route="cuda",
                        source="xgboost_ray_tpu_torch/csrc/objective.cu",
                        replaces="xgboost_ray_tpu/ops/survival.py:49"),
    "B9a": dict(name="B9a binned AUC histogram, [2, 4096] int64 fixed point "
                "(10,500,000 training rows; launches: both sets of the "
                "binary:logitraw run)", route="cuda",
                source="xgboost_ray_tpu_torch/csrc/auc.cu",
                replaces="xgboost_ray_tpu/ops/metrics.py:147"),
    "B9atest": dict(name="B9a binned AUC histogram (500,000 test rows; "
                    "launches: both sets of the binary:logitraw run)",
                    route="cuda", source="xgboost_ray_tpu_torch/csrc/auc.cu",
                    replaces="xgboost_ray_tpu/ops/metrics.py:147"),
    "B8exp": dict(name="B8 forest walk, value mode with the exp fused "
                  "(count:poisson, 10 trees, predict() over the 500,000 "
                  "test rows)", route="cuda",
                  source="xgboost_ray_tpu_torch/csrc/predict.cu",
                  replaces="xgboost_ray_tpu/models/booster.py:733"),
    "B13": dict(name="B13 pairwise lambda gradients, rank:ndcg (|delta "
                "NDCG| weights; MSLR shape: ~3.6M docs, 30,000 queries)",
                route="cuda", source="xgboost_ray_tpu_torch/csrc/ranking.cu",
                replaces="xgboost_ray_tpu/ops/ranking.py:81"),
    "B13pair": dict(name="B13 pairwise lambda gradients, rank:pairwise "
                    "(MSLR shape)", route="cuda",
                    source="xgboost_ray_tpu_torch/csrc/ranking.cu",
                    replaces="xgboost_ray_tpu/ops/ranking.py:46"),
    "B9r": dict(name="B9r per-group ndcg@10, summed in f64 (MSLR training "
                "groups; launches: both metrics, both sets of the rank:ndcg "
                "run)", route="cuda",
                source="xgboost_ray_tpu_torch/csrc/ranking.cu",
                replaces="xgboost_ray_tpu/ops/metrics.py:183"),
    "B9rmap": dict(name="B9r per-group map@10, summed in f64 (MSLR "
                   "training groups; launches: as B9r's)", route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/ranking.cu",
                   replaces="xgboost_ray_tpu/ops/metrics.py:183"),
    "B14": dict(name="B14 survival:cox Breslow pass: scans, gradients, "
                "cox-nloglik (10,500,000 HIGGS rows; launches: the training "
                "and the test set's of the run)", route="cuda",
                source="xgboost_ray_tpu_torch/csrc/cox.cu",
                replaces="xgboost_ray_tpu/ops/objectives.py:399"),
    "B12r": dict(name="B12r row sample, uniform: subsample 0.8 of the "
                 "10,500,000 HIGGS training rows (threefry keys, radix "
                 "select, compaction; launches: S1's)", route="cuda",
                 source="xgboost_ray_tpu_torch/csrc/sampling.cu",
                 replaces="xgboost_ray_tpu/ops/sampling.py:105"),
    "B12rgoss": dict(name="B12r row sample, GOSS 0.2 / 0.1: its two stages "
                     "over the 10,500,000 HIGGS training rows (launches: "
                     "S2's)", route="cuda",
                     source="xgboost_ray_tpu_torch/csrc/sampling.cu",
                     replaces="xgboost_ray_tpu/ops/sampling.py:105"),
    "B12f": dict(name="B12f feature masks: a level's bynode draw, 64 nodes "
                 "x 28 features, Gumbel-top-k over feature weights "
                 "(launches: S1's bytree and bynode draws)", route="cuda",
                 source="xgboost_ray_tpu_torch/csrc/sampling.cu",
                 replaces="xgboost_ray_tpu/ops/grow.py:132"),
    "K2masked": dict(name="K2 level step, masked instantiation: level 5 "
                     "(16 parents, 32 nodes) under a [32, 28] node mask "
                     "(launches: S1's)", route="cuda",
                     source="xgboost_ray_tpu_torch/csrc/split.cu",
                     replaces="xgboost_ray_tpu/ops/split.py:148"),
    "K4trees": dict(name="K4 T-tree add: 100 parallel trees' values over "
                    "the 10,500,000 HIGGS training rows, gh mode "
                    "(launches: S4's random forest)", route="cuda",
                    source="xgboost_ray_tpu_torch/csrc/objective.cu",
                    replaces="xgboost_ray_tpu/engine.py:1413"),
    "K2cons": dict(name="K2 level step, constrained instantiation: "
                   "monotone signs on 7 of 28 features and 4 interaction "
                   "groups, level 5 (16 parents, 32 nodes; launches: M1)",
                   route="cuda", source="xgboost_ray_tpu_torch/csrc/split.cu",
                   replaces="xgboost_ray_tpu/ops/split.py:116"),
    "K2consmasked": dict(name="K2 level step, constrained and masked "
                         "instantiation: the same under a [32, 28] node mask "
                         "(launches: M3)", route="cuda",
                         source="xgboost_ray_tpu_torch/csrc/split.cu",
                         replaces="xgboost_ray_tpu/ops/grow.py:634"),
    "SMXtrees": dict(name="softmax pass, training mode, T-tree add: 464,810 "
                     "x 7 classes x 4 parallel trees (launches: P1)",
                     route="cuda",
                     source="xgboost_ray_tpu_torch/csrc/softmax.cu",
                     replaces="xgboost_ray_tpu/engine.py:1413"),
    "K4multitrees": dict(name="K4 K-output kernel, T-tree add: 10,500,000 "
                         "rows x 3 quantiles x 2 parallel trees, gh mode "
                         "(launches: P2)", route="cuda",
                         source="xgboost_ray_tpu_torch/csrc/objective.cu",
                         replaces="xgboost_ray_tpu/engine.py:1413"),
    "K2cat": dict(name="K2 level step, categorical instantiation: 6 of 9 "
                  "airline features one-vs-rest, level 5 (16 parents, 32 "
                  "nodes; launches: C1)", route="cuda",
                  source="xgboost_ray_tpu_torch/csrc/split.cu",
                  replaces="xgboost_ray_tpu/ops/split.py:108"),
    "K2catmasked": dict(name="K2 level step, categorical and masked "
                        "instantiation: the same under a [32, 9] node mask "
                        "(launches: C3)", route="cuda",
                        source="xgboost_ray_tpu_torch/csrc/split.cu",
                        replaces="xgboost_ray_tpu/ops/split.py:108"),
    "K3cat": dict(name="K3 routing + stable partition, categorical route: "
                  "level 5 of the 10,500,000 airline training rows "
                  "(launches: C1)", route="cuda",
                  source="xgboost_ray_tpu_torch/csrc/partition.cu",
                  replaces="xgboost_ray_tpu/ops/grow.py:65"),
    "B4cat": dict(name="B4 binned walk, categorical records: a depth-6 tree "
                  "over the 500,000 airline test rows (launches: C1)",
                  route="cuda", source="xgboost_ray_tpu_torch/csrc/walk.cu",
                  replaces="xgboost_ray_tpu/ops/grow.py:786"),
    "LGstep": dict(name="lossguide frontier step: 509 entries, F = 28 "
                   "(launches: L1)", route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/lossguide.cu",
                   replaces="xgboost_ray_tpu/ops/grow_lossguide.py:200"),
    "B10": dict(name="B10 quantized gradients at the source: stochastic "
                "rounding of the 10,500,000 HIGGS training rows' (g, h) to "
                "int8 (launches: Q1-Q5, Q4's rank 0)", route="cuda",
                source="xgboost_ray_tpu_torch/csrc/quant.cu",
                replaces="xgboost_ray_tpu/ops/objectives.py:316"),
    "K1int": dict(name="K1 integer instantiation: int8 gh, exact int32 sums "
                  "(level 5: 32 nodes over 10,500,000 rows; launches: "
                  "Q1-Q5, Q4's rank 0)", route="cuda",
                  source="xgboost_ray_tpu_torch/csrc/histogram.cu",
                  replaces="46abde5^:xgboost_ray_tpu/ops/hist_pallas.py:105"),
    "K1form": dict(name="K1 form and dequantise: the sibling formed in the "
                   "integer domain and the level dequantised once, node "
                   "totals (level 5: 16 parents; launches: Q1-Q5, Q4's "
                   "rank 0)", route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/histogram.cu",
                   replaces="xgboost_ray_tpu/ops/grow.py:577"),
    "B11q": dict(name="B11 wire quantise: block absmax, scale, round-half-"
                 "even to int8, scales in-band (a level-5 HIGGS histogram, "
                 "230,272 values, block 512; launches: Q1-Q5, Q4's rank "
                 "0)",
                 route="cuda", source="xgboost_ray_tpu_torch/csrc/quant.cu",
                 replaces="xgboost_ray_tpu/ops/histogram.py:188"),
    "B11acc": dict(name="B11 wire dequantise-accumulate: a ring hop's "
                   "fma(q, scale, x) (the same histogram; launches: Q4's "
                   "rank 0: one rank has no hop)", route="cuda",
                   source="xgboost_ray_tpu_torch/csrc/quant.cu",
                   replaces="xgboost_ray_tpu/ops/histogram.py:367"),
    "B11deq": dict(name="B11 wire dequantise: a gathered int8 payload to "
                   "f32 (the same histogram; launches: Q1-Q5, Q4's rank "
                   "0)",
                   route="cuda", source="xgboost_ray_tpu_torch/csrc/quant.cu",
                   replaces="xgboost_ray_tpu/ops/histogram.py:269"),
    "B4w": dict(name="B4w weighted-forest walk (dart): the 10.5M HIGGS "
                "training rows' margins over D1's 10 depth-6 trees under "
                "their weights (int16 bins, 28 features; launches: D1-D3)",
                route="cuda", source="xgboost_ray_tpu_torch/csrc/walk.cu",
                replaces="xgboost_ray_tpu/engine.py:2880"),
    "B16": dict(name="B16 gblinear coordinate-descent round: the bias and "
                "28 features over the 10.5M HIGGS training rows, K = 1 "
                "(launches: G1-G3)", route="cuda",
                source="xgboost_ray_tpu_torch/csrc/linear.cu",
                replaces="xgboost_ray_tpu/linear.py:460"),
    **{f"B8serve{m}": dict(
        name=f"B8 forest walk: margins, heap layout, a serve batch of {m} "
             f"rows (windows mapping; launches: every batch of the heap "
             f"server, all buckets together)",
        route="cuda", source="xgboost_ray_tpu_torch/csrc/predict.cu",
        replaces="xgboost_ray_tpu/ops/predict.py:52") for m in SERVE_ROWS},
}

#: the kernel table's rows of phase 9
MULTICLASS_KERNELS = ("SMX", "SMXeval", "SMXtransform", "B4k", "K1f54",
                      "K2levelf54")

#: the kernel table's rows of phase 10
FACADE_KERNELS = ("K4nograd", "SMXnograd")

#: the kernel table's rows of phase 11
SHAP_KERNELS = ("B15exact", "B15saabas", "B15interactions")

#: kernels of the training path (phase 3's counters)
TRAIN_KERNELS = ("K1", "K1root", "K1deq", "K2", "K2level", "K2leaf", "K3",
                 "K3leaf", "K4")


def run(args):
    global CARD
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    try:
        import xgboost_ray_tpu_torch  # noqa: F401
        from xgboost_ray_tpu_torch.ops import _build
        from xgboost_ray_tpu_torch.ops import objectives as O
    except ImportError as exc:
        raise SmokeFailure(f"cannot import xgboost_ray_tpu_torch: {exc}")
    bad = [m for m in sys.modules
           if m == "jax" or m.startswith("jax.") or m == "xgboost_ray_tpu"
           or m.startswith("xgboost_ray_tpu.")]
    check(not bad, f"JAX modules imported: {bad[:5]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CARD = gpu_name_and_power()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": card})

    # phase 1: build
    t0 = time.perf_counter()
    _build.build_all()
    cuda_build_s = time.perf_counter() - t0
    for stem in _build.SIGNATURES:
        _build.library(stem)
    # K4's first launch in each mode (in a tree from before the CUDA K4,
    # Triton's compile of each variant and its launch)
    t1 = time.perf_counter()
    z = torch.zeros(4, device="cuda")
    O.round_update(z, z.clone(), z.clone(), torch.ones(4, device="cuda"), True)
    torch.cuda.synchronize()
    build = {"phase": "build", "nvcc_seconds": cuda_build_s,
             "k4_first_launch_seconds": time.perf_counter() - t1,
             "k4_route": "cuda" if hasattr(O, "k4_plan") else "triton"}
    if hasattr(O.round_update, "eval_launches"):  # not in an older tree
        t1 = time.perf_counter()
        O.round_update(z, z.clone(), z.clone(), torch.ones(4, device="cuda"),
                       True, with_gh=False)
        torch.cuda.synchronize()
        build["k4_eval_mode_first_launch_seconds"] = (
            time.perf_counter() - t1)
    if hasattr(O, "softmax_update"):  # not in an older tree
        # the CUDA pass's first training and transform launches (in a
        # tree from before it, the Triton pass's compile and launch)
        t1 = time.perf_counter()
        m7 = torch.zeros(4, 7, device="cuda")
        O.softmax_update(m7, torch.zeros(7, 4, device="cuda"), z.clone(),
                         torch.ones(4, device="cuda"))
        O.softmax_transform(m7, True)
        torch.cuda.synchronize()
        build["softmax_first_launches_seconds"] = time.perf_counter() - t1
        build["softmax_route"] = ("cuda" if hasattr(O, "softmax_plan")
                                  else "triton")
    emit(build)
    if args.k1_time:
        phase_k1_time(args.rows, args.rounds)
        return
    if args.multiclass_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        phase_multiclass(records)
        emit({"multiclass_kernels": {k: records[k] for k in MULTICLASS_KERNELS}})
        return
    if args.kernels_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        phase_kernels(args.rows, {k: records[k] for k in TRAIN_KERNELS})
        emit({"phase2_kernels": {k: records[k] for k in TRAIN_KERNELS}})
        return
    if args.evals_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        x, y = make_higgs_like(args.rows, 28, seed=0)
        phase_evals(x, y, records)
        emit({"evals_kernels": {k: records[k] for k in ("B4", "K4eval")}})
        return
    if args.k4_variants:
        phase_k4_variants()
        return
    if args.b15_variants:
        x, y = make_higgs_like(args.rows, 28, seed=0)
        served, _, _ = phase_train_model(x, y, args.predict_rounds)
        phase_b15_variants(served, x)
        return
    if args.objectives_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        x, y = make_higgs_like(args.rows, 28, seed=0)
        phase_objectives(x, y, records, compare_rows=min(args.compare_rows,
                                                         args.rows))
        emit({"objectives_kernels": {k: records[k]
                                     for k in OBJECTIVE_KERNELS}})
        return
    if args.ranking_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        x, y = make_higgs_like(args.rows, 28, seed=0)
        phase_ranking(x, y, records)
        emit({"ranking_kernels": {k: records[k] for k in RANKING_KERNELS}})
        return
    if args.constraints_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        x, y = make_higgs_like(args.rows, 28, seed=0)
        phase_constraints(x, y, records,
                          compare_rows=min(args.compare_rows, args.rows))
        emit({"constraints_kernels": {k: records[k]
                                      for k in CONSTRAINT_KERNELS}})
        return
    if args.categorical_only or args.lossguide_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        emit({"phase": "ptxas", **k2_ptxas()})
        if args.categorical_only:
            phase_categorical(records, n_rows=args.rows,
                              compare_rows=min(args.compare_rows, args.rows))
            keys = CATEGORICAL_KERNELS
        else:
            x, y = make_higgs_like(args.rows, 28, seed=0)
            phase_lossguide(x, y, records,
                            compare_rows=min(50_000, args.rows))
            keys = LOSSGUIDE_KERNELS
        emit({"phase_kernels": {k: records[k] for k in keys}})
        return
    if args.quantized_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        emit({"phase": "ptxas", **k2_ptxas(), **quant_ptxas()})
        x, y = make_higgs_like(args.rows, 28, seed=0)
        phase_quantized(x, y, records,
                        compare_rows=min(args.compare_rows, args.rows))
        emit({"quantized_kernels": {k: records[k] for k in QUANT_KERNELS}})
        return
    if args.sampling_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        x, y = make_higgs_like(args.rows, 28, seed=0)
        phase_sampling(x, y, records, compare_rows=min(args.compare_rows,
                                                        args.rows))
        emit({"sampling_kernels": {k: records[k] for k in SAMPLING_KERNELS}})
        return
    if args.facade_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        x, y = make_higgs_like(args.rows, 28, seed=0)
        phase_facade(x, y, records)
        emit({"facade_kernels": {k: records[k] for k in FACADE_KERNELS}})
        return
    if args.ranks_only:
        x, y = make_higgs_like(args.rows, 28, seed=0)
        bst, _, _, margins = phase_main(x, y, args.rounds, 6, 1)
        phase_ranks(x, y, args.rounds, 6, bst, margins)
        if hasattr(_build, "SIGNATURES") and "quant" in _build.SIGNATURES:
            phase_quant_nccl(x, y, args.rounds)
        return
    if args.shap_only or args.pool_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        x, y = make_higgs_like(args.rows, 28, seed=0)
        served, _, _ = phase_train_model(x, y, args.predict_rounds)
        if args.shap_only:
            phase_shap(served, x, records)
            emit({"shap_kernels": {k: records[k] for k in SHAP_KERNELS}})
        else:
            phase_serve_pool(served, x, y)
        return
    if args.dart_gblinear_only:
        records = {k: dict(v) for k, v in KERNELS.items()}
        x, y = make_higgs_like(args.rows, 28, seed=0)
        phase_dart_gblinear(x, y, records,
                            compare_rows=min(args.compare_rows, args.rows))
        emit({"dart_gblinear_kernels": {k: records[k]
                                        for k in DART_GBLINEAR_KERNELS}})
        return
    PHASE_SECONDS["build"] = time.perf_counter() - t0
    build_report = timed("build_report", phase_build_report,
                         args.predict_rounds, args.rows)

    x, y = make_higgs_like(args.rows, 28, seed=0)
    if args.profile_only:
        phase_profile(x, y, 6, None)
        return
    # phase 6's model, then phase 7 (B8 against its plain version and its
    # times) before the other phases: later in the process torch.profiler
    # records no device activity for B8's full-size launches (PERF.md §7)
    records = {k: dict(v) for k, v in KERNELS.items()}
    served, train_margin, last_ll = timed(
        "train_model", phase_train_model, x, y, args.predict_rounds)
    b8 = timed("b8", phase_b8, served, x, records)
    torch.cuda.empty_cache()
    if args.b8_only:
        return

    cmp_rows = min(args.compare_rows, args.rows)
    timed("kernels", phase_kernels, args.rows,
          {k: records[k] for k in TRAIN_KERNELS})
    results = {"evals": timed("evals", phase_evals, x, y, records),
               "multiclass": timed("multiclass", phase_multiclass, records)}
    torch.cuda.empty_cache()
    results["facade"] = timed("facade", phase_facade, x, y, records)
    torch.cuda.empty_cache()
    results["objectives"] = timed("objectives", phase_objectives, x, y,
                                  records, compare_rows=cmp_rows)
    torch.cuda.empty_cache()
    results["ranking"] = timed("ranking", phase_ranking, x, y, records)
    torch.cuda.empty_cache()
    results["sampling"] = timed("sampling", phase_sampling, x, y, records,
                                compare_rows=cmp_rows)
    torch.cuda.empty_cache()
    results["constraints"] = timed("constraints", phase_constraints, x, y,
                                   records, compare_rows=cmp_rows)
    torch.cuda.empty_cache()
    results["categorical"], airline = timed(
        "categorical", phase_categorical, records, n_rows=args.rows,
        compare_rows=cmp_rows)
    torch.cuda.empty_cache()
    results["lossguide"] = timed(
        "lossguide", phase_lossguide, x, y, records, airline=airline,
        compare_rows=min(50_000, args.rows))
    del airline
    torch.cuda.empty_cache()
    results["quantized"] = timed("quantized", phase_quantized, x, y, records,
                                 compare_rows=cmp_rows)
    torch.cuda.empty_cache()
    results["dart_gblinear"] = timed("dart_gblinear", phase_dart_gblinear,
                                     x, y, records, compare_rows=cmp_rows)
    torch.cuda.empty_cache()

    if args.rows < 11_000_000:
        emit({"phase": "main_path_cut", "rows": args.rows,
              "reason": "--rows below the 11,000,000-row HIGGS protocol"})
    runs = []
    t_main = time.perf_counter()
    for i, (key, actors) in enumerate((("1", 1), ("1_rerun", 1), ("2", 2))):
        b, launches, rt, margins = phase_main(x, y, args.rounds, 6, actors)
        results[key] = {"launches": launches, "round_ms": rt}
        runs.append((b, margins))
        if i == 0:
            for k in TRAIN_KERNELS:
                # the root row is K1 at another shape: the same launches
                records[k]["launches"] = launches[k.replace("root", "")]
    PHASE_SECONDS["main"] = time.perf_counter() - t_main
    bst = runs[0][0]
    gbtree_ms = float(np.median(results["1"]["round_ms"]))
    emit({"phase": "dart_gblinear_vs_gbtree", "gbtree_round_ms_median":
          gbtree_ms, **{k: v["round_ms_median"] for k, v in
                        results["dart_gblinear"]["runs"].items()}})
    results["determinism"] = timed("determinism", phase_determinism, runs)
    results["ranks"] = timed("ranks", phase_ranks, x, y, args.rounds, 6, bst,
                             runs[0][1])
    del runs
    results["profile"] = timed("profile", phase_profile, x, y, 6, gbtree_ms)
    cmp = timed("cpu_vs_card", phase_cpu_vs_card, x[:cmp_rows],
                y[:cmp_rows])
    timed("save_load", phase_save_load, bst)

    # phase 6: predict and serve, each path with B8's counters set to 0
    # just before it and read just after
    results["b8"] = b8
    results["predict"] = timed("predict", phase_predict, served, x, y,
                               train_margin, last_ll)
    results["predict_leaf"] = timed("predict_leaf", phase_predict_leaf,
                                    served, x)
    results["serve"] = timed("serve", phase_serve, served, x)
    results["serve_node_array"] = timed(
        "serve_node_array", phase_serve, served, x, layout="node_array",
        warm_s=0.5, duration_s=2.0)
    by_path = {p: results[p]["b8_launches"] for p in (
        "predict", "predict_leaf", "serve", "serve_node_array")}
    b8_launches = {k: sum(v[k] for v in by_path.values())
                   for k in by_path["predict"]}
    emit({"phase": "b8_launches", "by_path": by_path,
          "launches": b8_launches})
    for k, v in b8_launches.items():
        # the node array's rows mapping is off these paths (predict()
        # walks the heap); it is held and timed in phase 7; the softmax
        # transform runs on phase 9's paths (a K-output model), not these
        check(v > 0 or k in ("B8other", "B8margin_na", "SMXtransform"),
              f"{k} never launched on the predict/serve path")
    for k in ("B8margin", "B8margin_na", "B8leaf"):
        records[k]["launches"] = b8_launches[k]
    for m in SERVE_ROWS:  # the windows kernel of the heap server's batches
        records[f"B8serve{m}"]["launches"] = b8_launches["B8serve"]
    results["late_profile"] = timed("late_profile", phase_late_profile,
                                    served, x)
    # phase 11: SHAP (B15), each path with B15's counters set to 0 just
    # before it and read just after; phase 12: the replica pool,
    # autoscaler, canary and xgboost JSON
    results["shap"] = timed("shap", phase_shap, served, x, records)
    results["serve_pool"] = timed("serve_pool", phase_serve_pool, served, x,
                                  y)
    pr = results["predict"]
    emit({"phase": "predict_summary", "rows": pr["rows"], "trees": pr["trees"],
          "predict_value_wall_s": pr["predict_value_wall_s"],
          "matrix_load_s": pr["matrix_load_s"],
          "predict_margin_wall_after_load_s":
              pr["predict_margin_wall_after_load_s"],
          "h2d_copy_s": pr["h2d_copy_s"],
          "b8_device_ms_all_rows": results["b8"]["B8margin"]["device_ms"],
          "b8_device_ms_per_serve_batch_32_rows":
              results["serve"]["b8_device_ms_per_batch_32_rows"]})

    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    kernels = [{k: records[key][k] for k in order} for key in sorted(records)]
    emit({"phase_seconds": PHASE_SECONDS,
          "script_s": time.perf_counter() - T_START})
    emit({"kernels": kernels})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_report": build_report,
                   "kernels": kernels, "main_path": results,
                   "cpu_vs_card": cmp, "rows": args.rows,
                   "rounds": args.rounds}, f, indent=1)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=11_000_000)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--compare-rows", type=int, default=50_000,
                    help="rows of the cuts the card's models are held "
                         "against the CPU path on")
    ap.add_argument("--predict-rounds", type=int, default=500,
                    help="rounds of phase 6's served model")
    ap.add_argument("--b8-only", action="store_true",
                    help="only the served model and B8's timings (works on "
                         "another tree of the package too); prints no "
                         "result line")
    ap.add_argument("--profile-only", action="store_true",
                    help="only the main path's profile (device time and CUDA "
                         "launches per round; works on an older tree of the "
                         "package too); prints no result line")
    ap.add_argument("--k1-time", action="store_true",
                    help="only K1's times and the main path's median round "
                         "(works on an older tree of the package too); "
                         "prints no result line")
    ap.add_argument("--multiclass-only", action="store_true",
                    help="only the build and phase 9 (multiclass at "
                         "Covertype's width); prints no result line")
    ap.add_argument("--evals-only", action="store_true",
                    help="only the build and phase 8 (held-out eval sets at "
                         "the HIGGS split; works on an older tree of the "
                         "package too); prints no result line")
    ap.add_argument("--kernels-only", action="store_true",
                    help="only the build and phase 2 (every training kernel "
                         "against its plain version, timed; works on an "
                         "older tree of the package too); prints no result "
                         "line")
    ap.add_argument("--k4-variants", action="store_true",
                    help="only the build and K4 as built against edits of "
                         "its source (no last-CTA sum, streaming loads, "
                         "streaming stores), timed in turns; prints no "
                         "result line")
    ap.add_argument("--b15-variants", action="store_true",
                    help="only the build, phase 6's model and B15 as built "
                         "against edits of its source and a larger shared-"
                         "memory budget, timed in turns, then its mappings "
                         "across batch sizes; prints no result line")
    ap.add_argument("--ranks-only", action="store_true",
                    help="only the 1-rank main path and the ranks phase (on "
                         "a host of two or more cards: the NCCL path); "
                         "prints no result line")
    ap.add_argument("--shap-only", action="store_true",
                    help="only the build, phase 6's model and phase 11 (SHAP "
                         "with B15); prints no result line")
    ap.add_argument("--pool-only", action="store_true",
                    help="only the build, phase 6's model and phase 12 (the "
                         "replica pool, autoscaler, canary and xgboost "
                         "JSON); prints no result line")
    ap.add_argument("--objectives-only", action="store_true",
                    help="only the build and phase 13 (every row-elementwise "
                         "objective, the AFT pass and the AUC metrics at the "
                         "HIGGS shape); prints no result line")
    ap.add_argument("--ranking-only", action="store_true",
                    help="only the build and phase 14 (learning to rank at "
                         "MSLR-WEB30K's shape and survival:cox at the HIGGS "
                         "shape); prints no result line")
    ap.add_argument("--sampling-only", action="store_true",
                    help="only the build and phase 15 (row and column "
                         "sampling, feature weights, random forests at the "
                         "HIGGS shape); prints no result line")
    ap.add_argument("--constraints-only", action="store_true",
                    help="only the build and phase 16 (monotone and "
                         "interaction constraints at the HIGGS shape, "
                         "parallel trees of K outputs); prints no result "
                         "line")
    ap.add_argument("--categorical-only", action="store_true",
                    help="only the build and phase 17 (categorical "
                         "one-vs-rest splits at the airline set's shape); "
                         "prints no result line")
    ap.add_argument("--lossguide-only", action="store_true",
                    help="only the build and phase 18 (lossguide growth at "
                         "the HIGGS split and the airline set's shape); "
                         "prints no result line")
    ap.add_argument("--quantized-only", action="store_true",
                    help="only the build and phase 19 (quantized gradients "
                         "and the quantized histogram wire at the HIGGS "
                         "split); prints no result line")
    ap.add_argument("--dart-gblinear-only", action="store_true",
                    help="only the build and phase 20 (dart and gblinear at "
                         "the HIGGS split and Covertype's shape: B4w and "
                         "B16); prints no result line")
    ap.add_argument("--facade-only", action="store_true",
                    help="only the build and phase 10 (the sklearn "
                         "estimators, custom objectives and metrics, files, "
                         "callbacks); prints no result line")
    args = ap.parse_args()
    try:
        run(args)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
