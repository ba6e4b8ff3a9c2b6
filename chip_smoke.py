#!/usr/bin/env python3
"""Drive the PyTorch port of the isolation forest on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit::

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile ``isoforest_tpu_torch/csrc/*.cu`` with ``nvcc``, one
   process per source, all started together;
3. parity: load the JAX-written mammography model
   (``tests/resources/torch_port/mammography_std``) on the card, score the
   11,183 rows with the walk and the dense kernel, and hold the scores to the
   JAX package's (max |delta| <= 2e-6, AUROC in [0.84, 0.90], equal labels
   away from the threshold);
4. full_size: 1,000,000 seeded rows through the loaded 100-tree model with
   each strategy, through ``model.score`` (host rows, streamed in chunks:
   the launch counts are the call's chunks), with every launch counter set to
   0 just before and read just after; then each kernel against its plain
   PyTorch version on the same inputs, exactly (max |delta| 0), the walk
   also with its small-batch launch (a warp a row, four 32-tree rounds, the
   last ragged) on the first 4,096 rows, and CUDA-event timings;
5. edges: seeded synthetic forests (F in {1, 5, 6, 12, 13, 17, 274, 1025},
   T = 13 with a root-leaf tree, or 100, every height from 0 to the dense
   kernel's fence 10 (10 also at F = 6) and above it to 12 for the walk, N
   in {1, 31, 33, 1023, 1025, 4096}, on both sides of the walk's
   small-batch switch and at 300,001, where the walk's bulk launch stages
   a forest's records in shared memory if they fit, rows with NaN and
   +-inf): each kernel against its plain version exactly (max |delta| 0),
   the walk with both its bulk and its small-batch launch;
6. serving: ``model.score`` latency on batches of 1, 64 and 4,096 rows,
   with ``strategy="auto"`` (and what the autotuner resolved it to) and
   ``"dense"``.

Then the same for the extended (EIF) forest:

7. ext_parity: load the JAX-written mammography EIF
   (``tests/resources/torch_port/mammography_eif``, k = 6) on the card,
   score the 11,183 rows with the walk and the dense strategy, and hold each
   to its JAX counterpart's committed scores (``jax_walk_scores.npy``,
   ``jax_pallas_scores.npy``; max |delta| <= 2e-6), both to the JAX gather
   scores within the JAX package's own gap plus 2e-6, AUROC within 1e-3 of
   the gather scores', equal labels away from the threshold;
8. ext_breakdown: torch.profiler around one warm 1M-row EIF ``model.score``
   per strategy;
9. ext_full_size: the EIF main path, with every launch counter set to 0
   just before and read just after: 1,000,000 seeded rows through
   ``model.score`` with each strategy (the walk kernel and the sparse
   dense-walk kernel), and 1,000,000 host rows (1.1 GB, streamed) through
   ``score_matrix(..., strategy="dense")`` of a seeded, fully extended
   forest at the high-dim width (F = k = 274, 100 trees, height 8: the
   dense-table kernel), whose first 65,536 must equal one launch over them;
   then each kernel against its plain version on all of its rows (the
   dense-table kernel on those 65,536), the two path
   kernels (the walk and the sparse one) also with their small-batch
   launch (a warp a row, four 32-tree rounds, the last ragged) on the
   first 4,096 rows, CUDA-event timings and bounds, and beside the
   dense-table kernel the time of ``torch.matmul`` of its rows by all its
   weights as one [274 x 25,500] float32 product (``matmul_ms``: the dots
   alone, not the kernel's function; the port never calls it); every
   kernel is held to its plain version exactly (max |delta| 0);
10. ext_edges: seeded synthetic EIF forests (k in {1, 6, 8, 13, 16, 17, 32,
    33, 40, 274, 1000}, F in {1, 6, 13, 16, 17, 33, 40, 274, 1000}, T in
    {13, 77, 100}, root-leaf trees, heights 0 to the dense fence and one
    above, N in {1, 31, 33, 64, 129, 1000, 1023, 1025, 4096}, NaN and
    +-inf rows, a tile of finite rows with a few non-finite ones,
    tie-heavy quantized rows, a forest with duplicate coordinates): each
    kernel against its plain
    version exactly, the two path kernels (the walk and the sparse one)
    with both their bulk and small-batch launches;
11. ext_serving: EIF ``model.score`` latency on batches of 1, 64 and 4,096
    rows, ``"auto"`` (and its resolution) and ``"dense"``.

Then fit of the standard forest, on the card:

12. fit_parity: ``IsolationForest(contamination=0.02, random_seed=1).fit``
    of the 11,183 mammography rows, the parameters the committed fixture
    was fit with by the JAX package, held to the fixture node for node
    (split features, leaf counts, thresholds bitwise); the root of any
    differing subtree must be a Gumbel near-tie (the port's two draws
    within 4 float32 ulps of ``max(|g|, 1)``), printed with its draws; the threshold within 2e-6 of
    the fixture's at rank error 0 on the port's own scores, AUROC in [0.84,
    0.90], and a save, reload and rescore that gives equal scores;
13. fit_shuttle: a fit of the 49,097 shuttle rows (AUROC > 0.99), its
    record count and whether ``walk_sum``'s bulk launch would stage those
    records in shared memory, and the walk's time on 1M resampled rows;
14. fit_full_size: 100 trees on the 1M rows (the Floyd sampler) with the
    ``walk_sum`` counter set to 0 just before and read just after (the
    threshold pass must launch it), the threshold at rank error 0, times
    of the fit and of its parts (bag, growth, threshold pass), and
    torch.profiler around one warm fit from rows on the card; then a fit
    at F = 274 (five 64-feature chunks, a constant block in the second),
    held to growth's invariants;
15. fit_edges: small seeded fits (bootstrap, maxFeatures 0.5, a constant
    column, all-constant rows, contamination 0, N = 300 with S = 256 for
    the permutation sampler, subsample_trees 0.5), each held to growth's
    invariants.

Then fit of the extended forest, on the card:

16. eif_fit_parity: ``ExtendedIsolationForest(contamination=0.02,
    random_seed=1).fit`` of the mammography rows, held to the committed EIF
    fixture (``mammography_eif``) node for node: the count of nodes whose
    hyperplane indices or leaf counts differ, each differing subtree
    explained by the margin that flipped it (a Gumbel top-k near-tie within
    4 ulps, or a parent whose rows come within 4 ulps of its offset), and
    weights and offsets within 2 ulps elsewhere; the threshold within 2e-6
    of the fixture's at rank error 0, the walk and dense scores within 2e-6
    of ``jax_walk_scores.npy`` / ``jax_pallas_scores.npy`` where the forest
    is equal, AUROC within 1e-3 of the fixture's; the walk kernel and the
    sparse kernel on the fitted forest equal to their plain versions, bulk
    and small-batch; a save, reload and rescore that gives equal scores;
17. eif_fit_full_size: 100 trees on the 1M rows (k = 6) with the
    ``ext_walk_sum`` counter set to 0 just before and read just after (the
    threshold pass must launch it), the threshold at rank error 0, the walk
    kernel against its plain version on the first 65,536 rows, fit and part
    times (bag, growth, threshold pass, the walk kernel on the fitted
    forest), torch.profiler around one warm fit;
18. eif_fit_high_dim: a fully extended fit of 100,000 seeded rows x 274 (k
    = 274 over five chunks), its time and peak memory, growth's
    invariants, the walk kernel and the dense-table kernel (its ``dense``
    scoring) against their plain versions on 4,096 rows;
19. eif_fit_edges: small seeded EIF fits (extension level 0, maxFeatures
    0.5, a constant column, all-constant rows, contamination 0, bootstrap,
    N = 300 with S = 256, subsample_trees 0.5), each held to growth's
    invariants.

Then the model's lifecycle around the kernels, on the card:

20. baseline: the drift baseline of the fit_parity fits (standard and EIF)
    against each fixture's committed ``_BASELINE.json`` (feature streams
    exactly, score counts moved only by rows whose JAX score lies within
    2e-6 of a bin edge, quantiles within 2e-6), a save and reload that
    keeps it sealed and equal, and the 1M-row fits with and without capture
    (the capture launches the path kernel once more), the capture's time;
21. monitor: the loaded fixtures served with monitoring on: the training
    rows keep score PSI < 0.1 with no alert, a shifted batch (``X * 3 + 5``)
    alerts once for each stream past its threshold and a second one not
    again, the gauge is set, the card's fold equals the CPU's on the same
    values (NaN, +-inf and 1e30 included), latency at 1, 64, 4,096 and
    1M rows with the monitor on and off (median of 21), and torch.profiler
    around one 1-row call with the monitor off and on;
22. checkpoint: the 100-tree 1M-row fit and the mammography EIF fit with
    ``checkpoint_every=32``, and each killed after block 1 and resumed,
    equal to the plain fit bitwise; fit, seal and fingerprint times;
23. tolerant_load: fixture copies in 1,000-record blocks with a sync marker
    flipped as read, loaded on the card with ``on_corrupt="drop"``: the
    report equals the CPU load's, a strict load refuses, and the survivors
    through the walk kernels equal their plain versions exactly and the
    CPU's scores within 2e-6.

Then the scoring executor, the autotuner, the watchdog and spans:

24. streaming: for both fixtures and both strategies, the 1M host rows at
    chunks of 2^17 to 2^20 rows (2^20 is one chunk) with ``pipeline=True``
    and ``False``, 1,000,003 rows (a ragged tail), rows already on the
    card, and two streamed calls on different rows back to back with no
    synchronisation: every variant equal to one launch over rows on the card
    exactly (max |delta| 0); the wall time of each (median of 15, taken in
    turns), the first and the second streamed call (the pinned buffers'
    allocation), the overlap efficiency, torch.profiler around one streamed
    call of each (pinned copies, kernels, busy share); a monitored streamed
    call folds what a monitored ``pipeline=False`` one does; no
    ``pipeline_fallback`` on the card;
25. autotune: on a fresh table, ``auto`` resolved cold, then warm, for each
    fixture at 1, 64, 4,096 and 1M rows and the mammography rows (winner,
    probe seconds, source ``probe`` then ``table``; 1 and 64 rows share a
    bucket), ``auto``'s scores equal the winner's exactly, and on the
    mammography rows the winner's committed JAX counterpart within 2e-6;
26. watchdog: ``slow_collective`` armed, ``model.score(..., timeout_s=0.5)``
    raises ``WatchdogTimeout`` within the deadline plus 0.5 s, no rung and no
    dense launch follow; the next call, while the abandoned run wakes, equals
    the single-shot scores, and the abandoned run ends;
27. spans: torch.profiler around one 1M-row ``model.score`` with telemetry
    on: ``pipeline.chunk`` ranges inside ``score_matrix`` inside
    ``model.score``, and ``telemetry.spans.summary()`` lists them.

Then the quantized (q16) plane, in torch ops (no kernel of its own):

28. q16: both fixture models take ``set_scoring_representation("q16")``,
    which on the card keeps the f32 tables; the q16 plane's build time
    alone, and its bytes beside the walk's and the dense kernel's tables;
    the 1M host rows through ``strategy="q16"``,
    which launches no path kernel: the first 65,536 scores equal the port's
    gather walk exactly, the mammography rows' scores lie within 2e-6 of
    the committed JAX scores, a call under the watchdog equals them; a
    save and reload on the card keeps ``"q16"``; ``auto`` at 1, 4,096 and
    1M rows keys with ``|q16``, probes walk and dense only, equals its
    winner exactly, and its cold resolution is timed; warm ``model.score`` medians of walk and dense
    (in turns) and of q16 (alone) at 1, 4,096 and 1M rows; then a seeded 800-tree fit of 65,536
    uniform rows (more than 65,535 distinct thresholds) takes the ``q16_unsupported``
    rung onto ``walk_sum`` (counted), with the walk's scores, raises under
    ``strict=True`` and refuses the representation.

Then the out-of-core data plane, the kernels run chunk by chunk from disk:

29. out_of_core: A, the documented deployment (``bench.py --out-of-core``:
    KDDCup99-HTTP-like rows at F = 3, 100 trees, ``maxSamples`` 256,
    contamination 0.004) at 20,000,000 rows (cut from 100M for time) in
    five 4,000,000-row ``.npy`` shards, written one at a time:
    ``fit_source`` on the card, equal tensor for tensor to
    ``fit_from_sample`` of the same ``StreamedBagger`` sample (the sampler's
    host pass and that fit timed apart); ``score_source`` with ``walk``,
    equal exactly to ``model.score`` of each shard's rows, and with
    ``auto`` (what it resolved the 65,536-row bucket to); a run killed after
    shard 2 (``kill_score_after_shard``) and resumed, byte-equal to the clean
    sink; rows/s, seconds a shard, peak RSS, launches, and torch.profiler
    around one shard. B, every kernel through ``score_source``: the 1M rows
    in four uneven ``.npy`` shards and the mammography rows in a labeled
    ``.csv`` and ``.avro`` shard through both fixtures with ``walk`` and
    ``dense`` (K1-K4), and 65,536 rows of a seeded F = k = 274 forest in
    two shards with ``dense`` (K5): each sink equal to the in-memory scores
    exactly, each kernel launched once a chunk, the mammography sinks within
    2e-6 of the committed JAX scores; a parquet shard read where ``pyarrow``
    imports, else refused with ``SourceFormatError``.

Then the online scoring service, over HTTP on the card:

30. http_serving, for each fixture: ``serving.serve_model`` on
    ``127.0.0.1`` (a free port, ``lifecycle=False``, the default device, the
    1, 64 and 4,096-row buckets warmed); with every launch counter at 0 just
    before and read just after, JSON requests of 1, 64 and 4,096 rows, the
    11,183 mammography rows as CSV, one JSON request of 50,000 rows (past the
    largest warmed bucket: it streams through the executor in 4,096-row
    chunks), 32 concurrent 1-row requests from threads (fewer flushes than
    requests), and 200 closed-loop requests of 1 and of 64 rows at the 2 ms
    linger and at 0 (client and server p50/p99, flush and ``model.score``
    times); ``/trace`` of the first request converts to a Chrome trace,
    ``/metrics`` counts every response by status, ``/healthz`` carries the
    serving state, ``/debug/bundle`` has exactly the bundle's sections and no
    steady compile; then every answer equal bit for bit to one
    ``model.score`` call on the card of the same rows, the mammography
    answers within 2e-6 of the committed JAX scores of the resolved
    strategy, and each strategy the buckets resolved to launched its kernel.
    A ``{"serving": ...}`` line holds both fixtures' latencies beside the
    ``nvidia-smi`` line.

Then the model lifecycle on the card (``lifecycle.ModelManager``, the
README's default knobs, ``checkpoint_every=25``, the retry on a FakeClock;
4,096-row batches of resampled mammography rows, in distribution, then
shifted by 3 standard deviations per feature):

31. lifecycle: (a) no in-distribution batch triggers a refit; (b) sustained
    drift triggers one refit on the full 65,536-row window, killed after
    block 1 (``kill_retrain_after_block``) and resumed, validated and
    swapped: the 1M rows score bit for bit as a plain card fit of that
    window with ``retrain_seed(1, 2)``, ``CURRENT.json`` names
    ``gen-00002``, and drift falls back under its threshold on the
    re-served rows; (c) ``fail_swap`` and ``corrupt_candidate`` roll back,
    the incumbent's 1M scores bit for bit unchanged; (d) four threads score
    through a swap stalled on an event, each answer bit for bit the old or
    the new generation's; (e) a sliding refresh of ``mammography_eif``
    keeps 50 trees bit for bit and grows 50 equal to a card growth from the
    same draws; (f) ``serve_model(copy, lifecycle=True)`` over HTTP until
    ``/healthz`` names generation 2, each answer bit for bit one
    ``model.score`` of the generation it names. The line holds the refit's
    wall and part times, the swap's lock hold, ``manager.score`` against
    ``model.score`` at 1 and 4,096 rows idle and during a background
    refit, and the phase's launches.

Then the multi-device layer (``isoforest_tpu_torch/parallel``) on the one
card:

32. parallel: (a) ``create_mesh()``, a 1 x 1 mesh over ``cuda:0``: both
    estimators' ``fit(X_big, mesh=)`` equal the plain card fit node for
    node, threshold exactly; with every launch counter at 0 just before and
    read just after, ``model.score(X_big, mesh=)`` of both fixtures with
    ``walk`` and ``dense`` and ``sharded_score`` of 65,536 rows through a
    seeded F = k = 274 forest with ``dense``, each bit for bit the
    unsharded call, K1-K5 each launched; (b) eight logical shards of the
    card (2 x 4): sharded growth of 100 trees (padded to 104, sliced)
    bitwise the plain growth, ``sharded_score`` bit for bit and
    ``sharded_score_2d`` within 2e-6 for both fixtures and strategies; four
    (2 x 2): the train step at the north star's shape (10,000,000
    KDDCup99-HTTP-like rows, F = 3, 100 trees, ``maxSamples`` 256,
    contamination 0.004), exact and with ``contamination_error`` 0.0004,
    its forest node for node ``fit(X, mesh=)``'s, its scores bit for bit
    that model's ``score(X, mesh=, strategy="walk")``, both thresholds
    within the rank contract; (c) processes sharing the card, started
    together: two ranks over gloo (a 1 x 2 mesh, the train step on 1M rows
    equal to one process's 1 x 2 run exactly), an NCCL world of one (its
    all-gather and all-reduce on the card, equal to the 1 x 1 run), and two
    ranks of which one dies before joining (the survivor exits with a
    typed ``DistributedTimeoutError`` naming it within its 10 s deadline);
    every rank under a host-side timeout; then times (host clock,
    synchronised, medians of 7) of ``fit``, ``score`` and
    ``sharded_score_2d`` on 1 x 1 and 2 x 4 meshes beside the plain calls,
    and of the train step on 1 x 1 and 2 x 2, with the ``nvidia-smi`` line.

Then the multi-tenant fleet, the overload autopilot and the stream engine
(ROADMAP item 17, parts 1-3) on the card:

33. fleet: ``fleet.serve_fleet`` over a models directory of three tenants:
    copies of ``mammography_std`` and ``mammography_eif`` (each served
    through a lifecycle manager) and a seeded F = k = 274 EIF forest of
    phase 29's shape (100 trees, about 112 MB of records), saved there and
    served bare. With every launch counter at 0 just before and read just
    after: JSON ``POST /score/<id>`` of 1, 64 and 4,096 rows to each tenant
    under each ``ISOFOREST_TPU_STRATEGY`` pin (none, ``walk``, ``dense``),
    each answer bit for bit the tenant's ``model.score`` of the same rows
    under the same pin (K1-K5 each launched); the registry's count of each
    tenant's card bytes beside the rise of ``torch.cuda.memory_allocated``;
    a budget of both mammography tenants' counts and 1 MiB, so the wide
    tenant's first request evicts both by LRU; ``fail_fleet_load`` (a
    typed 503 with Retry-After while the resident tenant answers 200), the
    reload that evicts the wide tenant by LRU, ``evict_during_score`` (200,
    bit for bit, cause ``fault_injected``) and ``GET /models``. Then an
    ``autopilot.Autopilot`` over two threadless services on a FakeClock (the
    standard fixture at weight 1, the EIF fixture at 0.5), with real queued
    pressure and ``tick()`` driven by the phase, down rungs 1-3 and back
    up: flush times at 1, 64 and 4,096 rows at each rung (medians of 7), at
    rung 3 as the port applies it (a 50-tree prefix on the f32 kernels) and
    with ``set_quality(force_q16=True)``; rungs 0-2 bit for bit
    ``model.score``, rung 3 bit for bit ``score_matrix`` of the prefix
    under the same strategy; the lower weight shed with a 429 at rung 2;
34. stream: 500,000 resampled mammography rows (cut from 1M for time) at
    1,000 events a second of event time, up to 0.5 s out of order, the last
    40% shifted by 3 standard deviations per feature, in 4,096-row batches
    from ``stream.generator_source`` through a ``StreamEngine`` (60 s
    windows, 1 s lateness) over a ``ModelManager`` of ``mammography_std``
    (a decay reservoir with a 60 s half-life; drift over 16 batches
    triggers a refit inside the flush); with every launch counter at 0 just
    before and read just after: at least one swap, each batch's scores bit
    for bit its generation's ``model.score`` (generations reloaded from the
    work directory), pane, window, fold and late-row counts equal to the
    same run on the CPU; then 65,536 of the rows over ``socket_source`` on
    localhost under a 60 s deadline, bit for bit the generator run's. It
    prints events/s, the lag's p50 and p99 and each refit's wall time.

Then the replicated serving tier (ROADMAP item 17, parts 4 and 5, and the
``serve`` subcommand it spawns) on the card:

35. tier: (a) in this process, a ``replication.Router`` over two
    ``fleet.serve_fleet`` replicas of ``mammography_std`` and
    ``mammography_eif`` (each under its manager) behind a telemetry daemon;
    with every launch counter at 0 just before and read just after: JSON
    ``POST /score/<id>`` of 1, 64 and 4,096 rows through the router under
    each strategy pin (none, ``walk``, ``dense``), each answer bit for bit
    the tenant's ``model.score`` (K1-K4 each launched); a
    ``kill_replica_during_score`` sever retried bit for bit, the monitor
    folding the rows once; a ``stall_current_json_push`` drill (generation 1
    bit for bit while ``CURRENT.json`` names a sealed generation 2 and the
    push is stalled, generation 2's scores on both replicas after); the
    tier's ``/metrics`` (each counter the sum of its sources') and
    ``/trace``; the journal's cost on 1-row requests, off and on in turns.
    (b) ``replication.serve_router(models_dir, replicas=2, journal_dir=)``:
    two ``python -m isoforest_tpu_torch serve --models-dir --no-lifecycle``
    processes on the card (bare tenants: the hop repeats its rows, whose
    drift would refit a managed tenant), with an empty kernel build directory
    (``ISOFOREST_TPU_TORCH_BUILD_DIR``) that both fill at once when warmed
    together; every answer bit for bit the tenant's ``model.score``; the
    tier's ``/trace`` stitching the router's lane to a replica's; 200
    closed-loop 1-row requests with the serving replica SIGKILLed after 100:
    none fails, the router ejects it within ``probe_interval_s +
    probe_timeout_s``, the tier's ``/metrics`` counts the live replica's
    own, its ``/debug/bundle`` names it missing and recovers its spool (its
    ``fleet.load`` events) from the journal; the router's hop (routed
    against direct, in turns) at 1, 64 and 4,096 rows; a drain, the
    survivor's spool ending with ``journal.stop``. It prints each replica's
    seconds to its ready line and its card memory.

Then the command line and ONNX export (ROADMAP items 6 and 7) on the card:

36. cli: (a) real ``python -m isoforest_tpu_torch`` processes on the
    default device: ``fit`` of mammography (standard, and EIF with
    ``--extended --extension-level 5``; 100 trees, 11,183 x 6), then
    ``score`` of each and of the committed ``mammography_std``: each
    summary names ``cuda``, each saved forest equals an in-process fit node
    for node, each scores CSV this process's ``model.score`` bit for bit,
    the fixture's within 2e-6 of ``jax_scores.npy``. (b) Through
    ``main(argv)`` in this process, the launch counters at 0 before each
    call and read after it: ``score`` of phase 4's 1M rows with both
    fixtures, ``walk`` and ``dense`` (and the walk in four chunks, the
    same file byte for byte), ``score --source`` over five shards and
    ``--resume``, ``inspect``, ``diagnose``, ``telemetry``, ``trace``,
    ``debug-bundle``, ``autotune --warm``/``--format table``/``--clear``,
    ``monitor`` and ``manage`` on shifted rows (drift, a swap) and
    ``stream`` over 100,000 timestamped rows, each held to its JAX test's
    checks and timed. (c) ONNX: ``convert`` of the fixtures and of (a)'s
    fits, the port's runtime on the 11,183 rows within 1e-5 of the card's
    scores (standard) or the port's gather walk (EIF), the independent
    checker within 1e-6 of it on 1,000 rows; a 10-tree F = k = 274 EIF fit
    and scored with ``dense`` through the CLI (K5), converted and held to
    the JAX test's boundary bound. It prints each call's seconds and
    launches, and the conversions' and runtime's host seconds.

Then a ``{"kernels": [...]}`` line for all five kernels (``walk_sum`` also
with its launches in the 1M-row fit and ``ext_walk_sum`` with its launches
in the 1M-row EIF fit, ``fit_launches``; each with its launches through
phase 30, ``serving_launches``, through phase 31,
``lifecycle_launches``, through phase 32's counted mesh scoring,
``parallel_launches``, through phase 33's fleet requests,
``fleet_launches``, through phase 34's card run, ``stream_launches``,
through phase 35's in-process tier, ``tier_launches``, and through phase
36's in-process CLI calls, ``cli_launches``),
the ``nvidia-smi`` name and
power-limit line, and last ``{"ok": true, "device": {...}}``. Any
failed check raises and exits non-zero. The run's autotune tables live in
``build/`` (git-ignored), fresh each run, so every run probes cold. With
no CUDA card, or without the package beside it, the script prints no
result and exits 2.
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "resources" / "torch_port" / "mammography_std"
EIF_FIXTURE = ROOT / "tests" / "resources" / "torch_port" / "mammography_eif"
MAMMOGRAPHY = ROOT / "tests" / "resources" / "mammography.csv"
SHUTTLE = ROOT / "tests" / "resources" / "shuttle.csv"

# H100 SXM published peaks: HBM bytes/s and
# float32 operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

FULL_ROWS = 1_000_000
HIGH_DIM_ROWS = 65_536  # the F = 274 dense-table forest: rows cut from 1M for time
HIGH_DIM_FIT_ROWS = 100_000  # the F = 274 fits' seeded rows
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def auroc(scores, labels) -> float:
    """Rank AUROC with average ranks for ties (Mann-Whitney U)."""
    import numpy as np

    s = np.asarray(scores, np.float64)
    sorter = np.argsort(s, kind="mergesort")
    inv = np.empty_like(sorter)
    inv[sorter] = np.arange(len(s))
    ss = s[sorter]
    first = np.r_[True, ss[1:] != ss[:-1]]
    group = first.cumsum()[inv]
    bounds = np.r_[np.nonzero(first)[0], len(first)]
    ranks = 0.5 * (bounds[group] + bounds[group - 1] + 1)
    pos = np.asarray(labels) == 1
    n1, n0 = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def bound(nbytes: float, ops: float):
    """The least time the card could take: ``(ms, "bytes" or "operations")``."""
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def profile_call(fn, host_top: int = 0) -> dict:
    """Device activity by name from torch.profiler around one synchronised
    call, beside the call's wall time; with ``host_top``, also the number of
    device activities and the host operations that took the most self time."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = {}
    for e in prof.events():
        # spans are profiler ranges, shown on the device's timeline too: not device work
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            device[e.name] = device.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_ms": wall_ms, "device_ms": sum(device.values()),
           "device_busy_share": sum(device.values()) / wall_ms,
           "htod_in_trace": any("HtoD" in name for name in device),
           "top_device_ms": [[k[:80], v] for k, v in top]}
    if host_top:
        ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
        out["device_activities"] = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                                       and not getattr(e, "is_user_annotation", False))
        out["host_ops_self_ms_total"] = sum(a.self_cpu_time_total for a in ops) / 1e3
        out["host_ops_top"] = [[a.key[:60], a.count, a.self_cpu_time_total / 1e3] for a in ops[:host_top]]
    return out


def breakdown_phase(phase: str, model, X) -> dict:
    """torch.profiler around one warm ``model.score(X)`` per strategy, beside
    the host-to-device copy of X timed alone on CUDA events: where a trace
    misses the copy (``htod_in_trace`` false), its busy share lacks it."""
    import torch

    copy_ms = time_ms(lambda: torch.from_numpy(X).to("cuda"))
    return {"phase": phase, "rows": X.shape[0], "copy_alone_ms": copy_ms,
            **{strategy: profile_call(lambda strategy=strategy: model.score(X, strategy=strategy))
               for strategy in ("walk", "dense")}}


def serving_latency(model, X, strategies) -> dict:
    """Median and max host-clock latency of ``model.score`` (synchronised by
    the copy back) over 21 calls, per strategy and batch of 1, 64, 4,096
    rows; for ``"auto"``, what it resolved to and from where."""
    from isoforest_tpu_torch.tuning import resolve_decision

    out = {}
    for strategy in strategies:
        for n in (1, 64, 4096):
            batch = X[:n]
            for _ in range(3):
                model.score(batch, strategy=strategy)
            lat = []
            for _ in range(21):
                t0 = time.perf_counter()
                model.score(batch, strategy=strategy).cpu()
                lat.append((time.perf_counter() - t0) * 1e3)
            out[f"{strategy}_{n}"] = {"median_ms": statistics.median(lat), "max_ms": max(lat)}
            if strategy == "auto":
                d = resolve_decision(model.forest, batch, model.num_samples, cache=model._cache)
                out[f"{strategy}_{n}"].update(resolved=d.strategy, source=d.source)
    return out


def time_ms(fn, reps: int = 7, inner: int = 1, warmup: int = 2) -> float:
    """Median over ``reps`` of CUDA-event time per call, ``inner`` calls back to back."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def eif_phases(dev, rng, X_m, y_m, X_big) -> list:
    """Phases 7-11 (the extended forest); returns the three EIF kernels'
    entries of the ``kernels`` line."""
    import numpy as np
    import torch

    from isoforest_tpu_torch import load_model, score_matrix
    from isoforest_tpu_torch.io.interop import extended_forest_from_arrays
    from isoforest_tpu_torch.ops import dense, ext_dense, ext_path, ext_walk
    from isoforest_tpu_torch.ops.traversal import extended_path_lengths
    from isoforest_tpu_torch.testing import finite_rows, random_extended_forest, rows
    from isoforest_tpu_torch.utils.math import score_from_path_length

    # 7. parity with the JAX package on the committed EIF fixture
    model = load_model(str(EIF_FIXTURE / "model"))
    require(type(model).__name__ == "ExtendedIsolationForestModel" and model.device.type == "cuda",
            f"EIF model loaded as {type(model).__name__} on {model.device}")
    thr = model.outlier_score_threshold
    gather = np.load(EIF_FIXTURE / "jax_scores.npy")
    gather_auc = auroc(gather, y_m)
    parity = {"phase": "ext_parity", "rows": len(X_m), "trees": model.forest.num_trees,
              "heap_slots": model.forest.max_nodes, "k": model.forest.k, "threshold": thr,
              "jax_gather_auroc": gather_auc}
    for strategy, own_file in (("walk", "jax_walk_scores.npy"), ("dense", "jax_pallas_scores.npy")):
        own = np.load(EIF_FIXTURE / own_file)
        s = model.score(X_m, strategy=strategy).cpu().numpy()
        require(s.shape == own.shape and np.isfinite(s).all(), f"EIF {strategy}: bad scores")
        err = float(np.abs(s - own).max())
        jax_gap = float(np.abs(own - gather).max())
        gather_err = float(np.abs(s - gather).max())
        auc = auroc(s, y_m)
        away = np.abs(s - thr) > 2e-6
        labels = model.predict(torch.from_numpy(s)).numpy()
        same = bool((labels[away] == (own[away] >= thr)).all())
        parity[strategy] = {"counterpart": own_file, "max_abs_err": err, "vs_gather_max_abs": gather_err,
                            "jax_own_gap_to_gather": jax_gap, "auroc": auc, "labels_equal": same,
                            "outliers": int(labels.sum())}
        require(err <= 2e-6, f"EIF {strategy}: max |score - {own_file}| = {err} > 2e-6")
        require(gather_err <= jax_gap + 2e-6, f"EIF {strategy}: {gather_err} from the gather scores")
        require(abs(auc - gather_auc) <= 1e-3, f"EIF {strategy}: AUROC {auc} vs gather {gather_auc}")
        require(same, f"EIF {strategy}: labels differ from the JAX package's")
    emit(parity)

    # 8. where one warm 1M-row EIF model.score spends its time (traced
    # before the plain references below fill the card's memory)
    emit(breakdown_phase("ext_breakdown", model, X_big))

    # 9. the EIF main path: counters at 0 just before, read just after
    f5 = extended_forest_from_arrays(*random_extended_forest(rng, 100, 8, 274, 274, split_p=1.0))
    # 1.1 GB of host rows at F = 274: the executor streams them through the
    # dense-table kernel; the plain check keeps to their first 65,536
    X5_host = rows(rng, FULL_ROWS, 274)
    X5 = torch.from_numpy(X5_host[:HIGH_DIM_ROWS]).to(dev)
    f5_cache = {}
    eif_paths = ("ext_walk_sum", "ext_sparse_mean")
    for name in eif_paths:
        ext_path.launches[name] = 0
    ext_dense.ext_dense_mean.launches = 0
    ext_dense.ext_dense_mean.launches_by_top = {}
    t0 = time.perf_counter()
    s_walk = model.score(X_big, strategy="walk")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s_dense = model.score(X_big, strategy="dense")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    s_high = score_matrix(f5, X5_host, 256, strategy="dense", cache=f5_cache)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {**{name: ext_path.launches[name] for name in eif_paths},
                "ext_dense_mean": ext_dense.ext_dense_mean.launches}
    # by the levels computed as a product: the height means the fully dense form
    dense_by_top = dict(ext_dense.ext_dense_mean.launches_by_top)
    # the first call builds the table and pins 2 x 574 MB of staging; a warm one does neither
    high_warm_s = synced(lambda: score_matrix(f5, X5_host, 256, strategy="dense", cache=f5_cache))[1]
    require(all(v > 0 for v in launches.values()), f"an EIF kernel did not launch: {launches}")
    for name, s, n_rows in (("walk", s_walk, FULL_ROWS), ("dense", s_dense, FULL_ROWS),
                            ("high_dim_dense", s_high, FULL_ROWS)):
        require(tuple(s.shape) == (n_rows,) and bool(torch.isfinite(s).all())
                and bool(((s > 0) & (s <= 1)).all()), f"EIF {name}: bad full-size scores")

    Xd = torch.from_numpy(X_big).to(dev)
    wt = ext_walk.walk_tables_extended(model.forest)
    st = ext_dense.sparse_path_records(model.forest)
    dt = ext_dense.dense_hyperplane_table(f5)

    def chunked(plain, X, tables, rows_per=1 << 17):
        """The plain version, row chunk by row chunk (exact: rows are
        independent), so its float64 temporaries stay small."""
        return torch.cat([plain(X[i : i + rows_per], tables) for i in range(0, X.shape[0], rows_per)])

    def timed_once(fn):
        """``(result, ms)`` of one call, on CUDA events."""
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    # the plain versions are slow references: each runs once, timed, and its
    # result is what the kernel is held to
    walk_plain, walk_plain_ms = timed_once(lambda: chunked(ext_walk.ext_walk_sum_plain, Xd, wt))
    # (the sparse kernel's reference evaluates every slot, from heap tables)
    sparse_plain, sparse_plain_ms = timed_once(
        lambda: chunked(ext_dense.ext_sparse_mean_plain, Xd, ext_dense.sparse_hyperplane_tables(model.forest)))
    dense_plain, dense_plain_ms = timed_once(lambda: chunked(ext_dense.ext_dense_mean_plain, X5, dt, 1 << 15))

    def path_errs(name, tables, want):
        """Max |kernel - plain| of path kernel ``name``: its bulk launch on
        all rows, its small-batch launch on the first 4,096."""
        bulk = ext_path.launch(name, Xd, tables, tree_parallel=False)
        small = ext_path.launch(name, Xd[:4096], tables, tree_parallel=True)
        return float((bulk - want).abs().max()), float((small - want[:4096]).abs().max())

    walk_err, walk_small_err = path_errs("ext_walk_sum", wt, walk_plain)
    sparse_err, sparse_small_err = path_errs("ext_sparse_mean", st, sparse_plain)
    dense_err = float((ext_dense.ext_dense_mean(X5, dt) - dense_plain).abs().max())
    require(walk_err == 0.0 and walk_small_err == 0.0, f"EIF walk kernel vs plain: {walk_err}, {walk_small_err}")
    require(sparse_err == 0.0 and sparse_small_err == 0.0,
            f"EIF sparse kernel vs plain: {sparse_err}, {sparse_small_err}")
    require(dense_err == 0.0, f"EIF dense-table kernel vs plain: {dense_err}")
    # the streamed 1M-row call's first rows equal one launch on the checked rows
    high_single = score_matrix(f5, X5, 256, strategy="dense", cache=f5_cache, chunk_size=HIGH_DIM_ROWS)
    require(torch.equal(s_high[:HIGH_DIM_ROWS], high_single), "the streamed F = 274 scores differ from one launch's")
    # the dots alone as one float32 product (TF32 is off): a yardstick, not the function
    m_int5 = (dt.value.shape[1] + 1) // 2 - 1
    W5 = dt.weight[:, :, :m_int5].permute(1, 0, 2).reshape(dt.weight.shape[1], -1).contiguous()
    # the card's walk scores against the port's gather walk on a slice: equal
    # but where a tie routes the other way under the two dot orders
    ref = score_from_path_length(extended_path_lengths(model.forest, Xd[:4096]), model.num_samples)
    gather_gap = float((ref - s_walk[:4096]).abs().max())
    require(gather_gap < 0.05, f"EIF walk scores vs gather reference: {gather_gap}")
    times = {
        "walk_ms": time_ms(lambda: ext_walk.ext_walk_sum(Xd, wt), inner=10),
        "walk_plain_ms": walk_plain_ms,
        "sparse_ms": time_ms(lambda: ext_dense.ext_sparse_mean(Xd, st), inner=3),
        "sparse_plain_ms": sparse_plain_ms,
        "dense_ms": time_ms(lambda: ext_dense.ext_dense_mean(X5, dt), reps=5, warmup=1),
        "dense_plain_ms": dense_plain_ms,
        "dense_matmul_ms": time_ms(lambda: torch.matmul(X5, W5), reps=5),
    }

    # Bounds, from this run's inputs, counted as for the standard kernels:
    # the function needs, per internal slot a row visits, one compare and k
    # multiply-adds (2 operations each), plus one add per (row, tree), and
    # for a mean one divide per row; bytes are X read once, the kernel's
    # tables read once and the f32 result written once. The dense algorithm
    # evaluates every internal slot of every tree; that count, at peak, is
    # printed as *_algorithm_ops_ms beside the bound and not as it.
    def visits(forest, X):
        """Internal slots the rows visit, from the forest's own arrays (dots
        in float32 by torch.sum: a tie may route one ulp otherwise than in a
        kernel, a few visits)."""
        internal = forest.is_internal
        index = forest.indices.clamp(min=0).long()
        weight = torch.where(forest.indices >= 0, forest.weights, torch.zeros((), device=dev))
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for t in range(forest.num_trees):
            node = torch.zeros(X.shape[0], dtype=torch.long, device=dev)
            for _ in range(forest.height):
                inside = internal[t][node]
                total += inside.sum()
                dot = (X.gather(1, index[t][node]) * weight[t][node]).sum(dim=1)
                node = torch.where(inside, 2 * node + 1 + (dot >= forest.offset[t][node]).long(), node)
        return float(total)

    def nbytes(*fields):
        """Bytes of the tensors among ``fields`` (tables also carry ints)."""
        return float(sum(a.numel() * a.element_size() for a in fields if isinstance(a, torch.Tensor)))

    n, f = Xd.shape
    t_n, k = model.forest.num_trees, model.forest.k
    visited = visits(model.forest, Xd)
    n5, t5, k5 = X5.shape[0], f5.num_trees, f5.k
    visited5 = visits(f5, X5)
    walk_bound, walk_by = bound(nbytes(Xd, *wt) + n * 4, visited * (1 + 2 * k) + n * t_n)
    sparse_bound, sparse_by = bound(nbytes(Xd, *st) + n * 4, visited * (1 + 2 * k) + n * t_n + n)
    dense_bound, dense_by = bound(nbytes(X5, *dt) + n5 * 4, visited5 * (1 + 2 * k5) + n5 * t5 + n5)
    slots = float(model.forest.is_internal.sum())
    slots5 = float(f5.is_internal.sum())
    sparse_algo_ms = (n * slots * (1 + 2 * k) + 2.0 * n * t_n) / PEAK_F32_OPS_PER_S * 1e3
    dense_algo_ms = (n5 * slots5 * (1 + 2 * k5) + 2.0 * n5 * t5) / PEAK_F32_OPS_PER_S * 1e3
    emit({"phase": "ext_full_size", "rows": n, "features": f, "trees": t_n, "k": k,
          "heap_slots": model.forest.max_nodes, "high_dim": {"rows": n5, "features": 274, "k": k5, "trees": t5,
                                                             "height": f5.height, "matmul_shape": list(W5.shape)},
          "launches": launches, "score_walk_s": t1 - t0, "score_dense_s": t2 - t1,
          "score_high_dim_1m_streamed_s": t3 - t2, "score_high_dim_1m_streamed_warm_s": high_warm_s,
          "high_dim_streamed_rows": FULL_ROWS,
          "walk_vs_dense_max_abs_score": float((s_walk - s_dense).abs().max()),
          "walk_vs_gather_max_abs_score_4096": gather_gap,
          "walk_kernel_vs_plain_max_abs_sum": walk_err,
          "walk_small_batch_vs_plain_max_abs_sum_4096": walk_small_err,
          "sparse_kernel_vs_plain_max_abs_mean": sparse_err,
          "sparse_small_batch_vs_plain_max_abs_mean_4096": sparse_small_err,
          "dense_kernel_vs_plain_max_abs_mean": dense_err,
          "mean_internal_visits_per_row_tree": visited / (n * t_n),
          "high_dim_mean_internal_visits_per_row_tree": visited5 / (n5 * t5),
          **times,
          "walk_rows_per_s": n / times["walk_ms"] * 1e3, "sparse_rows_per_s": n / times["sparse_ms"] * 1e3,
          "dense_rows_per_s": n5 / times["dense_ms"] * 1e3,
          "walk_bound_ms": walk_bound, "walk_bound_by": walk_by,
          "sparse_bound_ms": sparse_bound, "sparse_bound_by": sparse_by,
          "dense_bound_ms": dense_bound, "dense_bound_by": dense_by,
          "sparse_algorithm_ops_ms": sparse_algo_ms, "dense_algorithm_ops_ms": dense_algo_ms})

    # 10. edges: synthetic EIF forests, each kernel against its plain version
    cases = [
        {"features": 1, "k": 1, "height": 0, "rows": 1023, "data": "nonfinite"},
        {"features": 1, "k": 1, "height": 8, "rows": 1025, "data": "nonfinite"},
        {"features": 6, "k": 6, "height": dense.DENSE_MAX_HEIGHT, "rows": 1025, "data": "ties"},
        {"features": 6, "k": 6, "height": dense.DENSE_MAX_HEIGHT + 1, "rows": 1023, "data": "ties"},
        {"features": 13, "k": 13, "height": 6, "rows": 1023, "data": "ties"},
        {"features": 17, "k": 16, "height": 6, "rows": 1025, "data": "nonfinite"},
        {"features": 17, "k": 17, "height": 6, "rows": 1023, "data": "nonfinite"},
        {"features": 40, "k": 32, "height": 5, "rows": 1025, "data": "ties"},
        {"features": 40, "k": 33, "height": 5, "rows": 1023, "data": "nonfinite"},
        {"features": 274, "k": 33, "height": 8, "rows": 1, "data": "nonfinite"},
        # rows too wide for the path kernels' shared-memory tile: x[f] from L1
        {"features": 1000, "k": 8, "height": 6, "rows": 1023, "data": "nonfinite"},
        {"features": 1000, "k": 40, "height": 4, "rows": 1025, "data": "nonfinite"},
        # the dense-table kernel at its tile boundaries: widths off the 16-feature
        # chunk, rows off the 128-row tile, heights 0 to 10 (128-slot tiles to
        # h = 7, 256-slot ones above, 4 at h = 10), a tile of finite rows with
        # a few non-finite ones, ties
        {"features": 33, "k": 33, "height": 8, "rows": 1025, "data": "ties"},
        {"features": 274, "k": 274, "height": 7, "rows": 1023, "data": "ties"},
        {"features": 40, "k": 40, "height": 10, "rows": 1023, "data": "ties"},
        {"features": 274, "k": 274, "height": 0, "rows": 1, "data": "nonfinite"},
        {"features": 274, "k": 274, "height": 10, "rows": 1000, "data": "mixed"},
        {"features": 274, "k": 40, "height": 8, "rows": 129, "data": "mixed"},
        {"features": 1000, "k": 1000, "height": 6, "rows": 1025, "data": "mixed"},
        # the path kernels on both sides of the small-batch switch: N from one
        # warp's row to 4,096, the walk's paired order's last k (16) and the
        # chain's first (17), the sparse kernel's widest k (32), h = 0 to 10
        {"features": 6, "k": 6, "height": 8, "rows": 1, "data": "ties"},
        {"features": 6, "k": 6, "height": 0, "rows": 31, "data": "nonfinite"},
        {"features": 16, "k": 16, "height": 8, "rows": 33, "data": "ties"},
        {"features": 17, "k": 17, "height": 10, "rows": 64, "data": "nonfinite"},
        {"features": 40, "k": 32, "height": 10, "rows": 4096, "data": "ties"},
        {"features": 6, "k": 6, "height": 10, "rows": 4096, "data": "nonfinite"},
        {"features": 17, "k": 17, "height": 8, "rows": 4096, "data": "ties"},
        {"features": 16, "k": 16, "height": 0, "rows": 1, "data": "nonfinite"},
        {"features": 6, "k": 6, "height": 8, "rows": 64, "data": "nonfinite", "duplicates": True},
        # more than two 32-tree rounds of the small-batch kernel, the last ragged
        {"features": 6, "k": 6, "height": 8, "rows": 4096, "data": "ties", "trees": 100},
        {"features": 17, "k": 17, "height": 10, "rows": 33, "data": "nonfinite", "trees": 77},
        {"features": 40, "k": 32, "height": 6, "rows": 1, "data": "ties", "trees": 77},
    ]

    def path_err(name, want, x, tables):
        """Max |kernel - plain| over path kernel ``name``'s bulk and
        small-batch launches."""
        return max(float((ext_path.launch(name, x, tables, tree_parallel=small) - want).abs().max())
                   for small in (False, True))

    edges = []
    for case in cases:
        f_e = case["features"]
        if case["data"] == "ties":
            Xe = rng.integers(0, 4, size=(case["rows"], f_e)).astype(np.float32)
        elif case["data"] == "mixed":  # one tile of finite rows, a few non-finite
            Xe = finite_rows(rng, case["rows"], f_e)
            Xe[[0, min(5, case["rows"] - 1)], [0, f_e - 1]] = [np.nan, np.inf]
            Xe[min(70, case["rows"] - 1), f_e // 2] = -np.inf
        else:
            Xe = rows(rng, case["rows"], f_e)
        trees = case.get("trees", 13)
        arrays = random_extended_forest(rng, trees, case["height"], f_e, case["k"], split_p=0.85,
                                        intercepts=Xe[:32], unused_p=0.2)
        if case.get("duplicates"):  # every other internal node lists its first coordinate twice
            arrays[0][:, ::2, 1] = np.where(arrays[0][:, ::2, 1] >= 0, arrays[0][:, ::2, 0], -1)
        forest = extended_forest_from_arrays(*arrays)
        xe = torch.from_numpy(Xe).to(dev)
        wte = ext_walk.walk_tables_extended(forest)
        w_err = path_err("ext_walk_sum", ext_walk.ext_walk_sum_plain(xe, wte), xe, wte)
        row = dict(case, trees=trees, walk_vs_plain=w_err)
        require(w_err == 0.0, f"EIF walk edge case {row}")
        tables = ext_dense.hyperplane_tables(forest)
        sparse = case["k"] <= ext_dense.SPARSE_K_MAX
        kernel = ext_dense.ext_sparse_mean if sparse else ext_dense.ext_dense_mean
        if case["height"] <= dense.DENSE_MAX_HEIGHT:
            if sparse:
                want = ext_dense.ext_sparse_mean_plain(xe, ext_dense.sparse_hyperplane_tables(forest))
                d_err = path_err("ext_sparse_mean", want, xe, tables)
            else:
                d_err = float((kernel(xe, tables) - ext_dense.ext_dense_mean_plain(xe, tables)).abs().max())
            row[f"{kernel.__name__}_vs_plain"] = d_err
            require(d_err == 0.0, f"EIF dense edge case {row}")
        else:
            try:
                kernel(xe, tables)
            except ValueError as exc:
                row["dense_fence"] = str(exc)
            else:
                fail(f"EIF dense kernel accepted height {case['height']}")
        edges.append(row)
    emit({"phase": "ext_edges", "cases": edges})

    # 11. serving-sized batches through the EIF model.score
    emit({"phase": "ext_serving", "latency": serving_latency(model, X_big, ("auto", "dense"))})
    del X5_host

    walk_src = sparse_src = "isoforest_tpu_torch/csrc/path_walk.cu"
    entry = {"route": "cuda", "library_ms": None}
    return [
        {**entry, "name": "ext_walk_sum", "source": walk_src,
         "replaces": "isoforest_tpu/ops/pallas_walk.py:346", "launches": launches["ext_walk_sum"],
         "max_abs_err": max(walk_err, walk_small_err), "ms": times["walk_ms"], "plain_ms": times["walk_plain_ms"],
         "bound_ms": walk_bound, "bound_by": walk_by, "rows": n, "plain_rows": n},
        {**entry, "name": "ext_sparse_mean", "source": sparse_src, "replaces": "isoforest_tpu/ops/pallas_traversal.py:304",
         "launches": launches["ext_sparse_mean"], "max_abs_err": max(sparse_err, sparse_small_err),
         "ms": times["sparse_ms"],
         "plain_ms": times["sparse_plain_ms"], "bound_ms": sparse_bound, "bound_by": sparse_by,
         "rows": n, "plain_rows": n},
        {**entry, "name": "ext_dense_mean", "source": "isoforest_tpu_torch/csrc/ext_gemm.cu",
         "replaces": "isoforest_tpu/ops/pallas_traversal.py:331",
         "launches": launches["ext_dense_mean"], "launches_by_top": dense_by_top, "max_abs_err": dense_err,
         "ms": times["dense_ms"],
         "plain_ms": times["dense_plain_ms"], "bound_ms": dense_bound, "bound_by": dense_by,
         "matmul_ms": times["dense_matmul_ms"], "streamed_1m_call_ms": (t3 - t2) * 1e3,
         "streamed_1m_warm_call_ms": high_warm_s * 1e3,
         "rows": n5, "plain_rows": n5},
    ]


def synced(fn):
    """``(result, seconds)`` of one call on the host clock, synchronised
    before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fit_phases(dev, X_m, y_m, X_big, fixture_model) -> dict:
    """Phases 12-15 (fit of the standard forest); returns the threshold
    pass's ``walk_sum`` launches on the 1M-row fit."""
    import tempfile

    import numpy as np
    import torch

    from isoforest_tpu_torch import IsolationForest, load_model
    from isoforest_tpu_torch.models.isolation_forest import _compute_and_set_threshold
    from isoforest_tpu_torch.ops import bagging, ext_path, prng, tree_growth, walk
    from isoforest_tpu_torch.ops.level_window import chunk_features
    from isoforest_tpu_torch.ops.quantile import quantile_rank_error
    from isoforest_tpu_torch.testing import growth_invariant_errors
    from isoforest_tpu_torch.utils.math import height_limit

    def invariants(model, X, allowed=None) -> None:
        errors = growth_invariant_errors(*(a.cpu().numpy() for a in model.forest), X, model.num_samples, allowed)
        require(not errors, f"growth invariants: {errors}")

    def fitted_walk_errors(records, X) -> dict:
        """walk_sum against its plain version on a fitted forest: the bulk
        launch over all of ``X``, the small-batch one over its first 4,096 rows."""
        return {
            "bulk": float((walk.walk_sum(X, records) - walk.walk_sum_plain(X, records)).abs().max()),
            "small_batch": float((walk.walk_sum(X[:4096], records)
                                  - walk.walk_sum_plain(X[:4096], records, tree_parallel=True)).abs().max()),
        }

    def fit_keys(seed, n_trees, n_feats_total, n_feats):
        """The fit's feature subsets and per-tree growth keys, re-derived."""
        _, k_feat, k_grow = prng.split(prng.PRNGKey(seed, device=dev), 3)
        return (bagging.feature_subsets(k_feat, n_feats_total, n_feats, n_trees),
                bagging.per_tree_keys(k_grow, n_trees))

    phases_t0 = time.perf_counter()
    # 12. fit_parity: the fixture's own fit, on the card, node for node
    est = IsolationForest(contamination=0.02, random_seed=1)
    model, first_fit_s = synced(lambda: est.fit(X_m))
    _, warm_fit_s = synced(lambda: est.fit(X_m))
    require(model.device.type == "cuda", f"fit ran on {model.device}")
    got = [a.cpu().numpy() for a in model.forest]
    want = [a.cpu().numpy() for a in fixture_model.forest]
    require(all(g.shape == w.shape for g, w in zip(got, want)), "forest shapes differ from the fixture's")
    differ = (got[0] != want[0]) | (got[1].view(np.int32) != want[1].view(np.int32)) | (got[2] != want[2])
    h = height_limit(model.num_samples)
    fidx, tree_keys = fit_keys(1, model.forest.num_trees, X_m.shape[1], model.num_features)
    geom = chunk_features(torch.zeros(1, model.num_features))
    near_ties = []
    for t, s in zip(*np.nonzero(differ)):
        if s > 0 and differ[t, (s - 1) // 2]:
            continue  # inside a differing subtree: its root explains it
        # the root of a differing subtree: the same data reached it, so only
        # the Gumbel argmax can differ, between two non-constant features
        a, b = int(got[0][t, s]), int(want[0][t, s])
        require(a >= 0 and b >= 0 and a != b, f"tree {t} slot {s}: a difference no Gumbel draw explains")
        level = int(np.log2(s + 1))
        row = s - (2**level - 1)
        level_key = prng.split(tree_keys[t : t + 1], h + 1)[:, level]
        chunk_gumbel, _ = tree_growth._level_draws(level_key, level, 2**h, geom.chunk, geom.n_chunks)
        local = fidx[t].tolist()
        draws = [float(chunk_gumbel(local.index(f) // geom.chunk)[0, row, local.index(f) % geom.chunk]) for f in (a, b)]
        # torch's log and XLA's differ by at most one float32 ulp of
        # max(|g|, 1) a draw (tests/test_torch_prng.py), so a flip needs the
        # two draws within a few such ulps
        unit = float(np.spacing(np.float32(max(abs(draws[0]), abs(draws[1]), 1.0))))
        ulps = abs(draws[0] - draws[1]) / unit
        near_ties.append({"tree": int(t), "slot": int(s), "port_feature": a, "jax_feature": b,
                          "port_draws": draws, "ulps_apart": ulps})
        require(ulps <= 4, f"tree {t} slot {s}: draws {draws} are {ulps} ulps apart, not a near-tie")
    thr = model.outlier_score_threshold
    scores = model.score(X_m, strategy="walk")  # the threshold pass's own kernel
    rank_error = quantile_rank_error(scores, thr, 1.0 - 0.02)
    auc = auroc(scores.cpu().numpy(), y_m)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = str(pathlib.Path(tmp) / "model")
        _, save_s = synced(lambda: model.save(path))
        loaded, load_s = synced(lambda: load_model(path))
        reloaded_equal = bool(torch.equal(loaded.score(X_m, strategy="walk"), scores))
        same_threshold = loaded.outlier_score_threshold == thr
    emit({"phase": "fit_parity", "rows": len(X_m), "trees": model.forest.num_trees,
          "heap_slots": model.forest.max_nodes, "first_fit_s": first_fit_s, "warm_fit_s": warm_fit_s,
          "differing_nodes": int(differ.sum()), "differing_subtrees": near_ties, "threshold": thr,
          "fixture_threshold": fixture_model.outlier_score_threshold, "rank_error": rank_error, "auroc": auc,
          "save_s": save_s, "load_s": load_s, "reloaded_scores_equal": reloaded_equal})
    require(abs(thr - 0.6111048460006714) <= 2e-6, f"fitted threshold {thr}")
    require(rank_error == 0, f"threshold rank error {rank_error}")
    require(0.84 <= auc <= 0.90, f"fitted mammography AUROC {auc}")
    require(reloaded_equal and same_threshold, "the saved and reloaded model scores otherwise")

    # 13. fit_shuttle: continuous-valued data, and K1's staging at its record count
    data = np.loadtxt(SHUTTLE, delimiter=",", comments="#").astype(np.float32)
    X_s, y_s = data[:, :-1], data[:, -1]
    shuttle, shuttle_fit_s = synced(lambda: IsolationForest(contamination=0.07, random_seed=1).fit(X_s))
    invariants(shuttle, X_s)
    shuttle_auc = auroc(shuttle.score(X_s).cpu().numpy(), y_s)
    records = walk.walk_tables(shuttle.forest)
    n_records, f_s = records.records.shape[0], X_s.shape[1]
    # csrc/path_walk.cu launch_staged: the records and a 1,024-row tile in
    # one block's shared memory, two blocks an SM (1 KB reserved each), F <= 48
    block_bytes = n_records * 16 + f_s * 1024 * 4
    props = torch.cuda.get_device_properties(0)
    per_sm = getattr(props, "shared_memory_per_multiprocessor", None)
    optin = getattr(props, "shared_memory_per_block_optin", None)
    stages = (None if per_sm is None or optin is None
              else bool(f_s <= 48 and block_bytes <= optin and 2 * (block_bytes + 1024) <= per_sm))
    X_sb = torch.from_numpy(X_s[np.random.default_rng(SEED).integers(0, len(X_s), FULL_ROWS)]).to(dev)
    shuttle_walk_err = fitted_walk_errors(records, X_sb)
    emit({"phase": "fit_shuttle", "rows": len(X_s), "features": f_s, "fit_s": shuttle_fit_s,
          "auroc": shuttle_auc, "threshold": shuttle.outlier_score_threshold,
          "walk_records": n_records, "staged_block_bytes": block_bytes,
          "shared_memory_per_sm": per_sm, "shared_memory_per_block_optin": optin,
          "bulk_walk_stages_records": stages, "walk_max_abs_err": shuttle_walk_err,
          "walk_ms_1m_rows": time_ms(lambda: walk.walk_sum(X_sb, records), inner=10)})
    require(shuttle_auc > 0.99, f"fitted shuttle AUROC {shuttle_auc}")
    require(all(e == 0.0 for e in shuttle_walk_err.values()), f"walk_sum on the shuttle forest: {shuttle_walk_err}")

    # 14. fit_full_size: 100 trees on the 1M rows (the Floyd sampler), the
    # threshold pass scoring all of them through walk_sum
    ext_path.launches["walk_sum"] = 0
    est = IsolationForest(contamination=0.02, random_seed=1)
    big, big_fit_s = synced(lambda: est.fit(X_big))
    fit_launches = ext_path.launches["walk_sum"]
    require(fit_launches >= 1, "the 1M-row fit's threshold pass did not launch walk_sum")
    Xd = torch.from_numpy(X_big).to(dev)
    invariants(big, X_big)
    big_rank_error = quantile_rank_error(big.score(Xd, strategy="walk"), big.outlier_score_threshold, 1.0 - 0.02)
    require(big_rank_error == 0, f"1M-row threshold rank error {big_rank_error}")
    big_walk_err = fitted_walk_errors(walk.walk_tables(big.forest), Xd)
    require(all(e == 0.0 for e in big_walk_err.values()), f"walk_sum on the 1M-row forest: {big_walk_err}")
    k_bag, k_feat, k_grow = prng.split(prng.PRNGKey(1, device=dev), 3)
    bag = bagging.bagged_indices(k_bag, FULL_ROWS, 256, 100, False)
    fidx_b = bagging.feature_subsets(k_feat, X_big.shape[1], X_big.shape[1], 100)
    keys_b = bagging.per_tree_keys(k_grow, 100)
    parts_ms = {
        "bag_ms": time_ms(lambda: bagging.bagged_indices(k_bag, FULL_ROWS, 256, 100, False), reps=3),
        "growth_ms": time_ms(lambda: tree_growth.grow_forest(keys_b, Xd, bag, fidx_b, 8), reps=3),
        "threshold_pass_ms": time_ms(lambda: _compute_and_set_threshold(big, Xd), reps=3),
        "fit_from_device_rows_ms": time_ms(lambda: est.fit(Xd), reps=3),
    }
    # where a warm fit from rows on the card spends its time
    fit_profile = profile_call(lambda: est.fit(Xd))
    # the same fit at the high-dim width: five 64-feature chunks
    rng = np.random.default_rng(SEED + 1)
    X_h = rng.normal(size=(100_000, 274)).astype(np.float32)
    X_h[:, 70:80] = 1.5  # a constant block in the second chunk
    wide_est = IsolationForest(contamination=0.02, random_seed=2)
    wide, wide_fit_s = synced(lambda: wide_est.fit(X_h))
    _, wide_warm_fit_s = synced(lambda: wide_est.fit(X_h))
    invariants(wide, X_h)
    # growth's widest level: 4,096-row bags (h = 12, W = 4,096) over the five
    # chunks; the Gumbel draws are held one chunk at a time, so the peak
    # is that of one chunk's [T, W, 64] draws, not a level's five
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    deep, deep_fit_s = synced(lambda: IsolationForest(contamination=0.02, random_seed=2, max_samples=4096.0).fit(X_h))
    deep_peak_bytes = torch.cuda.max_memory_allocated() - base_bytes
    invariants(deep, X_h)
    emit({"phase": "fit_full_size", "rows": FULL_ROWS, "features": X_big.shape[1], "trees": 100,
          "sampler": "floyd", "launches": {"walk_sum": fit_launches}, "fit_s": big_fit_s, **parts_ms,
          "fit_profile": fit_profile,
          "threshold": big.outlier_score_threshold, "rank_error": big_rank_error,
          "walk_max_abs_err": big_walk_err,
          "high_dim": {"rows": X_h.shape[0], "features": 274, "fit_s": wide_fit_s, "warm_fit_s": wide_warm_fit_s,
                       "heap_slots": wide.forest.max_nodes, "threshold": wide.outlier_score_threshold},
          "high_dim_4096_samples": {"fit_s": deep_fit_s, "heap_slots": deep.forest.max_nodes,
                                    "peak_allocated_bytes": deep_peak_bytes,
                                    "threshold": deep.outlier_score_threshold}})

    # 15. fit_edges: small seeded fits, each held to growth's invariants
    cases = {
        "bootstrap": ({"bootstrap": True}, None),
        "max_features_half": ({"max_features": 0.5}, None),
        "constant_column": ({}, "constant_column"),
        "all_constant": ({}, "all_constant"),
        "zero_contamination": ({"contamination": 0.0}, None),
        "permutation_300x256": ({"max_samples": 256.0}, "n300"),
        "subsample_trees_half": ({}, "subsample"),
    }
    edges = []
    for name, (kw, data_kind) in cases.items():
        X_e = rng.normal(size=(300 if data_kind == "n300" else 2000, 6)).astype(np.float32)
        if data_kind == "constant_column":
            X_e[:, 2] = 3.0
        elif data_kind == "all_constant":
            X_e[:] = 1.0
        params = {"num_estimators": 20, "max_samples": 64.0, "contamination": 0.05, "random_seed": 3, **kw}
        m = IsolationForest(**params).fit(X_e, subsample_trees=0.5 if data_kind == "subsample" else None)
        fidx_e, _ = fit_keys(3, m.forest.num_trees, 6, m.num_features)
        invariants(m, X_e, fidx_e.cpu().numpy())
        row = {"case": name, "trees": m.forest.num_trees, "num_samples": m.num_samples,
               "num_features": m.num_features, "heap_slots": m.forest.max_nodes,
               "threshold": m.outlier_score_threshold}
        if data_kind == "all_constant":
            require(bool((m.forest.feature == -1).all()) and bool((m.forest.num_instances[:, 0] == 64).all()),
                    "all-constant data: every root must be a 64-row leaf")
        if data_kind == "constant_column":
            require(not bool((m.forest.feature == 2).any()), "the constant column was chosen")
        if name == "zero_contamination":
            require(m.outlier_score_threshold == -1.0, "contamination 0 set a threshold")
        if data_kind == "n300":
            k_bag_e = prng.split(prng.PRNGKey(3, device=dev), 3)[0]
            bags = bagging.bagged_indices(k_bag_e, 300, 256, 20, False)
            row["bags_distinct"] = bool((bags.sort(dim=1).values.diff(dim=1) > 0).all())
            require(row["bags_distinct"], "the permutation sampler repeated a row")
        if data_kind == "subsample":
            require(m.forest.num_trees == 10 and m.params.num_estimators == 10, "subsample_trees=0.5 of 20")
        edges.append(row)
    emit({"phase": "fit_edges", "cases": edges, "fit_phases_s": time.perf_counter() - phases_t0})
    return fit_launches


def eif_fit_phases(dev, X_m, y_m, X_big) -> int:
    """Phases 16-19 (fit of the extended forest); returns the threshold
    pass's ``ext_walk_sum`` launches in the 1M-row EIF fit."""
    import tempfile

    import numpy as np
    import torch

    from isoforest_tpu_torch import ExtendedIsolationForest, load_model
    from isoforest_tpu_torch.models.isolation_forest import _compute_and_set_threshold
    from isoforest_tpu_torch.ops import bagging, ext_dense, ext_growth, ext_path, ext_walk, prng
    from isoforest_tpu_torch.ops.level_window import chunk_features
    from isoforest_tpu_torch.ops.quantile import quantile_rank_error
    from isoforest_tpu_torch.testing import extended_growth_invariant_errors
    from isoforest_tpu_torch.utils.math import height_limit

    def invariants(model, X, allowed=None) -> None:
        errors = extended_growth_invariant_errors(*(a.cpu().numpy() for a in model.forest), X, model.num_samples,
                                                  allowed)
        require(not errors, f"EIF growth invariants: {errors}")

    def path_errors(name, forest, X, small_rows=4096) -> dict:
        """Path kernel ``name`` on a fitted forest against its plain version:
        the bulk launch over ``X``, the small-batch launch over its first
        ``small_rows`` rows. The plain walk goes 32 trees side by side, to the
        same sum in tree order as one tree at a time."""
        if name == "ext_walk_sum":
            tables = ext_walk.walk_tables_extended(forest)
            want = ext_path.path_sum_plain(X, tables, paired=1 < forest.k <= ext_path.PAIRED_MAX_K, mean=False,
                                           tree_parallel=True)
        else:
            tables = ext_dense.sparse_path_records(forest)
            want = ext_dense.ext_sparse_mean_plain(X, ext_dense.sparse_hyperplane_tables(forest))
        bulk = ext_path.launch(name, X, tables, tree_parallel=False)
        small = ext_path.launch(name, X[:small_rows], tables, tree_parallel=True)
        return {"bulk": float((bulk - want).abs().max()), "small_batch": float((small - want[:small_rows]).abs().max())}

    def fit_keys(seed, n_rows, n_trees, n_feats_total, n_feats, n_samples):
        """The fit's bags, feature subsets and per-tree growth keys, re-derived."""
        k_bag, k_feat, k_grow = prng.split(prng.PRNGKey(seed, device=dev), 3)
        return (bagging.bagged_indices(k_bag, n_rows, n_samples, n_trees, False),
                bagging.feature_subsets(k_feat, n_feats_total, n_feats, n_trees),
                bagging.per_tree_keys(k_grow, n_trees))

    phases_t0 = time.perf_counter()
    # 16. eif_fit_parity: the committed EIF fixture's own fit, on the card
    fixture = load_model(str(EIF_FIXTURE / "model"))
    est = ExtendedIsolationForest(contamination=0.02, random_seed=1)
    model, first_fit_s = synced(lambda: est.fit(X_m))
    _, warm_fit_s = synced(lambda: est.fit(X_m))
    require(model.device.type == "cuda" and model.extension_level == 5, f"EIF fit on {model.device}")
    got = [a.cpu().numpy() for a in model.forest]
    want = [a.cpu().numpy() for a in fixture.forest]
    require(all(g.shape == w.shape for g, w in zip(got, want)), "EIF forest shapes differ from the fixture's")
    differ = (got[0] != want[0]).any(axis=2) | (got[3] != want[3])
    value_ulps = np.maximum(
        np.abs(got[1].view(np.int32).astype(np.int64) - want[1].view(np.int32)).max(axis=2),
        np.abs(got[2].view(np.int32).astype(np.int64) - want[2].view(np.int32)))
    value_ulps[differ] = 0
    h = height_limit(model.num_samples)
    bag, fidx, tree_keys = fit_keys(1, len(X_m), 100, X_m.shape[1], model.num_features, model.num_samples)
    geom = chunk_features(torch.zeros(1, model.num_features))
    Xm_dev = torch.from_numpy(X_m).to(dev)
    idx_t, w_t, off_t = model.forest.indices.long(), model.forest.weights, model.forest.offset
    explained = []
    for t, s in zip(*np.nonzero(differ)):
        if s > 0 and differ[t, (s - 1) // 2]:
            continue  # inside a differing subtree: its root explains it
        if (got[0][t, s] != want[0][t, s]).any() and got[0][t, s, 0] >= 0 and want[0][t, s, 0] >= 0:
            # another subspace on the same samples: the Gumbel top-k's k-th
            # and (k+1)-th draws of the port must tie within a few ulps
            level, row = int(np.log2(s + 1)), int(s - (2 ** int(np.log2(s + 1)) - 1))
            level_key = prng.split(tree_keys[t : t + 1], h + 1)[:, level]
            chunk_gumbel, _, _ = ext_growth._level_draws(level_key, level, 2**h, geom.chunk, geom.n_chunks,
                                                         model.forest.k)
            g = torch.cat([chunk_gumbel(c)[0, row] for c in range(geom.n_chunks)])[: model.num_features]
            top = torch.sort(g, descending=True).values.cpu().numpy()
            kth = top[model.forest.k - 1 : model.forest.k + 1]
            unit = float(np.spacing(np.float32(max(np.abs(kth).max(), 1.0))))
            ulps = float(abs(kth[0] - kth[1]) / unit)
            explained.append({"tree": int(t), "slot": int(s), "why": "gumbel_top_k_near_tie",
                              "draws": kth.tolist(), "ulps_apart": ulps})
            require(ulps <= 4, f"tree {t} slot {s}: subspace flip with draws {ulps} ulps apart")
            continue
        # other samples reached this slot: its parent routed a row by a hair
        parent = (s - 1) // 2
        require(s > 0, f"tree {t}: the root differs with the same subspace")
        x = Xm_dev[bag[t].long()]
        node = torch.zeros(x.shape[0], dtype=torch.long, device=dev)
        for _ in range(int(np.log2(parent + 1))):
            inside = idx_t[t, node, 0] >= 0
            dot = ext_growth.row_dot(x.gather(1, idx_t[t, node].clamp(min=0)), w_t[t, node], "dot")
            node = torch.where(inside, 2 * node + 1 + (dot >= off_t[t, node]).long(), node)
        rows = x[node == parent]
        dots = ext_growth.row_dot(rows.gather(1, idx_t[t, parent].clamp(min=0).expand(rows.shape[0], -1)),
                                  w_t[t, parent].expand(rows.shape[0], -1), "dot")
        off = float(off_t[t, parent])
        margin = float((dots - off).abs().min()) if rows.shape[0] else float("inf")
        ulps = margin / float(np.spacing(np.float32(max(abs(off), 1.0))))
        explained.append({"tree": int(t), "slot": int(s), "why": "routing_margin_at_parent",
                          "parent_offset": off, "min_abs_dot_minus_offset": margin, "ulps": ulps})
        require(ulps <= 4, f"tree {t} slot {s}: parent {parent} routes no row within 4 ulps of its offset")
    require(int(value_ulps.max()) <= 2, f"EIF weights/offsets {int(value_ulps.max())} ulps from the fixture's")
    equal = not differ.any()
    thr = model.outlier_score_threshold
    parity = {"phase": "eif_fit_parity", "rows": len(X_m), "trees": model.forest.num_trees, "k": model.forest.k,
              "heap_slots": model.forest.max_nodes, "first_fit_s": first_fit_s, "warm_fit_s": warm_fit_s,
              "differing_nodes": int(differ.sum()), "differing_subtrees": explained,
              "nodes_with_other_weight_or_offset_bits": int((value_ulps > 0).sum()),
              "threshold": thr, "fixture_threshold": fixture.outlier_score_threshold,
              "rank_error": quantile_rank_error(model.score(X_m, strategy="walk"), thr, 1.0 - 0.02)}
    require(abs(thr - 0.6251140236854553) <= 2e-6, f"fitted EIF threshold {thr}")
    require(parity["rank_error"] == 0, f"EIF threshold rank error {parity['rank_error']}")
    gather_auc = auroc(np.load(EIF_FIXTURE / "jax_scores.npy"), y_m)
    for strategy, own_file in (("walk", "jax_walk_scores.npy"), ("dense", "jax_pallas_scores.npy")):
        s = model.score(X_m, strategy=strategy).cpu().numpy()
        err = float(np.abs(s - np.load(EIF_FIXTURE / own_file)).max())
        auc = auroc(s, y_m)
        parity[strategy] = {"counterpart": own_file, "max_abs_err": err, "auroc": auc}
        require(np.isfinite(s).all() and s.shape == (len(X_m),), f"EIF fit {strategy}: bad scores")
        require(not equal or err <= 2e-6, f"EIF fit {strategy}: {err} from {own_file}")
        require(abs(auc - gather_auc) <= 1e-3, f"EIF fit {strategy}: AUROC {auc} vs the fixture's {gather_auc}")
    parity["kernel_vs_plain"] = {name: path_errors(name, model.forest, Xm_dev)
                                 for name in ("ext_walk_sum", "ext_sparse_mean")}
    require(all(v == 0.0 for e in parity["kernel_vs_plain"].values() for v in e.values()),
            f"a path kernel on the fitted EIF: {parity['kernel_vs_plain']}")
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = str(pathlib.Path(tmp) / "model")
        _, parity["save_s"] = synced(lambda: model.save(path))
        loaded, parity["load_s"] = synced(lambda: load_model(path))
        parity["reloaded_scores_equal"] = bool(torch.equal(loaded.score(X_m), model.score(X_m)))
        require(parity["reloaded_scores_equal"] and loaded.outlier_score_threshold == thr
                and loaded.extension_level == 5, "the saved and reloaded EIF scores otherwise")
    emit(parity)

    # 17. eif_fit_full_size: 100 trees on the 1M rows at k = 6, the
    # threshold pass scoring all of them through ext_walk_sum
    ext_path.launches["ext_walk_sum"] = 0
    big, big_fit_s = synced(lambda: est.fit(X_big))
    fit_launches = ext_path.launches["ext_walk_sum"]
    require(fit_launches >= 1, "the 1M-row EIF fit's threshold pass did not launch ext_walk_sum")
    Xd = torch.from_numpy(X_big).to(dev)
    invariants(big, X_big)
    big_rank_error = quantile_rank_error(big.score(Xd, strategy="walk"), big.outlier_score_threshold, 1.0 - 0.02)
    require(big_rank_error == 0, f"1M-row EIF threshold rank error {big_rank_error}")
    big_err = path_errors("ext_walk_sum", big.forest, Xd[:65_536])
    require(all(v == 0.0 for v in big_err.values()), f"ext_walk_sum on the 1M-row EIF: {big_err}")
    bag_b, fidx_b, keys_b = fit_keys(1, FULL_ROWS, 100, X_big.shape[1], X_big.shape[1], 256)
    k_bag = prng.split(prng.PRNGKey(1, device=dev), 3)[0]
    wt_big = ext_walk.walk_tables_extended(big.forest)
    parts_ms = {
        "bag_ms": time_ms(lambda: bagging.bagged_indices(k_bag, FULL_ROWS, 256, 100, False), reps=3, warmup=1),
        "growth_ms": time_ms(lambda: ext_growth.grow_extended_forest(keys_b, Xd, bag_b, fidx_b, 8, 5),
                             reps=3, warmup=1),
        "threshold_pass_ms": time_ms(lambda: _compute_and_set_threshold(big, Xd), reps=3, warmup=1),
        "fit_from_device_rows_ms": time_ms(lambda: est.fit(Xd), reps=3, warmup=1),
        "ext_walk_sum_ms_1m_rows": time_ms(lambda: ext_walk.ext_walk_sum(Xd, wt_big), inner=10),
    }
    fit_profile = profile_call(lambda: est.fit(Xd))
    emit({"phase": "eif_fit_full_size", "rows": FULL_ROWS, "features": X_big.shape[1], "trees": 100,
          "k": big.forest.k, "launches": {"ext_walk_sum": fit_launches}, "fit_s": big_fit_s, **parts_ms,
          "fit_profile": fit_profile, "threshold": big.outlier_score_threshold, "rank_error": big_rank_error,
          "walk_records": int(wt_big.records.shape[0]), "ext_walk_sum_max_abs_err_65536": big_err})

    # 18. eif_fit_high_dim: 100,000 seeded rows x 274, fully extended (k =
    # 274 over five 64-feature chunks, a constant block in the second)
    rng = np.random.default_rng(SEED + 2)
    X_h = rng.normal(size=(HIGH_DIM_FIT_ROWS, 274)).astype(np.float32)
    X_h[:, 70:80] = 1.5
    wide_est = ExtendedIsolationForest(contamination=0.02, random_seed=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    wide, wide_fit_s = synced(lambda: wide_est.fit(X_h))
    peak_bytes = torch.cuda.max_memory_allocated() - base_bytes
    _, wide_warm_fit_s = synced(lambda: wide_est.fit(X_h))
    require(wide.forest.k == 274, f"the F = 274 EIF has k = {wide.forest.k}")
    invariants(wide, X_h)
    Xh = torch.from_numpy(X_h[:4096]).to(dev)
    wide_walk_err = path_errors("ext_walk_sum", wide.forest, Xh)
    dt = ext_dense.dense_hyperplane_table(wide.forest)
    ext_dense.ext_dense_mean.launches = 0
    dense_scores = wide.score(Xh, strategy="dense")
    require(ext_dense.ext_dense_mean.launches >= 1 and bool(torch.isfinite(dense_scores).all()),
            "the F = 274 EIF's dense scoring did not launch ext_dense_mean")
    dense_err = float((ext_dense.ext_dense_mean(Xh, dt) - ext_dense.ext_dense_mean_plain(Xh, dt)).abs().max())
    require(all(v == 0.0 for v in wide_walk_err.values()) and dense_err == 0.0,
            f"K3/K5 on the F = 274 EIF: {wide_walk_err}, {dense_err}")
    emit({"phase": "eif_fit_high_dim", "rows": X_h.shape[0], "features": 274, "k": wide.forest.k, "trees": 100,
          "fit_s": wide_fit_s, "warm_fit_s": wide_warm_fit_s, "peak_allocated_bytes": peak_bytes,
          "heap_slots": wide.forest.max_nodes, "threshold": wide.outlier_score_threshold,
          "ext_walk_sum_max_abs_err_4096": wide_walk_err, "ext_dense_mean_max_abs_err_4096": dense_err})

    # 19. eif_fit_edges: small seeded fits, each held to growth's invariants
    cases = {
        "extension_level_0": ({"extension_level": 0}, None),
        "max_features_half": ({"max_features": 0.5}, None),
        "constant_column": ({}, "constant_column"),
        "all_constant": ({}, "all_constant"),
        "zero_contamination": ({"contamination": 0.0}, None),
        "bootstrap": ({"bootstrap": True}, None),
        "permutation_300x256": ({"max_samples": 256.0}, "n300"),
        "subsample_trees_half": ({}, "subsample"),
    }
    edges = []
    for name, (kw, data_kind) in cases.items():
        X_e = rng.normal(size=(300 if data_kind == "n300" else 2000, 6)).astype(np.float32)
        if data_kind == "constant_column":
            X_e[:, 2] = 3.0
        elif data_kind == "all_constant":
            X_e[:] = 1.0
        params = {"num_estimators": 20, "max_samples": 64.0, "contamination": 0.05, "random_seed": 3, **kw}
        m = ExtendedIsolationForest(**params).fit(X_e, subsample_trees=0.5 if data_kind == "subsample" else None)
        _, fidx_e, _ = fit_keys(3, len(X_e), m.forest.num_trees, 6, m.num_features, m.num_samples)
        invariants(m, X_e, fidx_e.cpu().numpy())
        row = {"case": name, "trees": m.forest.num_trees, "num_samples": m.num_samples, "k": m.forest.k,
               "num_features": m.num_features, "heap_slots": m.forest.max_nodes,
               "threshold": m.outlier_score_threshold}
        if name == "extension_level_0":
            w0 = m.forest.weights[..., 0][m.forest.is_internal]
            require(m.forest.k == 1 and bool((w0.abs() == 1.0).all()), "extension level 0 is not axis-aligned")
        if data_kind == "all_constant":
            # every row ties every offset and goes right: a chain of empty left leaves
            ni = m.forest.num_instances.cpu().numpy()
            row["empty_leaves"] = int((ni == 0).sum())
            require(row["empty_leaves"] == 20 * height_limit(64) and bool((ni[:, 2**7 - 2] == 64).all()),
                    "all-constant data did not grow a chain of empty left leaves")
        if name == "zero_contamination":
            require(m.outlier_score_threshold == -1.0, "contamination 0 set a threshold")
        if data_kind == "subsample":
            require(m.forest.num_trees == 10 and m.params.num_estimators == 10, "subsample_trees=0.5 of 20")
        edges.append(row)
    emit({"phase": "eif_fit_edges", "cases": edges, "eif_fit_phases_s": time.perf_counter() - phases_t0})
    return fit_launches


def _edge_rows(jax_scores) -> int:
    """Rows whose JAX score lies within 2e-6 of a score bin edge ``j / 64``:
    the port's walk sums in another order, so only these may change bins."""
    import numpy as np

    s = np.asarray(jax_scores, np.float64) * 64
    return int((np.abs(s - np.round(s)) <= 2e-6 * 64).sum())


def _sync_offsets(part) -> list:
    """Where an Avro container's sync markers start (one after each block)."""
    raw = pathlib.Path(part).read_bytes()
    sync = raw[-16:]
    return [i for i in range(len(raw) - 15) if raw.startswith(sync, i)]


def model_phases(dev, X_m, X_big) -> None:
    """Phases 20-23: the drift baseline, the monitor, the checkpointed fit
    and the tolerant load, each path driven with its kernel's launch count
    set to 0 just before and read just after."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from isoforest_tpu_torch import ExtendedIsolationForest, IsolationForest, load_model
    from isoforest_tpu_torch.io import avro
    from isoforest_tpu_torch.models.isolation_forest import _capture_fit_baseline
    from isoforest_tpu_torch.ops import ext_path, ext_walk, walk
    from isoforest_tpu_torch.resilience import checkpoint as ckpt
    from isoforest_tpu_torch.resilience import faults, manifest
    from isoforest_tpu_torch.telemetry import monitor as mon

    kinds = {"standard": (IsolationForest, FIXTURE, "walk_sum"),
             "extended": (ExtendedIsolationForest, EIF_FIXTURE, "ext_walk_sum")}

    def same_forest(a, b) -> bool:
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a.forest, b.forest))

    def path_kernel_errors(kernel, forest, X) -> dict:
        """The path kernel against its plain version on ``X``, with its bulk
        and its small-batch launch (not counted on the main path: callers
        read their counts before)."""
        if kernel == "walk_sum":
            tables = walk.walk_tables(forest)
            return {mode: float((ext_path.launch(kernel, X, tables, tree_parallel=small)
                                 - walk.walk_sum_plain(X, tables, tree_parallel=small)).abs().max())
                    for mode, small in (("bulk", False), ("small_batch", True))}
        tables = ext_walk.walk_tables_extended(forest)
        want = ext_path.path_sum_plain(X, tables, paired=1 < forest.k <= ext_path.PAIRED_MAX_K, mean=False,
                                       tree_parallel=True)
        return {mode: float((ext_path.launch(kernel, X, tables, tree_parallel=small) - want).abs().max())
                for mode, small in (("bulk", False), ("small_batch", True))}

    phases_t0 = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=build))
    try:
        # 20. baseline: the fixtures' own fits against their committed
        # sidecars, a save and reload, and the 1M-row fit with and without
        # capture (the capture launches the path kernel once more)
        out = {"phase": "baseline"}
        for kind, (cls, fixture, kernel) in kinds.items():
            model = cls(contamination=0.02, random_seed=1).fit(X_m)
            got = model.baseline.as_dict()
            want = json.loads((fixture / "model" / mon.BASELINE_NAME).read_text())
            moved = int(np.abs(np.array(got["score"]["counts"]) - np.array(want["score"]["counts"])).sum()) // 2
            edge_rows = _edge_rows(np.load(fixture / "jax_scores.npy"))
            quantile_err = max(abs(got["scoreQuantiles"][k] - want["scoreQuantiles"][k]) for k in want["scoreQuantiles"])
            require(got["features"] == want["features"], f"{kind}: the fit's feature baselines differ from the sidecar's")
            require(moved <= edge_rows, f"{kind}: {moved} score rows changed bins, only {edge_rows} lie at an edge")
            require(quantile_err <= 2e-6, f"{kind}: score quantiles {quantile_err} from the sidecar's")
            path = tmp / f"baseline_{kind}"
            model.save(str(path))
            listed = mon.BASELINE_NAME in json.loads((path / manifest.MANIFEST_NAME).read_text())["files"]
            reloaded = load_model(str(path)).baseline == model.baseline
            require(listed and reloaded, f"{kind}: the saved baseline did not come back sealed and equal")
            est = cls(contamination=0.02, random_seed=1)
            launches, fit_s = {}, {}
            for flag in (True, False):
                ext_path.launches[kernel] = 0
                big, fit_s[flag] = synced(lambda: est.fit(X_big, baseline=flag))
                launches[flag] = ext_path.launches[kernel]
                require((big.baseline is not None) == flag, f"{kind}: baseline={flag} was not honoured")
            require(launches[True] == launches[False] + 1 >= 2,
                    f"{kind}: {kernel} launches with and without capture: {launches}")
            Xd = torch.from_numpy(X_big).to(dev)
            capture_s = [synced(lambda: _capture_fit_baseline(big, Xd))[1] for _ in range(7)]
            out[kind] = {"kernel": kernel, "moved_score_rows": moved, "edge_rows": edge_rows,
                         "quantile_max_abs_err": quantile_err, "sidecar_in_manifest": listed,
                         "reloaded_equal": reloaded, "launches_1m_fit": {"with_capture": launches[True],
                                                                          "without_capture": launches[False]},
                         "fit_1m_s": {"with_capture": fit_s[True], "without_capture": fit_s[False]},
                         "capture_1m_ms_median": statistics.median(capture_s) * 1e3,
                         "captured_rows": big.baseline.captured_rows}
        emit(out)

        # 21. monitor: the fixtures served on the card with monitoring on
        out = {"phase": "monitor"}
        rng = np.random.default_rng(SEED + 3)
        odd = X_m.copy()
        odd[rng.integers(0, len(odd), 500), rng.integers(0, odd.shape[1], 500)] = rng.choice(
            [np.nan, np.inf, -np.inf, 1e30], 500)
        for kind, (cls, fixture, kernel) in kinds.items():
            model = load_model(str(fixture / "model"))
            monitor = model.enable_monitoring()
            ext_path.launches[kernel] = 0
            model.score(X_m, strategy="walk")
            launched = ext_path.launches[kernel]
            trained = monitor.report()
            require(launched >= 1, f"{kind}: the monitored score did not launch {kernel}")
            require(trained["score"]["psi"] < 0.1 and not trained["drifted"],
                    f"{kind}: the training rows drifted: {trained}")
            model.score(X_m * 3 + 5)
            first, drift = monitor.report(), monitor.drift()
            crossed = ["score"] * (drift["score"]["psi"] > monitor.threshold) + [
                f"feature:{i}" for i, v in drift["features"].items() if v > monitor.feature_threshold]
            model.score(X_m * 3 + 5)
            second = monitor.report()
            require("score" in crossed and sorted(a["stream"] for a in first["alerts"]) == sorted(crossed),
                    f"{kind}: alerts {first['alerts']} for crossings {crossed}")
            require(second["alerts"] == first["alerts"], f"{kind}: a second shifted batch alerted again")
            gauge = mon._SCORE_DRIFT_PSI.value()
            require(gauge > monitor.threshold, f"{kind}: the score PSI gauge reads {gauge}")
            # the card's fold against the CPU's, on the same values
            card = mon.ScoreMonitor(model.baseline, min_rows=1, ladder=False)
            host = mon.ScoreMonitor(model.baseline, min_rows=1, ladder=False)
            for batch in (X_m, X_m * 3 + 5, odd, X_big[:70_000]):
                xd = torch.from_numpy(np.ascontiguousarray(batch)).to(dev)
                sd = model.score(xd, nonfinite="allow", fold_monitor=False)
                card.observe(sd, xd)
                host.observe(sd.cpu(), xd.cpu())
            fold_equal = bool(np.array_equal(card._score_counts, host._score_counts)
                              and np.array_equal(card._feature_counts, host._feature_counts))
            require(fold_equal, f"{kind}: the card's fold differs from the CPU's")
            latency = {}
            for rows in (1, 64, 4096, FULL_ROWS):
                batch = X_big[:rows]
                for on in (True, False):
                    if on:
                        model.enable_monitoring()
                    else:
                        model.disable_monitoring()
                    for _ in range(3):
                        model.score(batch)
                    lat = []
                    for _ in range(21):
                        t0 = time.perf_counter()
                        model.score(batch).cpu()
                        lat.append((time.perf_counter() - t0) * 1e3)
                    latency[f"{'on' if on else 'off'}_{rows}"] = statistics.median(lat)
            # where a monitored 1-row call spends its time, against an
            # unmonitored one (the monitor is off after the loop above)
            one_row = {"off": profile_call(lambda: model.score(X_big[:1]).cpu(), host_top=8)}
            model.enable_monitoring()
            one_row["on"] = profile_call(lambda: model.score(X_big[:1]).cpu(), host_top=8)
            model.disable_monitoring()
            out[kind] = {"kernel_launches": launched, "training": {"score_psi": trained["score"]["psi"],
                                                                   "features_psi": trained["features"]},
                         "shifted_alerts": first["alerts"], "second_batch_new_alerts": len(second["alerts"])
                         - len(first["alerts"]), "score_psi_gauge": gauge, "card_fold_equals_cpu": fold_equal,
                         "latency_median_ms": latency, "one_row_profile": one_row}
        emit(out)

        # 22. checkpoint: checkpointed and killed-then-resumed fits against
        # the plain fit, the 1M rows (standard) and the mammography EIF
        out = {"phase": "checkpoint"}
        seal_s = []
        seal_block = ckpt.FitCheckpoint.seal_block

        def timed_seal(self, *args, **kw):
            t0 = time.perf_counter()
            seal_block(self, *args, **kw)
            seal_s.append(time.perf_counter() - t0)

        ckpt.FitCheckpoint.seal_block = timed_seal
        try:
            for kind, X in (("standard", X_big), ("extended", X_m)):
                cls, _, kernel = kinds[kind]
                est = cls(contamination=0.02, random_seed=1)
                plain, plain_s = synced(lambda: est.fit(X))
                _, plain_s = synced(lambda: est.fit(X))
                del seal_s[:]
                ext_path.launches[kernel] = 0
                model, ck_s = synced(lambda: est.fit(X, checkpoint_dir=str(tmp / f"ck_{kind}"), checkpoint_every=32))
                launched = ext_path.launches[kernel]
                seals = list(seal_s)
                killed = False
                try:
                    with faults.inject(kill_fit_after_block=1):
                        est.fit(X, checkpoint_dir=str(tmp / f"kill_{kind}"), checkpoint_every=32)
                except faults.FaultInjectedError:
                    killed = True
                resumed, resume_s = synced(lambda: est.fit(X, checkpoint_dir=str(tmp / f"kill_{kind}"),
                                                           checkpoint_every=32, resume=True))
                Xd = torch.from_numpy(X).to(dev)
                _, fingerprint_s = synced(lambda: ckpt.data_fingerprint(Xd.cpu().numpy()))
                equal = same_forest(model, plain) and model.outlier_score_threshold == plain.outlier_score_threshold
                resumed_equal = (same_forest(resumed, plain)
                                 and resumed.outlier_score_threshold == plain.outlier_score_threshold)
                require(launched >= 1, f"{kind}: the checkpointed fit did not launch {kernel}")
                require(equal and killed and resumed_equal, f"{kind}: checkpointed {equal}, killed {killed}, "
                        f"resumed {resumed_equal}")
                require(resumed.fit_checkpoint.blocks_loaded == 2, f"{kind}: resumed {resumed.fit_checkpoint.blocks_loaded}")
                out[kind] = {"rows": len(X), "trees": model.forest.num_trees, "blocks": len(seals),
                             "kernel_launches": launched, "equal_to_plain": equal, "resumed_equal_to_plain": resumed_equal,
                             "plain_fit_s": plain_s, "checkpointed_fit_s": ck_s, "resumed_fit_s": resume_s,
                             "seal_s": seals, "data_fingerprint_s": fingerprint_s}
        finally:
            ckpt.FitCheckpoint.seal_block = seal_block
        emit(out)

        # 23. tolerant_load: a fixture copy in 1,000-record blocks, one sync
        # marker flipped as it is read, loaded on the card and on the CPU
        out = {"phase": "tolerant_load"}
        Xd = torch.from_numpy(X_m).to(dev)
        for kind, (cls, fixture, kernel) in kinds.items():
            path = tmp / f"drop_{kind}"
            shutil.copytree(fixture / "model", path)
            part = next((path / "data").glob("*.avro"))
            schema, records = avro.read_container(str(part))
            avro.write_container(str(part), schema, records, block_records=1000)
            manifest.write(str(path))
            armed = dict(corrupt_avro=str(_sync_offsets(part)[3]))
            with faults.inject(**armed):
                card = load_model(str(path), on_corrupt="drop")
                host = load_model(str(path), device="cpu", on_corrupt="drop")
                try:
                    load_model(str(path))
                    refused = False
                except ValueError:
                    refused = True
            report = card.load_report.as_dict()
            require(report == host.load_report.as_dict() and report["dropped_tree_ids"] and refused,
                    f"{kind}: reports {report} / {host.load_report.as_dict()}, strict load refused: {refused}")
            ext_path.launches[kernel] = 0
            scores = card.score(Xd, strategy="walk")
            launched = ext_path.launches[kernel]
            cpu_err = float((scores.cpu() - host.score(X_m, strategy="walk")).abs().max())
            kernel_err = path_kernel_errors(kernel, card.forest, Xd)
            require(launched >= 1, f"{kind}: the salvaged model's score did not launch {kernel}")
            require(all(v == 0.0 for v in kernel_err.values()) and cpu_err <= 2e-6,
                    f"{kind}: salvaged {kernel} vs plain {kernel_err}, vs CPU {cpu_err}")
            out[kind] = {"kept_trees": report["kept_trees"], "dropped_tree_ids": report["dropped_tree_ids"],
                         "issues": report["issues"][:3], "strict_load_refused": refused, "kernel_launches": launched,
                         "kernel_vs_plain": kernel_err, "max_abs_err_vs_cpu": cpu_err}
        out["model_phases_s"] = time.perf_counter() - phases_t0
        emit(out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


SWEEP_CHUNKS = (1 << 17, 1 << 18, 1 << 19, 1 << 20)
WATCHDOG_DEADLINE_S = 0.5
WATCHDOG_SLACK_S = 0.5  # how late the timeout may surface past its deadline


def wall_ms(fns: dict, reps: int = 15, warmups: int = 2) -> dict:
    """Median host-clock ms of each ``fns[name]()`` between synchronisations,
    after ``warmups`` warm-ups, the calls taken in turns so that the host's
    noise spreads over all of them."""
    import torch

    for fn in fns.values():
        for _ in range(warmups):
            fn()
    lat = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            lat[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(v) for name, v in lat.items()}


def executor_phases(dev, X_m, X_big) -> None:
    """Phases 24-27: the streaming executor, the autotuner, the scoring
    watchdog and the spans, on both fixture models and the 1M rows."""
    import threading

    import numpy as np
    import torch

    from isoforest_tpu_torch import load_model, telemetry, tuning
    from isoforest_tpu_torch.ops import dense, streaming
    from isoforest_tpu_torch.resilience import faults, watchdog
    from isoforest_tpu_torch.resilience.degradation import degradation_report, degradations
    from isoforest_tpu_torch.telemetry import spans

    telemetry.enable()
    fixtures = {"standard": FIXTURE, "extended": EIF_FIXTURE}
    models = {kind: load_model(str(path / "model")) for kind, path in fixtures.items()}
    fallbacks = degradation_report().count("pipeline_fallback")
    Xd = torch.from_numpy(X_big).to(dev)
    X_rev = np.ascontiguousarray(X_big[::-1])
    ragged = np.concatenate([X_big, X_big[:3]])
    default_chunk = streaming.resolve_chunk_rows(None, "cuda")
    chunks = sorted(set(SWEEP_CHUNKS) | {default_chunk})

    # 24. streaming: every variant against one launch over rows on the card
    out = {"phase": "streaming", "rows": FULL_ROWS, "default_chunk_rows": default_chunk}
    singles = {}
    for kind, model in models.items():
        for strategy in ("walk", "dense"):
            single = singles[kind, strategy] = model.score(Xd, strategy=strategy, chunk_size=FULL_ROWS + 3)
            single_rev = model.score(torch.from_numpy(X_rev).to(dev), strategy=strategy, chunk_size=FULL_ROWS + 3)
            for chunk in chunks:
                for pipe in (True, False):
                    got = model.score(X_big, strategy=strategy, chunk_size=chunk, pipeline=pipe)
                    require(torch.equal(got, single), f"{kind} {strategy}: chunk {chunk} pipeline={pipe} "
                            f"differs by {float((got - single).abs().max())}")
            tail = model.score(ragged, strategy=strategy)
            require(torch.equal(tail[:FULL_ROWS], single) and torch.equal(tail[FULL_ROWS:], single[:3]),
                    f"{kind} {strategy}: the ragged 1,000,003 rows differ")
            require(torch.equal(model.score(Xd, strategy=strategy), single), f"{kind} {strategy}: resident rows differ")
            # hazards 1-2: two streamed calls on different rows, no synchronisation between
            got_a = model.score(X_big, strategy=strategy)
            got_b = model.score(X_rev, strategy=strategy)
            require(torch.equal(got_a, single) and torch.equal(got_b, single_rev),
                    f"{kind} {strategy}: back-to-back streamed calls differ")
            variants = {f"chunk_{chunk}_{'pipelined' if pipe else 'sync'}_ms":
                        (lambda chunk=chunk, pipe=pipe: model.score(X_big, strategy=strategy, chunk_size=chunk,
                                                                    pipeline=pipe))
                        for chunk in chunks for pipe in (True, False)}
            variants["resident_default_chunk_ms"] = lambda: model.score(Xd, strategy=strategy)
            times = wall_ms(variants)
            model.score(X_big, strategy=strategy)
            out[f"{kind}_{strategy}"] = {**times, "pipeline_stats": streaming.pipeline_stats()}
    # a trace taken while the card's memory is full of cached blocks can miss
    # device activity: hand the cache back first
    torch.cuda.empty_cache()
    # hazard 3: the first streamed call allocates the pinned buffers, the second reuses them
    with streaming._STAGING_LOCK:
        for staging in streaming._STAGING.values():
            staging.quiesce()
        streaming._STAGING.clear()
    std = models["standard"]
    out["first_call_ms"] = synced(lambda: std.score(X_big, strategy="walk"))[1] * 1e3
    out["second_call_ms"] = synced(lambda: std.score(X_big, strategy="walk"))[1] * 1e3
    out["profile"] = {f"{kind}_{strategy}_{'pipelined' if pipe else 'sync'}":
                      profile_call(lambda m=m, strategy=strategy, pipe=pipe: m.score(X_big, strategy=strategy,
                                                                                     pipeline=pipe))
                      for kind, m in models.items() for strategy in ("walk", "dense") for pipe in (True, False)}
    # hazard 6: a monitored streamed call folds what a monitored pipeline=False call folds
    folds = {}
    for kind, path in fixtures.items():
        counts = []
        for pipe in (True, False):
            m = load_model(str(path / "model"))
            monitor = m.enable_monitoring()
            m.score(X_big, pipeline=pipe)
            counts.append((monitor._score_counts.copy(), np.array(monitor._feature_counts), monitor.drift()["rows"]))
        folds[kind] = bool(np.array_equal(counts[0][0], counts[1][0]) and np.array_equal(counts[0][1], counts[1][1])
                           and counts[0][2] == counts[1][2] == FULL_ROWS)
        require(folds[kind], f"{kind}: the streamed call folded otherwise than pipeline=False")
    out["monitor_folds_equal"] = folds
    out["pipeline_fallbacks"] = degradation_report().count("pipeline_fallback") - fallbacks
    require(out["pipeline_fallbacks"] == 0, "a pipeline_fallback was recorded on the card")
    emit(out)

    # 25. autotune: cold, then warm, per fixture and bucket, on a fresh table
    os.environ["ISOFOREST_TPU_AUTOTUNE_PATH"] = str(ROOT / "build" / f"autotune_phase_{os.getpid()}.json")
    tuning.reset_cost_model()
    # q16 equals the gather walk, whose JAX scores are each fixture's jax_scores.npy
    counterparts = {"standard": {"walk": "jax_scores.npy", "dense": "jax_scores.npy", "q16": "jax_scores.npy"},
                    "extended": {"walk": "jax_walk_scores.npy", "dense": "jax_pallas_scores.npy",
                                 "q16": "jax_scores.npy"}}
    out = {"phase": "autotune"}
    for kind, model in models.items():
        rows, probed = {}, set()
        for n in (1, 64, 4096, FULL_ROWS, len(X_m)):
            batch = X_m if n == len(X_m) else X_big[:n]
            cold, cold_s = synced(lambda: tuning.resolve_decision(model.forest, batch, model.num_samples,
                                                                  cache=model._cache))
            warm = tuning.resolve_decision(model.forest, batch, model.num_samples, cache=model._cache)
            # 1 and 64 rows share the 1,024-row bucket: the second reads the first's probe
            first = cold.key not in probed
            probed.add(cold.key)
            require(cold.source == ("probe" if first else "table") and warm.source == "table"
                    and warm.strategy == cold.strategy, f"{kind} {n} rows: {cold.source} then {warm.source}")
            auto = model.score(batch)
            require(torch.equal(auto, model.score(batch, strategy=cold.strategy)),
                    f"{kind} {n} rows: auto differs from its winner {cold.strategy}")
            row = {"winner": cold.strategy, "probe_s": cold.timings_s, "resolve_cold_s": cold_s,
                   "probe_rows": tuning.table_snapshot()["entries"][cold.key]["probe_rows"],
                   "sources": [cold.source, warm.source]}
            if batch is X_m:
                want = np.load(fixtures[kind] / counterparts[kind][cold.strategy])
                row["committed"] = counterparts[kind][cold.strategy]
                row["max_abs_err_vs_committed"] = float(np.abs(auto.cpu().numpy() - want).max())
                require(row["max_abs_err_vs_committed"] <= 2e-6, f"{kind}: auto vs {row['committed']}")
            rows["mammography" if batch is X_m else n] = row
        out[kind] = rows
    emit(out)

    # 26. watchdog: a stalled call raises at its deadline, nothing is retried
    # elsewhere, and the next call is exact while the abandoned run wakes
    acquired = []
    acquire = streaming._acquire_staging

    def spy(*args):
        staging, cached = acquire(*args)
        acquired.append((threading.current_thread().name, id(staging), cached))
        return staging, cached

    want = singles["standard", "walk"]
    dense_before, rungs_before = dense.dense_mean.launches, len(degradations())
    streaming._acquire_staging = spy
    try:
        with faults.inject(slow_collective=True):
            t0 = time.perf_counter()
            try:
                std.score(X_big, strategy="walk", timeout_s=WATCHDOG_DEADLINE_S)
                raised = False
            except watchdog.WatchdogTimeout:
                raised = True
            waited = time.perf_counter() - t0
        next_equal = bool(torch.equal(std.score(X_big, strategy="walk"), want))
        still_alive = watchdog.join_abandoned(30.0)
        torch.cuda.synchronize()
    finally:
        streaming._acquire_staging = acquire
    out = {"phase": "watchdog", "deadline_s": WATCHDOG_DEADLINE_S, "slack_s": WATCHDOG_SLACK_S, "raised": raised,
           "waited_s": waited, "next_call_equal": next_equal, "abandoned_alive_after_join": still_alive,
           "staging_acquisitions": acquired, "dense_launches": dense.dense_mean.launches - dense_before,
           "rungs": len(degradations()) - rungs_before}
    emit(out)
    require(raised and waited <= WATCHDOG_DEADLINE_S + WATCHDOG_SLACK_S, f"the watchdog: raised {raised} after {waited} s")
    require(next_equal and still_alive == 0, "the call after the timeout differs, or the abandoned run hangs")
    require(out["dense_launches"] == 0 and out["rungs"] == 0, "a timed-out call was retried elsewhere")

    # 27. spans: one 1M-row model.score under torch.profiler, telemetry on
    spans.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        std.score(X_big)
        torch.cuda.synchronize()
    names = ("model.score", "score_matrix", "pipeline.chunk")
    ranges = {name: [(e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.name == name and e.device_type == torch.autograd.DeviceType.CPU] for name in names}

    def inside(inner, outer) -> bool:
        return all(any(o0 <= i0 and i1 <= o1 for o0, o1 in ranges[outer]) for i0, i1 in ranges[inner])

    summary = spans.summary()
    parents = {r.name: r.parent for r in spans.records()}
    out = {"phase": "spans", "profiler_ranges": {k: len(v) for k, v in ranges.items()},
           "chunks_nested_in_score_matrix": inside("pipeline.chunk", "score_matrix"),
           "score_matrix_nested_in_model_score": inside("score_matrix", "model.score"),
           "parents": parents, "summary": {k: summary[k] for k in names if k in summary}}
    emit(out)
    require(all(ranges[name] for name in names) and out["chunks_nested_in_score_matrix"]
            and out["score_matrix_nested_in_model_score"], f"the profiler ranges: {out['profiler_ranges']}")
    require(parents.get("pipeline.chunk") == "score_matrix" and parents.get("score_matrix") == "model.score"
            and all(name in summary for name in names), f"the spans: {parents}")


Q16_EXACT_ROWS = 65_536  # the q16 scores held to the gather walk exactly on these rows


def q16_phases(dev, X_m, X_big) -> None:
    """Phase 28: the quantized (q16) scoring plane on both fixture models:
    the gather walk's scores exactly, the committed JAX scores within 2e-6,
    save and load, the ``q16_unsupported`` rung onto the walk kernel, the
    ``|q16`` autotune facet over a pool of walk and dense, and warm times
    beside walk and dense."""
    import numpy as np
    import torch

    from isoforest_tpu_torch import IsolationForest, load_model, tuning
    from isoforest_tpu_torch.ops import ext_path
    from isoforest_tpu_torch.ops.scoring_layout import layout_nbytes, quantized_unsupported_reason
    from isoforest_tpu_torch.ops.traversal import extended_path_lengths, scoring_tables, standard_path_lengths
    from isoforest_tpu_torch.resilience.degradation import DegradationError, degradation_report
    from isoforest_tpu_torch.utils.math import score_from_path_length

    t_phase = time.perf_counter()
    os.environ["ISOFOREST_TPU_AUTOTUNE_PATH"] = str(ROOT / "build" / f"autotune_q16_{os.getpid()}.json")
    tuning.reset_cost_model()
    fixtures = {"standard": (FIXTURE, standard_path_lengths), "extended": (EIF_FIXTURE, extended_path_lengths)}
    Xd_exact = torch.from_numpy(X_big[:Q16_EXACT_ROWS]).to(dev)
    out = {"phase": "q16", "rows": FULL_ROWS, "exact_rows": Q16_EXACT_ROWS}
    for kind, (path, gather) in fixtures.items():
        model = load_model(str(path / "model"))
        # the f32 tables the model serves walk and dense from
        model.score(X_m[:1], strategy="walk")
        model.score(X_m[:1], strategy="dense")
        mdev = model.device  # the tables' cache keys name it (cuda:0)
        f32_bytes = {s: layout_nbytes(model._cache[(s, mdev)]) for s in ("walk", "dense")}
        # on the card the preference keeps the f32 tables auto serves from;
        # the plane is built at the first q16 call, timed here alone
        model.set_scoring_representation("q16")
        require(model.scoring_representation == "q16" and ("walk", mdev) in model._cache
                and ("q16", mdev) not in model._cache, f"{kind}: set_scoring_representation on the card")
        q, build_s = synced(lambda: scoring_tables(model.forest, "q16", mdev, model._cache))
        for name in ext_path.launches:
            ext_path.launches[name] = 0
        s_q16 = model.score(X_big, strategy="q16")
        torch.cuda.synchronize()
        path_kernel_launches = dict(ext_path.launches)
        require(tuple(s_q16.shape) == (FULL_ROWS,) and bool(torch.isfinite(s_q16).all())
                and bool(((s_q16 > 0) & (s_q16 <= 1)).all()), f"{kind}: bad q16 scores")
        require(not any(path_kernel_launches.values()), f"{kind}: q16 launched a path kernel {path_kernel_launches}")
        want = score_from_path_length(gather(model.forest, Xd_exact), model.num_samples)
        gap = float((s_q16[:Q16_EXACT_ROWS] - want).abs().max())
        require(torch.equal(s_q16[:Q16_EXACT_ROWS], want), f"{kind}: q16 vs the gather walk differ by {gap}")
        committed = np.load(path / "jax_scores.npy")
        s_m = model.score(X_m, strategy="q16").cpu().numpy()
        jax_err = float(np.abs(s_m - committed).max())
        require(jax_err <= 2e-6, f"{kind}: q16 vs the committed JAX scores: {jax_err}")
        timed = model.score(X_big[:Q16_EXACT_ROWS], strategy="q16", timeout_s=60.0)
        require(torch.equal(timed, s_q16[:Q16_EXACT_ROWS]), f"{kind}: the q16 call under the watchdog differs")
        # save and load on the card keep the representation
        saved = ROOT / "build" / f"q16_{kind}_{os.getpid()}"
        model.save(str(saved), overwrite=True)
        back = load_model(str(saved))
        require(back.scoring_representation == "q16" and ("walk", back.device) in back._cache,
                f"{kind}: the reloaded model is {back.scoring_representation}")
        require(torch.equal(back.score(X_big[:4096], strategy="q16"), s_q16[:4096]), f"{kind}: reloaded q16 scores")
        # auto: the |q16 facet over a pool of walk and dense, the winner's
        # scores, and the cold resolution's cost
        auto = {}
        for n in (1, 4096, FULL_ROWS):
            batch = X_big[:n]
            d, cold_s = synced(lambda: tuning.resolve_decision(model.forest, batch, model.num_samples,
                                                               cache=model._cache))
            require(d.key.endswith("|q16") and set(d.timings_s or {}) == {"walk", "dense"},
                    f"{kind} {n}: key {d.key}, probed {d.timings_s}")
            require(torch.equal(model.score(batch), model.score(batch, strategy=d.strategy)),
                    f"{kind} {n} rows: auto differs from its winner {d.strategy}")
            probe_rows = tuning.table_snapshot()["entries"][d.key]["probe_rows"]
            auto[n] = {"winner": d.strategy, "source": d.source, "probe_s": d.timings_s, "probe_rows": probe_rows,
                       "resolve_cold_s": cold_s}
        # warm model.score medians: walk and dense in turns, then q16 alone,
        # so the q16 calls' long runs and large temporaries do not sit between
        # the others' (the EIF's q16, 0.3-1.4 s a call: five calls, or three
        # at 1M rows, after one warm-up)
        times = {}
        for n in (1, 4096, FULL_ROWS):
            batch = X_big[:n]
            times[n] = wall_ms({s: (lambda s=s: model.score(batch, strategy=s)) for s in ("walk", "dense")})
            slow = kind == "extended"
            times[n].update(wall_ms({"q16": lambda: model.score(batch, strategy="q16")},
                                    reps=(3 if n == FULL_ROWS else 5) if slow else 15, warmups=1 if slow else 2))
        out[kind] = {"q16_build_s": build_s, "q16_table_bytes": layout_nbytes(q), "f32_table_bytes": f32_bytes,
                     "q16_vs_gather_max_abs": gap, "q16_vs_committed_jax_max_abs": jax_err,
                     "path_kernel_launches_in_q16_call": path_kernel_launches, "auto": auto, "score_ms": times}

    # a forest outside the fences: a seeded 800-tree fit of uniform rows holds
    # about 100 internal nodes a tree, over 65,535 distinct thresholds in all
    X_wide = np.random.default_rng(SEED + 3).random((65_536, X_big.shape[1]), dtype=np.float32)
    wide = IsolationForest(num_estimators=800, max_samples=256.0, random_seed=3).fit(X_wide, baseline=False)
    reason = quantized_unsupported_reason(wide.forest)
    require(reason is not None and "distinct thresholds" in reason, f"the 800-tree fit fits the q16 plane: {reason}")
    rungs_before = degradation_report().count("q16_unsupported")
    ext_path.launches["walk_sum"] = 0
    s_rung = wide.score(X_wide[:4096], strategy="q16")
    torch.cuda.synchronize()
    rung_launches = ext_path.launches["walk_sum"]
    require(rung_launches > 0 and degradation_report().count("q16_unsupported") == rungs_before + 1,
            f"the q16_unsupported rung: {rung_launches} walk_sum launches")
    require(torch.equal(s_rung, wide.score(X_wide[:4096], strategy="walk")), "the rung's scores are not the walk's")
    try:
        wide.score(X_wide[:4096], strategy="q16", strict=True)
        strict_raised = False
    except DegradationError:
        strict_raised = True
    try:
        wide.set_scoring_representation("q16")
        fence_raised = False
    except ValueError:
        fence_raised = True
    require(strict_raised and fence_raised, "strict q16 or the representation accepted an ineligible forest")
    require(not tuning.decision_key("cuda", wide.forest, 4096, X_wide.shape[1]).endswith("|q16")
            and "q16" not in tuning.eligible_strategies(wide.forest, "cuda"), "the ineligible forest keys with |q16")
    out["ineligible"] = {"trees": wide.forest.num_trees, "reason": reason, "walk_sum_launches": rung_launches,
                         "strict_raised": strict_raised, "representation_refused": fence_raised}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)


# The documented out-of-core deployment (bench.py --out-of-core): KDDCup99-
# HTTP-like rows at F = 3 in .npy shards of 4,000,000 rows; 20,000,000 rows
# here, cut from its 100,000,000 for the smoke's time
OOC_ROWS = 20_000_000
OOC_SHARD_ROWS = 4_000_000


def kdd_http_like_rows(rng, n: int):
    """KDDCup99-HTTP-like rows, ``f32[n, 3]`` (log-scaled duration, source
    and destination bytes): a Gaussian mixture with 0.4% of the rows in a
    dense attack cluster, shuffled."""
    import numpy as np

    n_out = int(n * 0.004)
    normal = rng.multivariate_normal([0.0, 5.2, 8.0], [[0.6, 0.1, 0.0], [0.1, 1.2, 0.3], [0.0, 0.3, 1.5]],
                                     size=n - n_out)
    attacks = rng.multivariate_normal([4.5, 9.5, 2.0], np.eye(3), size=n_out)
    X = np.vstack([normal, attacks]).astype(np.float32)
    return X[rng.permutation(n)]


def out_of_core_phases(dev, X_m, y_m, X_big) -> None:
    """Phase 29: the out-of-core data plane. A: the documented deployment
    (``fit_source`` and ``score_source`` of 20M KDDCup99-HTTP-like rows in
    4M-row shards, kill and resume); B: every kernel through
    ``score_source``, each sink equal to the in-memory scores exactly.
    Every ``score_source`` call is driven with the launch counters at 0 just
    before and read just after."""
    import resource
    import shutil
    import tempfile

    import numpy as np
    import torch

    from isoforest_tpu_torch import IsolationForest, load_model, tuning
    from isoforest_tpu_torch.io import outofcore, source
    from isoforest_tpu_torch.io.interop import extended_forest_from_arrays
    from isoforest_tpu_torch.io.source import SourceFormatError, open_source
    from isoforest_tpu_torch.models.extended import ExtendedIsolationForestModel
    from isoforest_tpu_torch.ops import dense, ext_dense, ext_path
    from isoforest_tpu_torch.ops.bagging import StreamedBagger
    from isoforest_tpu_torch.resilience import faults
    from isoforest_tpu_torch.testing import random_extended_forest, rows
    from isoforest_tpu_torch.utils.params import ExtendedIsolationForestParams

    def zero_counts() -> None:
        for name in ext_path.launches:
            ext_path.launches[name] = 0
        dense.dense_mean.launches = 0
        ext_dense.ext_dense_mean.launches = 0

    def nonzero_counts() -> dict:
        counts = {**ext_path.launches, "dense_mean": dense.dense_mean.launches,
                  "ext_dense_mean": ext_dense.ext_dense_mean.launches}
        return {k: v for k, v in counts.items() if v}

    def rss_bytes() -> int:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def peak_rss_of(fn):
        """``(fn(), seconds, the largest RSS in bytes seen during the
        call)``, sampled every 5 ms on a thread: the kernel's high-water
        mark cannot be reset where ``/proc/self/clear_refs`` is read-only."""
        import threading

        peak, done = [rss_bytes()], threading.Event()

        def sample() -> None:
            while not done.wait(0.005):
                peak[0] = max(peak[0], rss_bytes())

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        try:
            result, secs = synced(fn)
        finally:
            done.set()
            sampler.join()
        return result, secs, max(peak[0], rss_bytes())

    def scored(model, src, sink, strategy: str, **kw):
        """``score_source`` with the launch counters at 0 just before and
        read just after: ``(summary, seconds, launches, scores, peak RSS
        bytes during the call)``."""
        zero_counts()
        summary, secs, peak = peak_rss_of(lambda: outofcore.score_source(model, src, str(sink), strategy=strategy,
                                                                        **kw))
        launches = nonzero_counts()
        return summary, secs, launches, outofcore.read_scores(str(sink), num_shards=src.num_shards), peak

    def in_memory(model, src, strategy: str):
        """``model.score`` of each shard's rows in one call, concatenated."""
        whole = max(src.shard_rows())
        return np.concatenate([model.score(c.X, strategy=strategy).cpu().numpy()
                               for c in src.iter_chunks(chunk_rows=whole)])

    def part_bytes(sink) -> dict:
        return {str(p.relative_to(sink)): p.read_bytes() for p in sorted(pathlib.Path(sink).glob("part-*/*"))}

    def chunks_of(src) -> int:
        return sum(-(-r // source.DEFAULT_CHUNK_ROWS) for r in src.shard_rows())

    t_phase = time.perf_counter()
    rss_start = rss_bytes()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="out_of_core_", dir=build))
    out = {"phase": "out_of_core"}
    try:
        # A. the documented deployment, written one shard at a time
        src_dir = tmp / "kdd_http"
        src_dir.mkdir()
        t0 = time.perf_counter()
        for i in range(OOC_ROWS // OOC_SHARD_ROWS):
            rng = np.random.default_rng(SEED + 100 + i)
            source.write_npy_shard(str(src_dir / f"shard-{i:05d}.npy"), kdd_http_like_rows(rng, OOC_SHARD_ROWS))
        generate_s = time.perf_counter() - t0
        src = open_source(str(src_dir))
        require(src.total_rows() == OOC_ROWS and src.num_features() == 3, f"source {src.shard_rows()}")

        def estimator():
            return IsolationForest(num_estimators=100, max_samples=256.0, contamination=0.004, random_seed=1)

        # the sampler's host pass alone, then the fit of its sample
        t0 = time.perf_counter()
        bagger = StreamedBagger(1, 100, 256)
        for chunk in src.iter_chunks():
            bagger.consume(chunk.X)
        sample = bagger.finalize()
        sample_s = time.perf_counter() - t0
        ref, from_sample_s = synced(lambda: estimator().fit_from_sample(
            sample.X, sample.bag, sample_sha256=sample.sha256, source_rows=sample.total_rows))
        zero_counts()
        rss_before_fit = rss_bytes()
        model, fit_source_s, fit_peak_rss = peak_rss_of(lambda: estimator().fit_source(src))
        fit_launches = nonzero_counts()
        require(model.device.type == "cuda", f"fit_source fitted on {model.device}")
        require(fit_launches.get("walk_sum", 0) > 0, f"fit_source's threshold pass launched {fit_launches}")
        require(all(torch.equal(a, b) for a, b in zip(model.forest, ref.forest))
                and model.outlier_score_threshold == ref.outlier_score_threshold,
                "fit_source differs from fit_from_sample of the same sample")

        # score_source through the walk kernel, against the in-memory scores
        sink = tmp / "sink_walk"
        rss_before_score = rss_bytes()
        summary, score_s, score_launches, got, score_peak_rss = scored(model, src, sink, "walk")
        require(summary["rows"] == OOC_ROWS and summary["sealed"] == src.num_shards, f"summary {summary}")
        require(score_launches.get("walk_sum", 0) == chunks_of(src), f"score_source launched {score_launches}")
        require(got.shape == (OOC_ROWS,) and np.isfinite(got).all() and ((got > 0) & (got <= 1)).all(),
                "bad out-of-core scores")
        require(np.array_equal(got, in_memory(model, src, "walk")), "the walk sink differs from model.score")
        outlier_share = float((got >= model.outlier_score_threshold).mean())

        # auto: each 65,536-row chunk keys its own bucket
        _, auto_s, auto_launches, got_auto, _ = scored(model, src, tmp / "sink_auto", "auto")
        decision = tuning.resolve_decision(model.forest, next(src.iter_chunks()).X, model.num_samples,
                                           cache=model._cache)
        auto_gap = float(np.abs(got_auto - got).max())
        require(auto_gap <= 2e-6, f"the auto sink is {auto_gap} from the walk's")

        # killed after shard 2, then resumed: byte-equal to the clean sink
        killed = tmp / "sink_killed"
        try:
            with faults.inject(kill_score_after_shard=2):
                outofcore.score_source(model, src, str(killed), strategy="walk")
        except faults.FaultInjectedError:
            pass
        else:
            fail("kill_score_after_shard=2 did not fire")
        sealed_at_kill = sorted(p.name for p in killed.glob("part-*"))
        resumed, resume_s = synced(lambda: outofcore.score_source(model, src, str(killed), strategy="walk",
                                                                   resume=True))
        require(sealed_at_kill == ["part-00000", "part-00001", "part-00002"]
                and (resumed["skipped"], resumed["sealed"]) == (3, 2), f"resume {sealed_at_kill} {resumed}")
        require(part_bytes(killed) == part_bytes(sink), "the resumed sink is not byte-equal to the clean one")

        # one shard's score_source under torch.profiler: host against device time
        one = open_source(str(src_dir / "shard-00000.npy"))
        profiled = iter(range(2))
        prof = profile_call(lambda: outofcore.score_source(model, one, str(tmp / f"sink_prof_{next(profiled)}"),
                                                           strategy="walk"), host_top=8)
        out["deployment"] = {
            "rows": OOC_ROWS, "features": 3, "shards": src.num_shards, "shard_rows": OOC_SHARD_ROWS,
            "source_bytes": sum(s.size_bytes for s in src.shards), "generate_s": generate_s,
            "sample_distinct_rows": int(sample.X.shape[0]), "sampler_s": sample_s,
            "sampler_rows_per_s": OOC_ROWS / sample_s, "fit_from_sample_s": from_sample_s,
            "fit_source_s": fit_source_s, "fit_source_rows_per_s": OOC_ROWS / fit_source_s,
            "fit_source_launches": fit_launches, "threshold": model.outlier_score_threshold,
            "score_source_s": score_s, "score_rows_per_s": OOC_ROWS / score_s,
            "summary_rows_per_s": summary["rowsPerSecond"], "shard_seconds_mean": summary["shardSecondsMean"],
            "score_source_launches": score_launches, "chunks": chunks_of(src), "outlier_share": outlier_share,
            "auto": {"s": auto_s, "launches": auto_launches, "resolved_65536": decision.strategy,
                     "source": decision.source, "max_abs_vs_walk": auto_gap},
            "resume": {"sealed_at_kill": len(sealed_at_kill), "resume_s": resume_s, "byte_equal": True},
            "profile_one_shard": prof,
            "peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            "rss_start_bytes": rss_start, "rss_end_bytes": rss_bytes(),
            "fit_source_rss_before_bytes": rss_before_fit, "fit_source_peak_rss_sampled_bytes": fit_peak_rss,
            "score_source_rss_before_bytes": rss_before_score, "score_source_peak_rss_sampled_bytes": score_peak_rss,
        }
        shutil.rmtree(src_dir)

        # B. every kernel through score_source
        big_dir, labeled_dir, wide_dir = tmp / "mammography_1m", tmp / "mammography_labeled", tmp / "high_dim"
        for d in (big_dir, labeled_dir, wide_dir):
            d.mkdir()
        n = len(X_big)
        bounds = (0, n // 7, n * 2 // 5, n * 7 // 9, n)
        for i in range(4):
            source.write_npy_shard(str(big_dir / f"part-{i}.npy"), X_big[bounds[i] : bounds[i + 1]])
        source.write_csv_shard(str(labeled_dir / "a.csv"), X_m, y_m)
        source.write_avro_shard(str(labeled_dir / "b.avro"), X_m, y_m)
        big, labeled = open_source(str(big_dir)), open_source(str(labeled_dir), labeled=True)
        X_l, y_l = labeled.read_all()
        require(np.array_equal(X_l, np.concatenate([X_m, X_m])) and np.array_equal(y_l, np.concatenate([y_m, y_m])),
                "the labeled csv and avro shards do not read back")
        std, eif = load_model(str(FIXTURE / "model")), load_model(str(EIF_FIXTURE / "model"))
        cases = [("standard", std, "walk", "walk_sum", FIXTURE / "jax_scores.npy"),
                 ("standard", std, "dense", "dense_mean", FIXTURE / "jax_scores.npy"),
                 ("extended", eif, "walk", "ext_walk_sum", EIF_FIXTURE / "jax_walk_scores.npy"),
                 ("extended", eif, "dense", "ext_sparse_mean", EIF_FIXTURE / "jax_pallas_scores.npy")]
        kernels = {}
        for kind, m, strategy, kernel, committed in cases:
            for name, s in (("1m_npy", big), ("labeled_csv_avro", labeled)):
                summary, secs, launches, got, _ = scored(m, s, tmp / f"sink_{kind}_{strategy}_{name}", strategy)
                require(launches.get(kernel, 0) == chunks_of(s), f"{kind} {strategy} {name}: launched {launches}")
                require(np.array_equal(got, in_memory(m, s, strategy)), f"{kind} {strategy} {name}: sink differs")
                row = {"rows": summary["rows"], "s": secs, "launches": launches}
                if name == "labeled_csv_avro":
                    jax = np.load(committed)[: len(X_m)]
                    row["vs_committed_jax_max_abs"] = float(np.abs(got - np.concatenate([jax, jax])).max())
                    require(row["vs_committed_jax_max_abs"] <= 2e-6, f"{kind} {strategy}: {row}")
                kernels[f"{kind}_{strategy}_{name}"] = row
        # K5: a seeded fully extended forest at F = k = 274, 65,536 rows in 2 shards
        rng5 = np.random.default_rng(SEED + 29)
        f5 = extended_forest_from_arrays(*random_extended_forest(rng5, 100, 8, 274, 274, split_p=1.0))
        wide = ExtendedIsolationForestModel(forest=f5, params=ExtendedIsolationForestParams(), num_samples=256,
                                            num_features=274, extension_level=273, total_num_features=274)
        X5 = rows(rng5, HIGH_DIM_ROWS, 274)
        source.write_npy_shard(str(wide_dir / "part-0.npy"), X5[: HIGH_DIM_ROWS * 15 // 32])
        source.write_npy_shard(str(wide_dir / "part-1.npy"), X5[HIGH_DIM_ROWS * 15 // 32 :])
        wide_src = open_source(str(wide_dir))
        summary, secs, launches, got, _ = scored(wide, wide_src, tmp / "sink_high_dim", "dense")
        require(launches.get("ext_dense_mean", 0) == chunks_of(wide_src), f"high-dim dense launched {launches}")
        require(np.array_equal(got, in_memory(wide, wide_src, "dense")), "the high-dim dense sink differs")
        kernels["high_dim_dense"] = {"rows": summary["rows"], "s": secs, "launches": launches}
        out["kernels_through_score_source"] = kernels

        # parquet: read where pyarrow imports, else refused by name
        pq_path = tmp / "rows.parquet"
        try:
            import pyarrow as pa
            import pyarrow.parquet as pq
        except ImportError:
            pq_path.write_bytes(b"PAR1")
            try:
                open_source(str(pq_path)).total_rows()
            except SourceFormatError as exc:
                out["parquet"] = {"pyarrow": False, "refused": str(exc)[:80]}
            else:
                fail("a parquet shard without pyarrow was not refused")
        else:
            pq.write_table(pa.table({f"c{j}": X_m[:, j] for j in range(X_m.shape[1])}), str(pq_path))
            require(np.array_equal(open_source(str(pq_path)).read_all()[0], X_m), "the parquet shard differs")
            out["parquet"] = {"pyarrow": True, "version": pa.__version__}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)


SERVING_WARM = (1, 64, 4096)  # the warmed buckets of phase 30
SERVING_OVERSIZE_ROWS = 50_000  # a request past the largest warmed bucket
SERVING_CONCURRENT = 32
SERVING_LATENCY_REQUESTS = 200
SERVING_TIMEOUT_S = 60.0
# the committed JAX scores of each EIF strategy's counterpart (the standard
# fixture's walk and dense both hold to its gather scores, phase 3)
EIF_JAX_SCORES = {"walk": "jax_walk_scores.npy", "dense": "jax_pallas_scores.npy"}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from isoforest_tpu_torch.ops import dense, ext_dense, ext_path

    return {**ext_path.launches, "dense_mean": dense.dense_mean.launches,
            "ext_dense_mean": ext_dense.ext_dense_mean.launches}


def zero_launch_counts() -> None:
    from isoforest_tpu_torch.ops import dense, ext_dense, ext_path

    for name in ext_path.launches:
        ext_path.launches[name] = 0
    dense.dense_mean.launches = 0
    ext_dense.ext_dense_mean.launches = 0


def http_request(url: str, path: str, body=None, content_type: str = "application/json", headers=None):
    """``(status, headers, text)`` of one request, with a timeout."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + path, data=body, headers={"Content-Type": content_type, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=SERVING_TIMEOUT_S) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read().decode()


def percentile_ms(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values) * 1e3, q))


def serve_fixture(kind: str, fixture, X_m, X_big) -> tuple:
    """Phase 30 for one fixture (see ``serving_phases``); returns its phase
    line and its launches by kernel name."""
    import threading

    import numpy as np

    from isoforest_tpu_torch import telemetry, tuning
    from isoforest_tpu_torch.serving import ServingConfig, serve_model

    telemetry.reset()
    telemetry.reset_resources()
    out = {"phase": "http_serving", "fixture": kind}
    config = ServingConfig(max_queue_rows=1 << 17, request_timeout_s=SERVING_TIMEOUT_S)
    t0 = time.perf_counter()
    handle = serve_model(str(fixture / "model"), port=0, host="127.0.0.1", config=config, lifecycle=False,
                         warm_batch_sizes=SERVING_WARM)
    try:
        out["start_s"] = time.perf_counter() - t0
        service, url = handle.service, handle.url
        model = service.model
        require(model.device.type == "cuda", f"{kind}: served on {model.device}")
        warm = [(e.fields["buckets"], e.fields["strategies"]) for e in telemetry.get_events(kind="serving.warmup")]
        require(len(warm) == 1, f"{kind}: {len(warm)} serving.warmup events")
        out["warmed"] = {"buckets": warm[0][0], "strategies": json.loads(warm[0][1])}
        sent = {}
        answers = {}

        def post_json(name, rows, single=False):
            payload = {"row": rows[0].tolist()} if single else {"rows": rows.tolist()}
            status, headers, body = http_request(url, "/score", json.dumps(payload).encode())
            sent[status] = sent.get(status, 0) + 1
            require(status == 200, f"{kind} {name}: HTTP {status}: {body[:200]}")
            doc = json.loads(body)
            answers[name] = (rows, np.asarray(doc["scores"], np.float32), doc)
            return headers

        # every path of the phase with the launch counters at 0 just before
        zero_launch_counts()
        t_drive = time.perf_counter()
        headers = post_json("json_1", X_m[:1], single=True)
        trace_id = headers["X-Isoforest-Trace"]
        post_json("json_64", X_m[:64])
        post_json("json_4096", X_m[:4096])
        csv = "\n".join(",".join(repr(float(v)) for v in row) for row in X_m).encode()
        status, _, body = http_request(url, "/score", csv, content_type="text/csv")
        sent[status] = sent.get(status, 0) + 1
        require(status == 200, f"{kind} csv: HTTP {status}: {body[:200]}")
        answers["csv_mammography"] = (X_m, np.asarray([float(v) for v in body.splitlines()[1:]], np.float32),
                                      None)
        post_json("json_oversize", X_big[:SERVING_OVERSIZE_ROWS])
        require(answers["json_oversize"][2]["flush_rows"] == SERVING_OVERSIZE_ROWS,
                f"{kind}: the oversize request did not flush alone")

        # the trace of the first request, as Chrome trace JSON
        status, _, body = http_request(url, f"/trace?trace_id={trace_id}")
        chrome = json.loads(body)
        names = {e["name"] for e in chrome.get("traceEvents", ()) if e.get("ph") == "X"}
        require(status == 200 and "serving.request" in names, f"{kind}: /trace gave {status} {sorted(names)}")
        out["trace"] = {"trace_id": trace_id, "events": len(chrome["traceEvents"]), "spans": sorted(names)}

        # concurrent 1-row requests, with the linger widened for the burst
        flushes_before = sum(s["value"] for s in
                             telemetry.registry().snapshot()["isoforest_serving_flushes_total"]["series"])
        previous = service.coalescer.reconfigure(max_linger_s=0.02)
        results, errors = [None] * SERVING_CONCURRENT, []
        go = threading.Barrier(SERVING_CONCURRENT)

        def worker(i):
            try:
                go.wait(timeout=SERVING_TIMEOUT_S)
                status, _, body = http_request(url, "/score", json.dumps({"row": X_m[i].tolist()}).encode())
                results[i] = (status, body)
            except Exception as exc:  # surfaced below
                errors.append(repr(exc))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(SERVING_CONCURRENT)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVING_TIMEOUT_S)
        service.coalescer.reconfigure(**previous)
        require(not errors and not any(t.is_alive() for t in threads), f"{kind}: concurrent requests: {errors}")
        for status, body in results:
            sent[status] = sent.get(status, 0) + 1
            require(status == 200, f"{kind} concurrent: HTTP {status}: {body[:200]}")
        flushes = sum(s["value"] for s in
                      telemetry.registry().snapshot()["isoforest_serving_flushes_total"]["series"]) - flushes_before
        require(flushes < SERVING_CONCURRENT, f"{kind}: {SERVING_CONCURRENT} concurrent requests took {flushes} "
                                              "flushes")
        answers["concurrent"] = (X_m[:SERVING_CONCURRENT],
                                 np.asarray([json.loads(b)["scores"][0] for _, b in results], np.float32), None)
        out["concurrent"] = {"requests": SERVING_CONCURRENT, "flushes": flushes,
                             "flush_requests": sorted({json.loads(b)["flush_requests"] for _, b in results})}

        # closed-loop latency: one client, 1 and 64 rows, at the default
        # linger (2 ms) and at 0
        latency = {}
        for linger_ms in (config.linger_ms, 0.0):
            service.coalescer.reconfigure(max_linger_s=linger_ms / 1e3)
            for n in (1, 64):
                body = json.dumps({"rows": X_m[:n].tolist()}).encode()
                lat = []
                for i in range(5 + SERVING_LATENCY_REQUESTS):
                    if i == 5:  # after five warm-up requests
                        telemetry.reset_spans()
                    t1 = time.perf_counter()
                    status, _, _ = http_request(url, "/score", body)
                    lat.append(time.perf_counter() - t1)
                    sent[status] = sent.get(status, 0) + 1
                    require(status == 200, f"{kind}: latency request HTTP {status}")
                lat = lat[5:]
                flush = [r.wall_s for r in telemetry.span_records("serving.flush")]
                request = [r.wall_s for r in telemetry.span_records("serving.request")]
                score = [r.wall_s for r in telemetry.span_records("model.score")]
                latency[f"linger_{linger_ms:g}ms_rows_{n}"] = {
                    "client_p50_ms": percentile_ms(lat, 50), "client_p99_ms": percentile_ms(lat, 99),
                    "client_mean_ms": float(np.mean(lat)) * 1e3,
                    "server_request_p50_ms": percentile_ms(request, 50),
                    "server_request_p99_ms": percentile_ms(request, 99),
                    "flush_p50_ms": percentile_ms(flush, 50), "flush_p99_ms": percentile_ms(flush, 99),
                    # server times over the requests whose spans the span ring (512) kept
                    "model_score_p50_ms": percentile_ms(score, 50), "server_samples": len(request)}
        service.coalescer.reconfigure(**previous)
        out["latency"] = latency
        out["drive_s"] = time.perf_counter() - t_drive
        launches = launch_counts()
        out["launches"] = {k: v for k, v in launches.items() if v}

        # the telemetry endpoints
        status, _, text = http_request(url, "/metrics")
        parsed = telemetry.parse_prometheus(text)
        responses = {dict(k)["code"]: v for k, v in parsed["isoforest_serving_responses_total"].items()}
        require(status == 200 and responses == {str(k): float(v) for k, v in sent.items()},
                f"{kind}: /metrics counts {responses}, the phase sent {sent}")
        status, _, text = http_request(url, "/healthz")
        health = json.loads(text)
        require(status == 200 and health["status"] == "ok" and health["serving"]["lifecycle"] is False
                and health["serving"]["batch_rows"] == config.batch_rows, f"{kind}: /healthz {status} {health}")
        status, _, text = http_request(url, "/debug/bundle")
        bundle = json.loads(text)
        require(status == 200 and sorted(bundle) == sorted(telemetry.BUNDLE_SECTIONS),
                f"{kind}: /debug/bundle sections {sorted(bundle)}")
        require(bundle["compiles"]["by_phase"]["steady"] == 0, f"{kind}: steady compiles {bundle['compiles']}")
        require(bundle["config"]["backend"] == "gpu", f"{kind}: bundle backend {bundle['config']['backend']}")
        status, _, text = http_request(url, "/snapshot")
        require(status == 200 and "isoforest_serving_request_seconds" in json.loads(text)["metrics"],
                f"{kind}: /snapshot")
        out["responses"] = responses
        out["compiles"] = bundle["compiles"]
        out["compile_log"] = [[e["site"], e["key"], e["phase"], e["seconds"]] for e in bundle["compile_log"]]
        out["memory"] = {"host_staging_peak_bytes": bundle["memory"]["host_staging_peak_bytes"],
                         "plane": telemetry.model_plane_bytes(model)}
    finally:
        handle.close()

    # the answers against one model.score call on the card, bit for bit, and
    # the mammography rows against the committed JAX scores
    checks = {}
    for name, (rows, got, _) in answers.items():
        want = model.score(rows).cpu().numpy()
        require(got.shape == want.shape and np.isfinite(got).all(), f"{kind} {name}: bad scores {got.shape}")
        checks[name] = int((got != want).sum())
        require(checks[name] == 0, f"{kind} {name}: {checks[name]} scores differ from model.score")
    out["answers_differing_from_model_score"] = checks
    if kind == "standard":
        jax_file = "jax_scores.npy"
    else:
        resolved = tuning.resolve_decision(model.forest, X_m, model.num_samples, cache=model._cache)
        jax_file = EIF_JAX_SCORES[resolved.strategy]
    err = float(np.abs(answers["csv_mammography"][1] - np.load(fixture / jax_file)).max())
    require(err <= 2e-6, f"{kind}: the served mammography scores differ from {jax_file} by {err}")
    out["mammography_vs_jax"] = {"file": jax_file, "max_abs_err": err}
    path_kernels = {"standard": {"walk": "walk_sum", "dense": "dense_mean"},
                    "extended": {"walk": "ext_walk_sum", "dense": "ext_sparse_mean"}}[kind]
    for strategy in set(out["warmed"]["strategies"].values()):
        kernel = path_kernels.get(strategy)  # q16 (the CPU's pool only) has none
        require(kernel is None or launches[kernel] > 0,
                f"{kind}: buckets resolve to {strategy}, but {kernel} never launched")
    return out, launches


def serving_phases(X_m, X_big, smi: str) -> dict:
    """Phase 30: the online scoring service on the card. For each fixture,
    ``serve_model`` (lifecycle off, the default device) with buckets 1, 64
    and 4,096 warmed; JSON requests of 1, 64 and 4,096 rows, the mammography
    rows as CSV, one request of 50,000 rows (past the largest warmed bucket:
    it streams in 4,096-row chunks), 32 concurrent 1-row requests from
    threads (fewer flushes than requests), and closed-loop latency of 200
    requests at 1 and 64 rows; each answer bitwise one ``model.score`` call
    on the card, the mammography answers within 2e-6 of the committed JAX
    scores; ``/metrics`` counts every response, ``/healthz`` carries the
    serving state, ``/debug/bundle`` has exactly the bundle's sections and no
    steady compile, ``/trace`` converts to a Chrome trace. Returns the
    launches through serving by kernel name (the counters at 0 just before
    each fixture's requests, read just after)."""
    t_phase = time.perf_counter()
    total = {}
    latency = {}
    for kind, fixture in (("standard", FIXTURE), ("extended", EIF_FIXTURE)):
        line, launches = serve_fixture(kind, fixture, X_m, X_big)
        emit(line)
        latency[kind] = line["latency"]
        for name, count in launches.items():
            total[name] = total.get(name, 0) + count
    emit({"serving": latency, "nvidia_smi": smi, "phase_s": time.perf_counter() - t_phase})
    return total


LIFECYCLE_BATCH = 4096  # rows of a served batch in phase 31
LIFECYCLE_WINDOW = 65536  # the manager's default window_rows
LIFECYCLE_WINDOW_BATCHES = LIFECYCLE_WINDOW // LIFECYCLE_BATCH
LIFECYCLE_SHIFT_SD = 3.0  # the covariate shift of tests/test_lifecycle.py, in standard deviations per feature
LIFECYCLE_IDLE_CALLS = 200
LIFECYCLE_TRAFFIC_BATCHES = 120  # distinct 4,096-row batches of phase 31's traffic
LIFECYCLE_LOAD_S = 60.0  # how long (g)'s client posts without a pause, at most

# (g)'s client, a process of its own: posts the request bodies of a file (one
# a line) back to back until a stop file appears, then prints its latencies
LOAD_CLIENT = r"""
import json, os, sys, time, urllib.request
url, bodies_path, stop_path = sys.argv[1:4]
bodies = open(bodies_path, "rb").read().split(b"\n")
lat, not_ok = [], 0
while not os.path.exists(stop_path):
    req = urllib.request.Request(url + "/score", data=bodies[len(lat) % len(bodies)],
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            resp.read()
            not_ok += resp.status != 200
    except Exception:
        not_ok += 1
    lat.append(time.perf_counter() - t0)
print(json.dumps({"latencies_s": lat, "not_ok": not_ok}))
"""


def latency_in_turns(manager, rows_by_n: dict, calls: int, until=None) -> dict:
    """Host-clock latency of ``manager.score`` and of ``model.score`` of the
    manager's model without the monitor's fold (the bare scoring under it),
    each synchronised by its copy back, in turns, at each batch size; with
    ``until``, the rounds stop once it is true. p50, p99 and the count."""
    lat = {f"{who}_{n}": [] for n in rows_by_n for who in ("manager", "model")}
    for _ in range(calls):
        if until is not None and until():
            break
        for n, rows in rows_by_n.items():
            t0 = time.perf_counter()
            manager.score(rows).cpu()
            lat[f"manager_{n}"].append(time.perf_counter() - t0)
            model = manager.model
            t0 = time.perf_counter()
            model.score(rows, fold_monitor=False).cpu()
            lat[f"model_{n}"].append(time.perf_counter() - t0)
    return {k: {"p50_ms": percentile_ms(v, 50) if v else None, "p99_ms": percentile_ms(v, 99) if v else None,
                "calls": len(v)} for k, v in lat.items()}


def lifecycle_phases(dev, X_m, X_big, smi: str) -> dict:
    """Phase 31: the model lifecycle on the card. Managers over copies of the
    fixtures (the README's default knobs, ``checkpoint_every=25``: 4 refit
    blocks; the retry on a FakeClock) take 4,096-row batches of the
    resampled rows, in distribution, then shifted by 3 standard deviations
    per feature. (a) no in-distribution batch triggers; (b) sustained drift
    triggers one refit on the full 65,536-row window (the manager refits
    only on a full window, ``min_window_rows=65536``), killed after block 1,
    resumed, validated, swapped: the 1M rows score bit for bit as a plain
    card fit of that window with ``retrain_seed(1, 2)``, ``CURRENT.json``
    names ``gen-00002``, drift falls back under its threshold on the
    re-served rows; (c) ``fail_swap`` and ``corrupt_candidate`` roll back,
    the incumbent's scores bit for bit unchanged; (d) four threads score
    through a swap stalled on an event, each answer bit for bit the old or
    the new generation's; (e) a sliding refresh of ``mammography_eif`` keeps
    50 trees bit for bit and grows 50 equal to a card growth from the same
    draws; (f) ``serve_model(copy, lifecycle=True)`` over HTTP until
    ``/healthz`` names generation 2, each answer bit for bit one
    ``model.score`` of the generation it names; (g) the same under a client
    process that posts without a pause, for at most 60 s: the refit's wall,
    or that it did not finish under the load. The line holds the refit's
    wall and part times, the swap's lock hold, ``manager.score`` against
    ``model.score`` at 1 and 4,096 rows idle and during a background refit
    (after (a)'s counted traffic, on its window), and the managed path's
    launches: the counters at 0 just before each managed section and read
    just after it, so no reference computation or bare ``model.score`` of
    the latency probes counts. Returns those launches by kernel name."""
    import contextlib
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from isoforest_tpu_torch import IsolationForest, load_model, telemetry
    from isoforest_tpu_torch.lifecycle import ModelManager, retrain_seed
    from isoforest_tpu_torch.models.extended import ExtendedIsolationForestModel
    from isoforest_tpu_torch.models.isolation_forest import _grow_block
    from isoforest_tpu_torch.ops import prng
    from isoforest_tpu_torch.ops.bagging import bagged_indices, feature_subsets, per_tree_keys
    from isoforest_tpu_torch.resilience import faults
    from isoforest_tpu_torch.serving import ServingConfig, serve_model
    from isoforest_tpu_torch.utils.math import height_limit

    t_phase = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="lifecycle_", dir=build))
    out = {"phase": "lifecycle", "nvidia_smi": smi}
    # the traffic: mammography rows resampled as they are (X_big's jitter
    # breaks the rows' ties with the trees' split values, and moves the
    # score distribution past the drift threshold: that is drift)
    traffic = X_m[np.random.default_rng(SEED + 31).integers(0, len(X_m), LIFECYCLE_TRAFFIC_BATCHES
                                                                 * LIFECYCLE_BATCH)]
    shift = (LIFECYCLE_SHIFT_SD * X_m.std(axis=0)).astype(np.float32)

    def batch(i: int, shifted: bool) -> np.ndarray:
        rows = traffic[i * LIFECYCLE_BATCH : (i + 1) * LIFECYCLE_BATCH]
        return rows + shift if shifted else rows

    def events(kind: str) -> list:
        return telemetry.get_events(kind=kind)

    clock = faults.FakeClock()
    knobs = dict(drift_debounce=3, window_rows=LIFECYCLE_WINDOW, min_window_rows=1024, mode="full",
                 checkpoint_every=25, clock=clock.now, sleep=clock.sleep)
    launches = {}

    @contextlib.contextmanager
    def managed():
        """A section of the managed path: the launch counters at 0 just
        before it, read just after and added to the phase's launches."""
        zero_launch_counts()
        yield
        for name, count in launch_counts().items():
            launches[name] = launches.get(name, 0) + count

    def refit_wall_s() -> float:
        return events("retrain.swap")[-1].unix_s - events("retrain.start")[-1].unix_s

    telemetry.reset()
    try:
        std_dir, eif_dir = tmp / "std", tmp / "eif"
        shutil.copytree(FIXTURE / "model", std_dir)
        shutil.copytree(EIF_FIXTURE / "model", eif_dir)

        # (a) in distribution: no batch triggers; then the idle overhead
        model_a = load_model(str(std_dir)).warmup((1, LIFECYCLE_BATCH))
        require(model_a.device.type == "cuda", f"lifecycle: loaded on {model_a.device}")
        with managed():
            a = ModelManager(model_a, str(tmp / "lc-a"), **knobs)
        try:
            with managed():
                for i in range(LIFECYCLE_WINDOW_BATCHES):
                    a.score(batch(i, False))
            require(a.generation == 1 and not events("retrain.start") and not a.retrain_in_progress,
                    f"lifecycle (a): in-distribution traffic triggered a refit: {a.state()}")
            out["a_in_distribution"] = {"batches": LIFECYCLE_WINDOW_BATCHES, "score_psi": a.monitor.drift()["score"]["psi"],
                                        "threshold": a.monitor.threshold,
                                        "consecutive_over_threshold": a.state()["consecutive_over_threshold"]}
            # the overhead, uncounted: idle, then during a background refit
            # of (a)'s window (a quiet one: no kill)
            probes = {1: batch(0, False)[:1], LIFECYCLE_BATCH: batch(1, False)}
            latency_in_turns(a, probes, 5)
            out["latency_idle"] = latency_in_turns(a, probes, LIFECYCLE_IDLE_CALLS)
            require(a.retrain(reason="latency_probe", wait=False) == "started", "lifecycle (a): no refit started")
            out["latency_during_refit"] = latency_in_turns(a, probes, 10 ** 6, until=lambda: not a.retrain_in_progress)
            require(a.wait_retrain(timeout_s=300), "lifecycle (a): the probed refit did not finish")
            out["latency_during_refit"]["refit"] = {
                "outcome": a.last_retrain["outcome"],
                "wall_s": refit_wall_s() if a.last_retrain["outcome"] == "swapped" else None}
        finally:
            a.close()

        # (b) sustained drift: one refit on the full window, killed after
        # block 1 and resumed, then the swap
        telemetry.reset()
        model_b = load_model(str(std_dir)).warmup((1, LIFECYCLE_BATCH))
        stall, entered, release = {"on": False}, threading.Event(), threading.Event()

        def mid_swap():
            if stall["on"]:
                entered.set()
                release.wait(120)

        with managed():
            b = ModelManager(model_b, str(tmp / "lc-b"), **dict(knobs, min_window_rows=LIFECYCLE_WINDOW),
                             hooks={"mid_swap": mid_swap})
        try:
            with faults.inject(kill_retrain_after_block=1), managed():
                for i in range(LIFECYCLE_WINDOW_BATCHES):
                    require(b.generation == 1 and not b.retrain_in_progress,
                            f"lifecycle (b): a refit started before the window was full (batch {i})")
                    b.score(batch(i, True))
                require(b.retrain_in_progress or b.generation == 2, "lifecycle (b): sustained drift did not trigger")
                require(b.wait_retrain(timeout_s=300), "lifecycle (b): the refit did not finish")
            info = b.last_retrain
            require(info["outcome"] == "swapped" and b.generation == 2,
                    f"lifecycle (b): outcome {info['outcome']}, state {b.state()}")
            require(len(events("retrain.start")) == 1, "lifecycle (b): more than one refit")
            trail = [(e.fields["index"], e.fields["resumed"]) for e in events("retrain.block")]
            require(trail == [(0, False), (1, False), (0, True), (1, True), (2, False), (3, False)],
                    f"lifecycle (b): block trail {trail}")
            window = info["window"]
            seed = retrain_seed(model_b.params.random_seed, 2)
            require(window.shape == (LIFECYCLE_WINDOW, X_big.shape[1]) and info["seed"] == seed == 15839,
                    f"lifecycle (b): window {window.shape}, seed {info['seed']}")
            t0 = time.perf_counter()
            plain = IsolationForest(params=model_b.params.replace(random_seed=seed)).fit(window)
            torch.cuda.synchronize()
            plain_fit_s = time.perf_counter() - t0
            swapped = b.model
            require(plain.device.type == "cuda" and swapped.device.type == "cuda", "lifecycle (b): off the card")
            require(all(torch.equal(x, y) for x, y in zip(swapped.forest, plain.forest)),
                    "lifecycle (b): the swapped forest differs from a plain card fit of the window")
            s_new = swapped.score(X_big, fold_monitor=False)
            require(torch.equal(s_new, plain.score(X_big)), "lifecycle (b): 1M scores differ from the plain fit's")
            require(swapped.outlier_score_threshold == plain.outlier_score_threshold, "lifecycle (b): threshold")
            current = json.loads((tmp / "lc-b" / "CURRENT.json").read_text())
            require(current["generation"] == 2 and pathlib.Path(current["path"]).name == "gen-00002",
                    f"lifecycle (b): CURRENT.json {current}")
            validate = events("retrain.validate")[-1].fields
            t = {e.kind: e.unix_s for e in telemetry.get_events() if e.kind.startswith(("retrain.", "retry."))}
            blocks = [e.unix_s for e in events("retrain.block")]
            start = events("retrain.start")[-1].unix_s
            out["b_refit"] = {
                "window_rows": int(window.shape[0]), "seed": seed, "trail": trail,
                "wall_s": t["retrain.swap"] - start,
                "parts_s": {"killed_attempt": t["retry.attempt"] - start,
                            "resumed_growth": blocks[-1] - t["retry.attempt"],
                            "threshold_baseline_validation": t["retrain.validate"] - blocks[-1],
                            "save_and_flip": t["retrain.swap"] - t["retrain.validate"]},
                "swap_lock_hold_ms": b.last_swap_lock_hold_s * 1e3, "plain_fit_s": plain_fit_s,
                "validation": json.loads(validate["gates"]), "reference_rows": validate["reference_rows"],
                "retry_sleeps_s": list(clock.sleeps)}
            with managed():
                for i in range(LIFECYCLE_WINDOW_BATCHES):
                    b.score(batch(i, True))
            psi, gauge = b.monitor.drift()["score"]["psi"], telemetry.gauge("isoforest_score_drift_psi").value()
            require(psi < b.monitor.threshold and gauge < b.monitor.threshold and b.generation == 2,
                    f"lifecycle (b): drift {psi} (gauge {gauge}) on the re-served rows, generation {b.generation}")
            out["b_refit"]["reserved_score_psi"] = psi

            # (c) rollbacks: the incumbent's scores stay bit for bit
            b.auto_retrain = False
            incumbent = b.model
            drills = {}
            for fault, outcome in (("fail_swap", "swap_failed"), ("corrupt_candidate", "validation_failed")):
                t0 = time.perf_counter()
                with faults.inject(**{fault: True}), managed():
                    got = b.retrain(reason=fault)
                drills[fault] = {"outcome": got, "wall_s": time.perf_counter() - t0,
                                 "failed_gates": list(b.last_validation.failed_gates())}
                require(got == outcome and b.model is incumbent and b.generation == 2,
                        f"lifecycle (c): {fault} gave {got}, generation {b.generation}")
                require(torch.equal(incumbent.score(X_big, fold_monitor=False), s_new),
                        f"lifecycle (c): the incumbent's scores moved after {fault}")
                require(not (tmp / "lc-b" / "gen-00003").exists(), f"lifecycle (c): {fault} left gen-00003")
            out["c_rollbacks"] = drills

            # (d) swap under load: four threads through a stalled swap
            probe = batch(30, True)
            old_scores = incumbent.score(probe, fold_monitor=False)
            stall["on"] = True
            results, errors = [], []
            go = threading.Barrier(5)

            def scorer():
                try:
                    go.wait(60)
                    for _ in range(4):
                        results.append(b.score(probe, return_generation=True))
                except Exception as exc:  # surfaced below
                    errors.append(repr(exc))

            with managed():
                require(b.retrain(reason="swap_under_load", wait=False) == "started", "lifecycle (d): no refit")
                require(entered.wait(120), "lifecycle (d): the swap never reached its hook")
                threads = [threading.Thread(target=scorer) for _ in range(4)]
                for th in threads:
                    th.start()
                go.wait(60)
                release.set()
                for th in threads:
                    th.join(120)
                require(b.wait_retrain(timeout_s=300) and not errors and b.generation == 3,
                        f"lifecycle (d): errors {errors}, state {b.state()}")
            stall["on"] = False
            new_scores = b.model.score(probe, fold_monitor=False)
            require(not torch.equal(old_scores, new_scores), "lifecycle (d): the swap changed nothing")
            torn = sum(not torch.equal(s, old_scores if g == 2 else new_scores) for s, g in results)
            require(len(results) == 16 and torn == 0, f"lifecycle (d): {torn} of {len(results)} answers torn")
            out["d_swap_under_load"] = {"answers": len(results), "by_generation": {
                str(g): sum(1 for _, x in results if x == g) for g in (2, 3)},
                "swap_lock_hold_ms": b.last_swap_lock_hold_s * 1e3}
        finally:
            release.set()
            b.close()

        # (e) sliding refresh of the EIF fixture
        model_e = load_model(str(eif_dir))
        require(isinstance(model_e, ExtendedIsolationForestModel), "lifecycle (e): not an EIF")
        before = {f: getattr(model_e.forest, f).clone() for f in model_e.forest._fields}
        with managed():
            e = ModelManager(model_e, str(tmp / "lc-e"), **dict(knobs, mode="sliding"), background=False)
        try:
            t0 = time.perf_counter()
            with managed():
                for i in range(8):
                    e.score(batch(i, True))
                    if e.generation > 1:
                        break
            sliding_s = time.perf_counter() - t0
            require(e.generation == 2 and e.last_retrain["outcome"] == "swapped", f"lifecycle (e): {e.state()}")
            kept = model_e.forest.num_trees - 50
            after = e.model.forest
            for f in before:
                require(torch.equal(getattr(after, f)[:kept], before[f][50:]), f"lifecycle (e): kept {f} differs")
            window = e.last_retrain["window"]
            k_bag, k_feat, k_grow = prng.split(prng.PRNGKey(e.last_retrain["seed"] & 0xFFFFFFFF, device=dev), 3)
            Xw = torch.from_numpy(window).to(dev)
            grown = _grow_block(per_tree_keys(k_grow, 50), Xw,
                                bagged_indices(k_bag, len(window), model_e.num_samples, 50, model_e.params.bootstrap),
                                feature_subsets(k_feat, window.shape[1], model_e.num_features, 50),
                                height_limit(model_e.num_samples), model_e.extension_level)
            for f in before:
                require(torch.equal(getattr(after, f)[kept:], getattr(grown, f)), f"lifecycle (e): grown {f} differs")
            out["e_sliding_eif"] = {"window_rows": int(window.shape[0]), "kept_trees": kept, "grown_trees": 50,
                                    "wall_s": sliding_s}
        finally:
            e.close()

        # (f) serve_model with lifecycle=True over HTTP
        served_dir = tmp / "served"
        shutil.copytree(FIXTURE / "model", served_dir)
        serving_kw = dict(port=0, host="127.0.0.1",
                          config=ServingConfig(max_queue_rows=1 << 17, request_timeout_s=SERVING_TIMEOUT_S),
                          warm_batch_sizes=(1, LIFECYCLE_BATCH),
                          manager_kwargs=dict(checkpoint_every=25, clock=clock.now, sleep=clock.sleep))
        with managed():
            handle = serve_model(str(served_dir), **serving_kw)
            try:
                manager = handle.manager
                require(manager is not None and manager.model.device.type == "cuda", "lifecycle (f): not managed")
                gen1 = manager.model
                answers, generation = [], 1
                t_http = time.perf_counter()
                for i in range(10 ** 6):
                    if time.perf_counter() - t_http > 2 * SERVING_TIMEOUT_S:
                        break
                    rows = batch(40 + i % (LIFECYCLE_TRAFFIC_BATCHES - 40), True)
                    status, _, body = http_request(handle.url, "/score", json.dumps({"rows": rows.tolist()}).encode())
                    require(status == 200, f"lifecycle (f): HTTP {status}: {body[:200]}")
                    doc = json.loads(body)
                    answers.append((rows, np.asarray(doc["scores"], np.float32), doc["generation"]))
                    status, _, body = http_request(handle.url, "/healthz")
                    if generation == 2:
                        break  # this request came after /healthz named generation 2
                    state = json.loads(body)["lifecycle"]
                    generation = state["generation"]
                    if state["retrain_in_progress"]:
                        # a client with 20 ms of think time: (g) measures one
                        # that posts without a pause
                        time.sleep(0.02)
                http_s = time.perf_counter() - t_http
                require(generation == 2 and manager.wait_retrain(timeout_s=300),
                        f"lifecycle (f): no swap over HTTP in {len(answers)} requests, "
                        f"{http_s:.1f} s: {manager.state()}")
                gen2 = manager.model
            finally:
                handle.close()
        differing = sum(int((got != (gen1 if g == 1 else gen2).score(rows, fold_monitor=False).cpu().numpy()).sum())
                        for rows, got, g in answers)
        require(differing == 0 and {g for _, _, g in answers} == {1, 2},
                f"lifecycle (f): {differing} served scores differ from their generation's model.score")
        out["f_http"] = {"requests": len(answers), "seconds": http_s, "refit_wall_s": refit_wall_s(),
                         "by_generation": {str(g): sum(1 for _, _, x in answers if x == g) for g in (1, 2)},
                         "differing_scores": differing}

        # (g) the same server under a client process that posts shifted
        # batches back to back: the refit's wall under that load, or that it
        # did not finish in LIFECYCLE_LOAD_S (it then finishes once the
        # client stops)
        load_dir, bodies, stop = tmp / "load", tmp / "bodies.jsonl", tmp / "stop"
        shutil.copytree(FIXTURE / "model", load_dir)
        bodies.write_bytes(b"\n".join(json.dumps({"rows": batch(40 + i, True).tolist()}).encode()
                                       for i in range(LIFECYCLE_WINDOW_BATCHES)))
        with managed():
            handle = serve_model(str(load_dir), **serving_kw)
            try:
                manager = handle.manager
                client = subprocess.Popen([sys.executable, "-c", LOAD_CLIENT, handle.url, str(bodies), str(stop)],
                                          stdout=subprocess.PIPE, text=True)
                try:
                    # the refit's start and swap as this poll sees them (10 ms
                    # apart): the event ring may drop them under this traffic
                    t_load, t_start = time.perf_counter(), None
                    while manager.generation == 1 and time.perf_counter() - t_load < LIFECYCLE_LOAD_S:
                        if t_start is None and manager.retrain_in_progress:
                            t_start = time.perf_counter()
                        time.sleep(0.01)
                    load_s = time.perf_counter() - t_load
                    swapped_under_load = manager.generation == 2
                    stop.touch()
                    report = json.loads(client.communicate(timeout=SERVING_TIMEOUT_S)[0])
                finally:
                    if client.poll() is None:
                        client.kill()
                        client.wait()
                t_stop = time.perf_counter()
                require(manager.wait_retrain(timeout_s=300) and manager.generation == 2,
                        f"lifecycle (g): no swap after the load: {manager.state()}")
                after_stop_s = time.perf_counter() - t_stop
            finally:
                handle.close()
        lat = report["latencies_s"]
        require(report["not_ok"] == 0 and lat, f"lifecycle (g): {report['not_ok']} of {len(lat)} requests failed")
        out["g_http_without_pause"] = {
            "requests": len(lat), "load_s": load_s, "swapped_under_load": swapped_under_load,
            "refit_started_s": None if t_start is None else t_start - t_load,
            "refit_wall_s": t_load + load_s - t_start if swapped_under_load and t_start is not None else None,
            "swap_after_client_stopped_s": None if swapped_under_load else after_stop_s,
            "client_p50_ms": percentile_ms(lat, 50), "client_p99_ms": percentile_ms(lat, 99)}
        out["launches"] = launches
        require(launches["walk_sum"] > 0 and launches["ext_walk_sum"] > 0, f"lifecycle: launches {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return launches


PARALLEL_ROWS = 10_000_000  # the north star's rows (SURVEY.md:388)
PARALLEL_WORLD_ROWS = 1_000_000  # (c)'s rows, each of two ranks sharing the card
# the north star's deployment (bench.py:800-880): KDDCup99-HTTP-like rows,
# F = 3, 100 trees, maxSamples 256, contamination 0.004
PARALLEL_STEP = dict(num_features_total=3, num_trees=100, num_samples=256, num_features=3, contamination=0.004)
PARALLEL_SKETCH_ERROR = 0.0004
PARALLEL_DEADLINE_S = 10.0  # (c)'s dying world: the survivor's deadline
PARALLEL_HOST_TIMEOUT_S = 300.0  # (c)'s hard bound on every rank process
EXIT_RANK_TIMEOUT = 43
EXIT_RANK_DIED_EARLY = 44

# (c)'s rank, a process of its own: brings up a world (gloo over
# initialize_distributed, or NCCL for a world of one), builds a mesh of its
# one cuda:0 entry, runs the train step and rank 0 saves its arrays; under a
# deadline watchdog with peer heartbeats, exiting 43 on a typed timeout
PARALLEL_RANK = r"""
import os, sys, traceback
root, rank, world, port, out, backend, hb_dir, deadline_s, rows, die_early, device = sys.argv[1:12]
sys.path.insert(0, root)
rank, world, rows = int(rank), int(world), int(rows)
import numpy as np, torch
import chip_smoke
from isoforest_tpu_torch.resilience.retry import DistributedTimeoutError
from isoforest_tpu_torch.resilience.watchdog import (HeartbeatWriter, WatchdogTimeout, format_heartbeat_ages,
                                                     peer_heartbeat_ages, run_with_deadline)
beat = HeartbeatWriter(hb_dir, f"proc{rank}", interval_s=0.5).start()
beat.beat()
if die_early == "1":
    beat.stop()
    print(f"rank {rank}: dying before joining", flush=True)
    os._exit(chip_smoke.EXIT_RANK_DIED_EARLY)

def body():
    import torch.distributed as dist
    from isoforest_tpu_torch.parallel import create_mesh, initialize_distributed
    if world > 1:
        initialize_distributed(f"127.0.0.1:{port}", world, rank, backend=backend)
    else:  # the bring-up is a no-op for one process: a world of one directly
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    mesh = create_mesh([torch.device(device)])
    out_arrays = chip_smoke.parallel_train_steps(mesh, rows)
    out_arrays["backend"] = np.array(mesh.backend)
    if rank == 0:
        np.savez(out, **out_arrays)
    dist.barrier()
    dist.destroy_process_group()

def peers():
    return format_heartbeat_ages(peer_heartbeat_ages(hb_dir), stale_after_s=2.0)

try:
    run_with_deadline(body, float(deadline_s), describe=f"rank {rank} distributed body", on_timeout=peers)
except WatchdogTimeout as exc:
    print(f"rank {rank}: DistributedTimeoutError: {DistributedTimeoutError(str(exc), deadline_s=float(deadline_s))}",
          flush=True)
    os._exit(chip_smoke.EXIT_RANK_TIMEOUT)
except BaseException:
    traceback.print_exc()
    os._exit(1)
beat.stop()
os._exit(0)
"""


def parallel_rows(rows: int, device):
    """``rows`` seeded KDDCup99-HTTP-like rows on ``device``, the same in
    every process."""
    import numpy as np
    import torch

    return torch.from_numpy(kdd_http_like_rows(np.random.default_rng(SEED + 32), rows)).to(device)


def parallel_train_steps(mesh, rows: int, X=None) -> dict:
    """The train step over ``mesh`` on ``rows`` seeded KDDCup99-HTTP-like
    rows (the north star's deployment; ``X``, when given, holds them),
    exact and with the sketch; numpy arrays (forest fields, scores,
    thresholds)."""
    import numpy as np

    from isoforest_tpu_torch.ops import prng
    from isoforest_tpu_torch.parallel import make_train_step

    X = parallel_rows(rows, mesh.first_device) if X is None else X
    exact = make_train_step(mesh, num_rows=rows, **PARALLEL_STEP)(prng.PRNGKey(SEED), X)
    sketch = make_train_step(mesh, num_rows=rows, contamination_error=PARALLEL_SKETCH_ERROR,
                             **PARALLEL_STEP)(prng.PRNGKey(SEED), X)
    out = {f"forest_{f}": getattr(exact.forest, f).cpu().numpy() for f in exact.forest._fields}
    out.update(scores=exact.scores.cpu().numpy(), threshold=np.float32(exact.threshold.item()),
               sketch_scores=sketch.scores.cpu().numpy(), sketch_threshold=np.float32(sketch.threshold.item()))
    return out


def spawn_ranks(world: int, backend: str, rows: int, work: pathlib.Path, die_early_rank=None, device="cuda:0"):
    """Start ``world`` rank processes of :data:`PARALLEL_RANK`, each with a
    mesh of one ``device`` entry, on a free localhost port; returns
    ``(procs, out_path, start)``."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    work.mkdir(parents=True, exist_ok=True)
    out, hb = work / "rank0.npz", work / "heartbeats"
    deadline = PARALLEL_DEADLINE_S if die_early_rank is not None else PARALLEL_HOST_TIMEOUT_S - 60
    procs = [subprocess.Popen(
        [sys.executable, "-c", PARALLEL_RANK, str(ROOT), str(r), str(world), str(port), str(out), backend, str(hb),
         str(deadline), str(rows), "1" if r == die_early_rank else "0", device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for r in range(world)]
    return procs, out, time.perf_counter()


def collect_ranks(procs, start: float) -> tuple:
    """Wait for every rank under the host's hard timeout, killing them all
    past it; ``(exit codes, logs, seconds)``. No rank outlives the call."""
    logs = []
    try:
        for p in procs:
            left = max(1.0, PARALLEL_HOST_TIMEOUT_S - (time.perf_counter() - start))
            logs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return [p.returncode for p in procs], logs, time.perf_counter() - start


def parallel_phases(dev, X_m, X_big, smi: str) -> dict:
    """Phase 32: the multi-device layer on the one card (module docstring).
    Returns the launches of (a)'s mesh scoring by kernel name."""
    import shutil

    import numpy as np
    import torch

    from isoforest_tpu_torch import ExtendedIsolationForest, IsolationForest, load_model
    from isoforest_tpu_torch.io.interop import extended_forest_from_arrays
    from isoforest_tpu_torch.ops import prng
    from isoforest_tpu_torch.ops.bagging import ensemble_draws
    from isoforest_tpu_torch.ops.quantile import quantile_rank_error
    from isoforest_tpu_torch.ops.traversal import score_matrix
    from isoforest_tpu_torch.ops.tree_growth import grow_forest
    from isoforest_tpu_torch.parallel import (create_mesh, make_train_step, sharded_grow_forest, sharded_score,
                                              sharded_score_2d)
    from isoforest_tpu_torch.testing import random_extended_forest, rows
    from isoforest_tpu_torch.utils.math import height_limit

    t_phase = time.perf_counter()
    line = {"phase": "parallel"}

    def same_forest(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # (a) a 1 x 1 mesh over the card
    mesh11 = create_mesh()
    require(mesh11.shape == {"data": 1, "trees": 1} and mesh11.first_device == torch.device("cuda", 0),
            f"create_mesh() on one card: {mesh11}")
    fits = {}
    for kind, cls in (("standard", IsolationForest), ("extended", ExtendedIsolationForest)):
        plain = cls(contamination=0.02, random_seed=1).fit(X_big, baseline=False)
        sharded = cls(contamination=0.02, random_seed=1).fit(X_big, baseline=False, mesh=mesh11)
        require(same_forest(plain.forest, sharded.forest), f"(a) {kind} fit(mesh=) differs from the plain fit")
        require(plain.outlier_score_threshold == sharded.outlier_score_threshold, f"(a) {kind} threshold differs")
        fits[kind] = {"threshold": sharded.outlier_score_threshold}
    models = {"standard": load_model(str(FIXTURE / "model")), "extended": load_model(str(EIF_FIXTURE / "model"))}
    rng = np.random.default_rng(SEED + 32)
    f5 = extended_forest_from_arrays(*random_extended_forest(rng, 100, 8, 274, 274, split_p=1.0)).to(dev)
    X5 = rows(rng, HIGH_DIM_ROWS, 274)
    want = {(kind, s): m.score(X_big, strategy=s) for kind, m in models.items() for s in ("walk", "dense")}
    want["high_dim", "dense"] = score_matrix(f5, X5, 256, strategy="dense")
    zero_launch_counts()
    got = {(kind, s): m.score(X_big, strategy=s, mesh=mesh11) for kind, m in models.items() for s in ("walk", "dense")}
    got["high_dim", "dense"] = sharded_score(mesh11, f5, X5, 256, "dense")
    torch.cuda.synchronize()
    launches = launch_counts()
    require(all(v > 0 for v in launches.values()), f"(a) a kernel did not launch through the mesh: {launches}")
    for key, s in got.items():
        require(torch.equal(s, want[key]), f"(a) score(mesh=) {key} differs from the unsharded scores")
    line["a"] = {"fits": fits, "launches": launches, "bitwise": sorted("/".join(k) for k in got)}

    # (b) logical shards on the one card
    mesh24 = create_mesh([dev] * 8)
    require(mesh24.shape == {"data": 2, "trees": 4}, f"8 entries: {mesh24.shape}")
    Xd = torch.from_numpy(X_big).to(dev)
    tree_keys, bag, fidx = ensemble_draws(prng.PRNGKey(1, device=dev), Xd, num_samples=256, num_trees=100,
                                          bootstrap=False, num_features=Xd.shape[1])
    h = height_limit(256)
    require(same_forest(sharded_grow_forest(mesh24, tree_keys, Xd, bag, fidx, h),
                        grow_forest(tree_keys, Xd, bag, fidx, h)), "(b) sharded growth (T = 100 -> 104) differs")
    b = {"growth_bitwise": True}
    zero_launch_counts()
    for kind, m in models.items():
        for s in ("walk", "dense"):
            require(torch.equal(sharded_score(mesh24, m.forest, X_big, m.num_samples, s, cache=m._cache),
                                want[kind, s]), f"(b) sharded_score {kind}/{s} differs")
            gap = float((sharded_score_2d(mesh24, m.forest, X_big, m.num_samples, s, cache=m._cache)
                         - want[kind, s]).abs().max())
            require(gap <= 2e-6, f"(b) sharded_score_2d {kind}/{s} off by {gap}")
            b[f"2d_{kind}_{s}_max_abs"] = gap
    torch.cuda.synchronize()
    b["launches_2x4"] = launch_counts()

    mesh22 = create_mesh([dev] * 4)
    X_kdd = parallel_rows(PARALLEL_ROWS, dev)  # 120 MB, copied once
    step = parallel_train_steps(mesh22, PARALLEL_ROWS, X_kdd)
    kdd_model = IsolationForest(num_estimators=100, max_samples=256.0, contamination=0.004,
                                random_seed=SEED).fit(X_kdd, baseline=False, mesh=mesh22)
    for f in kdd_model.forest._fields:
        require(np.array_equal(step[f"forest_{f}"], getattr(kdd_model.forest, f).cpu().numpy()),
                f"(b) train step forest field {f} differs from fit(mesh=)")
    kdd_scores = kdd_model.score(X_kdd, strategy="walk", mesh=mesh22)
    require(np.array_equal(step["scores"], kdd_scores.cpu().numpy()), "(b) train step scores differ from score(mesh=)")
    require(np.array_equal(step["sketch_scores"], step["scores"]), "(b) the sketch step's scores differ")
    exact_err = quantile_rank_error(kdd_scores, float(step["threshold"]), 1.0 - 0.004)
    sketch_err = quantile_rank_error(kdd_scores, float(step["sketch_threshold"]), 1.0 - 0.004)
    require(exact_err == 0 and float(step["threshold"]) == kdd_model.outlier_score_threshold,
            f"(b) exact threshold: rank error {exact_err}")
    require(sketch_err <= PARALLEL_SKETCH_ERROR * PARALLEL_ROWS, f"(b) sketch threshold: rank error {sketch_err}")
    b["train_step"] = {"rows": PARALLEL_ROWS, "mesh": mesh22.shape, "threshold": float(step["threshold"]),
                       "sketch_threshold": float(step["sketch_threshold"]), "sketch_rank_error": sketch_err}
    line["b"] = b
    del kdd_scores, kdd_model, step

    # (c) processes sharing the card: a gloo world of two, an NCCL world of
    # one, and a world of two whose rank 1 dies before joining, all at once
    work = ROOT / "build" / f"parallel_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    runs = {"gloo": spawn_ranks(2, "gloo", PARALLEL_WORLD_ROWS, work / "gloo"),
            "nccl": spawn_ranks(1, "nccl", PARALLEL_WORLD_ROWS, work / "nccl"),
            "dying": spawn_ranks(2, "gloo", PARALLEL_WORLD_ROWS, work / "dying", die_early_rank=1)}
    mesh12 = create_mesh([dev] * 2)
    ref12 = parallel_train_steps(mesh12, PARALLEL_WORLD_ROWS)
    ref11 = parallel_train_steps(mesh11, PARALLEL_WORLD_ROWS)
    c = {}
    for name, (procs, out, start) in runs.items():
        codes, logs, seconds = collect_ranks(procs, start)
        c[name] = {"exit_codes": codes, "seconds": seconds}
        if name == "dying":
            require(codes == [EXIT_RANK_TIMEOUT, EXIT_RANK_DIED_EARLY], f"(c) dying world exits {codes}:\n{logs[0][-3000:]}")
            require("DistributedTimeoutError" in logs[0] and "proc1" in logs[0], f"(c) survivor's log:\n{logs[0][-3000:]}")
            require(seconds < PARALLEL_DEADLINE_S + 60, f"(c) the typed timeout took {seconds} s")
            continue
        require(codes == [0] * len(procs), f"(c) {name} world exits {codes}:\n{logs[0][-3000:]}")
        res = dict(np.load(out))
        ref = ref12 if name == "gloo" else ref11
        require(str(res.pop("backend")) == name, f"(c) {name} world ran another backend")
        for key, value in ref.items():
            require(np.array_equal(res[key], value), f"(c) {name} world: {key} differs from one process's")
        c[name]["bitwise_to_one_process"] = True
    shutil.rmtree(work, ignore_errors=True)
    line["c"] = c

    # timings: host clock around synchronised calls, medians of 7, sharded
    # against unsharded on the same card
    def median_s(fn, reps: int = 7) -> float:
        fn()
        return statistics.median(synced(fn)[1] for _ in range(reps))

    std = models["standard"]
    times = {
        "fit_s": {"plain": median_s(lambda: IsolationForest(contamination=0.02, random_seed=1).fit(X_big, baseline=False)),
                  "mesh_1x1": median_s(lambda: IsolationForest(contamination=0.02, random_seed=1).fit(
                      X_big, baseline=False, mesh=mesh11)),
                  "mesh_2x4": median_s(lambda: IsolationForest(contamination=0.02, random_seed=1).fit(
                      X_big, baseline=False, mesh=mesh24))},
        "score_walk_1m_host_s": {"plain": median_s(lambda: std.score(X_big, strategy="walk")),
                                 "mesh_1x1": median_s(lambda: std.score(X_big, strategy="walk", mesh=mesh11)),
                                 "mesh_2x4": median_s(lambda: std.score(X_big, strategy="walk", mesh=mesh24))},
        "score_2d_walk_1m_host_s": {"mesh_2x4": median_s(lambda: sharded_score_2d(
            mesh24, std.forest, X_big, std.num_samples, "walk", cache=std._cache))},
        "train_step_10m_s": {
            "mesh_1x1": median_s(lambda: make_train_step(mesh11, num_rows=PARALLEL_ROWS, **PARALLEL_STEP)(
                prng.PRNGKey(SEED), X_kdd)),
            "mesh_2x2": median_s(lambda: make_train_step(mesh22, num_rows=PARALLEL_ROWS, **PARALLEL_STEP)(
                prng.PRNGKey(SEED), X_kdd))},
    }
    line["times"] = times
    line["nvidia_smi"] = smi
    line["phase_s"] = time.perf_counter() - t_phase
    emit(line)
    return launches


FLEET_SIZES = (1, 64, 4096)  # rows of each phase-33 request, and of each timed autopilot flush
FLEET_PINS = ("auto", "walk", "dense")  # the ISOFOREST_TPU_STRATEGY pin of each pass (auto: none)
FLEET_WIDE_TREES = 100  # the F = k = 274 tenant: phase 29's forest shape
FLEET_BUDGET_SLACK = 1 << 20  # the budget: both mammography tenants' card bytes and 1 MiB
AUTOPILOT_QUEUE_ROWS = 16_384
AUTOPILOT_REPS = 7  # timed flushes per size and rung (median)
STREAM_EVENTS = 500_000  # cut from 1M: the phase's same run on the CPU takes about 45 s a million
STREAM_BATCH = 4096
STREAM_RATE = 1000.0  # events per second of event time: 1M events span 1,000 s
STREAM_SHIFT_FROM = 0.6  # the last 40% of the events shifted by LIFECYCLE_SHIFT_SD
STREAM_WINDOW_S = 60.0
STREAM_LATENESS_S = 1.0  # the events arrive up to 0.5 s out of order: none late
STREAM_HALF_LIFE_S = 60.0  # the decay reservoir's half-life: a window of event time
STREAM_DEBOUNCE = 16  # drifted evaluations (4,096-row batches) in a row that trigger a refit
STREAM_SOCKET_ROWS = 65_536
STREAM_SOCKET_TIMEOUT_S = 60.0


class strategy_pin:
    """``ISOFOREST_TPU_STRATEGY`` set to ``pin`` for the block (``auto``:
    unset), as a user pins the strategy of every ``auto`` resolution."""

    def __init__(self, pin: str) -> None:
        self.pin = pin

    def __enter__(self):
        self.saved = os.environ.pop("ISOFOREST_TPU_STRATEGY", None)
        if self.pin != "auto":
            os.environ["ISOFOREST_TPU_STRATEGY"] = self.pin

    def __exit__(self, *exc):
        os.environ.pop("ISOFOREST_TPU_STRATEGY", None)
        if self.saved is not None:
            os.environ["ISOFOREST_TPU_STRATEGY"] = self.saved


def json_rows(X) -> bytes:
    return json.dumps({"rows": X.tolist()}).encode()


def fleet_phases(dev, X_m, smi: str) -> dict:
    """Phase 33: the multi-tenant fleet and the overload autopilot on the
    card. ``serve_fleet`` over a models directory of three tenants: copies of
    ``mammography_std`` (K1, K2) and ``mammography_eif`` (K3, K4), each
    served through a lifecycle manager, and a seeded F = k = 274 EIF forest
    (phase 29's shape, K5 and K3) saved there, served bare. With every launch
    counter at 0 just before and read just after: JSON ``POST
    /score/<id>`` of 1, 64 and 4,096 rows to each tenant under each
    strategy pin (auto, walk, dense), each answer bit for bit the tenant's
    ``model.score`` of the same rows under the same pin; the registry's
    count of each tenant's card bytes beside the rise of
    ``torch.cuda.memory_allocated`` over its load and passes; the budget
    set to both mammography tenants' counts and 1 MiB, so the wide
    tenant's first request evicts both by LRU; a ``fail_fleet_load`` drill
    (a typed 503 with Retry-After, the resident tenant answering 200), the
    reload that evicts the wide tenant by LRU, an ``evict_during_score``
    drill (200, bit for bit, evicted with cause ``fault_injected``) and
    ``GET /models``. Then an ``Autopilot`` over two threadless services on
    a FakeClock (the standard fixture at weight 1, the EIF fixture at
    0.5), with real queued pressure and ``tick()`` driven here, walked down
    rungs 1-3 and back up: flush times at 1, 64 and 4,096 rows at each rung
    (medians), at rung 3 both as the port applies it (the tree prefix on
    the f32 kernels) and with ``set_quality(force_q16=True)``; answers at
    rungs 0-2 bit for bit ``model.score``, at rung 3 bit for bit
    ``score_matrix`` of the same prefix and strategy. Returns the fleet
    section's launches by kernel name."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from isoforest_tpu_torch import load_model, telemetry
    from isoforest_tpu_torch.autopilot import Autopilot, AutopilotConfig
    from isoforest_tpu_torch.fleet import serve_fleet
    from isoforest_tpu_torch.io.interop import extended_forest_from_arrays
    from isoforest_tpu_torch.models.extended import ExtendedIsolationForestModel
    from isoforest_tpu_torch.ops.traversal import score_matrix
    from isoforest_tpu_torch.resilience import faults
    from isoforest_tpu_torch.resilience.degradation import degradations
    from isoforest_tpu_torch.serving import ScoringService, ServingConfig, ShedError
    from isoforest_tpu_torch.testing import random_extended_forest, rows
    from isoforest_tpu_torch.utils.params import ExtendedIsolationForestParams

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="fleet_", dir=build))
    out = {"phase": "fleet", "nvidia_smi": smi}
    try:
        models_dir = tmp / "models"
        shutil.copytree(FIXTURE / "model", models_dir / "mammography_std")
        shutil.copytree(EIF_FIXTURE / "model", models_dir / "mammography_eif")
        rng = np.random.default_rng(SEED + 33)
        wide = ExtendedIsolationForestModel(
            forest=extended_forest_from_arrays(*random_extended_forest(rng, FLEET_WIDE_TREES, 8, 274, 274,
                                                                       split_p=1.0), device=dev),
            params=ExtendedIsolationForestParams(), num_samples=256, num_features=274, extension_level=273,
            total_num_features=274)
        t0 = time.perf_counter()
        wide.save(str(models_dir / "wide_eif_274"))
        out["wide_save_s"] = time.perf_counter() - t0
        tenants = ("mammography_std", "mammography_eif", "wide_eif_274")
        refs = {"mammography_std": load_model(str(FIXTURE / "model"), device=dev),
                "mammography_eif": load_model(str(EIF_FIXTURE / "model"), device=dev), "wide_eif_274": wide}
        pool = {t: X_m if t != "wide_eif_274" else rows(rng, max(FLEET_SIZES), 274) for t in tenants}
        req = {t: {n: pool[t][np.random.default_rng(SEED + n).integers(0, len(pool[t]), n)] for n in FLEET_SIZES}
               for t in tenants}
        bodies = {(t, n): json_rows(req[t][n]) for t in tenants for n in FLEET_SIZES}
        # the references, outside the counted section: each tenant's model.score
        # under each pin (auto: the autotune table's winner, which the fleet's
        # resolutions then read)
        want = {}
        for pin in FLEET_PINS:
            with strategy_pin(pin):
                for t in tenants:
                    for n in FLEET_SIZES:
                        want[(t, pin, n)] = [float(s) for s in refs[t].score(req[t][n]).cpu().numpy()]

        def alloc() -> int:
            gc.collect()
            return torch.cuda.memory_allocated(dev) if on_card else 0

        config = ServingConfig(batch_rows=4096, linger_ms=2.0, max_queue_rows=16_384, request_timeout_s=120.0)
        handle = serve_fleet(str(models_dir), config=config, work_root=str(tmp / "work"), device=dev)
        registry = handle.registry
        checks, footprint = [], {}
        zero_launch_counts()
        try:
            def post(t: str, n: int, pin: str, expect: int = 200):
                status, headers, text = http_request(handle.url, f"/score/{t}", bodies[(t, n)])
                require(status == expect, f"/score/{t} {n} rows under {pin}: {status} {text[:300]}")
                doc = json.loads(text)
                if expect == 200:
                    require(doc["scores"] == want[(t, pin, n)], f"/score/{t} {n} rows under {pin}: not model.score")
                    require(doc["model_id"] == t, f"/score/{t}: model_id {doc['model_id']}")
                checks.append((t, n, pin, status))
                return doc, headers

            def passes(t: str) -> None:
                for pin in FLEET_PINS:
                    with strategy_pin(pin):
                        for n in FLEET_SIZES:
                            post(t, n, pin)

            base = alloc()
            t0 = time.perf_counter()
            passes("mammography_std")
            a1 = alloc()
            passes("mammography_eif")
            a2 = alloc()
            out["mammography_passes_s"] = time.perf_counter() - t0
            counted = {t: registry.entry(t).resident_bytes for t in tenants[:2]}
            footprint["mammography_std"] = {"registry_bytes": counted["mammography_std"], "allocated_rise": a1 - base}
            footprint["mammography_eif"] = {"registry_bytes": counted["mammography_eif"], "allocated_rise": a2 - a1}
            # the budget holds both mammography tenants, not the wide one too
            registry.budget_bytes = counted["mammography_std"] + counted["mammography_eif"] + FLEET_BUDGET_SLACK
            out["budget_bytes"] = registry.budget_bytes
            t0 = time.perf_counter()
            passes("wide_eif_274")
            out["wide_load_and_passes_s"] = time.perf_counter() - t0
            wide_entry = registry.entry("wide_eif_274")
            # both mammography tenants were evicted by the wide tenant's load:
            # what is allocated now, above the fleet's start, is its alone
            footprint["wide_eif_274"] = {"registry_bytes": wide_entry.resident_bytes, "allocated_rise": alloc() - base}
            require(not registry.entry("mammography_std").resident and not registry.entry("mammography_eif").resident,
                    f"the wide tenant's load left {registry.models_state()}")
            for t, row in footprint.items():
                row["registry_vs_allocated"] = row["registry_bytes"] / row["allocated_rise"] if row[
                    "allocated_rise"] else None
            out["footprint"] = footprint
            # fail_fleet_load on the evicted standard tenant: a typed 503, while
            # the resident wide tenant answers
            with faults.inject(fail_fleet_load="mammography_std"):
                doc, headers = post("mammography_std", 1, "auto", expect=503)
                require(doc["status"] == 503 and headers.get("Retry-After") == "1", f"fail_fleet_load: {doc}")
                post("wide_eif_274", 1, "auto")
            # the drill cleared: the reload evicts the wide tenant by LRU
            post("mammography_std", 64, "auto")
            require(not wide_entry.resident, "the standard tenant's reload kept the wide tenant")
            # evict_during_score: the answer comes from the drained flush
            with faults.inject(evict_during_score=True):
                post("mammography_std", 64, "auto")
            require(not registry.entry("mammography_std").resident, "evict_during_score did not evict")
            post("mammography_eif", max(FLEET_SIZES), "auto")
            status, _, text = http_request(handle.url, "/models")
            models = json.loads(text)
            resident = sorted(r["model_id"] for r in models["models"] if r["resident"])
            require(status == 200 and resident == ["mammography_eif"] and models["resident_bytes"]
                    <= models["budget_bytes"], f"GET /models: {models}")
            evicts = [(e.fields["model_id"], e.fields["cause"]) for e in telemetry.get_events(kind="fleet.evict")]
            require(evicts == [("mammography_std", "budget"), ("mammography_eif", "budget"),
                               ("wide_eif_274", "budget"), ("mammography_std", "fault_injected")],
                    f"evictions {evicts}")
            rungs = {d.reason: d.count for d in degradations() if d.reason.startswith("fleet_")}
            require(rungs == {"fleet_load_failed": 1, "fleet_evict_under_load": 1}, f"fleet rungs {rungs}")
            launches = launch_counts()
            out.update(requests=len(checks), evictions=evicts, rungs=rungs,
                       loads=[(e.fields["model_id"], e.fields["bytes"], e.fields["load_seconds"])
                              for e in telemetry.get_events(kind="fleet.load")],
                       models=models["models"], launches=launches)
            require(not on_card or all(launches[k] > 0 for k in launches),
                    f"a kernel did not launch in the fleet: {launches}")
        finally:
            handle.close()

        # the autopilot, over two threadless services on a FakeClock
        fc = faults.FakeClock()
        std, eif = refs["mammography_std"], refs["mammography_eif"]
        gold = ScoringService(model=std, config=ServingConfig(batch_rows=4096, linger_ms=2.0,
                                                              max_queue_rows=AUTOPILOT_QUEUE_ROWS, weight=1.0),
                              clock=fc.now, start=False, model_id="mammography_std")
        bronze = ScoringService(model=eif, config=ServingConfig(batch_rows=4096, linger_ms=2.0,
                                                                max_queue_rows=AUTOPILOT_QUEUE_ROWS, weight=0.5),
                                clock=fc.now, start=False, model_id="mammography_eif")
        ap = Autopilot(services=[gold, bronze], config=AutopilotConfig(engage_ticks=1, recover_ticks=1),
                       clock=fc.now)
        prefix = type(std.forest)(*(leaf[: std.forest.num_trees // 2] for leaf in std.forest))
        zero_launch_counts()
        flush_ms, rung_log = {}, []
        try:
            def drain() -> None:
                while gold.coalescer.pending_rows:
                    if not gold.coalescer.pump():
                        fc.advance(1.0)

            def pressure() -> None:
                # real queued rows: 0.75 of the queue, never pumped before the tick
                big = req["mammography_std"][max(FLEET_SIZES)]
                for i in range(3 * AUTOPILOT_QUEUE_ROWS // 4 // len(big)):
                    gold.coalescer.submit(big)

            def timed(label: str, expected) -> None:
                drain()
                times = {}
                for n in FLEET_SIZES:
                    rows_n = req["mammography_std"][n]
                    want_n = expected(rows_n)
                    samples = []
                    for _ in range(AUTOPILOT_REPS):
                        p = gold.coalescer.submit(rows_n)
                        fc.advance(1.0)
                        t0 = time.perf_counter()
                        require(gold.coalescer.pump() == 1, f"{label}: no flush")
                        samples.append(time.perf_counter() - t0)
                        got = gold.coalescer.result(p, timeout_s=0)
                        require(np.array_equal(got, want_n), f"{label}: {n}-row answer differs")
                    times[n] = statistics.median(samples) * 1e3
                flush_ms[label] = times

            def model_score(X):
                return std.score(X).cpu().numpy()

            def prefix_score(strategy):
                return lambda X: score_matrix(prefix, X, std.num_samples, strategy=strategy, device=std.device,
                                              cache={}).cpu().numpy()

            timed("rung0", model_score)
            for rung in (1, 2, 3):
                pressure()
                got = ap.tick()
                require(got == rung, f"tick gave rung {got}, expected {rung}")
                rung_log.append({"rung": rung, "pressure": ap.last_pressure, "batch_rows": gold.coalescer.max_batch_rows,
                                 "linger_ms": gold.coalescer.max_linger_s * 1e3, "bronze_shed": bronze.shed,
                                 "quality": gold.quality})
                if rung == 2:
                    try:
                        bronze.check_admission()
                    except ShedError as exc:
                        require(exc.status == 429, f"shed status {exc.status}")
                    else:
                        fail("rung 2 did not shed the lower-weight service")
                if rung < 3:
                    timed(f"rung{rung}", model_score)
            require(gold.quality == {"subsample_trees": 0.5, "q16": not on_card}, f"rung 3 quality {gold.quality}")
            timed("rung3_as_applied", prefix_score("q16" if not on_card else "auto"))
            detail = [d.detail for d in degradations() if d.reason == "autopilot_quality_degrade"]
            gold.set_quality(subsample_trees=0.5, force_q16=True)
            timed("rung3_q16", prefix_score("q16"))
            gold.set_quality(subsample_trees=0.5, force_q16=not on_card)
            for rung in (2, 1, 0):
                drain()
                got = ap.tick()
                require(got == rung, f"recovery tick gave rung {got}, expected {rung}")
            require(gold.quality is None and not bronze.shed and gold.coalescer.max_batch_rows == 4096,
                    f"rung 0 did not restore: {gold.state()}")
            timed("recovered", model_score)
            out["autopilot"] = {"rungs": rung_log, "flush_ms": flush_ms, "rung3_detail": detail,
                                "launches": launch_counts(), "state": ap.state()}
        finally:
            ap.close()
            gold.close()
            bronze.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out["launches"]


def stream_events(X_m, n: int):
    """``(event_ts, rows)`` of the phase-34 stream: resampled mammography
    rows at ``STREAM_RATE`` events a second, up to 0.5 s out of order, the
    last 40% shifted by ``LIFECYCLE_SHIFT_SD`` standard deviations per
    feature."""
    import numpy as np

    rng = np.random.default_rng(SEED + 34)
    X = X_m[rng.integers(0, len(X_m), n)].astype(np.float32)
    X[int(n * STREAM_SHIFT_FROM):] += (LIFECYCLE_SHIFT_SD * X_m.std(axis=0)).astype(np.float32)
    ts = np.arange(n, dtype=np.float64) / STREAM_RATE + rng.uniform(0.0, 0.5, n)
    return ts, X


def run_stream(dev, ts, X, work: pathlib.Path, source=None, on_scored=None):
    """One ``StreamEngine`` over a ``ModelManager`` of ``mammography_std`` on
    ``dev`` (a decay reservoir with a 60 s half-life; sustained drift over
    ``STREAM_DEBOUNCE`` batches triggers a refit inside the flush that saw
    it, so the swap lands at one point of the stream, and the engine adds no
    window-cadence refits), fed ``STREAM_BATCH``-row batches through
    ``generator_source`` (or ``source``). Returns ``(summary, wall seconds,
    events, generation -> model)``."""
    from isoforest_tpu_torch import load_model, telemetry
    from isoforest_tpu_torch.lifecycle import ModelManager
    from isoforest_tpu_torch.stream import StreamBatch, StreamConfig, StreamEngine, generator_source

    telemetry.reset_events()
    model = load_model(str(FIXTURE / "model"), device=dev)
    manager = ModelManager(model, str(work), reservoir="decay", reservoir_half_life_s=STREAM_HALF_LIFE_S,
                           drift_debounce=STREAM_DEBOUNCE, background=False)
    engine = StreamEngine(manager, StreamConfig(window_s=STREAM_WINDOW_S, lateness_s=STREAM_LATENESS_S,
                                                retrain_every=10**9, batch_rows=STREAM_BATCH), on_scored=on_scored)
    if source is None:
        source = generator_source(StreamBatch(ts[i : i + STREAM_BATCH], X[i : i + STREAM_BATCH], None)
                                  for i in range(0, len(ts), STREAM_BATCH))
    try:
        t0 = time.perf_counter()
        summary = engine.run(source)
        wall = time.perf_counter() - t0
    finally:
        manager.close()
    events = [(e.kind, e.unix_s, dict(e.fields)) for e in telemetry.get_events()
              if e.kind.startswith(("stream.", "retrain.", "drift."))]
    models = {1: model}
    for g in range(2, summary["generation"] + 1):
        models[g] = load_model(str(work / f"gen-{g:05d}"), device=dev)
    return summary, wall, events, models


def stream_phases(dev, X_m, smi: str, events: int = STREAM_EVENTS) -> dict:
    """Phase 34: the stream engine on the card. ``events`` resampled
    mammography rows with event times (1,000 a second of event time, up to
    0.5 s out of order, 1 s lateness, 60 s tumbling windows), the last 40%
    shifted by 3 standard deviations per feature, in 4,096-row batches from
    ``generator_source`` through a ``StreamEngine`` over a ``ModelManager``
    of ``mammography_std`` (decay reservoir; sustained drift triggers the
    refits, run inside the flush), with every launch counter at 0 just before and read
    just after: at least one refit and swap; each batch's scores bit for
    bit its generation's ``model.score`` (generations reloaded from the
    work directory); the pane, window, fold and late-row counts equal to
    the same run on the CPU; then 65,536 of the rows over a
    ``socket_source`` on localhost (under its own timeout), whose scores
    equal the generator run's bit for bit. Prints events/s, the lag's p50
    and p99 and the refit's wall time. Returns the launches by kernel
    name."""
    import shutil
    import socket
    import tempfile
    import threading

    import numpy as np
    import torch

    from isoforest_tpu_torch import telemetry
    from isoforest_tpu_torch.stream import engine as stream_engine
    from isoforest_tpu_torch.stream import socket_source

    t_phase = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="stream_", dir=build))
    out = {"phase": "stream", "nvidia_smi": smi, "events": events}
    try:
        ts, X = stream_events(X_m, events)
        scored = []
        telemetry.reset_metrics()
        zero_launch_counts()
        summary, wall, evs, models = run_stream(dev, ts, X, tmp / "card",
                                                on_scored=lambda b, s, g: scored.append((b.X, np.array(s), g)))
        launches = launch_counts()
        lag = stream_engine._LAG_SECONDS.summary()
        require(summary["rows"] == events and summary["late_rows"] == 0, f"stream summary {summary}")
        swaps = sum(1 for e in evs if e[0] == "retrain.swap")
        require(swaps >= 1 and summary["generation"] == swaps + 1, f"no swap on the shifted stream: {summary}")
        require(dev.type != "cuda" or launches["walk_sum"] + launches["dense_mean"] > 0,
                f"the stream launched {launches}")
        for Xb, s, g in scored:
            require(np.array_equal(s, models[g].score(Xb).cpu().numpy()),
                    f"a batch differs from generation {g}'s model.score")
        starts = {e[2]["seq"]: e[1] for e in evs if e[0] == "retrain.start"}
        refits = [{"generation": e[2]["generation"], "wall_s": e[1] - starts[e[2]["seq"]], "outcome": e[0]}
                  for e in evs if e[0] in ("retrain.swap", "retrain.rollback")]
        counts = {k: summary[k] for k in ("windows_closed", "empty_windows", "folded_rows", "late_rows")}
        counts["folds"] = sum(1 for e in evs if e[0] == "stream.fold")
        out.update(wall_s=wall, events_per_s=events / wall, lag_s={k: lag[k] for k in ("p50", "p99", "max")},
                   swaps=swaps, generation=summary["generation"],
                   rows_by_generation=summary["rows_by_generation"], refits=refits, counts=counts,
                   retrain_outcomes=summary["retrain_outcomes"], launches=launches)
        # the same run on the CPU: the same panes, windows and folds
        t0 = time.perf_counter()
        cpu_summary, _, cpu_evs, _ = run_stream(torch.device("cpu"), ts, X, tmp / "cpu")
        cpu_counts = {k: cpu_summary[k] for k in ("windows_closed", "empty_windows", "folded_rows", "late_rows")}
        cpu_counts["folds"] = sum(1 for e in cpu_evs if e[0] == "stream.fold")
        out["cpu"] = {"counts": cpu_counts, "generation": cpu_summary["generation"],
                      "wall_s": time.perf_counter() - t0}
        require(cpu_counts == counts, f"pane and window counts: card {counts}, CPU {cpu_counts}")
        # the socket source over localhost, under its own deadline
        n_sock = min(STREAM_SOCKET_ROWS, events)
        deadline = time.monotonic() + STREAM_SOCKET_TIMEOUT_S
        done = threading.Event()
        feed = socket_source(0, chunk_rows=STREAM_BATCH, idle_s=0.05,
                             should_stop=lambda: done.is_set() or time.monotonic() > deadline)
        lines = "".join(",".join(repr(float(v)) for v in (t, *r)) + "\n" for t, r in zip(ts[:n_sock], X[:n_sock]))

        def send() -> None:
            with socket.create_connection(("127.0.0.1", feed.port), timeout=STREAM_SOCKET_TIMEOUT_S) as s:
                s.sendall(lines.encode())

        sender = threading.Thread(target=send, daemon=True)
        sender.start()

        def received():
            n = 0
            for b in feed.batches():
                n += b.rows
                if n >= n_sock:
                    done.set()
                yield b

        sock_scored = []
        try:
            t0 = time.perf_counter()
            sock_summary, _, _, _ = run_stream(dev, None, None, tmp / "socket", source=received(),
                                               on_scored=lambda b, s, g: sock_scored.append(np.array(s)))
            sock_wall = time.perf_counter() - t0
        finally:
            done.set()
            feed.stop()
            sender.join(timeout=STREAM_SOCKET_TIMEOUT_S)
        require(sock_summary["rows"] == n_sock, f"the socket delivered {sock_summary['rows']} of {n_sock} rows")
        first = np.concatenate([s for _, s, _ in scored])[:n_sock]
        require(np.array_equal(np.concatenate(sock_scored), first), "the socket run's scores differ")
        out["socket"] = {"rows": n_sock, "wall_s": sock_wall, "windows_closed": sock_summary["windows_closed"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out["launches"]


TIER_SIZES = (1, 64, 4096)  # rows of each routed request, and of the router's hop
TIER_PINS = FLEET_PINS  # (a)'s requests under each strategy pin, so K1-K4 all run
TIER_LOAD_REQUESTS = 200  # (b)'s closed-loop 1-row requests
TIER_KILL_AFTER = 100  # (b) SIGKILLs the serving replica after this many answers
TIER_HOP_REPS = {1: 100, 64: 100, 4096: 30}  # routed and direct requests of each size, in turns
TIER_JOURNAL_REQUESTS = 200  # 1-row requests with the journal on and off, in four turns


# a router in a process of its own (argv: the checkout's root, a replica's
# URL): one routed 1-row request, and whether the process brought up CUDA
ROUTER_ALONE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from isoforest_tpu_torch.replication import Replica, Router
router = Router([Replica("replica", sys.argv[2])])
router.probe_once()
status, _, payload, _ = router.handle_score_model("mammography_std", b'{"rows": [[0, 0, 0, 0, 0, 0]]}', {})
print(json.dumps({"status": status, "admitted": router.replicas[0].admitted,
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


def tier_post(url: str, path: str, body: bytes, headers=None):
    """``http_request``'s ``(status, headers, text)`` of one JSON POST, and
    its seconds."""
    t0 = time.perf_counter()
    return (*http_request(url, path, body, headers=headers), time.perf_counter() - t0)


def counter_sums(metrics_doc: dict, name: str) -> dict:
    """``{label set: value}`` of one counter in a registry snapshot."""
    series = (metrics_doc.get(name) or {}).get("series", ())
    return {tuple(sorted((k, str(v)) for k, v in s["labels"].items())): s["value"] for s in series}


def compute_apps() -> dict:
    """``{pid: used MiB}`` of the card's compute processes, as
    ``nvidia-smi --query-compute-apps`` lists them."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    apps = {}
    for line in out.stdout.strip().splitlines():
        pid, _, mib = line.partition(",")
        try:
            apps[int(pid)] = float(mib)
        except ValueError:
            continue
    return apps


def tier_phases(dev, X_m, smi: str) -> dict:
    """Phase 35: the replicated serving tier on the card. (a) In one
    process: a port ``Router`` over two port ``serve_fleet`` replicas of
    ``mammography_std`` and ``mammography_eif`` (each under its manager),
    behind a telemetry daemon. With every launch counter at 0 just before
    and read just after: JSON ``POST /score/<id>`` of 1, 64 and 4,096 rows
    through the router under each strategy pin, each answer bit for bit the
    tenant's ``model.score``; a ``kill_replica_during_score`` sever retried
    bit for bit, the monitor folding its rows once; a
    ``stall_current_json_push`` drill (a generation 2 sealed and named by
    ``CURRENT.json``: answers stay generation 1's bit for bit while the push
    is stalled, then generation 2's on both replicas); the tier's ``GET
    /metrics`` (each counter the sum of the sources' own) and ``GET
    /trace?format=spans`` (``router.request`` and ``serving.request`` under
    one trace id). Then the journal's cost: 1-row requests straight to a
    replica with the journal off and on, in turns. (b) Spawned:
    ``serve_router(models_dir, replicas=2, journal_dir=)`` starts two
    ``python -m isoforest_tpu_torch serve --models-dir --no-lifecycle``
    processes (bare tenants) on the card with an empty kernel build
    directory, warmed at once (both build the kernels together); every
    answer bit for bit the tenant's ``model.score``; the tier's ``/trace``
    stitching the router's lane to a replica's; 200 closed-loop 1-row
    requests, the serving replica SIGKILLed after 100: no request fails,
    the router ejects it within ``probe_interval_s + probe_timeout_s``, the
    tier's ``/metrics`` counts the live replica's own requests, its
    ``/debug/bundle`` names it missing and recovers its spool (with its
    ``fleet.load`` events) from the journal; the router's hop on the
    survivor (routed against direct, in turns, at 1, 64 and 4,096 rows);
    then a drain. Prints each replica's seconds to its ready line
    and its card memory. Returns (a)'s launches by kernel name."""
    import shutil
    import signal
    import tempfile
    import threading

    import numpy as np
    import torch

    from isoforest_tpu_torch import IsolationForest, load_model, telemetry
    from isoforest_tpu_torch.fleet import serve_fleet
    from isoforest_tpu_torch.ops import _build
    from isoforest_tpu_torch.replication import Replica, Router, RouterConfig, mount_router, serve_router
    from isoforest_tpu_torch.replication import unmount_router
    from isoforest_tpu_torch.resilience import faults
    from isoforest_tpu_torch.serving import ServingConfig
    from isoforest_tpu_torch.telemetry.http import MetricsServer

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="tier_", dir=build))
    out = {"phase": "tier", "nvidia_smi": smi}
    tenants = ("mammography_std", "mammography_eif")

    def free_mib() -> float:
        """The card's free memory, MiB (0 off the card)."""
        return torch.cuda.mem_get_info(dev)[0] / 2**20 if on_card else 0.0

    policy = telemetry.set_trace_policy()
    telemetry.set_trace_policy(slow_threshold_s=0.0, sample_every=1)  # keep every trace for /trace
    try:
        models_dir = tmp / "models"
        shutil.copytree(FIXTURE / "model", models_dir / "mammography_std")
        shutil.copytree(EIF_FIXTURE / "model", models_dir / "mammography_eif")
        refs = {"mammography_std": load_model(str(FIXTURE / "model"), device=dev),
                "mammography_eif": load_model(str(EIF_FIXTURE / "model"), device=dev)}
        req = {n: X_m[np.random.default_rng(SEED + 35 + n).integers(0, len(X_m), n)] for n in TIER_SIZES}
        bodies = {n: json_rows(req[n]) for n in TIER_SIZES}
        # the references, outside the counted section: each tenant's
        # model.score under each pin (auto: the autotune table's winner, which
        # the replicas' resolutions then read, the spawned ones from its file)
        want = {}
        for pin in TIER_PINS:
            with strategy_pin(pin):
                for t in tenants:
                    for n in TIER_SIZES:
                        want[(t, pin, n)] = [float(s) for s in refs[t].score(req[n]).cpu().numpy()]
        # generation 2 of the standard tenant, sealed outside the tier (as a
        # refit in another process would), for the push drill
        gen2 = IsolationForest(contamination=0.02, random_seed=77, device=dev).fit(X_m)
        work = tmp / "work"
        gen2_dir = work / "mammography_std" / "gen-00002"
        gen2.save(str(gen2_dir))
        want_gen2 = [float(s) for s in gen2.score(req[64]).cpu().numpy()]
        require(want_gen2 != want[("mammography_std", "auto", 64)], "generation 2 scores as generation 1")

        # (a) the in-process tier
        config = ServingConfig(batch_rows=4096, linger_ms=0.0, request_timeout_s=120.0)
        handles = [serve_fleet(str(models_dir), config=config, work_root=str(work), device=dev) for _ in range(2)]
        router = Router([Replica(f"r{i}", h.server.url) for i, h in enumerate(handles)], models_dir=str(models_dir),
                        work_root=str(work))
        front = MetricsServer(port=0).start()
        mount_router(front, router)
        a = {}
        zero_launch_counts()
        try:
            router.probe_once()
            require(all(r.admitted for r in router.replicas), f"probe: {router.state()}")

            def routed(t: str, n: int, pin: str, headers=None) -> dict:
                status, hdrs, text, _ = tier_post(front.url, f"/score/{t}", bodies[n], headers)
                require(status == 200, f"routed /score/{t} {n} rows under {pin}: {status} {text[:300]}")
                doc = json.loads(text)
                require(doc["scores"] == want[(t, pin, n)], f"routed /score/{t} {n} rows under {pin}: not model.score")
                return doc

            for pin in TIER_PINS:
                with strategy_pin(pin):
                    for t in tenants:
                        for n in TIER_SIZES:
                            routed(t, n, pin)
            a["requests"] = len(TIER_PINS) * len(tenants) * len(TIER_SIZES)
            # a replica severed mid-request: retried bit for bit, folded once
            folded = counter_sums(telemetry.registry().snapshot(), "isoforest_monitored_rows_total")
            with faults.inject(kill_replica_during_score=True):
                routed("mammography_std", 64, "auto")
            folded_after = counter_sums(telemetry.registry().snapshot(), "isoforest_monitored_rows_total")
            delta = sum(folded_after.values()) - sum(folded.values())
            retries = [e.fields["replica"] for e in telemetry.get_events(kind="router.replica_retry")]
            require(delta == 64 and len(retries) == 1, f"sever drill: folded {delta} rows, retries {retries}")
            r0 = router.replicas[0]
            require(not r0.admitted and r0.down_cause == "request_failed", f"sever drill: {r0.state()}")
            router.probe_once()
            require(r0.admitted, "the severed replica was not admitted again")
            a["sever"] = {"retried_from": retries, "folded_rows": delta}
            # the push drill: both replicas hold generation 1, CURRENT.json
            # names generation 2, the push is stalled, then released
            for h in handles:
                status, _, text, _ = tier_post(h.server.url, "/score/mammography_std", bodies[64])
                require(status == 200 and json.loads(text)["generation"] == 1, f"push drill warm: {text[:200]}")
            with open(work / "mammography_std" / "CURRENT.json", "w") as fh:
                json.dump({"generation": 2, "path": str(gen2_dir), "swapped_unix_s": time.time()}, fh)
            with faults.inject(stall_current_json_push=True):
                require(router.push_once() == {}, "a stalled push made progress")
                for _ in range(4):
                    doc = routed("mammography_std", 64, "auto")
                    require(doc["generation"] == 1, f"stalled push answered generation {doc['generation']}")
            require(router.push_once() == {"mammography_std": 2}, f"push: {router.state()}")
            pushes = [dict(e.fields) for e in telemetry.get_events(kind="router.push")]
            require(len(pushes) == 1 and pushes[0]["generation"] == 2, f"router.push events {pushes}")
            for h in handles:
                status, _, text, _ = tier_post(h.server.url, "/score/mammography_std", bodies[64])
                doc = json.loads(text)
                require(status == 200 and doc["generation"] == 2 and doc["scores"] == want_gen2,
                        f"after the push a replica answered generation {doc.get('generation')}")
            status, _, text, _ = tier_post(front.url, "/score/mammography_std", bodies[64])
            require(status == 200 and json.loads(text)["scores"] == want_gen2, "routed after the push")
            a["push"] = {"events": pushes, "acked": {r.name: dict(r.acked_generations) for r in router.replicas}}
            # the tier's /metrics: every counter the sum of its sources' own
            local = telemetry.registry().snapshot()
            sources, missing = router.federation_sources("/snapshot")
            status, _, text = http_request(front.url, "/metrics")
            require(status == 200 and not missing, f"tier /metrics {status}: {text[:300]}")
            parsed = telemetry.parse_prometheus(text)
            for name in ("isoforest_fleet_responses_total", "isoforest_router_requests_total"):
                own = {}
                for doc in (local, *(d["metrics"] for _, d in sources)):
                    for key, value in counter_sums(doc, name).items():
                        own[key] = own.get(key, 0) + value
                require(own and all(parsed[name][k] == v for k, v in own.items()), f"tier {name}: {own}")
            # /trace: router.request and serving.request under one trace id
            routed("mammography_eif", 1, "auto", headers={"X-Isoforest-Trace": "tier-a-1"})
            status, _, text = http_request(front.url, "/trace?trace_id=tier-a-1&format=spans")
            names = sorted({s["name"] for s in json.loads(text)["spans"]}) if status == 200 else []
            require({"router.request", "serving.request"} <= set(names), f"tier /trace spans {names}")
            a["trace_spans"] = names
            a["launches"] = launch_counts()
            # the journal's cost: 1-row requests straight to one replica, off
            # and on in turns (each on turn spools into build/)
            lat = {"off": [], "on": []}
            for turn in ("off", "on", "off", "on"):
                if turn == "on":
                    telemetry.activate_journal(str(tmp / "journal_a"), "smoke")
                try:
                    for _ in range(TIER_JOURNAL_REQUESTS // 4):
                        status, _, _, s = tier_post(handles[1].server.url, "/score/mammography_std", bodies[1])
                        require(status == 200, "journal turn: a request failed")
                        lat[turn].append(s)
                finally:
                    if turn == "on":
                        telemetry.deactivate_journal()
            spool = telemetry.read_spool(str(tmp / "journal_a" / "smoke"))
            a["journal"] = {k: {"p50_ms": percentile_ms(v, 50), "p99_ms": percentile_ms(v, 99)} for k, v in lat.items()}
            a["journal"]["records"] = len(spool["records"])
            require(spool["records"] and not spool["torn_tail"], "the smoke's journal spooled nothing")
        finally:
            unmount_router(front)
            front.stop()
            for h in handles:
                h.close()
        launches = a["launches"]
        require(not on_card or all(launches[k] > 0 for k in ("walk_sum", "ext_walk_sum", "dense_mean",
                                                             "ext_sparse_mean")),
                f"a kernel of the tier did not launch: {launches}")
        out["in_process"] = a

        # (b) the spawned tier, with an empty kernel build directory
        telemetry.reset_metrics()
        kernels_dir = tmp / "kernels"
        journal_dir = tmp / "journal"
        saved_build = os.environ.get(_build.BUILD_DIR_ENV)
        os.environ[_build.BUILD_DIR_ENV] = str(kernels_dir)
        config = RouterConfig()
        free_before = free_mib()
        t0 = time.perf_counter()
        try:
            # bare tenants (--no-lifecycle): the hop repeats the same rows,
            # whose drift would refit a managed tenant mid-measurement
            handle = serve_router(str(models_dir), replicas=2, journal_dir=str(journal_dir), config=config,
                                  work_root=str(tmp / "work_b"),
                                  replica_args=("--no-lifecycle",) + (() if on_card else ("--device", "cpu")))
        finally:
            if saved_build is None:
                os.environ.pop(_build.BUILD_DIR_ENV, None)
            else:
                os.environ[_build.BUILD_DIR_ENV] = saved_build
        b = {"serve_router_s": time.perf_counter() - t0}
        closed = False
        try:
            router = handle.router
            reps = router.replicas
            b["ready_s"] = {r.name: r.ready_s for r in reps}
            require(all(r.admitted for r in reps), f"spawned tier: {router.state()}")
            # warm both replicas at once: each loads both tenants and builds
            # the kernels it needs into the empty directory, together
            warm, errors = {}, []

            def warm_replica(r) -> None:
                t_w = time.perf_counter()
                for t in tenants:
                    for n in TIER_SIZES:
                        status, _, text, _ = tier_post(r.url, f"/score/{t}", bodies[n])
                        if status != 200 or json.loads(text)["scores"] != want[(t, "auto", n)]:
                            errors.append((r.name, t, n, status, text[:200]))
                warm[r.name] = time.perf_counter() - t_w

            threads = [threading.Thread(target=warm_replica, args=(r,)) for r in reps]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=4 * SERVING_TIMEOUT_S)
            require(not errors and len(warm) == 2, f"warm: {errors or warm}")
            built = sorted(p.name for p in kernels_dir.iterdir()) if on_card else []
            require(not on_card or built and all(p.endswith(".so") for p in built), f"kernel build directory {built}")
            b["warm_s"], b["built"] = warm, built
            # card memory: nvidia-smi's list (its pids may be the host's), the
            # card's free memory taken by both replicas, and below each
            # replica's alone, the free memory its exit gives back
            b["compute_apps_mib"] = compute_apps() if on_card else {}
            b["both_replicas_mib"] = free_before - free_mib() if on_card else None
            # a router in a process of its own routes a request and brings up
            # no CUDA: it holds no model
            probe = subprocess.run([sys.executable, "-c", ROUTER_ALONE, str(ROOT), reps[1].url], capture_output=True,
                                   text=True, timeout=SERVING_TIMEOUT_S)
            alone = json.loads(probe.stdout.strip().splitlines()[-1]) if probe.returncode == 0 else {}
            require(alone.get("status") == 200 and alone.get("cuda_initialized") is False,
                    f"a router alone: {probe.returncode} {alone} {probe.stderr[-500:]}")
            b["router_alone"] = alone
            # /trace across processes: the router's lane into the replica's
            tier_post(handle.url, "/score/mammography_eif", bodies[1], {"X-Isoforest-Trace": "tier-b-1"})
            status, _, text = http_request(handle.url, "/trace?trace_id=tier-b-1")
            doc = json.loads(text)
            lanes = {e["pid"]: e["args"]["name"] for e in doc.get("traceEvents", ())
                     if e["ph"] == "M" and e["name"] == "process_name"}
            arrows = [(lanes.get(e["pid"]), e["ph"]) for e in doc.get("traceEvents", ()) if e.get("cat") == "xproc"]
            require(status == 200 and ("router", "s") in arrows and any(
                ph == "f" and lane.startswith("replica-") for lane, ph in arrows), f"tier /trace: {arrows} {lanes}")
            b["trace_lanes"] = sorted(lanes.values())
            # the load, with the serving replica SIGKILLed after 100 answers:
            # replica-0, which an idle tier picks first
            serving = min(reps, key=lambda r: r.name)
            routed_before = sum(r.requests for r in reps)
            killed = {}

            def kill_when_due(victim, answered) -> None:
                answered.wait(SERVING_TIMEOUT_S)
                killed["t"] = time.perf_counter()
                os.kill(victim.pid, signal.SIGKILL)
                while victim.admitted and time.perf_counter() - killed["t"] < 10.0:
                    time.sleep(0.001)
                killed["ejected_s"] = time.perf_counter() - killed["t"]

            answered = threading.Event()
            free_alive = free_mib()
            killer = threading.Thread(target=kill_when_due, args=(serving, answered))
            killer.start()
            lat, failed = [], []
            for i in range(TIER_LOAD_REQUESTS):
                status, _, text, s = tier_post(handle.url, "/score/mammography_std", bodies[1])
                if status != 200 or json.loads(text)["scores"] != want[("mammography_std", "auto", 1)]:
                    failed.append((i, status, text[:200]))
                lat.append(s)
                if i + 1 == TIER_KILL_AFTER:
                    answered.set()
            answered.set()
            killer.join(timeout=30.0)
            survivor = next(r for r in reps if r is not serving)
            serving.process.wait(timeout=SERVING_TIMEOUT_S)
            replica_mib = {serving.name: free_mib() - free_alive if on_card else None}
            require(not failed, f"failed requests under the kill: {failed[:3]}")
            require("ejected_s" in killed and not serving.admitted
                    and killed["ejected_s"] <= config.probe_interval_s + config.probe_timeout_s,
                    f"ejection: {killed} {serving.state()}")
            require(survivor.admitted and serving.process.poll() == -signal.SIGKILL, f"after the kill: {router.state()}")
            b["load"] = {"requests": TIER_LOAD_REQUESTS, "failed": len(failed), "p50_ms": percentile_ms(lat, 50),
                         "p99_ms": percentile_ms(lat, 99), "max_ms": max(lat) * 1e3,
                         "ejected_s": killed["ejected_s"], "down_cause": serving.down_cause,
                         "routed": sum(r.requests for r in reps) - routed_before}
            # the tier's /metrics: the live replica's own counts, the router's
            # count of everything routed
            status, _, text = http_request(handle.url, "/metrics")
            parsed = telemetry.parse_prometheus(text)
            live = json.loads(http_request(survivor.url, "/snapshot")[2])["metrics"]
            own = counter_sums(live, "isoforest_fleet_responses_total")
            require(status == 200 and own and all(parsed["isoforest_fleet_responses_total"][k] == v
                                                  for k, v in own.items()), f"tier fleet responses vs {own}")
            routed_200 = sum(v for k, v in parsed["isoforest_router_requests_total"].items() if ("code", "200") in k)
            require(routed_200 == sum(r.requests for r in reps), f"router count {routed_200}")
            require(parsed["isoforest_tier_missing_replicas"][(("replica", serving.name),)] == 1, "missing gauge")
            # the bundle recovers the dead replica's spool from the journal
            status, _, text = http_request(handle.url, "/debug/bundle")
            bundle = json.loads(text)
            recovered = bundle["replicas"].get(serving.name, {}).get("journal", {})
            loads = [r["model_id"] for r in recovered.get("records", ()) if r.get("kind") == "fleet.load"]
            require(status == 200 and bundle["missing_replicas"] == [serving.name] and sorted(loads) == sorted(tenants),
                    f"bundle: missing {bundle.get('missing_replicas')}, recovered loads {loads}")
            b["bundle"] = {"missing_replicas": bundle["missing_replicas"], "recovered_records":
                           len(recovered["records"]), "torn_tail": recovered["torn_tail"], "fleet_loads": loads}
            # the router's hop on the survivor: routed against direct, in turns
            hop = {}
            for n in TIER_SIZES:
                lat = {"routed": [], "direct": []}
                for _ in range(TIER_HOP_REPS[n]):
                    for way, url in (("routed", handle.url), ("direct", survivor.url)):
                        status, _, text, s = tier_post(url, "/score/mammography_std", bodies[n])
                        require(status == 200 and json.loads(text)["scores"] == want[("mammography_std", "auto", n)],
                                f"hop {way} {n} rows: {status} {text[:200]}")
                        lat[way].append(s)
                hop[n] = {way: {"p50_ms": percentile_ms(v, 50), "p99_ms": percentile_ms(v, 99)}
                          for way, v in lat.items()}
                hop[n]["hop_p50_ms"] = hop[n]["routed"]["p50_ms"] - hop[n]["direct"]["p50_ms"]
            b["hop"] = hop
            # close by drain
            free_alive = free_mib()
            t0 = time.perf_counter()
            handle.close()
            closed = True
            b["close_s"] = time.perf_counter() - t0
            replica_mib[survivor.name] = free_mib() - free_alive if on_card else None
            b["replica_mib"] = replica_mib
            require(survivor.process.returncode == 0, f"the survivor exited {survivor.process.returncode}")
            spools = telemetry.list_spools(str(journal_dir))
            tail = telemetry.read_spool(str(journal_dir / survivor.name))["records"][-1]
            require(sorted(spools) == ["replica-0", "replica-1"] and tail.get("kind") == "journal.stop",
                    f"spools {spools}, the survivor's last record {tail}")
        finally:
            if not closed:
                handle.close()
        out["spawned"] = b
    finally:
        telemetry.set_trace_policy(**policy)
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = out["in_process"]["launches"]
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out["launches"]


CLI_PROCESS_TIMEOUT_S = 300.0  # (a)'s bound on each CLI process
CLI_BIG_ROWS = FULL_ROWS  # (b)'s rows: phase 4's (a rehearsal on the CPU shrinks them)
CLI_SHARDS = 5  # (b)'s .npy shards of them
CLI_CHUNK_ROWS = 262_144  # (b)'s chunked score: four chunks of the 1M rows instead of one
CLI_STREAM_EVENTS = 100_000  # cut from phase 34's 500,000 for time
CLI_STREAM_WINDOW_S = 20.0  # five windows over the 100 s of event time
CLI_MANAGE_CHUNK = 2048  # manage's chunks: one drift evaluation each
CLI_WIDE_TREES = 10  # (c)'s F = k = 274 EIF: a 100-tree one's host Avro takes 20 s to load
CLI_BOUNDARY_DIFF = 5e-3  # tests/test_onnx.py:248: a boundary flip moves a score by one subtree's share
CLI_TOP_SHARE = 0.95  # ... and the top 2% keep their ranks


def cli_processes(argvs: list, env: dict) -> list:
    """``python -m isoforest_tpu_torch <argv>`` for each of ``argvs``, all
    started together from the checkout's root, each under
    ``CLI_PROCESS_TIMEOUT_S``; a non-zero exit fails the smoke with its
    stderr. Returns ``(stdout, seconds)`` per process. Every process is
    stopped before this returns."""
    procs = [(argv, time.perf_counter(),
              subprocess.Popen([sys.executable, "-m", "isoforest_tpu_torch", *argv], cwd=ROOT, env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for argv in ([str(a) for a in argv] for argv in argvs)]
    results = []
    try:
        for argv, t0, proc in procs:
            try:
                out, err = proc.communicate(timeout=CLI_PROCESS_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                fail(f"`{' '.join(argv[:1])}` did not end within {CLI_PROCESS_TIMEOUT_S} s")
            require(proc.returncode == 0, f"`{' '.join(argv)}` exited {proc.returncode}: {err[-3000:]}")
            results.append((out, time.perf_counter() - t0))
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def cli_call(argv: list, totals: dict) -> tuple:
    """``main(argv)`` of the port's CLI in this process, with every launch
    counter at 0 just before and read just after (and added to
    ``totals``); a non-zero exit fails the smoke with its stderr. Returns
    ``(stdout, stderr, seconds, launches)``."""
    import contextlib
    import io

    import torch

    from isoforest_tpu_torch.__main__ import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    zero_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main([str(a) for a in argv])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    require(rc == 0, f"`{argv[0]}` exited {rc}: {err.getvalue()[-3000:]}")
    for name, n in launches.items():
        totals[name] = totals.get(name, 0) + n
    return out.getvalue(), err.getvalue(), seconds, launches


def require_same_scores(path, model, scores, what: str) -> None:
    """The CSV's scores equal ``scores`` (``model``'s float32 tensor) bit for
    bit, its labels ``model.predict`` of them."""
    import numpy as np

    # float64: the CSV's %.18e text holds each float32 score exactly
    table = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    got, labels = table[:, 0], table[:, 1]
    want = scores.cpu().numpy()
    require(got.shape == want.shape and np.array_equal(got, want.astype(np.float64)),
            f"{what}: the CSV's scores differ from model.score's (max |d| "
            f"{float(np.abs(got - want).max()) if got.shape == want.shape else 'shape'})")
    require(np.array_equal(labels, model.predict(scores).cpu().numpy()), f"{what}: the CSV's labels differ")


def cli_phases(dev, X_m, smi: str) -> dict:
    """Phase 36: the port's command line and ONNX export on the card.

    (a) Real processes: ``python -m isoforest_tpu_torch fit`` of
    mammography (``--labeled --contamination 0.02``, and ``--extended
    --extension-level 5``; 100 trees, 11,183 x 6) on the default device,
    then ``score --strategy walk`` of each and of the committed
    ``mammography_std``. Each summary names ``cuda``; each saved forest
    equals an in-process fit of the same arguments node for node, threshold
    exact; the standard AUROC in [0.84, 0.90]; each scores CSV equals this
    process's ``model.score`` of the saved directory bit for bit; the
    fixture's within 2e-6 of ``jax_scores.npy``.

    (b) In this process through ``main(argv)``, each call with the launch
    counters at 0 just before and read just after: ``score --input`` of
    phase 4's 1,000,000 rows (one ``.npy``) with both fixtures and
    ``walk`` and ``dense``, each CSV ``model.score`` bit for bit, and the
    standard walk again in four chunks, byte for byte the same file;
    ``score --source`` over five ``.npy`` shards of them (``walk``), then
    ``--resume``, which skips every part and launches nothing, the sink one
    ``model.score`` a shard exactly; ``inspect`` with and without
    ``--tree 0``; ``diagnose`` as JSON and Prometheus; ``telemetry``,
    ``trace`` and ``debug-bundle`` on the synthetic workload; ``autotune
    --warm --batch-sizes 1,64,4096`` (its own table), ``--format table``
    and ``--clear``; ``monitor`` and ``manage`` on the mammography rows
    shifted by 3 standard deviations a feature (drift reported; at least
    one swap); ``stream`` over a file of 100,000 of phase 34's timestamped
    rows. Each is held to its JAX test's checks, and timed.

    (c) ONNX: ``convert`` of both fixtures and of (a)'s fits (timed on the
    host), the port's runtime on the 11,183 rows (timed): the standard
    graphs within 1e-5 of the card's ``model.score`` with equal labels away
    from the threshold, the EIF graphs within 1e-5 of the port's gather
    walk (on the CPU); ``checker.reference_scores`` on the first 1,000 rows
    within 1e-6 of the runtime. Then ``fit --extended --extension-level
    273`` of a 10-tree EIF on 65,536 of phase 29's K5-shaped rows (its
    generator's finite rows, F = k = 274), ``score --strategy dense`` of it
    (K5), its conversion, and the runtime held to the JAX test's boundary
    bound against the card's scores.

    Returns the launches of (b)'s and (c)'s CLI calls by kernel name. On
    the CPU (a rehearsal: shrink ``CLI_BIG_ROWS`` and ``CLI_CHUNK_ROWS``)
    every call gets ``--device cpu`` and the launch checks are skipped."""
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch

    from isoforest_tpu_torch import ExtendedIsolationForest, IsolationForest, load_model, telemetry, tuning
    from isoforest_tpu_torch.io import source as srcmod
    from isoforest_tpu_torch.io.outofcore import read_scores
    from isoforest_tpu_torch.onnx import checker, runtime
    from isoforest_tpu_torch.ops import _build
    from isoforest_tpu_torch.ops.traversal import extended_path_lengths
    from isoforest_tpu_torch.testing import finite_rows, random_extended_forest
    from isoforest_tpu_torch.utils.math import score_from_path_length

    t_phase = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="cli_", dir=build))
    out = {"phase": "cli", "nvidia_smi": smi}
    totals: dict = {}
    saved_autotune = os.environ.get("ISOFOREST_TPU_AUTOTUNE_PATH")
    on_card = dev.type == "cuda"
    # on the card every call takes the default device; a CPU rehearsal names its own
    device = [] if on_card else ["--device", "cpu"]
    try:
        # (a) the entry point in real processes, on the default device
        t_a = time.perf_counter()
        env = {**os.environ, "PYTHONPATH": str(ROOT), _build.BUILD_DIR_ENV: str(_build.BUILD_DIR)}
        env.pop("ISOFOREST_TPU_STRATEGY", None)
        fits = {"std": [], "eif": ["--extended", "--extension-level", "5"]}
        fit_runs = cli_processes([["fit", "--input", MAMMOGRAPHY, "--labeled", "--output", tmp / kind,
                                   "--contamination", "0.02", *extra, *device]
                                  for kind, extra in fits.items()], env)
        score_dirs = {"std": tmp / "std", "eif": tmp / "eif", "jax_std_fixture": FIXTURE / "model"}
        score_runs = cli_processes([["score", "--model", d, "--input", MAMMOGRAPHY, "--labeled", "--strategy", "walk",
                                     "--output", tmp / f"scores_{kind}.csv", *device]
                                    for kind, d in score_dirs.items()], env)
        X, y = srcmod.open_source(str(MAMMOGRAPHY), labeled=True).read_all()
        processes = {}
        for (kind, extra), (stdout, secs) in zip(fits.items(), fit_runs):
            summary = json.loads(stdout.strip().splitlines()[-1])
            require(summary["device"] == dev.type, f"fit {kind} ran on {summary['device']}")
            saved = load_model(str(tmp / kind), device=dev)
            # the CLI's defaults, named
            kw = dict(num_estimators=100, max_samples=256.0, contamination=0.02, contamination_error=0.0,
                      max_features=1.0, bootstrap=False, random_seed=1, device=dev)
            est = ExtendedIsolationForest(extension_level=5, **kw) if extra else IsolationForest(**kw)
            here = est.fit(X)
            differing = [name for name, a, b in zip(type(here.forest)._fields, here.forest, saved.forest)
                         if not torch.equal(a, b)]
            require(not differing, f"fit {kind}: the saved forest differs from an in-process fit in {differing}")
            require(summary["threshold"] == here.outlier_score_threshold == saved.outlier_score_threshold,
                    f"fit {kind}: threshold {summary['threshold']} against {here.outlier_score_threshold}")
            if kind == "std":
                require(0.84 <= summary["auroc"] <= 0.90, f"fit std: AUROC {summary['auroc']}")
            processes[f"fit_{kind}"] = {"s": secs, "summary": summary}
        for (kind, d), (_, secs) in zip(score_dirs.items(), score_runs):
            model = load_model(str(d), device=dev)
            s = model.score(X, strategy="walk")
            require_same_scores(tmp / f"scores_{kind}.csv", model, s, f"score {kind}")
            processes[f"score_{kind}"] = {"s": secs}
            if kind == "jax_std_fixture":
                err = float(np.abs(s.cpu().numpy() - np.load(FIXTURE / "jax_scores.npy")).max())
                require(err <= 2e-6, f"the CLI's fixture scores are {err} from the JAX package's")
                processes[f"score_{kind}"]["vs_jax_max_abs"] = err
        out["processes"] = processes
        out["processes_s"] = time.perf_counter() - t_a

        # (b) every subcommand in this process, with the launch counters
        t_b = time.perf_counter()
        calls = {}
        X_big = full_size_rows(X_m, np.random.default_rng(SEED))[:CLI_BIG_ROWS]
        big = tmp / "big.npy"
        np.save(big, X_big)
        fixtures = {"std": load_model(str(FIXTURE / "model"), device=dev),
                    "eif": load_model(str(EIF_FIXTURE / "model"), device=dev)}
        for kind, model in fixtures.items():
            model_dir = FIXTURE / "model" if kind == "std" else EIF_FIXTURE / "model"
            for strategy in ("walk", "dense"):
                csv = tmp / f"big_{kind}_{strategy}.csv"
                _, _, secs, launches = cli_call(["score", "--model", model_dir, "--input", big, "--strategy", strategy,
                                                 "--output", csv, *device], totals)
                require_same_scores(csv, model, model.score(X_big, strategy=strategy), f"score {kind} {strategy} 1M")
                calls[f"score_1m_{kind}_{strategy}"] = {"s": secs, "launches": launches}
        chunked = tmp / "big_std_walk_chunked.csv"
        _, _, secs, launches = cli_call(["score", "--model", FIXTURE / "model", "--input", big, "--strategy", "walk",
                                         "--chunk-rows", CLI_CHUNK_ROWS, "--output", chunked, *device], totals)
        require(chunked.read_bytes() == (tmp / "big_std_walk.csv").read_bytes(),
                "the chunked scores CSV differs from the unchunked one")
        calls["score_1m_std_walk_chunked"] = {"s": secs, "launches": launches, "chunk_rows": CLI_CHUNK_ROWS}
        for path in tmp.glob("big_*.csv"):
            path.unlink()

        shards = tmp / "shards"
        shards.mkdir()
        bounds = np.linspace(0, CLI_BIG_ROWS, CLI_SHARDS + 1).astype(int)
        for i in range(CLI_SHARDS):
            srcmod.write_npy_shard(str(shards / f"part-{i}.npy"), X_big[bounds[i]:bounds[i + 1]])
        sink = tmp / "sink"
        std_dir = FIXTURE / "model"
        stdout, _, secs, launches = cli_call(["score", "--model", std_dir, "--source", shards, "--output", sink,
                                              "--strategy", "walk", *device], totals)
        summary = json.loads(stdout.strip().splitlines()[-1])
        require(summary["sealed"] == CLI_SHARDS and summary["rows"] == CLI_BIG_ROWS and summary["device"] == dev.type
                and (launches["walk_sum"] > 0 or not on_card), f"score --source: {summary}, {launches}")
        calls["score_source"] = {"s": secs, "launches": launches}
        stdout, _, secs, launches = cli_call(["score", "--model", std_dir, "--source", shards, "--output", sink,
                                              "--strategy", "walk", "--resume", *device], totals)
        summary = json.loads(stdout.strip().splitlines()[-1])
        require((summary["sealed"], summary["skipped"]) == (0, CLI_SHARDS) and not any(launches.values()),
                f"score --resume: {summary}, {launches}")
        per_shard = np.concatenate([fixtures["std"].score(X_big[bounds[i]:bounds[i + 1]], strategy="walk")
                                    .cpu().numpy() for i in range(CLI_SHARDS)])
        require(np.array_equal(read_scores(str(sink), num_shards=CLI_SHARDS), per_shard),
                "the sink differs from model.score a shard")
        calls["score_source_resume"] = {"s": secs, "launches": launches}
        shutil.rmtree(shards)
        shutil.rmtree(sink)
        big.unlink()
        del X_big

        stdout, _, secs, _ = cli_call(["inspect", "--model", std_dir, *device], totals)
        info = json.loads(stdout)
        require(info["numTrees"] == 100 and info["params"]["numEstimators"] == 100 and info["device"] == dev.type,
                f"inspect: {info}")
        calls["inspect"] = {"s": secs}
        stdout, _, secs, _ = cli_call(["inspect", "--model", EIF_FIXTURE / "model", "--tree", "0", *device], totals)
        require(stdout.strip().startswith(("ExtendedInternalNode(", "ExtendedExternalNode(")),
                f"inspect --tree 0: {stdout[:80]}")
        calls["inspect_tree"] = {"s": secs}
        stdout, _, secs, _ = cli_call(["diagnose", std_dir, *device], totals)
        diag = json.loads(stdout)
        require(diag["num_trees"] == 100 and "feature_split_usage" in diag and diag["device"] == dev.type,
                f"diagnose: {sorted(diag)}")
        calls["diagnose_json"] = {"s": secs}
        stdout, _, secs, _ = cli_call(["diagnose", std_dir, "--format", "prometheus", *device], totals)
        require(telemetry.parse_prometheus(stdout)["isoforest_forest_trees"][()] == 100.0, "diagnose prometheus")
        calls["diagnose_prometheus"] = {"s": secs}

        stdout, _, secs, launches = cli_call(["telemetry", *device], totals)
        snap = json.loads(stdout)
        require(snap["telemetry_enabled"] is True and "isolation_forest.fit.grow" in snap["spans"]
                and "isoforest_scored_rows_total" in snap["metrics"], f"telemetry: {sorted(snap['spans'])}")
        calls["telemetry"] = {"s": secs, "launches": launches}
        trace_path = tmp / "trace.json"
        stdout, _, secs, _ = cli_call(["trace", trace_path, *device], totals)
        summary = json.loads(stdout)
        doc = json.loads(trace_path.read_text())
        require(summary["root"] == "model.score" and summary["device"] == dev.type
                and any(e.get("name") == "model.score" for e in doc["traceEvents"]), f"trace: {summary}")
        calls["trace"] = {"s": secs, "spans": summary["spans"]}
        bundle_path = tmp / "bundle.json"
        stdout, _, secs, _ = cli_call(["debug-bundle", bundle_path, *device], totals)
        summary = json.loads(stdout)
        bundle = json.loads(bundle_path.read_text())
        require(summary["traces"] >= 1 and summary["sections"] == sorted(k for k in bundle if k != "schema"),
                f"debug-bundle: {summary}")
        calls["debug_bundle"] = {"s": secs, "sections": len(summary["sections"])}

        # autotune against a table of its own, so --clear removes only it
        table = tmp / "autotune.json"
        os.environ["ISOFOREST_TPU_AUTOTUNE_PATH"] = str(table)
        tuning.reset_cost_model()
        _, stderr, secs, launches = cli_call(["autotune", "--warm", "--batch-sizes", "1,64,4096", *device], totals)
        warmed = json.loads(stderr.strip().splitlines()[-1])
        require(table.exists() and warmed["device"] == dev.type and len(warmed["warmed"]) == 3
                and {d["strategy"] for d in warmed["warmed"]} <= ({"walk", "dense"} if on_card else
                                                                   {"walk", "dense", "q16"}),
                f"autotune --warm: {warmed}")
        calls["autotune_warm"] = {"s": secs, "launches": launches,
                                  "decisions": [[d["batch"], d["strategy"], d["source"]] for d in warmed["warmed"]]}
        stdout, _, secs, _ = cli_call(["autotune", "--format", "table"], totals)
        keys = {d["key"] for d in warmed["warmed"]}  # 1 and 64 rows share a batch bucket
        require(sum(line.split(" -> ")[0] in keys for line in stdout.splitlines()) == len(keys),
                f"autotune table: {stdout[:300]}")
        stdout, _, secs, _ = cli_call(["autotune", "--clear"], totals)
        require(json.loads(stdout)["existed"] is True and not table.exists(), "autotune --clear")
        calls["autotune_clear"] = {"s": secs}
        if saved_autotune is None:
            os.environ.pop("ISOFOREST_TPU_AUTOTUNE_PATH", None)
        else:
            os.environ["ISOFOREST_TPU_AUTOTUNE_PATH"] = saved_autotune
        tuning.reset_cost_model()

        shifted = tmp / "shifted.csv"
        np.savetxt(shifted, X_m + (LIFECYCLE_SHIFT_SD * X_m.std(axis=0)).astype(np.float32), delimiter=",")
        model_copy = tmp / "model_std"
        shutil.copytree(std_dir, model_copy)
        stdout, _, secs, launches = cli_call(["monitor", model_copy, "--input", shifted, *device], totals)
        report = json.loads(stdout)
        require(report["drifted"] is True and report["score"]["psi"] > 0.25 and report["rows"] == len(X_m)
                and report["device"] == dev.type, f"monitor: drifted {report['drifted']}, psi {report['score']['psi']}")
        calls["monitor"] = {"s": secs, "launches": launches, "psi": report["score"]["psi"]}
        stdout, _, secs, launches = cli_call(["manage", model_copy, "--input", shifted, "--work-dir", tmp / "lc",
                                              "--debounce", "1", "--chunk-rows", CLI_MANAGE_CHUNK, *device], totals)
        summary = json.loads(stdout)
        current = json.loads((tmp / "lc" / "CURRENT.json").read_text())
        require(summary["retrains"].get("swapped", 0) >= 1 and summary["generation"] >= 2
                and current["generation"] == summary["generation"] and summary["rows"] == len(X_m)
                and summary["device"] == dev.type, f"manage: {summary['retrains']}, generation {summary['generation']}")
        calls["manage"] = {"s": secs, "launches": launches, "generation": summary["generation"],
                           "retrains": summary["retrains"], "psi_after": summary["drift"]["score"]["psi"]}
        ts, Xs = stream_events(X_m, CLI_STREAM_EVENTS)
        stream_csv = tmp / "stream.csv"
        np.savetxt(stream_csv, np.column_stack([ts, Xs]), delimiter=",")
        # stream takes SIGTERM and SIGINT for its own stop: give them back after
        handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
        try:
            stdout, _, secs, launches = cli_call(["stream", model_copy, "--source", stream_csv, "--window-s",
                                                  CLI_STREAM_WINDOW_S, "--lateness-s", STREAM_LATENESS_S,
                                                  "--retrain-every", "2", "--work-dir", tmp / "stream_lc",
                                                  *device], totals)
        finally:
            for sig, handler in handlers.items():
                signal.signal(sig, handler)
        summary = json.loads(stdout)
        current = json.loads((tmp / "stream_lc" / "CURRENT.json").read_text())
        require(summary["rows"] == CLI_STREAM_EVENTS and summary["late_rows"] == 0
                and summary["windows_closed"] >= 4 and summary["swaps"] >= 1 and summary["reservoir"] == "decay"
                and summary["rss_trajectory"] and current["generation"] == summary["generation"]
                and summary["device"] == dev.type,
                f"stream: {({k: summary[k] for k in ('rows', 'late_rows', 'windows_closed', 'swaps')})}")
        calls["stream"] = {"s": secs, "launches": launches, "events_per_s": CLI_STREAM_EVENTS / secs,
                           "windows_closed": summary["windows_closed"], "swaps": summary["swaps"]}
        out["calls"] = calls
        out["calls_s"] = time.perf_counter() - t_b

        # (c) ONNX: conversion and the portable runtime, on the host
        t_c = time.perf_counter()
        onnx_rows = {}
        graphs = {"std_fixture": FIXTURE / "model", "eif_fixture": EIF_FIXTURE / "model",
                  "std_fit": tmp / "std", "eif_fit": tmp / "eif"}
        for name, model_dir in graphs.items():
            path = tmp / f"{name}.onnx"
            stdout, _, convert_s, _ = cli_call(["convert", "--model", model_dir, "--output", path], totals)
            require(json.loads(stdout)["onnx"] == str(path), f"convert {name}: {stdout}")
            graph = path.read_bytes()
            t0 = time.perf_counter()
            scores, labels = runtime.run_model(graph, {"features": X})
            runtime_s = time.perf_counter() - t0
            model = load_model(str(model_dir), device=dev)
            if name.startswith("std"):
                want = model.score(X).cpu().numpy()
                thr = model.outlier_score_threshold
                away = np.abs(want - thr) > 1e-5
                require(np.array_equal(labels[away, 0], (want[away] >= thr).astype(np.int32)),
                        f"{name}: ONNX labels differ away from the threshold")
            else:
                cpu = load_model(str(model_dir), device="cpu")
                want = score_from_path_length(extended_path_lengths(cpu.forest, torch.from_numpy(X)),
                                              cpu.num_samples).numpy()
            err = float(np.abs(scores[:, 0] - want).max())
            require(scores.shape == (len(X), 1) and err < 1e-5, f"{name}: ONNX scores {err} from the port's")
            ref_err = float(np.abs(checker.reference_scores(graph, X[:1000])[:, 0] - scores[:1000, 0]).max())
            require(ref_err < 1e-6, f"{name}: the checker's evaluator is {ref_err} from the runtime")
            onnx_rows[name] = {"bytes": len(graph), "convert_s": convert_s, "runtime_s": runtime_s,
                               "vs_port_max_abs": err, "checker_vs_runtime_max_abs": ref_err}

        # K5 through the CLI: a 10-tree fully extended EIF at F = k = 274
        rng5 = np.random.default_rng(SEED + 29)
        random_extended_forest(rng5, 100, 8, 274, 274, split_p=1.0)  # phase 29's forest: its draws come first
        X5 = finite_rows(rng5, HIGH_DIM_ROWS, 274)
        wide_rows, wide_dir, wide_csv = tmp / "wide.npy", tmp / "wide", tmp / "wide.csv"
        np.save(wide_rows, X5)
        stdout, _, fit_s, fit_launches = cli_call(["fit", "--input", wide_rows, "--extended", "--extension-level",
                                                   "273", "--num-estimators", CLI_WIDE_TREES, "--output", wide_dir,
                                                   *device], totals)
        require(json.loads(stdout)["numTrees"] == CLI_WIDE_TREES, f"the wide fit: {stdout}")
        _, _, score_s, score_launches = cli_call(["score", "--model", wide_dir, "--input", wide_rows, "--strategy",
                                                  "dense", "--output", wide_csv, *device], totals)
        require(score_launches["ext_dense_mean"] > 0 or not on_card, f"the wide dense score launched {score_launches}")
        wide = load_model(str(wide_dir), device=dev)
        require(wide.forest.k == 274, f"the wide EIF has k = {wide.forest.k}")
        card = wide.score(X5, strategy="dense")
        require_same_scores(wide_csv, wide, card, "score of the wide EIF")
        path = tmp / "wide.onnx"
        _, _, convert_s, _ = cli_call(["convert", "--model", wide_dir, "--output", path], totals)
        t0 = time.perf_counter()
        scores, _ = runtime.run_model(path.read_bytes(), {"features": X5})
        runtime_s = time.perf_counter() - t0
        # the JAX test's contract for an EIF whose dots sum in another order
        diff = np.abs(scores[:, 0] - card.cpu().numpy())
        top = HIGH_DIM_ROWS // 50
        bound_check = {"max_abs": float(diff.max()), "rows_differing": int((diff > 1e-5).sum()),
                       "top_2pct_overlap": len(set(np.argsort(scores[:, 0])[-top:])
                                               & set(np.argsort(card.cpu().numpy())[-top:])) / top}
        require(bound_check["max_abs"] < CLI_BOUNDARY_DIFF and bound_check["top_2pct_overlap"] >= CLI_TOP_SHARE,
                f"the wide EIF's ONNX scores break the boundary bound: {bound_check}")
        onnx_rows["wide_eif_274"] = {"rows": HIGH_DIM_ROWS, "trees": CLI_WIDE_TREES, "bytes": path.stat().st_size,
                                     "fit_s": fit_s, "score_s": score_s, "fit_launches": fit_launches,
                                     "score_launches": score_launches, "convert_s": convert_s,
                                     "runtime_s": runtime_s, **bound_check}
        out["onnx"] = onnx_rows
        out["onnx_s"] = time.perf_counter() - t_c
    finally:
        if saved_autotune is None:
            os.environ.pop("ISOFOREST_TPU_AUTOTUNE_PATH", None)
        else:
            os.environ["ISOFOREST_TPU_AUTOTUNE_PATH"] = saved_autotune
        shutil.rmtree(tmp, ignore_errors=True)
    missing = [name for name in launch_counts() if not totals.get(name)]
    require(not missing or not on_card, f"the CLI's in-process runs launched no {missing}: {totals}")
    out["launches"] = totals
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return totals


def full_size_rows(X_m, rng):
    """``main``'s 1,000,000 full-size rows: resampled mammography rows with
    1% jitter, the first draws of ``rng`` (``default_rng(SEED)``)."""
    import numpy as np

    idx = rng.integers(0, len(X_m), FULL_ROWS)
    jitter = rng.normal(0.0, 0.01, (FULL_ROWS, X_m.shape[1])).astype(np.float32)
    return (X_m[idx] + jitter * X_m.std(axis=0)).astype(np.float32)


def run_alone(phase: str) -> int:
    """Build the kernels and run one of the late phases (``parallel``,
    ``fleet``, ``stream``, ``tier``, ``cli``) alone on the card, on ``main``'s rows:
    its checks, its JSON line and its timings, without the whole smoke."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from isoforest_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print(f"{phase}: no CUDA device is available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.build()
    print("build_s", time.perf_counter() - t0, flush=True)
    os.environ["ISOFOREST_TPU_AUTOTUNE_PATH"] = str(ROOT / "build" / f"autotune_{os.getpid()}.json")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    X_m = np.loadtxt(MAMMOGRAPHY, delimiter=",", comments="#").astype(np.float32)[:, :-1]
    if phase == "parallel":
        parallel_phases(dev, X_m, full_size_rows(X_m, np.random.default_rng(SEED)), smi)
    elif phase == "fleet":
        fleet_phases(dev, X_m, smi)
    elif phase == "tier":
        tier_phases(dev, X_m, smi)
    elif phase == "cli":
        cli_phases(dev, X_m, smi)
    else:
        stream_phases(dev, X_m, smi)
    print("total_s", time.perf_counter() - t0)
    return 0


def main() -> int:
    if not (ROOT / "isoforest_tpu_torch").is_dir() or not FIXTURE.is_dir() or not EIF_FIXTURE.is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from isoforest_tpu_torch import load_model
    from isoforest_tpu_torch.io.interop import forest_from_arrays
    from isoforest_tpu_torch.ops import _build, dense, ext_path, walk
    from isoforest_tpu_torch.ops.traversal import standard_path_lengths
    from isoforest_tpu_torch.testing import random_heap_forest, rows
    from isoforest_tpu_torch.utils.math import score_from_path_length

    dev = torch.device("cuda")
    # every run probes cold: its own autotune table
    os.environ["ISOFOREST_TPU_AUTOTUNE_PATH"] = str(ROOT / "build" / f"autotune_{os.getpid()}.json")
    # plain float32 products only: nothing below may round through TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch_device_name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    report = _build.build(ptxas_verbose=True)
    ptxas, entry = [], ""
    for r in report.values():
        for line in r["log"].splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1][:90]
            elif "Used" in line or ("spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line):
                ptxas.append(f"{entry}: {line.strip()}")
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "per_source_s": {k: v["seconds"] for k, v in report.items()}, "ptxas": ptxas})

    # 3. parity with the JAX package on the committed fixture
    data = np.loadtxt(MAMMOGRAPHY, delimiter=",", comments="#").astype(np.float32)
    X_m, y_m = data[:, :-1], data[:, -1]
    jax_scores = np.load(FIXTURE / "jax_scores.npy")
    model = load_model(str(FIXTURE / "model"))
    require(model.device.type == "cuda", f"model loaded on {model.device}")
    thr = model.outlier_score_threshold
    parity = {"phase": "parity", "rows": len(X_m), "trees": model.forest.num_trees,
              "heap_slots": model.forest.max_nodes, "threshold": thr}
    for strategy in ("walk", "dense"):
        s = model.score(X_m, strategy=strategy).cpu().numpy()
        err = float(np.abs(s - jax_scores).max())
        auc = auroc(s, y_m)
        away = np.abs(s - thr) > 2e-6
        labels = model.predict(torch.from_numpy(s)).numpy()
        same = bool((labels[away] == (jax_scores[away] >= thr)).all())
        parity[strategy] = {"max_abs_err": err, "auroc": auc, "labels_equal": same,
                            "outliers": int(labels.sum())}
        require(s.shape == jax_scores.shape and np.isfinite(s).all(), f"{strategy}: bad scores")
        require(err <= 2e-6, f"{strategy}: max |score - jax| = {err} > 2e-6")
        require(0.84 <= auc <= 0.90, f"{strategy}: AUROC {auc} outside [0.84, 0.90]")
        require(same, f"{strategy}: labels differ from the JAX package's")
    emit(parity)

    # 4. full size: the main path, then each kernel against its plain version
    rng = np.random.default_rng(SEED)
    X_big = full_size_rows(X_m, rng)
    ext_path.launches["walk_sum"] = 0
    dense.dense_mean.launches = 0
    t0 = time.perf_counter()
    s_walk = model.score(X_big, strategy="walk")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s_dense = model.score(X_big, strategy="dense")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"walk": ext_path.launches["walk_sum"], "dense": dense.dense_mean.launches}
    require(launches["walk"] > 0 and launches["dense"] > 0, f"a kernel did not launch: {launches}")
    for name, s in (("walk", s_walk), ("dense", s_dense)):
        require(tuple(s.shape) == (FULL_ROWS,) and bool(torch.isfinite(s).all())
                and bool(((s > 0) & (s <= 1)).all()), f"{name}: bad full-size scores")
    score_gap = float((s_walk - s_dense).abs().max())
    require(score_gap <= 2e-6, f"walk and dense scores differ by {score_gap}")

    Xd = torch.from_numpy(X_big).to(dev)
    wt = walk.walk_tables(model.forest)
    dt = dense.pack_standard(model.forest)
    n, f = Xd.shape
    t_n, m = dt.value.shape
    walk_err = float((walk.walk_sum(Xd, wt) - walk.walk_sum_plain(Xd, wt)).abs().max())
    # the small-batch launch against the plain walk of its own order
    walk_small_err = float((ext_path.launch("walk_sum", Xd[:4096], wt, tree_parallel=True)
                            - walk.walk_sum_plain(Xd[:4096], wt, tree_parallel=True)).abs().max())
    dense_err = float((dense.dense_mean(Xd, dt) - dense.dense_mean_plain(Xd, dt)).abs().max())
    require(walk_err == 0.0 and walk_small_err == 0.0, f"walk kernel vs plain: {walk_err}, {walk_small_err}")
    require(dense_err == 0.0, f"dense kernel vs plain: {dense_err}")
    times = {
        "walk_ms": time_ms(lambda: walk.walk_sum(Xd, wt), inner=10),
        "walk_plain_ms": time_ms(lambda: walk.walk_sum_plain(Xd, wt), reps=5),
        "dense_ms": time_ms(lambda: dense.dense_mean(Xd, dt), inner=10),
        "dense_plain_ms": time_ms(lambda: dense.dense_mean_plain(Xd, dt), reps=5),
    }
    # Bounds from this run's inputs. Both kernels compute one function, each
    # row's path length through the forest (walk_sum the sum over trees,
    # dense_mean the mean), so both carry that function's bound. Bytes: X
    # read once, the kernel's tables read once, the f32[N] result written
    # once. Operations (float32): what these rows need, one compare per
    # internal slot a row visits plus one add per (row, tree), and for the
    # mean one divide per row. The dense algorithm compares at every slot
    # of every tree; that count is printed as dense_algorithm_ops_ms, the
    # time the card needs for it at peak, beside the bound and not as one.
    internal = model.forest.feature >= 0
    feature = model.forest.feature.clamp(min=0).long()
    visited = torch.zeros((), dtype=torch.float64, device=dev)
    for t in range(t_n):
        node = torch.zeros(n, dtype=torch.long, device=dev)
        for _ in range(model.forest.height):
            inside = internal[t][node]
            visited += inside.sum()
            step = Xd.gather(1, feature[t][node][:, None])[:, 0] >= model.forest.threshold[t][node]
            node = torch.where(inside, 2 * node + 1 + step.long(), node)
    x_bytes, out_bytes = n * f * 4, n * 4
    walk_bytes = x_bytes + out_bytes + (wt.records.numel() + wt.roots.numel()) * 4
    dense_bytes = x_bytes + out_bytes + 2 * t_n * m * 4
    path_ops = float(visited) + n * t_n

    walk_bound, walk_by = bound(walk_bytes, path_ops)
    dense_bound, dense_by = bound(dense_bytes, path_ops + n)
    dense_algorithm_ops_ms = (float(n) * t_n * m + 2.0 * n * t_n) / PEAK_F32_OPS_PER_S * 1e3
    emit({"phase": "full_size", "rows": n, "features": f, "trees": t_n, "heap_slots": m,
          "launches": launches, "score_walk_s": t1 - t0, "score_dense_s": t2 - t1,
          "walk_vs_dense_max_abs_score": score_gap,
          "walk_kernel_vs_plain_max_abs_sum": walk_err,
          "walk_small_batch_vs_plain_max_abs_sum_4096": walk_small_err,
          "walk_records": wt.records.shape[0], "walk_table_bytes": walk_bytes - x_bytes - out_bytes,
          "dense_kernel_vs_plain_max_abs_mean": dense_err,
          "mean_internal_visits_per_row_tree": float(visited) / (n * t_n),
          **times,
          "walk_rows_per_s": n / times["walk_ms"] * 1e3,
          "dense_rows_per_s": n / times["dense_ms"] * 1e3,
          "walk_bound_ms": walk_bound, "walk_bound_by": walk_by,
          "dense_bound_ms": dense_bound, "dense_bound_by": dense_by,
          "dense_algorithm_ops_ms": dense_algorithm_ops_ms})

    # where one full-size model.score call spends its time: device activity
    # by name from torch.profiler, beside the call's wall time
    emit(breakdown_phase("breakdown", model, X_big))

    # 5. edges: synthetic forests, kernel against plain version
    # every height to the dense fence, each at one of F in {1, 6, 12, 13, 274}
    # (274: the row tile in 5 feature chunks; the dense kernel's too) and N in
    # {1, 1023, 1025}
    widths, row_counts = (1, 6, 12, 13, 274), (1, 1023, 1025)
    cases = [{"features": widths[h % 5], "height": h, "rows": row_counts[h % 3]}
             for h in range(dense.DENSE_MAX_HEIGHT + 1)]
    cases += [
        {"features": 6, "height": dense.DENSE_MAX_HEIGHT, "rows": 1025},
        {"features": 274, "height": 8, "rows": 1025},
        {"features": 17, "height": 6, "rows": 1023},
        {"features": 6, "height": dense.DENSE_MAX_HEIGHT + 1, "rows": 1023},
        {"features": 5, "height": 12, "rows": 1025},
        {"features": 274, "height": 12, "rows": 33},
        # the walk: rows too wide for the row tile (x[f] through L1), one
        # warp's rows and around it, 100 trees (four small-batch rounds, the
        # last ragged), and N on both sides of the small-batch switch, where
        # walk_sum's own choice takes each launch
        {"features": 1025, "height": 6, "rows": 1025},
        {"features": 6, "height": 8, "rows": 31, "trees": 100},
        {"features": 6, "height": 8, "rows": 4096, "trees": 100},
        {"features": 13, "height": 9, "rows": 33},
        {"features": 6, "height": 8, "rows": ext_path.TREE_PARALLEL_MAX_ROWS["walk_sum"]},
        {"features": 6, "height": 8, "rows": ext_path.TREE_PARALLEL_MAX_ROWS["walk_sum"] + 1},
        # rows enough for the staged bulk walk: root leaves only (no record),
        # records that fit beside the row tile, and ones that do not
        {"features": 1, "height": 0, "rows": 300_001},
        {"features": 13, "height": 9, "rows": 300_001},
        {"features": 17, "height": 6, "rows": 300_001, "trees": 100},
        {"features": 5, "height": 12, "rows": 300_001},
    ]
    edges = []
    for case in cases:
        Xe = rows(rng, case["rows"], case["features"])
        trees = case.get("trees", 13)
        forest = forest_from_arrays(*random_heap_forest(rng, trees, case["height"], case["features"], 0.85))
        xe = torch.from_numpy(Xe).to(dev)
        wte = walk.walk_tables(forest)
        want = walk.walk_sum_plain(xe, wte)
        w_err = max(float((walk.walk_sum(xe, wte) - want).abs().max()),
                    *(float((ext_path.launch("walk_sum", xe, wte, tree_parallel=small) - want).abs().max())
                      for small in (False, True)))
        g_err = float((walk.path_lengths_walk(xe, wte) - standard_path_lengths(forest, xe)).abs().max())
        # shared memory a staged walk block would take with the whole forest
        # as one group (a group's records and the row tile: two blocks an SM,
        # at most 113 KB each on the H100, and F <= 48)
        row = dict(case, trees=trees, walk_records=wte.records.shape[0],
                   walk_staged_block_bytes=wte.records.numel() * 4 + case["features"] * 1024 * 4,
                   walk_vs_plain=w_err, walk_vs_gather=g_err)
        # the gather walk sums 8-tree blocks, then divides: another order
        require(w_err == 0.0 and g_err <= 1e-5, f"walk edge case {row}")
        if case["height"] <= dense.DENSE_MAX_HEIGHT:
            dte = dense.pack_standard(forest)
            d_err = float((dense.dense_mean(xe, dte) - dense.dense_mean_plain(xe, dte)).abs().max())
            row["dense_vs_plain"] = d_err
            require(d_err == 0.0, f"dense edge case {row}")
        else:
            tables = dense.pack_standard(forest)
            try:
                dense.dense_mean(xe, tables)
            except ValueError as exc:
                row["dense_fence"] = str(exc)
            else:
                fail(f"dense kernel accepted height {case['height']}")
        edges.append(row)
    emit({"phase": "edges", "cases": edges})

    # 6. serving-sized batches through model.score (host clock, synchronised)
    serving = serving_latency(model, X_big, ("auto", "dense"))
    emit({"phase": "serving", "latency": serving})

    # end-to-end sanity: the card's scores agree with the gather reference on
    # a slice of the full-size rows
    ref = score_from_path_length(standard_path_lengths(model.forest, Xd[:4096]), model.num_samples)
    require(float((ref - s_walk[:4096]).abs().max()) <= 2e-6, "walk scores vs gather reference")

    ext_kernels = eif_phases(dev, rng, X_m, y_m, X_big)
    fit_launches = fit_phases(dev, X_m, y_m, X_big, model)
    ext_kernels[0]["fit_launches"] = eif_fit_phases(dev, X_m, y_m, X_big)
    model_phases(dev, X_m, X_big)
    executor_phases(dev, X_m, X_big)
    q16_phases(dev, X_m, X_big)
    out_of_core_phases(dev, X_m, y_m, X_big)
    serving_launches = serving_phases(X_m, X_big, smi)
    lifecycle_launches = lifecycle_phases(dev, X_m, X_big, smi)
    parallel_launches = parallel_phases(dev, X_m, X_big, smi)
    fleet_launches = fleet_phases(dev, X_m, smi)
    stream_launches = stream_phases(dev, X_m, smi)
    tier_launches = tier_phases(dev, X_m, smi)
    cli_launches = cli_phases(dev, X_m, smi)

    emit({"kernels": [
        {"name": "walk_sum", "route": "cuda", "source": "isoforest_tpu_torch/csrc/path_walk.cu",
         "replaces": "isoforest_tpu/ops/pallas_walk.py:312", "launches": launches["walk"],
         "fit_launches": fit_launches, "serving_launches": serving_launches["walk_sum"],
         "lifecycle_launches": lifecycle_launches["walk_sum"], "parallel_launches": parallel_launches["walk_sum"],
         "fleet_launches": fleet_launches["walk_sum"], "stream_launches": stream_launches["walk_sum"],
         "tier_launches": tier_launches["walk_sum"], "cli_launches": cli_launches["walk_sum"],
         "max_abs_err": max(walk_err, walk_small_err), "ms": times["walk_ms"], "plain_ms": times["walk_plain_ms"],
         "bound_ms": walk_bound, "bound_by": walk_by, "library_ms": None},
        {"name": "dense_mean", "route": "cuda", "source": "isoforest_tpu_torch/csrc/dense.cu",
         "replaces": "isoforest_tpu/ops/pallas_traversal.py:278", "launches": launches["dense"],
         "serving_launches": serving_launches["dense_mean"], "lifecycle_launches": lifecycle_launches["dense_mean"],
         "parallel_launches": parallel_launches["dense_mean"], "fleet_launches": fleet_launches["dense_mean"],
         "stream_launches": stream_launches["dense_mean"], "tier_launches": tier_launches["dense_mean"],
         "cli_launches": cli_launches["dense_mean"],
         "max_abs_err": dense_err, "ms": times["dense_ms"], "plain_ms": times["dense_plain_ms"],
         "bound_ms": dense_bound, "bound_by": dense_by, "library_ms": None},
        *({**k, "serving_launches": serving_launches[k["name"]], "lifecycle_launches": lifecycle_launches[k["name"]],
           "parallel_launches": parallel_launches[k["name"]], "fleet_launches": fleet_launches[k["name"]],
           "stream_launches": stream_launches[k["name"]], "tier_launches": tier_launches[k["name"]],
           "cli_launches": cli_launches[k["name"]]}
          for k in ext_kernels),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
