"""Command-line front-end of the port: the JAX package's fifteen subcommands
over CSV files and sharded sources, on the card.

    python -m isoforest_tpu_torch fit --input data.csv --output /tmp/model \\
        --num-estimators 100 --contamination 0.02 [--extended] [--device cuda|cpu]
    python -m isoforest_tpu_torch fit --source /data/shards/ --output /tmp/model
        # out-of-core: one streamed pass over .csv/.npy/.avro/.parquet shards
    python -m isoforest_tpu_torch score --model /tmp/model --input data.csv \\
        --output scores.csv [--strategy auto|walk|dense|q16] [--device cuda|cpu]
    python -m isoforest_tpu_torch score --model /tmp/model --source /data/shards/ \\
        --output /tmp/scores_sink [--resume] [--strategy walk]
        # resumable: one sealed part per shard; --resume skips sealed parts
    python -m isoforest_tpu_torch convert --model /tmp/model --output model.onnx
    python -m isoforest_tpu_torch inspect --model /tmp/model [--tree 0] [--device cuda|cpu]
    python -m isoforest_tpu_torch telemetry [--format json|prometheus] \\
        [--input data.csv [--model /tmp/model]] [--device cuda|cpu]
    python -m isoforest_tpu_torch trace out.json \\
        [--input data.csv [--model /tmp/model]] [--device cuda|cpu]
    python -m isoforest_tpu_torch debug-bundle out.json \\
        [--input data.csv [--model /tmp/model]] [--device cuda|cpu]
    python -m isoforest_tpu_torch diagnose /tmp/model [--format json|prometheus] \\
        [--device cuda|cpu]
    python -m isoforest_tpu_torch monitor /tmp/model --input live.csv \\
        [--threshold 0.25] [--port 9101] [--format json|prometheus] [--device cuda|cpu]
    python -m isoforest_tpu_torch manage /tmp/model --input live.csv \\
        [--work-dir /tmp/model.lifecycle] [--debounce 3] [--window-rows N] \\
        [--mode full|sliding] [--threshold 0.25] [--port 9101] [--device cuda|cpu]
    python -m isoforest_tpu_torch stream /tmp/model --source live_shards/ \\
        [--window-s 60 --slide-s 30 --lateness-s 5] [--follow] \\
        [--reservoir decay --half-life-s 3600] [--retrain-every 1] \\
        [--port 9101] [--device cuda|cpu]  # rows are event_ts,f1,...,fn[,label]
    python -m isoforest_tpu_torch autotune [--format json|table] [--clear] \\
        [--warm --input data.csv [--model /tmp/model] \\
         --batch-sizes 1024,65536 [--refresh] [--device cuda|cpu]]
    python -m isoforest_tpu_torch serve /tmp/model --port 9100 \\
        [--batch-rows 1024] [--linger-ms 2] [--max-queue-rows 8192] \\
        [--queue-deadline-ms 2000] [--no-lifecycle] [--max-seconds N] \\
        [--device cuda|cpu]
    python -m isoforest_tpu_torch serve --models-dir /tmp/models --port 9100 \\
        [--fleet-budget-mb 64] [--preload]  # POST /score/<model_id>
    python -m isoforest_tpu_torch route --models-dir /tmp/models --replicas 2 \\
        [--port 9100] [--journal-dir /tmp/journal] [--device cuda|cpu]
        # replicated tier: K replica processes behind one router; the
        # router's /metrics /snapshot /trace /debug/bundle answer for the tier
    python -m isoforest_tpu_torch journal /tmp/journal \\
        [--spool replica-0] [--format json|chrome] [--tail N]
        # dump the flight recorder's NDJSON spools

CSV rows are feature columns; ``--labeled`` treats the last column as a label
(excluded from features; used to report AUROC after fit/score).

Every subcommand that loads or fits a model runs on the card unless
``--device`` names another device (``cpu`` runs the kernels' plain PyTorch
versions). With the default device and no card it raises before it reads
any input: it never carries on on the CPU. Each JSON summary that names a
model also names that device (``"device"``). ``route`` passes ``--device``
to every replica it spawns. ``convert`` loads no model onto a device: it
reads the directory's JSON and Avro on the host, as ``journal`` reads its
spools. ``score --strategy`` takes what the port serves (``auto``,
``walk``, ``dense``, ``q16``) and refuses the JAX package's ``gather``,
``pallas`` and ``native`` before it writes anything.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .utils.device import resolve_device

_DEVICE_HELP = (
    "the device the model loads or fits on (default: the card; with no card "
    "this raises, it never falls back to the CPU); cpu runs the kernels' plain "
    "PyTorch versions"
)


def _load(path: str, labeled: bool):
    """Materialise (X, y) from any source spec — a single CSV, a directory
    of shards, or a glob — read chunk by chunk through the sharded source
    abstraction (io/source.py), so even a single huge CSV never buffers
    more than one parsed chunk transiently above the final matrix."""
    from .io.source import open_source

    return open_source(path, labeled=labeled).read_all()


def _iter_input_chunks(spec: str, labeled: bool, chunk_rows: int):
    """Stream (X, y) chunks from any source spec (file / directory / glob)
    without materialising it."""
    from .io.source import open_source

    for chunk in open_source(spec, labeled=labeled).iter_chunks(chunk_rows=chunk_rows):
        yield chunk.X, chunk.y


def _auroc(scores, labels) -> float:
    """Rank AUROC of host arrays (ties broken by position, as the JAX CLI's)."""
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels == 1
    n1, n0 = int(pos.sum()), int((~pos).sum())
    if n1 == 0 or n0 == 0:
        return float("nan")
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def _load_model(path: str, device):
    from .io.persistence import load_model

    return load_model(path, device=device)


def cmd_fit(args) -> int:
    from .models import ExtendedIsolationForest, IsolationForest

    # no card with the default device raises here, before any input is read
    device = resolve_device(args.device)
    kw = dict(
        num_estimators=args.num_estimators,
        max_samples=args.max_samples,
        contamination=args.contamination,
        contamination_error=args.contamination_error,
        max_features=args.max_features,
        bootstrap=args.bootstrap,
        random_seed=args.random_seed,
        device=device,
    )
    if args.extended:
        est = ExtendedIsolationForest(extension_level=args.extension_level, **kw)
    else:
        est = IsolationForest(**kw)
    if args.source:
        # out-of-core path: one streamed sampling pass, bounded memory at
        # any source size
        from .io.source import open_source

        src = open_source(args.source, labeled=args.labeled)
        model = est.fit_source(src, chunk_rows=args.chunk_rows)
        y = None
    else:
        X, y = _load(args.input, args.labeled)
        model = est.fit(X)
    model.save(args.output, overwrite=args.overwrite)
    summary = {
        "model": args.output,
        "numTrees": model.forest.num_trees,
        "numSamples": model.num_samples,
        "threshold": model.outlier_score_threshold,
    }
    if args.source:
        summary["source"] = args.source
        summary["sourceShards"] = src.num_shards
    if y is not None:
        summary["auroc"] = round(_auroc(model.score(X).cpu().numpy(), y), 4)
    summary["device"] = str(device)
    print(json.dumps(summary))
    return 0


def cmd_score(args) -> int:
    import torch

    from .io.source import open_source
    from .ops.traversal import check_strategy_name

    device = resolve_device(args.device)
    # a strategy the port does not serve is refused before anything is
    # read or written
    check_strategy_name(args.strategy)
    model = _load_model(args.model, device)
    if args.source:
        # out-of-core sharded path: scores stream into a resumable sink
        # directory, one sealed part per shard
        from .io.outofcore import score_source

        if args.output == "-":
            print(
                "error: score --source writes a sink directory; pass "
                "--output <dir>",
                file=sys.stderr,
            )
            return 2
        src = open_source(args.source, labeled=args.labeled)
        summary = score_source(
            model,
            src,
            args.output,
            chunk_rows=args.chunk_rows,
            strategy=args.strategy,
            resume=args.resume,
        )
        summary["sink"] = args.output
        summary["device"] = str(device)
        print(json.dumps(summary))
        return 0
    header = "outlierScore,predictedLabel"
    # resolve (and thereby validate) the input BEFORE truncating the output —
    # a missing input must not destroy a pre-existing results file
    src = open_source(args.input, labeled=args.labeled)
    out_fh = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        out_fh.write(header + "\n")
        all_scores, all_labels = [], []
        for chunk in src.iter_chunks(chunk_rows=args.chunk_rows):
            # one copy to the host a chunk; the labels come from those scores
            scores = model.score(chunk.X, strategy=args.strategy).cpu().numpy()
            labels = model.predict(torch.from_numpy(scores)).numpy()
            np.savetxt(out_fh, np.stack([scores, labels], axis=1), delimiter=",")
            if chunk.y is not None:
                all_scores.append(scores)
                all_labels.append(chunk.y)
    finally:
        if out_fh is not sys.stdout:
            out_fh.close()
    if all_labels:
        auroc = _auroc(np.concatenate(all_scores), np.concatenate(all_labels))
        print(json.dumps({"auroc": round(auroc, 4)}), file=sys.stderr)
    return 0


def cmd_convert(args) -> int:
    from .onnx import convert_and_save

    convert_and_save(args.model, args.output)
    print(json.dumps({"onnx": args.output}))
    return 0


def cmd_inspect(args) -> int:
    from .utils.inspect import tree_structure_string

    device = resolve_device(args.device)
    model = _load_model(args.model, device)
    if args.tree is not None:
        print(tree_structure_string(model, args.tree))
        return 0
    ni = model.forest.num_instances.cpu().numpy()
    leaves = (ni >= 0).sum(axis=1)
    print(
        json.dumps(
            {
                "class": type(model).__name__,
                "numTrees": model.forest.num_trees,
                "maxNodes": model.forest.max_nodes,
                "numSamples": model.num_samples,
                "numFeatures": model.num_features,
                "totalNumFeatures": model.total_num_features,
                "outlierScoreThreshold": model.outlier_score_threshold,
                "avgLeavesPerTree": round(float(leaves.mean()), 2),
                "params": model.params.to_param_map(),
                "device": str(device),
            }
        )
    )
    return 0


def _workload(args, device):
    """The instrumented workload of ``telemetry``, ``trace`` and
    ``debug-bundle``: the ``--input`` CSV (scored with ``--model`` when
    given, else fit and scored), or a small synthetic mixture; scored once."""
    from .models import IsolationForest

    if args.input:
        X, _ = _load(args.input, args.labeled)
        if args.model:
            model = _load_model(args.model, device)
        else:
            model = IsolationForest(num_estimators=args.trees, random_seed=1, device=device).fit(X)
    else:
        rng = np.random.default_rng(0)
        X = rng.normal(size=(args.rows, 4)).astype(np.float32)
        X[: max(1, args.rows // 100)] += 4.0
        model = IsolationForest(num_estimators=args.trees, random_seed=1, device=device).fit(X)
    model.score(X)
    return model


def cmd_telemetry(args) -> int:
    """Run a workload with full instrumentation and print the telemetry
    snapshot — the operational smoke test for the observability layer:
    span timings, metric series and the event timeline for a real fit and
    score, in JSON or Prometheus exposition.

    With ``--input`` the workload is the user's CSV (scored with ``--model``
    when given, else fit and scored); without it, a small synthetic mixture.
    """
    from . import telemetry

    _workload(args, resolve_device(args.device))
    if args.format == "prometheus":
        print(telemetry.to_prometheus(), end="")
    else:
        print(telemetry.snapshot_json(indent=1))
    return 0


def cmd_trace(args) -> int:
    """Run an instrumented workload and write its scoring trace as
    Chrome trace-event JSON — drop the output file onto
    https://ui.perfetto.dev to see the causal path (root span, strategy
    attribution, per-chunk pipeline timings).

    Workload selection matches ``telemetry``. Capture policy is forced to
    keep everything for the run so the trace is always present regardless
    of latency.
    """
    from . import telemetry

    device = resolve_device(args.device)
    telemetry.set_trace_policy(slow_threshold_s=0.0, sample_every=1)
    _workload(args, device)
    recent = telemetry.recent_traces(limit=50)
    if not recent:
        print(json.dumps({"error": "no traces captured"}))
        return 1
    # prefer the scoring trace; fall back to the newest one
    chosen = next(
        (t for t in recent if t["root"] == "model.score"), recent[0]
    )
    trace = telemetry.get_trace(chosen["trace_id"])
    with open(args.output, "w") as fh:
        fh.write(telemetry.to_chrome_trace_json(trace, indent=1))
        fh.write("\n")
    print(
        json.dumps(
            {
                "trace_id": chosen["trace_id"],
                "root": chosen["root"],
                "spans": chosen["spans"],
                "wall_s": chosen["wall_s"],
                "output": args.output,
                "device": str(device),
            }
        )
    )
    return 0


def cmd_debug_bundle(args) -> int:
    """Run an instrumented workload and write the flight-recorder debug
    bundle: recent traces, the event timeline tail, a metrics snapshot,
    degradation rungs, the autotune winner table, the compile log and
    memory watermarks — one attachable JSON artifact. Workload selection
    matches ``telemetry`` and ``trace``.
    """
    from . import telemetry

    device = resolve_device(args.device)
    telemetry.set_trace_policy(slow_threshold_s=0.0, sample_every=1)
    _workload(args, device)
    bundle = telemetry.write_bundle(args.output)
    print(
        json.dumps(
            {
                "output": args.output,
                "schema": bundle["schema"],
                "sections": sorted(k for k in bundle if k != "schema"),
                "compiles": bundle["compiles"]["total"],
                "traces": len(bundle["traces"]),
                "events": len(bundle["events"]),
                "device": str(device),
            }
        )
    )
    return 0


def cmd_diagnose(args) -> int:
    """Forest-structure diagnostics for a saved model: tree depths, leaf
    sizes, split-feature usage, expected-vs-realised average path length
    and imbalance stats — straight from the node tables, no data needed."""
    from . import telemetry

    device = resolve_device(args.device)
    model = _load_model(args.model_dir, device)
    diag = model.diagnostics()
    if args.format == "prometheus":
        telemetry.publish_gauges(diag)
        print(telemetry.to_prometheus(), end="")
    else:
        print(json.dumps({**diag, "device": str(device)}, indent=1, sort_keys=True))
    return 0


def _refuse_without_baseline(model, what: str) -> bool:
    """Print the JAX CLI's error for a model with no drift baseline."""
    if model.baseline is not None:
        return False
    print(
        "error: this model directory has no _BASELINE.json sidecar "
        f"(legacy save, or fit with baseline capture disabled) — {what}",
        file=sys.stderr,
    )
    return True


def cmd_monitor(args) -> int:
    """Score a CSV through a saved model with the drift monitor attached
    and report PSI/KS of the served scores and input features against the
    model's training baseline. ``--port`` serves the live /metrics endpoint
    while scoring (0 = ephemeral)."""
    from . import telemetry

    device = resolve_device(args.device)
    model = _load_model(args.model_dir, device)
    if _refuse_without_baseline(model, "refit and re-save to enable drift monitoring"):
        return 2
    monitor = model.enable_monitoring(
        threshold=args.threshold, min_rows=args.min_rows
    )
    server = telemetry.serve(port=args.port) if args.port is not None else None
    try:
        for X, _ in _iter_input_chunks(args.input, args.labeled, args.chunk_rows):
            model.score(X)  # folds into the monitor
    finally:
        if server is not None:
            server.stop()
    report = monitor.report()
    report["model"] = args.model_dir
    report["input"] = args.input
    report["device"] = str(device)
    if args.format == "prometheus":
        print(telemetry.to_prometheus(), end="")
        if report["drifted"]:
            print(
                f"# drift alerts: {json.dumps(report['alerts'])}",
                file=sys.stderr,
            )
    else:
        print(json.dumps(report, indent=1, sort_keys=True))
    return 0


def cmd_manage(args) -> int:
    """Serve a CSV through the model lifecycle manager: score with drift
    monitoring, and on sustained drift retrain on the recent window,
    validate the candidate against the incumbent, and atomically hot-swap
    generations — synchronously, so the command's exit state is
    deterministic. Prints the lifecycle summary (generation, retrain
    outcomes, drift report) as JSON. ``--port`` serves the live /metrics +
    /healthz endpoint (with the lifecycle section) while scoring."""
    from . import telemetry
    from .lifecycle import ModelManager

    device = resolve_device(args.device)
    model = _load_model(args.model_dir, device)
    if _refuse_without_baseline(
        model, "the lifecycle manager needs the drift baseline; refit and re-save"
    ):
        return 2
    manager = ModelManager(
        model,
        work_dir=args.work_dir or args.model_dir + ".lifecycle",
        monitor_threshold=args.threshold,
        drift_debounce=args.debounce,
        window_rows=args.window_rows,
        min_window_rows=args.min_window_rows,
        mode=args.mode,
        reservoir=args.reservoir,
        reservoir_half_life_s=args.half_life_s,
        checkpoint_every=args.checkpoint_every,
        background=False,  # retrains run inline: the CLI is deterministic
        monitor_kwargs={"min_rows": args.min_rows},
    )
    server = telemetry.serve(port=args.port) if args.port is not None else None
    if args.journal_dir:
        telemetry.activate_journal(args.journal_dir, "manage")
    try:
        rows = 0
        for X, y in _iter_input_chunks(args.input, args.labeled, args.chunk_rows):
            manager.score(X, y=y)
            rows += len(X)
    finally:
        if args.journal_dir:
            telemetry.deactivate_journal()
        if server is not None:
            server.stop()
    summary = manager.state()
    summary["rows"] = rows
    summary["model"] = args.model_dir
    summary["input"] = args.input
    summary["device"] = str(device)
    summary["drift"] = manager.monitor.report()
    if manager.last_validation is not None:
        summary["last_validation"] = manager.last_validation.as_dict()
    manager.close()
    print(json.dumps(summary, indent=1, sort_keys=True))
    return 0


def cmd_stream(args) -> int:
    """Online anomaly detection over an event-time stream: tail a shard
    directory / CSV file, listen on a TCP line protocol, or read stdin;
    score every timestamped row with bounded lag through the micro-batch
    coalescer; and run the window-cadenced retrain/validate/swap loop as
    the steady state. Rows are ``event_ts,f1,...,fn[,label]``. Prints the
    stream summary as JSON; ``--port`` serves live /metrics +
    /traces/recent while streaming, and ``--hold-seconds`` keeps that
    endpoint up after the source ends so a harness can pull traces and the
    debug bundle before SIGTERM."""
    import signal
    import threading
    import time as _time

    from . import telemetry
    from .lifecycle import ModelManager
    from .stream import StreamConfig, StreamEngine, socket_source, tail_source

    device = resolve_device(args.device)
    model = _load_model(args.model_dir, device)
    if _refuse_without_baseline(
        model, "the streaming lifecycle needs the drift baseline; refit and re-save"
    ):
        return 2
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:  # pragma: no cover - non-main-thread embedding
            pass
    feed = None
    if args.source == "-":
        from .stream.sources import parse_lines

        def _stdin_batches():
            buf = []
            for line in sys.stdin:
                line = line.strip()
                if line and not line.startswith("#"):
                    buf.append(line)
                if len(buf) >= args.chunk_rows or stop.is_set():
                    if buf:
                        yield parse_lines(buf, args.labeled)
                        buf = []
                    if stop.is_set():
                        return
            if buf:
                yield parse_lines(buf, args.labeled)

        source = _stdin_batches()
    elif args.source.startswith("tcp://"):
        host, _, port_s = args.source[len("tcp://") :].partition(":")
        feed = socket_source(
            int(port_s or 0),
            host or "127.0.0.1",
            labeled=args.labeled,
            chunk_rows=args.chunk_rows,
            should_stop=stop.is_set,
        )
        source = feed.batches()
    else:
        source = tail_source(
            args.source,
            labeled=args.labeled,
            follow=args.follow,
            poll_s=args.poll_s,
            chunk_rows=args.chunk_rows,
            stop=stop.is_set,
        )
    manager = ModelManager(
        model,
        work_dir=args.work_dir or args.model_dir + ".stream",
        monitor_threshold=args.threshold,
        window_rows=args.window_rows,
        min_window_rows=args.min_window_rows,
        mode=args.mode,
        reservoir=args.reservoir,
        reservoir_half_life_s=args.half_life_s,
        checkpoint_every=args.checkpoint_every,
        auto_retrain=False,  # the window-close cadence drives retrains
        background=False,  # inline: the CLI's swap count is deterministic
        monitor_kwargs={"min_rows": args.min_rows},
    )
    engine = StreamEngine(
        manager,
        StreamConfig(
            window_s=args.window_s,
            slide_s=args.slide_s,
            lateness_s=args.lateness_s,
            retrain_every=args.retrain_every,
            batch_rows=args.batch_rows,
            linger_s=args.linger_ms / 1000.0,
        ),
    )
    server = telemetry.serve(port=args.port) if args.port is not None else None
    if args.journal_dir:
        telemetry.activate_journal(args.journal_dir, "stream")
    if server is not None:
        print(
            json.dumps(
                {
                    "stream": args.model_dir,
                    "source": args.source,
                    "url": f"http://127.0.0.1:{server.port}",
                    "device": str(device),
                    **({"tcp_port": feed.port} if feed is not None else {}),
                }
            ),
            flush=True,
        )
    try:
        try:
            summary = engine.run(source, max_rows=args.max_rows)
        except KeyboardInterrupt:
            summary = engine.finish()
        summary["model"] = args.model_dir
        summary["source"] = args.source
        summary["device"] = str(device)
        summary["drift"] = manager.monitor.report()
        print(json.dumps(summary, indent=1, sort_keys=True), flush=True)
        if server is not None and args.hold_seconds > 0:
            deadline = _time.time() + args.hold_seconds
            while _time.time() < deadline and not stop.is_set():
                _time.sleep(0.1)
    finally:
        if args.journal_dir:
            telemetry.deactivate_journal()
        if feed is not None:
            feed.stop()
        if server is not None:
            server.stop()
        manager.close()
    return 0


def cmd_serve(args) -> int:
    """Serve ``POST /score``: load the model onto ``--device`` (default:
    the card; none present raises), wrap it in
    the lifecycle manager when it carries a drift baseline (resuming the
    last swapped generation from ``CURRENT.json``), mount the scoring
    endpoint with dynamic micro-batch coalescing on the telemetry HTTP
    server, pre-warm the autotuned batch buckets, print one JSON ready
    line, and serve until SIGTERM/SIGINT (or ``--max-seconds``).

    With ``--models-dir`` the process serves a multi-tenant **fleet**
    instead: every sealed model directory under the dir
    becomes a tenant behind ``POST /score/<model_id>`` (+ ``GET /models``),
    loaded lazily under the ``--fleet-budget-mb`` residency LRU, each with
    its own coalescer, admission queue and lifecycle manager."""
    import signal
    import threading

    from .serving import ServingConfig, serve_model

    if (args.model_dir is None) == (args.models_dir is None):
        print(
            "error: pass exactly one of <model_dir> (single-model serving) "
            "or --models-dir (multi-tenant fleet)",
            file=sys.stderr,
        )
        return 2
    # no card with the default device raises here, before anything serves
    device = resolve_device(args.device)
    if args.journal_dir:
        # flight-record before anything serves: the first fleet.load must
        # already hit the spool (a spawned replica spools under its tier
        # name — the router recovers it from the tier /debug/bundle)
        from . import telemetry

        telemetry.activate_journal(
            args.journal_dir, args.replica_name or f"serve-{os.getpid()}"
        )
    config = ServingConfig(
        batch_rows=args.batch_rows,
        linger_ms=args.linger_ms,
        max_queue_rows=args.max_queue_rows,
        queue_deadline_ms=args.queue_deadline_ms,
        request_timeout_s=args.request_timeout_s,
        score_timeout_s=args.score_timeout_s,
        weight=args.weight,
    )
    weights = {}
    for spec in args.tenant_weight or ():
        model_id, sep, value = spec.partition("=")
        if not sep or not model_id:
            print(
                f"error: --tenant-weight expects MODEL_ID=WEIGHT, got {spec!r}",
                file=sys.stderr,
            )
            return 2
        weights[model_id] = float(value)
    warm = sorted({int(s) for s in args.warm_batch_sizes.split(",") if s})
    manager_kwargs = {
        "drift_debounce": args.debounce,
        "window_rows": args.window_rows,
        "min_window_rows": args.min_window_rows,
        "mode": args.mode,
        "monitor_kwargs": {"min_rows": args.min_rows},
    }
    if args.threshold is not None:
        manager_kwargs["monitor_threshold"] = args.threshold
    if args.models_dir is not None:
        from .fleet import serve_fleet

        budget = (
            int(args.fleet_budget_mb * (1 << 20))
            if args.fleet_budget_mb is not None
            else None
        )
        handle = serve_fleet(
            args.models_dir,
            port=args.port,
            host=args.host,
            config=config,
            budget_bytes=budget,
            lifecycle=not args.no_lifecycle,
            work_root=args.work_dir,
            manager_kwargs=manager_kwargs,
            preload=args.preload,
            weights=weights or None,
            device=device,
        )
        ready = {
            "serving": True,
            "fleet": True,
            "url": handle.url,
            "endpoint": handle.url + "/score/<model_id>",
            "models": handle.registry.model_ids(),
            "budget_bytes": budget,
            "device": str(device),
            "batch_rows": config.batch_rows,
            "linger_ms": config.linger_ms,
        }
    else:
        handle = serve_model(
            args.model_dir,
            port=args.port,
            host=args.host,
            config=config,
            lifecycle=not args.no_lifecycle,
            work_dir=args.work_dir,
            warm_batch_sizes=warm or (1,),
            manager_kwargs=manager_kwargs,
            device=device,
        )
        ready = {
            "serving": True,
            "url": handle.url,
            "endpoint": handle.url + "/score",
            "model": args.model_dir,
            "lifecycle": handle.manager is not None,
            "generation": (
                handle.manager.generation if handle.manager is not None else None
            ),
            "batch_rows": config.batch_rows,
            "linger_ms": config.linger_ms,
            "device": str(device),
        }
    autopilot = None
    if args.autopilot:
        from .autopilot import Autopilot, AutopilotConfig, mount_autopilot

        ap_config = AutopilotConfig(
            high_water=args.autopilot_high_water,
            low_water=args.autopilot_low_water,
            engage_ticks=args.autopilot_engage_ticks,
            recover_ticks=args.autopilot_recover_ticks,
            tick_interval_s=args.autopilot_interval_s,
            subsample_trees=args.autopilot_subsample_trees,
            strict=args.autopilot_strict,
        )
        if args.models_dir is not None:
            autopilot = Autopilot(registry=handle.registry, config=ap_config)
        else:
            autopilot = Autopilot(services=[handle.service], config=ap_config)
        mount_autopilot(handle.server, autopilot)
        autopilot.start()
        ready["autopilot"] = True
    heartbeat = None
    if args.replica_name and args.heartbeat_dir:
        # replicated tier: advertise liveness to the
        # fronting router. Write-only wiring — the replica's own /healthz
        # deliberately does NOT read this directory (a dead PEER must not
        # flip this replica unhealthy)
        from .resilience.watchdog import HeartbeatWriter

        os.makedirs(args.heartbeat_dir, exist_ok=True)
        heartbeat = HeartbeatWriter(args.heartbeat_dir, args.replica_name)
        heartbeat.start()
        ready["replica"] = args.replica_name
    stop = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    except ValueError:
        pass  # not the main thread (in-process tests drive stop themselves)
    print(json.dumps(ready), flush=True)
    try:
        stop.wait(args.max_seconds)  # None waits until SIGTERM/SIGINT
    except KeyboardInterrupt:
        pass
    finally:
        if heartbeat is not None:
            heartbeat.stop()
        if autopilot is not None:
            autopilot.close()
        handle.close()
        if args.journal_dir:
            from . import telemetry

            telemetry.deactivate_journal()
    return 0


def cmd_route(args) -> int:
    """Front a replicated serving tier: spawn ``--replicas`` fleet replicas
    (``serve --models-dir`` processes on ``--device``) over one
    ``--models-dir``, balance
    ``POST /score/<model_id>`` across them with health-probe admission and
    idempotent retries, watch ``CURRENT.json`` for rolling model pushes,
    print one JSON ready line, and serve until SIGTERM/SIGINT (draining
    in-flight requests, then the replicas, on the way down)."""
    import signal
    import threading

    from .replication import RouterConfig, serve_router

    config = RouterConfig(
        probe_interval_s=args.probe_interval_s,
        probe_timeout_s=args.probe_timeout_s,
        stale_after_s=args.stale_after_s,
        request_timeout_s=args.request_timeout_s,
        drain_timeout_s=args.drain_timeout_s,
        retry_attempts=args.retry_attempts,
    )
    replica_args = []
    if args.batch_rows is not None:
        replica_args += ["--batch-rows", str(args.batch_rows)]
    if args.linger_ms is not None:
        replica_args += ["--linger-ms", str(args.linger_ms)]
    if args.fleet_budget_mb is not None:
        replica_args += ["--fleet-budget-mb", str(args.fleet_budget_mb)]
    if args.preload:
        replica_args += ["--preload"]
    if args.no_lifecycle:
        replica_args += ["--no-lifecycle"]
    if args.work_dir is not None:
        replica_args += ["--work-dir", args.work_dir]
    if args.device is not None:
        replica_args += ["--device", args.device]
    if args.journal_dir:
        # the router flight-records its own plane ("router" spool); each
        # spawned replica gets --journal-dir and spools under its tier name
        from . import telemetry

        telemetry.activate_journal(args.journal_dir, "router")
    handle = serve_router(
        args.models_dir,
        replicas=args.replicas,
        port=args.port,
        host=args.host,
        config=config,
        work_root=args.work_dir,
        replica_args=tuple(replica_args),
        journal_dir=args.journal_dir,
    )
    ready = {
        "router": True,
        "url": handle.url,
        "endpoint": handle.url + "/score/<model_id>",
        "models_dir": args.models_dir,
        "journal_dir": args.journal_dir,
        "replicas": [
            {"name": r.name, "url": r.url, "pid": r.pid}
            for r in handle.router.replicas
        ],
    }
    stop = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    except ValueError:
        pass  # not the main thread (in-process tests drive stop themselves)
    print(json.dumps(ready), flush=True)
    try:
        stop.wait(args.max_seconds)  # None waits until SIGTERM/SIGINT
    except KeyboardInterrupt:
        pass
    finally:
        handle.close()
        if args.journal_dir:
            from . import telemetry

            telemetry.deactivate_journal()
    return 0


def cmd_journal(args) -> int:
    """Dump a flight-recorder journal directory: every spool's NDJSON records as JSON lines (each tagged with its
    ``spool``), or — with ``--format chrome`` — the journaled traces
    merged into ONE Perfetto document with a ``pid`` lane per spool, the
    same stitched rendering as the federated ``GET /trace``. ``--tail N``
    keeps the newest N records per spool; ``--spool NAME`` restricts to
    one process's spool. Torn final lines (a kill -9 mid-write) are
    reported in the summary, never fatal."""
    from . import telemetry

    journal_dir = args.journal_dir
    spool_names = telemetry.list_spools(journal_dir)
    if args.spool:
        if args.spool not in spool_names:
            print(
                f"error: no spool {args.spool!r} under {journal_dir} "
                f"(found: {', '.join(spool_names) or 'none'})",
                file=sys.stderr,
            )
            return 2
        spool_names = [args.spool]
    if not spool_names:
        print(f"error: no journal spools under {journal_dir}", file=sys.stderr)
        return 2
    spools = {
        name: telemetry.read_spool(
            os.path.join(journal_dir, name), tail=args.tail
        )
        for name in spool_names
    }
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        if args.format == "chrome":
            named = [
                (
                    name,
                    [
                        span
                        for record in spool["records"]
                        if record.get("type") == "trace"
                        for span in (record.get("trace") or {}).get("spans", ())
                    ],
                )
                for name, spool in spools.items()
            ]
            doc = telemetry.federated_chrome(named)
            json.dump(doc, out, sort_keys=True)
            out.write("\n")
        else:
            for name, spool in spools.items():
                for record in spool["records"]:
                    out.write(
                        json.dumps({"spool": name, **record}, sort_keys=True)
                        + "\n"
                    )
    except BrokenPipeError:
        # `journal ... | head` closing the pipe is a normal way to read a
        # spool, not an error; mute the interpreter-shutdown stdout flush
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
    finally:
        if args.output:
            out.close()
    summary = {
        "journal_dir": journal_dir,
        "spools": {
            name: {
                "records": len(spool["records"]),
                "segments": spool["segments"],
                "torn_tail": spool["torn_tail"],
                "skipped_lines": spool["skipped_lines"],
            }
            for name, spool in spools.items()
        },
        **({"output": args.output} if args.output else {}),
    }
    print(json.dumps(summary, sort_keys=True), file=sys.stderr)
    return 0


def cmd_autotune(args) -> int:
    """Operate the measured strategy autotuner's persisted cost model: dump
    the winner table (default; ``--format json`` round-trips the persisted
    file), ``--clear`` it, or ``--warm`` it by probing the given workload at
    each batch bucket on ``--device`` so a serving fleet never pays a cold
    probe on a live request. On the card the probe pool is the kernels
    (``walk``, ``dense``)."""
    from . import tuning

    if args.clear:
        existed = tuning.clear_table()
        print(json.dumps({"cleared": str(tuning.table_path()), "existed": existed}))
        return 0
    if args.warm:
        device = resolve_device(args.device)
        if args.input:
            X, _ = _load(args.input, args.labeled)
        else:
            rng = np.random.default_rng(0)
            X = rng.normal(size=(4096, 4)).astype(np.float32)
            X[:40] += 4.0
        if args.model:
            model = _load_model(args.model, device)
        else:
            from .models import IsolationForest

            model = IsolationForest(num_estimators=args.trees, random_seed=1, device=device).fit(X)
        decisions = []
        for b in sorted({int(s) for s in args.batch_sizes.split(",") if s}):
            Xb = np.resize(np.asarray(X, np.float32), (max(b, 1), X.shape[1]))
            d = tuning.resolve_decision(
                model.forest, Xb, model.num_samples, refresh=args.refresh
            )
            decisions.append(
                {"batch": b, "key": d.key, "strategy": d.strategy, "source": d.source}
            )
        print(json.dumps({"warmed": decisions, "device": str(device)}), file=sys.stderr)
    doc = tuning.table_snapshot()
    if args.format == "table":
        print(f"# {doc['path']} (schema {doc['schema']}, ttl {doc['ttl_s']:g}s)")
        for key, entry in doc["entries"].items():
            timings = " ".join(
                f"{s}={t if t is not None else 'fail'}"
                for s, t in sorted(entry.get("timings_s", {}).items())
            )
            print(f"{key} -> {entry['strategy']} [{timings}]")
    else:
        print(json.dumps(doc, indent=1, sort_keys=True))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="isoforest_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    fit = sub.add_parser(
        "fit", help="train a model from a CSV or a sharded on-disk source"
    )
    fit_in = fit.add_mutually_exclusive_group(required=True)
    fit_in.add_argument("--input", help="CSV file (materialised in memory)")
    fit_in.add_argument(
        "--source",
        help="sharded source — directory, glob, or file of "
        ".csv/.npy/.avro/.parquet shards; fit streams it out-of-core "
        "(one bounded-memory pass)",
    )
    fit.add_argument("--output", required=True)
    fit.add_argument(
        "--chunk-rows",
        type=int,
        default=None,
        help="rows per streamed chunk for --source (default 65536)",
    )
    fit.add_argument("--labeled", action="store_true")
    fit.add_argument("--extended", action="store_true")
    fit.add_argument("--num-estimators", type=int, default=100)
    fit.add_argument("--max-samples", type=float, default=256.0)
    fit.add_argument("--contamination", type=float, default=0.0)
    fit.add_argument("--contamination-error", type=float, default=0.0)
    fit.add_argument("--max-features", type=float, default=1.0)
    fit.add_argument("--bootstrap", action="store_true")
    fit.add_argument("--random-seed", type=int, default=1)
    fit.add_argument("--extension-level", type=int, default=None)
    fit.add_argument("--overwrite", action="store_true")
    fit.add_argument("--device", default=None, help=_DEVICE_HELP)
    fit.set_defaults(func=cmd_fit)

    score = sub.add_parser(
        "score", help="score a CSV or a sharded source with a saved model"
    )
    score.add_argument("--model", required=True)
    score_in = score.add_mutually_exclusive_group(required=True)
    score_in.add_argument("--input", help="CSV file, scored to --output CSV")
    score_in.add_argument(
        "--source",
        help="sharded source — scores stream shard by shard into the "
        "--output sink directory with resumable sealed parts",
    )
    score.add_argument("--output", default="-")
    score.add_argument("--labeled", action="store_true")
    score.add_argument(
        "--chunk-rows",
        type=int,
        default=1 << 20,
        help="stream the input in chunks of this many rows — bounded memory "
        "for arbitrarily large unlabeled files (--labeled accumulates "
        "scores+labels for the final AUROC report)",
    )
    score.add_argument(
        "--strategy",
        default="auto",
        help="scoring strategy: auto (default), walk, dense or q16; pin walk "
        "or dense to make a --source sink resumable across machines and "
        "across the two packages (gather, pallas and native are the JAX "
        "package's and are refused)",
    )
    score.add_argument(
        "--resume",
        action="store_true",
        help="with --source: re-attach to an existing sink, skipping every "
        "intact sealed shard (bitwise-identical final output)",
    )
    score.add_argument("--device", default=None, help=_DEVICE_HELP)
    score.set_defaults(func=cmd_score)

    conv = sub.add_parser(
        "convert",
        help="export a saved model to ONNX (host numpy: no device)",
    )
    conv.add_argument("--model", required=True)
    conv.add_argument("--output", required=True)
    conv.set_defaults(func=cmd_convert)

    insp = sub.add_parser("inspect", help="summarise a saved model")
    insp.add_argument("--model", required=True)
    insp.add_argument("--tree", type=int, default=None)
    insp.add_argument("--device", default=None, help=_DEVICE_HELP)
    insp.set_defaults(func=cmd_inspect)

    tele = sub.add_parser(
        "telemetry",
        help="run an instrumented workload and print the telemetry snapshot",
    )
    tele.add_argument(
        "--format", choices=("json", "prometheus"), default="json"
    )
    _workload_arguments(tele)
    tele.set_defaults(func=cmd_telemetry)

    trc = sub.add_parser(
        "trace",
        help="run an instrumented workload and write a Perfetto-loadable trace",
    )
    trc.add_argument("output", help="Chrome trace-event JSON output path")
    _workload_arguments(trc)
    trc.set_defaults(func=cmd_trace)

    dbg = sub.add_parser(
        "debug-bundle",
        help="run an instrumented workload and write the flight-recorder "
        "debug bundle (one JSON artifact)",
    )
    dbg.add_argument("output", help="debug-bundle JSON output path")
    _workload_arguments(dbg)
    dbg.set_defaults(func=cmd_debug_bundle)

    diag = sub.add_parser(
        "diagnose", help="forest-structure diagnostics for a saved model"
    )
    diag.add_argument("model_dir")
    diag.add_argument("--format", choices=("json", "prometheus"), default="json")
    diag.add_argument("--device", default=None, help=_DEVICE_HELP)
    diag.set_defaults(func=cmd_diagnose)

    mon = sub.add_parser(
        "monitor",
        help="score a CSV with drift monitoring vs the model's baseline",
    )
    mon.add_argument("model_dir")
    mon.add_argument("--input", required=True, help="CSV of serving traffic")
    mon.add_argument("--labeled", action="store_true")
    mon.add_argument(
        "--threshold",
        type=float,
        default=None,
        help="PSI alert threshold (default 0.25, the 'major shift' band)",
    )
    mon.add_argument(
        "--min-rows",
        type=int,
        default=512,
        help="rows to fold before drift is evaluated",
    )
    mon.add_argument("--chunk-rows", type=int, default=1 << 16)
    mon.add_argument(
        "--port",
        type=int,
        default=None,
        help="serve the live /metrics endpoint on this port while scoring "
        "(0 = ephemeral)",
    )
    mon.add_argument("--format", choices=("json", "prometheus"), default="json")
    mon.add_argument("--device", default=None, help=_DEVICE_HELP)
    mon.set_defaults(func=cmd_monitor)

    man = sub.add_parser(
        "manage",
        help="serve a CSV under the drift-triggered retraining lifecycle",
    )
    man.add_argument("model_dir")
    man.add_argument("--input", required=True, help="CSV of serving traffic")
    man.add_argument("--labeled", action="store_true")
    man.add_argument(
        "--work-dir",
        default=None,
        help="lifecycle artifact dir: swapped generations + refit "
        "checkpoints (default: <model_dir>.lifecycle)",
    )
    man.add_argument(
        "--threshold",
        type=float,
        default=None,
        help="PSI alert threshold (default 0.25, the 'major shift' band)",
    )
    man.add_argument(
        "--debounce",
        type=int,
        default=3,
        help="consecutive over-threshold drift evaluations before a retrain",
    )
    man.add_argument(
        "--window-rows",
        type=int,
        default=65536,
        help="recent-data reservoir capacity the refit trains on",
    )
    man.add_argument(
        "--min-window-rows",
        type=int,
        default=1024,
        help="refuse to retrain on a window smaller than this",
    )
    man.add_argument(
        "--min-rows",
        type=int,
        default=512,
        help="rows to fold before drift is evaluated",
    )
    man.add_argument(
        "--mode",
        choices=("full", "sliding"),
        default="full",
        help="full refit, or sliding-window tree refresh (retire oldest "
        "trees, grow replacements on the window)",
    )
    man.add_argument(
        "--reservoir",
        choices=("fifo", "decay"),
        default="fifo",
        help="retrain-window policy: the last N rows, or the seeded "
        "exponential-decay weighted sample",
    )
    man.add_argument(
        "--half-life-s",
        type=float,
        default=3600.0,
        help="decay reservoir half-life: every this many seconds of event "
        "time halves an old row's retention odds",
    )
    man.add_argument(
        "--checkpoint-every",
        type=int,
        default=None,
        help="trees per refit checkpoint block (default 32)",
    )
    man.add_argument("--chunk-rows", type=int, default=1 << 16)
    man.add_argument(
        "--port",
        type=int,
        default=None,
        help="serve the live /metrics + /healthz endpoint on this port "
        "while scoring (0 = ephemeral)",
    )
    man.add_argument(
        "--journal-dir",
        default=None,
        help="flight-record every event and committed trace into an "
        "append-only NDJSON spool under this directory",
    )
    man.add_argument("--device", default=None, help=_DEVICE_HELP)
    man.set_defaults(func=cmd_manage)

    stm = sub.add_parser(
        "stream",
        help="online anomaly detection over an event-time stream",
    )
    stm.add_argument("model_dir")
    stm.add_argument(
        "--source",
        required=True,
        help="append-only stream: a shard dir/glob or CSV file to tail "
        "(rows are event_ts,f1,...,fn[,label]), tcp://HOST:PORT to "
        "listen on the line protocol, or - for stdin",
    )
    stm.add_argument("--labeled", action="store_true")
    stm.add_argument(
        "--follow",
        action="store_true",
        help="keep tailing a file source for appended rows / new shards "
        "after the current end (default: stop at end of data)",
    )
    stm.add_argument(
        "--window-s",
        type=float,
        default=60.0,
        help="event-time window width",
    )
    stm.add_argument(
        "--slide-s",
        type=float,
        default=None,
        help="window slide (must divide --window-s; default = tumbling)",
    )
    stm.add_argument(
        "--lateness-s",
        type=float,
        default=5.0,
        help="allowed lateness: the watermark trails the max event time by "
        "this much; rows behind it are scored but counted late",
    )
    stm.add_argument(
        "--retrain-every",
        type=int,
        default=1,
        help="retrain/validate/swap after every N non-empty window closes",
    )
    stm.add_argument(
        "--mode",
        choices=("full", "sliding"),
        default="sliding",
        help="refit flavour at each window-cadenced retrain (default "
        "sliding: the streaming steady state)",
    )
    stm.add_argument(
        "--reservoir",
        choices=("fifo", "decay"),
        default="decay",
        help="retrain-window policy (default: event-time exponential decay)",
    )
    stm.add_argument(
        "--half-life-s",
        type=float,
        default=3600.0,
        help="decay reservoir half-life in event-time seconds",
    )
    stm.add_argument("--window-rows", type=int, default=65536)
    stm.add_argument("--min-window-rows", type=int, default=1024)
    stm.add_argument("--min-rows", type=int, default=512)
    stm.add_argument("--threshold", type=float, default=None)
    stm.add_argument("--checkpoint-every", type=int, default=None)
    stm.add_argument("--work-dir", default=None, help="default: <model_dir>.stream")
    stm.add_argument("--batch-rows", type=int, default=1024)
    stm.add_argument("--linger-ms", type=float, default=2.0)
    stm.add_argument("--chunk-rows", type=int, default=4096)
    stm.add_argument("--poll-s", type=float, default=0.25)
    stm.add_argument(
        "--max-rows", type=int, default=None, help="stop after ~N ingested rows"
    )
    stm.add_argument(
        "--port",
        type=int,
        default=None,
        help="serve live /metrics + /traces/recent while streaming "
        "(0 = ephemeral; prints a JSON ready line with the URL)",
    )
    stm.add_argument(
        "--hold-seconds",
        type=float,
        default=0.0,
        help="keep the telemetry endpoint up this long after the summary "
        "line (until SIGTERM), so a harness can pull traces + debug bundle",
    )
    stm.add_argument(
        "--journal-dir",
        default=None,
        help="flight-record every event and committed trace into an "
        "append-only NDJSON spool under this directory",
    )
    stm.add_argument("--device", default=None, help=_DEVICE_HELP)
    stm.set_defaults(func=cmd_stream)

    srv = sub.add_parser(
        "serve",
        help="serve POST /score with dynamic micro-batch coalescing "
        "(or a multi-tenant fleet with --models-dir)",
    )
    srv.add_argument(
        "model_dir",
        nargs="?",
        default=None,
        help="single-model mode: the sealed model directory to serve "
        "(mutually exclusive with --models-dir)",
    )
    srv.add_argument(
        "--models-dir",
        default=None,
        help="fleet mode: serve every sealed model "
        "directory under this dir as a tenant behind POST "
        "/score/<model_id> (the subdir name is the model id)",
    )
    srv.add_argument(
        "--fleet-budget-mb",
        type=float,
        default=None,
        help="fleet residency budget in MiB of packed scoring-layout "
        "bytes: past it, least-recently-used tenants are evicted and "
        "re-load lazily from their sealed dirs (default: unbounded)",
    )
    srv.add_argument(
        "--preload",
        action="store_true",
        help="fleet mode: load every tenant at startup instead of lazily "
        "on first request",
    )
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument(
        "--port",
        type=int,
        default=0,
        help="HTTP port for /score + /metrics + /healthz (0 = ephemeral, "
        "reported on the ready line)",
    )
    srv.add_argument(
        "--batch-rows",
        type=int,
        default=1024,
        help="coalescer flush size — keep it a power-of-two batch bucket "
        "so flushes land on the pre-warmed autotuned shapes",
    )
    srv.add_argument(
        "--linger-ms",
        type=float,
        default=2.0,
        help="max time the oldest queued request waits for company before "
        "its flush goes out (the tail-latency bound)",
    )
    srv.add_argument(
        "--max-queue-rows",
        type=int,
        default=8192,
        help="admission queue bound; a request past it gets HTTP 429",
    )
    srv.add_argument(
        "--queue-deadline-ms",
        type=float,
        default=2000.0,
        help="once the oldest queued request is older than this the "
        "service answers HTTP 503 (not draining)",
    )
    srv.add_argument(
        "--request-timeout-s",
        type=float,
        default=30.0,
        help="per-request wait budget (queue + scoring) before a 503",
    )
    srv.add_argument(
        "--score-timeout-s",
        type=float,
        default=None,
        help="arm the scoring watchdog per coalesced flush "
        "(the degradation ladder's watchdog rung)",
    )
    srv.add_argument(
        "--warm-batch-sizes",
        default="1",
        help="comma-separated batch sizes to pre-warm at startup (always "
        "includes --batch-rows; bucketed power-of-two)",
    )
    srv.add_argument(
        "--no-lifecycle",
        action="store_true",
        help="serve the bare model even when it carries a drift baseline "
        "(no monitoring, no retraining, no hot-swap)",
    )
    srv.add_argument(
        "--work-dir",
        default=None,
        help="lifecycle artifact dir (default: <model_dir>.lifecycle); "
        "CURRENT.json there resumes the last swapped generation. In fleet "
        "mode this is the work ROOT: each tenant gets <work-dir>/<model_id>",
    )
    srv.add_argument("--threshold", type=float, default=None)
    srv.add_argument("--debounce", type=int, default=3)
    srv.add_argument("--window-rows", type=int, default=65536)
    srv.add_argument("--min-window-rows", type=int, default=1024)
    srv.add_argument("--min-rows", type=int, default=512)
    srv.add_argument("--mode", choices=("full", "sliding"), default="full")
    srv.add_argument(
        "--max-seconds",
        type=float,
        default=None,
        help="exit after this many seconds (default: serve until "
        "SIGTERM/SIGINT) — CI smoke runs use it with `timeout`",
    )
    srv.add_argument(
        "--autopilot",
        action="store_true",
        help="arm the overload autopilot: under "
        "sustained queue pressure walk the reversible brownout ladder — "
        "widen coalescing, shed low-weight tenants (429 + Retry-After), "
        "degrade quality (q16 + subsampled forest) — and recover "
        "rung-by-rung when pressure drops",
    )
    srv.add_argument(
        "--autopilot-high-water",
        type=float,
        default=0.5,
        help="queue-fill fraction at/above which ticks count toward "
        "engaging the next brownout rung",
    )
    srv.add_argument(
        "--autopilot-low-water",
        type=float,
        default=0.15,
        help="queue-fill fraction at/below which ticks count toward "
        "lifting the deepest engaged rung (hysteresis: must be below "
        "--autopilot-high-water)",
    )
    srv.add_argument(
        "--autopilot-engage-ticks",
        type=int,
        default=3,
        help="consecutive high-water ticks before one rung engages",
    )
    srv.add_argument(
        "--autopilot-recover-ticks",
        type=int,
        default=6,
        help="consecutive low-water ticks before one rung lifts",
    )
    srv.add_argument(
        "--autopilot-interval-s",
        type=float,
        default=0.5,
        help="control-loop tick interval",
    )
    srv.add_argument(
        "--autopilot-subsample-trees",
        type=float,
        default=0.5,
        help="rung 3: fraction of the forest scored while quality is "
        "degraded (FastForest-style prefix subsample)",
    )
    srv.add_argument(
        "--autopilot-strict",
        action="store_true",
        help="report pressure but REFUSE every brownout rung (the "
        "degradation ladder's strict=True opt-out; autopilot.refused "
        "events mark each refusal)",
    )
    srv.add_argument(
        "--weight",
        type=float,
        default=1.0,
        help="this deployment's shed-priority weight class "
        "(fleet tenants can override per tenant with "
        "--tenant-weight)",
    )
    srv.add_argument(
        "--tenant-weight",
        action="append",
        default=None,
        metavar="MODEL_ID=WEIGHT",
        help="fleet mode: per-tenant shed-priority weight (repeatable); "
        "tenants below the fleet's highest weight class are shed first "
        "under the autopilot's rung 2",
    )
    srv.add_argument(
        "--replica-name",
        default=os.environ.get("ISOFOREST_TPU_REPLICA_NAME") or None,
        help="replicated tier: this replica's name; "
        "with --heartbeat-dir, writes heartbeat-<name>.json there so the "
        "fronting router's /healthz tracks this process",
    )
    srv.add_argument(
        "--heartbeat-dir",
        default=None,
        help="directory for this replica's liveness heartbeat file "
        "(requires --replica-name). Deliberately NOT the "
        "ISOFOREST_TPU_HEARTBEAT_DIR env: the replica only WRITES here — "
        "its own /healthz must not 503 when a PEER dies",
    )
    srv.add_argument(
        "--journal-dir",
        default=None,
        help="flight-record every event and committed trace into an "
        "append-only NDJSON spool under this directory, named after "
        "--replica-name when set — a kill -9 "
        "victim's last moments survive for the tier /debug/bundle",
    )
    srv.add_argument(
        "--device",
        default=None,
        help="the device the models load onto (default: the card; with no "
        "card this raises, it never falls back to the CPU); cpu runs the "
        "kernels' plain PyTorch versions",
    )
    srv.set_defaults(func=cmd_serve)

    rt = sub.add_parser(
        "route",
        help="front a replicated serving tier: spawn "
        "K fleet replicas over one --models-dir and balance POST "
        "/score/<model_id> across them with health-probe admission, "
        "idempotent retries, drains and rolling model pushes",
    )
    rt.add_argument(
        "--models-dir",
        required=True,
        help="the sealed models directory every replica serves (one "
        "model directory a tenant, named by its model id)",
    )
    rt.add_argument(
        "--replicas",
        type=int,
        default=2,
        help="how many serving replicas to spawn (default 2)",
    )
    rt.add_argument("--host", default="127.0.0.1")
    rt.add_argument(
        "--port",
        type=int,
        default=0,
        help="the router's HTTP port (0 = ephemeral, reported on the "
        "ready line); replicas always bind ephemeral ports",
    )
    rt.add_argument(
        "--probe-interval-s",
        type=float,
        default=1.0,
        help="maintenance cadence: health probes + rolling-push passes",
    )
    rt.add_argument(
        "--probe-timeout-s",
        type=float,
        default=2.0,
        help="a replica whose /healthz answers slower than this is ejected",
    )
    rt.add_argument(
        "--stale-after-s",
        type=float,
        default=15.0,
        help="a replica whose heartbeat file is older than this is ejected",
    )
    rt.add_argument(
        "--request-timeout-s",
        type=float,
        default=30.0,
        help="one forward's wire budget before the router retries elsewhere",
    )
    rt.add_argument(
        "--drain-timeout-s",
        type=float,
        default=30.0,
        help="SIGTERM: how long to wait for in-flight requests to finish",
    )
    rt.add_argument(
        "--retry-attempts",
        type=int,
        default=3,
        help="forward attempts across replicas before a 503",
    )
    rt.add_argument(
        "--batch-rows", type=int, default=None,
        help="passed through to each spawned replica",
    )
    rt.add_argument(
        "--linger-ms", type=float, default=None,
        help="passed through to each spawned replica",
    )
    rt.add_argument(
        "--fleet-budget-mb", type=float, default=None,
        help="passed through to each spawned replica",
    )
    rt.add_argument(
        "--preload", action="store_true",
        help="passed through to each spawned replica",
    )
    rt.add_argument(
        "--no-lifecycle", action="store_true",
        help="passed through to each spawned replica",
    )
    rt.add_argument(
        "--work-dir",
        default=None,
        help="lifecycle work ROOT shared by all replicas (each tenant at "
        "<work-dir>/<model_id>); the router watches CURRENT.json under it "
        "for rolling pushes. Default: <model_dir>.lifecycle next to each "
        "sealed model",
    )
    rt.add_argument(
        "--max-seconds",
        type=float,
        default=None,
        help="exit after this many seconds (default: serve until "
        "SIGTERM/SIGINT) — CI smoke runs use it with `timeout`",
    )
    rt.add_argument(
        "--journal-dir",
        default=None,
        help="tier flight recorder: the router "
        "spools under <dir>/router/ and every replica under its tier name; "
        "the tier GET /debug/bundle recovers dead replicas' spools off disk",
    )
    rt.add_argument(
        "--device",
        default=None,
        help="passed through to each spawned replica (default: the card); "
        "the router itself holds no model and brings up no CUDA",
    )
    rt.set_defaults(func=cmd_route)

    jrn = sub.add_parser(
        "journal",
        help="dump a flight-recorder journal directory as JSON lines or "
        "one merged Perfetto trace",
    )
    jrn.add_argument(
        "journal_dir",
        help="the --journal-dir a serve/route/manage/stream run spooled "
        "into (one subdirectory per process)",
    )
    jrn.add_argument(
        "--spool",
        default=None,
        help="restrict to one process's spool (default: every spool)",
    )
    jrn.add_argument(
        "--format",
        choices=("json", "chrome"),
        default="json",
        help="json: every record as one JSON line tagged with its spool; "
        "chrome: journaled traces merged into ONE Perfetto document with "
        "a pid lane per spool (load at ui.perfetto.dev)",
    )
    jrn.add_argument(
        "--tail",
        type=int,
        default=None,
        help="keep only the newest N records per spool",
    )
    jrn.add_argument(
        "--output",
        default=None,
        help="write the dump here instead of stdout (the per-spool summary "
        "always prints to stderr)",
    )
    jrn.set_defaults(func=cmd_journal)


    at = sub.add_parser(
        "autotune",
        help="dump/clear/pre-warm the measured strategy cost model",
    )
    at.add_argument("--format", choices=("json", "table"), default="json")
    at.add_argument(
        "--clear", action="store_true", help="delete the persisted winner table"
    )
    at.add_argument(
        "--warm",
        action="store_true",
        help="probe the workload at each --batch-sizes bucket before dumping",
    )
    at.add_argument("--input", default=None, help="CSV workload (default: synthetic)")
    at.add_argument("--model", default=None, help="probe with a saved model")
    at.add_argument("--labeled", action="store_true")
    at.add_argument("--trees", type=int, default=50)
    at.add_argument(
        "--batch-sizes",
        default="1024,65536",
        help="comma-separated batch sizes to pre-warm (bucketed power-of-two)",
    )
    at.add_argument(
        "--refresh",
        action="store_true",
        help="force re-probe even for fresh table entries (--no-cache analogue)",
    )
    at.add_argument(
        "--device", default=None, help="with --warm: " + _DEVICE_HELP
    )
    at.set_defaults(func=cmd_autotune)
    return p


def _workload_arguments(parser) -> None:
    """The workload flags ``telemetry``, ``trace`` and ``debug-bundle`` share."""
    parser.add_argument("--input", default=None, help="CSV workload (default: synthetic)")
    parser.add_argument("--model", default=None, help="score with a saved model")
    parser.add_argument("--labeled", action="store_true")
    parser.add_argument("--rows", type=int, default=4096, help="synthetic workload rows")
    parser.add_argument("--trees", type=int, default=50)
    parser.add_argument("--device", default=None, help=_DEVICE_HELP)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
