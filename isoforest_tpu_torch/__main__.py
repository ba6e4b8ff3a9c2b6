"""Command-line front-end of the port: the serving tier's subcommands.

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

``serve`` and ``route`` run on the card unless ``--device`` names another
device (``cpu`` runs the kernels' plain PyTorch versions); a ``serve`` that
finds no card with the default device raises. ``route`` passes
``--device`` to every replica it spawns. The JAX package's other
subcommands (``fit``, ``score``, ``convert``, ``inspect``, ``telemetry``,
``trace``, ``debug-bundle``, ``diagnose``, ``monitor``, ``manage``,
``stream``, ``autotune``) are not in the port yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


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
    from .utils.device import resolve_device

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



def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="isoforest_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

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

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
