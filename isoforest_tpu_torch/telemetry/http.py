"""The port's live telemetry endpoint: a stdlib HTTP daemon
(``isoforest_tpu/telemetry/http.py``, copied: it is stdlib only).

It serves the port's telemetry on one daemon thread, beside the scoring
path (the server thread only reads registries that are already
thread-safe):

* ``GET /metrics``: the Prometheus text exposition (:func:`..export.to_prometheus`);
* ``GET /healthz``: liveness from the peer heartbeat files
  (:func:`..resilience.watchdog.peer_heartbeat_ages`): 200 while every
  peer's last beat is younger than ``stale_after_s``, 503 naming the stale
  peers once one goes quiet, plain process liveness with no heartbeat
  directory; a mounted scoring service adds its ``serving`` section, and a
  live :class:`~isoforest_tpu_torch.lifecycle.ModelManager` its
  ``lifecycle`` section (``ModelManager.state()``: generation, last swap,
  refit in progress, debounce, window, outcomes), as on ``/snapshot``;
* ``GET /snapshot``: the JSON snapshot (:func:`..export.snapshot`);
* ``GET /trace?trace_id=<id>``: one captured trace as Chrome trace-event
  JSON (``&format=spans`` for the raw span documents), and
  ``GET /traces/recent?limit=N``: newest-first trace summaries and the
  ring's counts;
* ``GET /debug/bundle``: the flight-recorder bundle
  (:func:`..resources.build_bundle`);
* registered GET, POST and prefix-POST routes: the serving layer mounts
  ``POST /score`` here. Bodies past :data:`MAX_POST_BYTES` are refused
  unread; errors are typed JSON bodies.

Start with ``telemetry.serve(port=...)`` (``port=0`` takes a free port,
reported on the handle) or by setting ``ISOFOREST_TPU_METRICS_PORT``
before import: the package then starts the server itself.
``ISOFOREST_TPU_HEARTBEAT_DIR`` and ``ISOFOREST_TPU_STALE_AFTER_S``
configure ``/healthz``. The variables are the JAX package's.
"""

from __future__ import annotations

import json
import math
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from . import export, spans
from .events import record_event

METRICS_PORT_ENV = "ISOFOREST_TPU_METRICS_PORT"
HEARTBEAT_DIR_ENV = "ISOFOREST_TPU_HEARTBEAT_DIR"
STALE_AFTER_ENV = "ISOFOREST_TPU_STALE_AFTER_S"
DEFAULT_STALE_AFTER_S = 15.0

_INDEX = (
    "isoforest_tpu telemetry endpoint\n"
    "  /metrics        Prometheus text exposition\n"
    "  /healthz        liveness (heartbeat ages + lifecycle state when configured)\n"
    "  /snapshot       full JSON telemetry snapshot\n"
    "  /trace          one trace as Chrome trace-event JSON (?trace_id=<id>)\n"
    "  /traces/recent  newest-first trace summaries (?limit=N)\n"
    "  /debug/bundle   flight-recorder debug bundle (one JSON artifact)\n"
)

# Refuse request bodies past this size before reading them into memory: the
# scoring endpoint is for serving batches, not bulk uploads (use the `score`
# CLI for files). 64 MiB ~= a 4M-row x 4-feature JSON batch.
MAX_POST_BYTES = 64 << 20


def _lifecycle_state():
    """The live ModelManager's state, or None when none is live; a failure
    reading it must not take the endpoint's telemetry down with it."""
    try:
        # lazy import: lifecycle imports telemetry at module load
        from ..lifecycle import state_snapshot

        return state_snapshot()
    except Exception:
        return None


class _Handler(BaseHTTPRequestHandler):
    # the MetricsServer instance is attached to the HTTPServer as `.owner`

    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler contract
        owner: "MetricsServer" = self.server.owner  # type: ignore[attr-defined]
        path, _, query = self.path.partition("?")
        if path in owner.get_routes:
            # registered routes win over the built-ins
            try:
                status, content_type, payload = owner.get_routes[path](query)
            except Exception as exc:
                status, content_type, payload = (
                    500,
                    "application/json",
                    json.dumps({"error": repr(exc), "status": 500}) + "\n",
                )
            self._reply(status, content_type, payload)
        elif path == "/metrics":
            self._reply(
                200,
                "text/plain; version=0.0.4; charset=utf-8",
                export.to_prometheus(),
            )
        elif path == "/snapshot":
            doc = export.snapshot()
            state = _lifecycle_state()
            if state is not None:
                doc["lifecycle"] = state
            self._reply(
                200,
                "application/json",
                json.dumps(doc, sort_keys=True) + "\n",
            )
        elif path == "/trace":
            params = urllib.parse.parse_qs(query)
            trace_id = (params.get("trace_id") or [""])[0]
            if not trace_id:
                self._reply(
                    400,
                    "application/json",
                    json.dumps(
                        {"error": "trace_id query parameter required",
                         "status": 400}
                    ) + "\n",
                )
                return
            trace = spans.get_trace(trace_id)
            if trace is None:
                self._reply(
                    404,
                    "application/json",
                    json.dumps(
                        {"error": f"no captured trace {trace_id} "
                                  "(never captured, sampled out, or evicted)",
                         "status": 404}
                    ) + "\n",
                )
                return
            fmt = (params.get("format") or ["chrome"])[0]
            doc = trace if fmt == "spans" else export.to_chrome_trace(trace)
            self._reply(
                200,
                "application/json",
                json.dumps(doc, sort_keys=True) + "\n",
            )
        elif path == "/traces/recent":
            params = urllib.parse.parse_qs(query)
            try:
                limit = int((params.get("limit") or ["20"])[0])
            except ValueError:
                limit = 20
            doc = {
                "traces": spans.recent_traces(limit=limit),
                "stats": spans.trace_stats(),
            }
            self._reply(
                200,
                "application/json",
                json.dumps(doc, sort_keys=True) + "\n",
            )
        elif path == "/debug/bundle":
            # the flight recorder: everything an operator needs to debug a
            # bad deployment in ONE artifact — curl it before restarting
            from . import resources

            try:
                doc = resources.build_bundle()
                status = 200
            except Exception as exc:  # the daemon must never die to this
                doc = {"error": repr(exc), "status": 500}
                status = 500
            self._reply(
                status,
                "application/json",
                json.dumps(doc, sort_keys=True) + "\n",
            )
        elif path in ("/healthz", "/health"):
            if owner.is_replica:
                # fault seam: a wedged replica answers /healthz slower than
                # a router's probe timeout
                from ..resilience import faults

                faults.maybe_wedge_healthz()
            payload, healthy = owner.health()
            self._reply(
                200 if healthy else 503,
                "application/json",
                json.dumps(payload, sort_keys=True) + "\n",
            )
        elif path == "/":
            self._reply(200, "text/plain; charset=utf-8", _INDEX)
        else:
            self._reply(
                404, "text/plain; charset=utf-8", f"unknown path {path}\n{_INDEX}"
            )

    def do_POST(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler contract
        """Dispatch to the owner's registered POST routes (the serving
        layer mounts ``/score`` here). Routes return
        ``(status, content_type, body)`` or ``(status, content_type, body,
        headers)`` — the 4th element is a dict of extra response headers
        (the scoring routes echo ``X-Isoforest-Trace`` this way); any
        handler exception is a typed 500 — the telemetry daemon must never
        die to a bad request."""
        owner: "MetricsServer" = self.server.owner  # type: ignore[attr-defined]
        path, _, query = self.path.partition("?")
        handler = owner.post_routes.get(path)
        if handler is None:
            # parameterised routes: the longest registered prefix wins, and
            # the rest of the path is passed to the handler
            for prefix in sorted(owner.post_prefix_routes, key=len, reverse=True):
                if path.startswith(prefix) and len(path) > len(prefix):
                    suffix = path[len(prefix):]
                    prefix_handler = owner.post_prefix_routes[prefix]
                    handler = (
                        lambda body, headers, query="", _h=prefix_handler,
                        _s=suffix: _h(_s, body, headers, query)
                    )
                    break
        if handler is None:
            # a JSON body, not a bare text error: clients of the scoring
            # wire speak JSON and should not need a second parser for 404s
            self._reply(
                404,
                "application/json",
                json.dumps(
                    {
                        "error": f"no POST route at {path}",
                        "status": 404,
                        "routes": sorted(owner.post_routes)
                        + sorted(p + "<suffix>" for p in owner.post_prefix_routes),
                    }
                )
                + "\n",
            )
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = -1
        if length < 0 or length > MAX_POST_BYTES:
            self._reply(
                413 if length > MAX_POST_BYTES else 400,
                "application/json",
                json.dumps(
                    {
                        "error": f"Content-Length must be 0..{MAX_POST_BYTES}",
                        "status": 413 if length > MAX_POST_BYTES else 400,
                    }
                )
                + "\n",
            )
            return
        body = self.rfile.read(length) if length else b""
        if owner.is_replica and (path + "/").startswith("/score/"):
            # fault seam: a replica that dies while holding a scoring
            # request; gated on is_replica, so only a server with a scoring
            # service mounted consumes the fault
            from ..resilience import faults

            action = faults.take_replica_kill()
            if action == "exit":
                os._exit(17)  # the whole replica process, mid-request
            if action == "sever":
                # drop the connection without a response: the client sees
                # RemoteDisconnected, exactly what a SIGKILL'd peer looks
                # like from the wire
                self.close_connection = True
                return
        extra_headers = None
        try:
            result = handler(body, self.headers, query)
            if len(result) == 4:
                status, content_type, payload, extra_headers = result
            else:
                status, content_type, payload = result
        except Exception as exc:
            status, content_type, payload = (
                500,
                "application/json",
                json.dumps({"error": repr(exc), "status": 500}) + "\n",
            )
        self._reply(status, content_type, payload, extra_headers)

    def _reply(
        self,
        status: int,
        content_type: str,
        body: str,
        headers: Optional[dict] = None,
    ) -> None:
        data = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for name, value in (headers or {}).items():
            self.send_header(str(name), str(value))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, format: str, *args) -> None:
        # request logging at debug only: a scraper polls every few seconds
        # and must not flood the operator's log
        from ..utils.logging import logger

        logger.debug("metrics server: " + format, *args)


class _ThreadingServer(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5, and a burst of concurrent
    # scoring clients past it is reset by the kernel before a handler thread
    # can take it; the JAX package keeps the default
    request_queue_size = 128
    daemon_threads = True


class MetricsServer:
    """Handle for a running telemetry HTTP daemon (see :func:`serve`)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        heartbeat_dir: Optional[str] = None,
        stale_after_s: float = DEFAULT_STALE_AFTER_S,
    ) -> None:
        self.heartbeat_dir = heartbeat_dir
        self.stale_after_s = float(stale_after_s)
        # POST routes (path -> (body, headers, query) -> (status, ctype,
        # body)): the serving layer mounts /score here. post_prefix_routes
        # are parameterised (prefix -> (suffix, body, headers, query) ->
        # same triple); get_routes (path -> (query) -> triple).
        # serving_state is an optional zero-argument callable merged into
        # /healthz.
        self.post_routes: dict = {}
        self.post_prefix_routes: dict = {}
        self.get_routes: dict = {}
        self.serving_state = None
        # True while a scoring service is mounted: arms the replica fault
        # seams (kill during a score, a wedged healthz) for this server only
        self.is_replica = False
        self._httpd = _ThreadingServer((host, int(port)), _Handler)
        self._httpd.owner = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            daemon=True,
            name=f"isoforest-metrics[{self.port}]",
        )
        self._stopped = False

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def register_post(self, path: str, handler) -> None:
        """Mount a POST route (``handler(body, headers, query) -> (status,
        content_type, body_str[, extra_headers])``); replaces any existing
        route at ``path``."""
        self.post_routes[str(path)] = handler

    def unregister_post(self, path: str) -> None:
        self.post_routes.pop(str(path), None)

    def register_post_prefix(self, prefix: str, handler) -> None:
        """Mount a parameterised POST route: every ``POST <prefix><suffix>``
        (non-empty suffix; longest prefix wins over other prefixes, exact
        routes always win) dispatches ``handler(suffix, body, headers,
        query)``."""
        self.post_prefix_routes[str(prefix)] = handler

    def unregister_post_prefix(self, prefix: str) -> None:
        self.post_prefix_routes.pop(str(prefix), None)

    def register_get(self, path: str, handler) -> None:
        """Mount a GET route (``handler(query) -> (status, content_type,
        body_str)``) consulted before the built-in paths, so a registered
        route may shadow a built-in (``unregister_get`` restores it)."""
        self.get_routes[str(path)] = handler

    def unregister_get(self, path: str) -> None:
        self.get_routes.pop(str(path), None)

    def health(self) -> Tuple[dict, bool]:
        """``(payload, healthy)`` for ``/healthz``: heartbeat ages from the
        configured directory, flagging peers older than ``stale_after_s``
        (an unreadable/torn heartbeat reports age ``null`` and counts as
        stale — a peer that died mid-write is still a dead peer)."""
        ages = {}
        if self.heartbeat_dir:
            # lazy: the watchdog imports telemetry at module load
            from ..resilience.watchdog import peer_heartbeat_ages

            ages = peer_heartbeat_ages(self.heartbeat_dir)
        stale = sorted(
            peer
            for peer, age in ages.items()
            if not math.isfinite(age) or age > self.stale_after_s
        )
        payload = {
            "status": "ok" if not stale else "stale",
            "peers": {
                peer: (round(age, 3) if math.isfinite(age) else None)
                for peer, age in sorted(ages.items())
            },
            "stale_peers": stale,
            "stale_after_s": self.stale_after_s,
            "heartbeat_dir": self.heartbeat_dir,
        }
        lifecycle = _lifecycle_state()
        if lifecycle is not None:
            # model generation / last-swap timestamp / retrain-in-progress:
            # a swapped model and a stale one answer /healthz differently
            payload["lifecycle"] = lifecycle
        if self.serving_state is not None:
            try:
                payload["serving"] = self.serving_state()
            except Exception:
                # the liveness answer must not die to a state-read race
                payload["serving"] = None
        return payload, not stale

    def stop(self) -> None:
        """Shut the daemon down (idempotent)."""
        if self._stopped:
            return
        self._stopped = True
        port = self.port
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        record_event("metrics_server.stop", port=port)
        global _SERVER
        if _SERVER is self:
            _SERVER = None


_SERVER: Optional[MetricsServer] = None


def serve(
    port: Optional[int] = None,
    host: str = "127.0.0.1",
    heartbeat_dir: Optional[str] = None,
    stale_after_s: Optional[float] = None,
) -> MetricsServer:
    """Start the telemetry HTTP daemon; returns its handle (``.port`` for
    ``port=0`` ephemeral binds, ``.stop()`` to shut down).

    ``port=None`` reads ``ISOFOREST_TPU_METRICS_PORT``; ``heartbeat_dir``
    and ``stale_after_s`` default from ``ISOFOREST_TPU_HEARTBEAT_DIR`` /
    ``ISOFOREST_TPU_STALE_AFTER_S`` and wire ``/healthz`` to the peer
    heartbeat files."""
    if port is None:
        raw = os.environ.get(METRICS_PORT_ENV)
        if raw is None:
            raise ValueError(
                f"serve() needs port=... or the {METRICS_PORT_ENV} env var"
            )
        port = int(raw)
    if heartbeat_dir is None:
        heartbeat_dir = os.environ.get(HEARTBEAT_DIR_ENV) or None
    if stale_after_s is None:
        stale_after_s = float(
            os.environ.get(STALE_AFTER_ENV, DEFAULT_STALE_AFTER_S)
        )
    server = MetricsServer(
        host=host,
        port=port,
        heartbeat_dir=heartbeat_dir,
        stale_after_s=stale_after_s,
    ).start()
    record_event("metrics_server.start", port=server.port)
    global _SERVER
    _SERVER = server
    return server


def active_server() -> Optional[MetricsServer]:
    """The most recently started (still running) server, if any."""
    return _SERVER


def maybe_serve_from_env() -> Optional[MetricsServer]:
    """Auto-start at package import when ``ISOFOREST_TPU_METRICS_PORT`` is
    set; a bind failure logs a warning instead of breaking the import (the
    scoring library must work even when the operator fat-fingers a port)."""
    raw = os.environ.get(METRICS_PORT_ENV)
    if not raw or _SERVER is not None:
        return None
    try:
        return serve(port=int(raw))
    except Exception as exc:
        from ..utils.logging import logger

        logger.warning(
            "could not start the telemetry metrics server from %s=%r: %s",
            METRICS_PORT_ENV,
            raw,
            exc,
        )
        return None
