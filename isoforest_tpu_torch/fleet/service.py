"""Per-tenant serving behind one port: ``POST /score/<model_id>``
(``isoforest_tpu/fleet/service.py``).

The wire layer over :class:`~.registry.ModelRegistry`, mounted on the same
telemetry HTTP daemon as everything else; one port serves ``/metrics``,
``/healthz``, ``/snapshot``, the single-model ``POST /score`` (when one is
mounted) and the fleet routes:

* ``POST /score/<model_id>``: the single-model wire schema (JSON
  ``row``/``rows`` or CSV, the same response fields plus ``model_id``),
  routed to the tenant's own coalescer. An unknown id answers a 404 JSON
  body naming the registered models; a tenant whose lazy load failed
  answers 503 (retriable) while every other tenant keeps serving.
  Per-tenant latency and status land in
  ``isoforest_fleet_request_seconds{model_id=}`` and
  ``isoforest_fleet_responses_total{model_id=,code=}``. The answer names
  the generation that scored its flush.
* ``POST /reload/<model_id>``: adopt a newer generation from the tenant's
  ``CURRENT.json``.
* ``GET /models``: one state row per tenant (residency, generation, queue
  depth, pin state) plus the fleet budget roll-up.
* ``GET /healthz``: gains a ``serving`` section with per-tenant lifecycle
  subsections.

:func:`serve_fleet` is the one-call assembly: discover sealed model dirs,
register, mount, serve.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Tuple

from ..serving.http import (
    TRACE_HEADER,
    _BadRequest,
    _error_body,
    _finish as _serving_finish,
    _parse_csv,
    _parse_json,
    inbound_idempotency_key,
    inbound_trace_id,
)
from ..serving.coalescer import ServingError
from ..serving.service import ServingConfig
from ..telemetry.events import record_event
from ..telemetry.metrics import counter as _counter
from ..telemetry.metrics import exponential_buckets, histogram as _histogram
from ..telemetry.spans import TraceContext, span, with_context
from ..utils.logging import logger
from .registry import ModelRegistry, UnknownModelError

SCORE_PREFIX = "/score/"
MODELS_PATH = "/models"
RELOAD_PREFIX = "/reload/"

# same bucket shape as the single-model isoforest_serving_request_seconds
# so per-tenant and deployment-wide latency compare bucket-for-bucket
_FLEET_REQUEST_SECONDS = _histogram(
    "isoforest_fleet_request_seconds",
    "End-to-end /score/<model_id> request latency per tenant "
    "(parse + queue wait + coalesced scoring + encode)",
    labelnames=("model_id",),
    buckets=exponential_buckets(50e-6, 1.3, 36),
)
_FLEET_RESPONSES = _counter(
    "isoforest_fleet_responses_total",
    "/score/<model_id> responses by tenant and HTTP status code",
    labelnames=("model_id", "code"),
)


class FleetService:
    """The HTTP-facing face of one :class:`ModelRegistry` (module doc)."""

    def __init__(self, registry: ModelRegistry) -> None:
        self.registry = registry
        self.started_unix_s = time.time()

    # ------------------------------------------------------------------ #

    def _finish(
        self,
        model_id: str,
        t0: float,
        status: int,
        body: str,
        content_type: str = "application/json",
        retry_after_s: Optional[float] = None,
    ) -> Tuple[int, str, str, dict]:
        """Account one tenant response: the unlabelled serving series keep
        the deployment-wide totals, the ``{model_id=}`` twins separate the
        tenants. Backpressure statuses (429/503) carry ``Retry-After``
        like the single-model path."""
        out = _serving_finish(t0, status, body, content_type, retry_after_s)
        _FLEET_REQUEST_SECONDS.observe(
            time.perf_counter() - t0, model_id=model_id
        )
        _FLEET_RESPONSES.inc(model_id=model_id, code=status)
        return out

    def handle_score(self, model_id: str, body: bytes, headers, query: str = ""):
        """One ``/score/<model_id>`` request -> ``(status, content_type,
        body, headers)``. Pure function of the payload + registry, so the
        status mapping is unit-testable without a socket (the single-model
        ``handle_score`` contract, per tenant). The root span carries the
        tenant's ``model_id`` and the response echoes the effective
        ``X-Isoforest-Trace`` id."""
        inbound = inbound_trace_id(headers)
        ctx = TraceContext(inbound) if inbound else None
        with with_context(ctx):
            with span(
                "serving.request", path=SCORE_PREFIX + model_id,
                model_id=model_id,
            ) as sp:
                status, content_type, payload, extra = self._respond(
                    model_id, body, headers, query, sp
                )
                sp.set_attrs(status=status)
                trace_id = sp.trace_id or inbound
        resp_headers = dict(extra)
        if trace_id:
            resp_headers[TRACE_HEADER] = trace_id
        return status, content_type, payload, resp_headers

    def _respond(
        self, model_id: str, body: bytes, headers, query: str, sp
    ) -> Tuple[int, str, str, dict]:
        t0 = time.perf_counter()
        try:
            try:
                self.registry.entry(model_id)
            except UnknownModelError as exc:
                return self._finish(
                    model_id,
                    t0,
                    404,
                    json.dumps(
                        {
                            "error": str(exc),
                            "status": 404,
                            "model_id": model_id,
                            "models": self.registry.model_ids(),
                        }
                    )
                    + "\n",
                )
            content_type = (headers.get("Content-Type") or "").lower()
            csv = "csv" in content_type or "format=csv" in (query or "")
            try:
                rows = _parse_csv(body) if csv else None
                single = False
                if rows is None:
                    rows, single = _parse_json(body)
            except _BadRequest as exc:
                return self._finish(model_id, t0, 400, _error_body(400, str(exc)))
            try:
                scores, info = self.registry.score_detail(
                    model_id,
                    rows,
                    idempotency_key=inbound_idempotency_key(headers),
                )
            except ServingError as exc:
                return self._finish(
                    model_id,
                    t0,
                    exc.status,
                    _error_body(exc.status, str(exc)),
                    retry_after_s=exc.retry_after_s,
                )
            except Exception as exc:  # scoring failure: typed 500, never a hang
                return self._finish(model_id, t0, 500, _error_body(500, repr(exc)))
            flush_ctx = info.get("flush_ctx")
            sp.set_attrs(
                rows=int(rows.shape[0]),
                queue_wait_s=round(float(info.get("queue_wait_s") or 0.0), 6),
                flush_trace_id=flush_ctx.trace_id if flush_ctx else None,
                flush_span_id=flush_ctx.span_id if flush_ctx else None,
            )
            if csv:
                out = "outlierScore\n" + "".join(
                    f"{float(s)!r}\n" for s in scores
                )
                return self._finish(
                    model_id, t0, 200, out, "text/csv; charset=utf-8"
                )
            predictions = info["service"].predict(scores)
            doc = {
                "model_id": model_id,
                "scores": [float(s) for s in scores],
                "predictions": [float(p) for p in predictions],
                "rows": int(rows.shape[0]),
                "single": single,
                "generation": info["generation"],
                "flush_rows": info["flush_rows"],
                "flush_requests": info["flush_requests"],
            }
            if info.get("replayed"):
                # an idempotent retry re-scored fold-free
                doc["replayed"] = True
            if info.get("degraded"):
                # autopilot quality rung: degradation reported on the wire
                doc["degraded"] = info["degraded"]
            return self._finish(model_id, t0, 200, json.dumps(doc) + "\n")
        except Exception as exc:  # encoder/accounting bug: still a typed 500
            return self._finish(model_id, t0, 500, _error_body(500, repr(exc)))

    def handle_reload(self, model_id: str, body: bytes, headers, query: str = ""):
        """``POST /reload/<model_id>`` — the per-tenant leg of a rolling
        model push: re-read the tenant's
        ``CURRENT.json`` and adopt a newer generation in place. 404 JSON on
        an unknown tenant; a non-resident tenant reloads nothing (its next
        lazy load resumes from ``CURRENT.json`` by construction)."""
        try:
            doc = self.registry.refresh_from_current(model_id)
        except UnknownModelError as exc:
            body_out = json.dumps(
                {
                    "error": str(exc),
                    "status": 404,
                    "model_id": model_id,
                    "models": self.registry.model_ids(),
                }
            ) + "\n"
            return 404, "application/json", body_out
        except Exception as exc:  # a torn push must not kill the route
            return 500, "application/json", _error_body(500, repr(exc))
        return 200, "application/json", json.dumps(doc, sort_keys=True) + "\n"

    def handle_models(self, query: str = "") -> Tuple[int, str, str]:
        """``GET /models``: per-tenant state rows + the fleet roll-up.
        When an overload autopilot is attached the roll-up names its
        current brownout rung."""
        from ..autopilot import current_rung

        doc = self.registry.state()
        doc["models"] = self.registry.models_state()
        doc["autopilot_rung"] = current_rung()
        return 200, "application/json", json.dumps(doc, sort_keys=True) + "\n"

    def state(self) -> dict:
        """``/healthz`` serving section: the fleet roll-up plus a
        per-tenant lifecycle subsection each."""
        from ..autopilot import current_rung

        doc = self.registry.state()
        doc["fleet"] = True
        doc["autopilot_rung"] = current_rung()
        doc["tenants"] = {
            row["model_id"]: {
                "resident": row["resident"],
                "generation": row["generation"],
                "queue_rows": row["queue_rows"],
                "retrain_in_progress": row["retrain_in_progress"],
                "pinned": row["pinned"],
                "weight": row["weight"],
                "shed": row["shed"],
                "quality": row["quality"],
            }
            for row in self.registry.models_state()
        }
        return doc


def mount_fleet(server, fleet: FleetService) -> None:
    """Register the fleet routes on a running
    :class:`~isoforest_tpu_torch.telemetry.http.MetricsServer`."""
    server.register_post_prefix(SCORE_PREFIX, fleet.handle_score)
    server.register_post_prefix(RELOAD_PREFIX, fleet.handle_reload)
    server.register_get(MODELS_PATH, fleet.handle_models)
    server.serving_state = fleet.state  # picked up by health()
    server.is_replica = True  # arm the replica chaos seams on this server


def unmount_fleet(server) -> None:
    server.unregister_post_prefix(SCORE_PREFIX)
    server.unregister_post_prefix(RELOAD_PREFIX)
    server.unregister_get(MODELS_PATH)
    server.serving_state = None
    server.is_replica = False


def discover_models(models_dir: str) -> dict:
    """``model_id -> path`` for every sealed model directory directly under
    ``models_dir`` (a subdirectory with the Spark-layout ``metadata/``
    dir); lifecycle work dirs (``*.lifecycle``) are skipped. The subdir
    name becomes the tenant id."""
    out = {}
    for name in sorted(os.listdir(models_dir)):
        path = os.path.join(models_dir, name)
        if name.endswith(".lifecycle") or not os.path.isdir(path):
            continue
        if os.path.isdir(os.path.join(path, "metadata")):
            out[name] = path
    return out


class FleetHandle:
    """A running fleet deployment: HTTP server + registry (+ service).
    ``close()`` tears down in dependency order; usable as a context
    manager."""

    def __init__(self, server, registry: ModelRegistry, fleet: FleetService) -> None:
        self.server = server
        self.registry = registry
        self.fleet = fleet

    @property
    def url(self) -> str:
        return self.server.url

    def __enter__(self) -> "FleetHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        unmount_fleet(self.server)
        self.registry.close()
        self.server.stop()


def serve_fleet(
    models_dir: Optional[str] = None,
    *,
    models: Optional[dict] = None,
    port: int = 0,
    host: str = "127.0.0.1",
    config: Optional[ServingConfig] = None,
    budget_bytes: Optional[int] = None,
    lifecycle: bool = True,
    work_root: Optional[str] = None,
    manager_kwargs: Optional[dict] = None,
    preload: bool = False,
    weights: Optional[dict] = None,
    device=None,
) -> FleetHandle:
    """Assemble a multi-tenant fleet over sealed model directories:

    1. discover tenants (every model dir under ``models_dir``; or pass an
       explicit ``models`` mapping ``model_id -> path``);
    2. register each with the byte-budgeted registry (loads stay lazy
       unless ``preload=True``);
    3. start the telemetry HTTP server and mount ``POST /score/<model_id>``
       + ``GET /models`` on it.

    ``work_root`` hosts per-tenant lifecycle dirs (``<work_root>/<id>``;
    default ``<model_dir>.lifecycle`` next to each model). ``weights``
    maps ``model_id -> priority weight`` for the autopilot's shed rung;
    unnamed tenants keep ``config.weight``. Tenants load onto ``device``
    (default: the card). Returns the :class:`FleetHandle`.
    """
    import dataclasses

    from ..telemetry.http import serve as _telemetry_serve

    if (models_dir is None) == (models is None):
        raise ValueError("pass exactly one of models_dir= or models=")
    mapping = dict(models) if models is not None else discover_models(models_dir)
    if not mapping:
        raise ValueError(
            f"no sealed model directories found under {models_dir!r} "
            "(expected subdirectories with a metadata/ dir)"
        )
    registry = ModelRegistry(
        budget_bytes=budget_bytes,
        config=config,
        lifecycle=lifecycle,
        manager_kwargs=manager_kwargs,
        device=device,
    )
    base_config = config or ServingConfig()
    for model_id, path in sorted(mapping.items()):
        work_dir = (
            os.path.join(work_root, model_id) if work_root else None
        )
        tenant_config = None
        if weights and model_id in weights:
            tenant_config = dataclasses.replace(
                base_config, weight=float(weights[model_id])
            )
        registry.register(model_id, path, work_dir=work_dir, config=tenant_config)
    server = _telemetry_serve(port=port, host=host)
    fleet = FleetService(registry)
    mount_fleet(server, fleet)
    if preload:
        for model_id in sorted(mapping):
            registry.ensure_resident(model_id)
    record_event(
        "fleet.start",
        port=server.port,
        models=len(mapping),
        budget_bytes=budget_bytes,
        preloaded=bool(preload),
    )
    logger.info(
        "fleet: serving %d tenant(s) on %s (budget %s bytes, %s): %s",
        len(mapping),
        server.url,
        budget_bytes if budget_bytes is not None else "unbounded",
        "preloaded" if preload else "lazy",
        ", ".join(sorted(mapping)),
    )
    return FleetHandle(server, registry, fleet)
