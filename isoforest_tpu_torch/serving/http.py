"""``POST /score``: the wire protocol over the telemetry HTTP server
(``isoforest_tpu/serving/http.py``, copied: host Python and numpy).

Mounted on :class:`~isoforest_tpu_torch.telemetry.http.MetricsServer`: one
daemon serves ``/metrics``, ``/healthz``, ``/snapshot`` and scores. The
wire is the JAX package's, byte for byte:

* ``Content-Type: application/json``: ``{"row": [f, ...]}`` (one row) or
  ``{"rows": [[f, ...], ...]}`` (a batch). Response: ``{"scores": [...],
  "predictions": [...], "rows": n, "single": b, "generation": g,
  "flush_rows": m, "flush_requests": k}`` (``flush_*`` name the coalesced
  flush the request rode in; ``generation`` is the lifecycle generation
  that scored that flush, where the JAX package reads the manager's
  generation after it, which a swap can move on);
* ``Content-Type: text/csv`` (or a ``?format=csv`` query): CSV feature rows
  in, an ``outlierScore`` CSV column out.

Statuses are the backpressure ladder, never a hang: 400 malformed payload,
429 admission queue full (retry with backoff; ``Retry-After``), 503 stale
queue, request timeout or shutting down, 500 scoring error (a stalled
flush under ``score_timeout_s`` among them). The request's latency (parse,
queue, coalesced score, encode) lands in
``isoforest_serving_request_seconds``, and every response ticks
``isoforest_serving_responses_total{code=}``.

Every request runs in a ``serving.request`` root span. An inbound
``X-Isoforest-Trace`` header (``[A-Za-z0-9._-]``, at most 64 characters)
becomes the request's trace id, and the response always echoes the
effective id in the same header; the span records the queue wait and the
flush that served it (``flush_trace_id``, ``flush_span_id``).
"""

from __future__ import annotations

import io
import json
import math
import re
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ..telemetry.metrics import counter as _counter
from ..telemetry.metrics import exponential_buckets, histogram as _histogram
from ..telemetry.spans import TraceContext, span, with_context
from .coalescer import ServingError

SCORE_PATH = "/score"
RELOAD_PATH = "/reload"

TRACE_HEADER = "X-Isoforest-Trace"
# one scoring request's identity across retries: a server that already
# answered this key scores again without folding the drift monitor again
IDEMPOTENCY_HEADER = "X-Isoforest-Idempotency-Key"
# accepted inbound trace ids: our own hex ids plus dotted/dashed client
# ids; anything else (header injection, oversized junk) is ignored and the
# server mints its own id instead
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

# ~1.3x-geometric bounds, 50 us .. ~0.65 s: a warm coalesced 1-row request
# through a cold full-bucket flush all resolve (the JAX package's buckets)
_REQUEST_SECONDS = _histogram(
    "isoforest_serving_request_seconds",
    "End-to-end /score request latency (parse + queue wait + coalesced "
    "scoring + encode)",
    buckets=exponential_buckets(50e-6, 1.3, 36),
)
_RESPONSES = _counter(
    "isoforest_serving_responses_total",
    "/score responses by HTTP status code",
    labelnames=("code",),
)


class _BadRequest(ValueError):
    """Payload the endpoint refuses with a 400 and a reason."""


def _parse_json(body: bytes) -> Tuple[np.ndarray, bool]:
    """(rows, single?) from a JSON body; raises :class:`_BadRequest` with
    an actionable message on any malformed shape."""
    try:
        doc = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise _BadRequest(f"body is not valid JSON: {exc}") from None
    if not isinstance(doc, dict) or ("row" in doc) == ("rows" in doc):
        raise _BadRequest(
            'JSON body must be an object with exactly one of "row" '
            '(single feature vector) or "rows" (list of feature vectors)'
        )
    single = "row" in doc
    payload = [doc["row"]] if single else doc["rows"]
    try:
        rows = np.asarray(payload, dtype=np.float32)
    except (TypeError, ValueError) as exc:
        raise _BadRequest(f"feature values are not numeric: {exc}") from None
    if rows.ndim != 2 or rows.shape[0] < 1 or rows.shape[1] < 1:
        raise _BadRequest(
            f'"{"row" if single else "rows"}" must parse to a non-empty '
            f"[N, F] matrix, got shape {tuple(rows.shape)}"
        )
    return rows, single


def _parse_csv(body: bytes) -> np.ndarray:
    if not body.strip():
        raise _BadRequest("CSV body contains no rows")
    try:
        rows = np.loadtxt(
            io.StringIO(body.decode("utf-8")),
            delimiter=",",
            comments="#",
            ndmin=2,
        ).astype(np.float32)
    except (UnicodeDecodeError, ValueError) as exc:
        raise _BadRequest(f"body is not parseable CSV: {exc}") from None
    if rows.size == 0:
        raise _BadRequest("CSV body contains no rows")
    return rows


def inbound_trace_id(headers) -> Optional[str]:
    """The sanitised client-supplied trace id, or None (absent/invalid)."""
    raw = headers.get(TRACE_HEADER) if headers is not None else None
    if raw and _TRACE_ID_RE.match(raw):
        return raw
    return None


def inbound_idempotency_key(headers) -> Optional[str]:
    """The sanitised ``X-Isoforest-Idempotency-Key``, or None (same
    alphabet as trace ids: junk is ignored rather than indexed)."""
    raw = headers.get(IDEMPOTENCY_HEADER) if headers is not None else None
    if raw and _TRACE_ID_RE.match(raw):
        return raw
    return None


def handle_score(
    service, body: bytes, headers, query: str = ""
) -> Tuple[int, str, str, Dict[str, str]]:
    """One ``/score`` request → ``(status, content_type, body, headers)``.
    Pure function of the payload + service so the status mapping is
    unit-testable without a socket. The returned headers always carry the
    request's effective trace id (module doc)."""
    inbound = inbound_trace_id(headers)
    ctx = TraceContext(inbound) if inbound else None
    with with_context(ctx):
        with span("serving.request", path=SCORE_PATH) as sp:
            status, content_type, payload, extra = _respond(
                service, body, headers, query, sp
            )
            sp.set_attrs(status=status)
            trace_id = sp.trace_id or inbound
    resp_headers = dict(extra)
    if trace_id:
        resp_headers[TRACE_HEADER] = trace_id
    return status, content_type, payload, resp_headers


def _respond(
    service, body: bytes, headers, query: str, sp
) -> Tuple[int, str, str, Dict[str, str]]:
    t0 = time.perf_counter()
    content_type = (headers.get("Content-Type") or "").lower()
    csv = "csv" in content_type or "format=csv" in (query or "")
    try:
        try:
            rows = _parse_csv(body) if csv else None
            single = False
            if rows is None:
                rows, single = _parse_json(body)
        except _BadRequest as exc:
            return _finish(t0, 400, _error_body(400, str(exc)))
        sp.set_attrs(rows=int(rows.shape[0]))
        try:
            # the shed rung refuses this tenant before any queue or replay
            # work: a typed 429 with Retry-After
            service.check_admission()
        except ServingError as exc:
            return _finish(
                t0,
                exc.status,
                _error_body(exc.status, str(exc)),
                retry_after_s=exc.retry_after_s,
            )
        idem_key = inbound_idempotency_key(headers)
        if idem_key is not None and service.idempotency_seen(idem_key):
            # a retry of a request this server already answered (the first
            # response died on the wire): score again without the fold, so
            # the drift monitor counts the rows once
            try:
                scores, generation = service.score_replay(rows)
            except Exception as exc:
                return _finish(t0, 500, _error_body(500, repr(exc)))
            sp.set_attrs(idempotent_replay=True)
            if csv:
                out = "outlierScore\n" + "".join(
                    f"{float(s)!r}\n" for s in scores
                )
                return _finish(t0, 200, out, "text/csv; charset=utf-8")
            doc = {
                "scores": [float(s) for s in scores],
                "predictions": [float(p) for p in service.predict(scores)],
                "rows": int(rows.shape[0]),
                "single": single,
                "generation": generation,
                "flush_rows": int(rows.shape[0]),
                "flush_requests": 1,
                "replayed": True,
            }
            return _finish(t0, 200, json.dumps(doc) + "\n")
        try:
            pending = service.coalescer.submit(rows)
            scores = service.coalescer.result(
                pending, timeout_s=service.config.request_timeout_s
            )
        except ServingError as exc:
            return _finish(
                t0,
                exc.status,
                _error_body(exc.status, str(exc)),
                retry_after_s=exc.retry_after_s,
            )
        except Exception as exc:  # scoring failure: typed 500, never a hang
            return _finish(t0, 500, _error_body(500, repr(exc)))
        # the flush folded these rows: remember the key BEFORE the response
        # hits the wire, so a retry after a torn write replays fold-free
        service.record_idempotency(idem_key)
        # where the latency went and which flush served the request: the
        # flush is another trace, linked back to this request
        sp.set_attrs(
            queue_wait_s=round(pending.queue_wait_s, 6),
            flush_trace_id=(
                pending.flush_ctx.trace_id if pending.flush_ctx else None
            ),
            flush_span_id=(
                pending.flush_ctx.span_id if pending.flush_ctx else None
            ),
        )
        if csv:
            out = "outlierScore\n" + "".join(
                f"{float(s)!r}\n" for s in scores
            )
            return _finish(t0, 200, out, "text/csv; charset=utf-8")
        predictions = service.predict(scores)
        doc = {
            "scores": [float(s) for s in scores],
            "predictions": [float(p) for p in predictions],
            "rows": int(rows.shape[0]),
            "single": single,
            # the generation that scored this request's flush
            "generation": pending.generation,
            "flush_rows": pending.flush_rows,
            "flush_requests": pending.flush_requests,
        }
        quality = service.quality
        if quality is not None:
            # quality loss is never silent: a flush scored on the sliced or
            # q16 brownout path says so on the wire
            doc["degraded"] = quality
        return _finish(t0, 200, json.dumps(doc) + "\n")
    except Exception as exc:  # encoder/accounting bug: still a typed 500
        return _finish(t0, 500, _error_body(500, repr(exc)))


def _error_body(status: int, message: str) -> str:
    return json.dumps({"error": message, "status": status}) + "\n"


def retry_after_headers(
    status: int, retry_after_s: Optional[float] = None
) -> Dict[str, str]:
    """The ``Retry-After`` header for a backpressure response: every
    429/503 carries one (integer seconds, >= 1) so clients back off for a
    server-grounded interval — the raiser's queue-drain estimate when it
    provided one (``ServingError.retry_after_s``), else a 1 s floor.
    Non-backpressure statuses get no header."""
    if status not in (429, 503):
        return {}
    seconds = 1 if retry_after_s is None else max(1, math.ceil(retry_after_s))
    return {"Retry-After": str(int(seconds))}


def _finish(
    t0: float,
    status: int,
    body: str,
    content_type: str = "application/json",
    retry_after_s: Optional[float] = None,
) -> Tuple[int, str, str, Dict[str, str]]:
    _REQUEST_SECONDS.observe(time.perf_counter() - t0)
    _RESPONSES.inc(code=status)
    return status, content_type, body, retry_after_headers(status, retry_after_s)


def handle_reload(service, body: bytes, headers, query: str = ""):
    """``POST /reload``: adopt a newer generation another process swapped
    into the shared work directory (``CURRENT.json``). Always 200 with the
    state after the reload (``ModelManager.refresh_from_current``); a
    deployment without a lifecycle manager reports ``lifecycle: false`` and
    reloads nothing."""
    manager = service.manager
    if manager is None:
        doc = {"reloaded": False, "lifecycle": False, "generation": None}
        return 200, "application/json", json.dumps(doc) + "\n"
    try:
        changed = manager.refresh_from_current()
    except Exception as exc:  # a torn push must not kill the route
        return 500, "application/json", _error_body(500, repr(exc))
    doc = {
        "reloaded": bool(changed),
        "lifecycle": True,
        "generation": manager.generation,
    }
    return 200, "application/json", json.dumps(doc) + "\n"


def mount(server, service) -> None:
    """Register ``POST /score`` (and ``POST /reload``) on a running
    :class:`~isoforest_tpu_torch.telemetry.http.MetricsServer` and add the
    service's state to its ``/healthz`` payload."""
    server.register_post(
        SCORE_PATH,
        lambda body, headers, query="": handle_score(service, body, headers, query),
    )
    server.register_post(
        RELOAD_PATH,
        lambda body, headers, query="": handle_reload(service, body, headers, query),
    )
    server.serving_state = service.state  # picked up by health()
    server.is_replica = True  # arm the replica fault seams on this server


def unmount(server) -> None:
    server.unregister_post(SCORE_PATH)
    server.unregister_post(RELOAD_PATH)
    server.serving_state = None
    server.is_replica = False
