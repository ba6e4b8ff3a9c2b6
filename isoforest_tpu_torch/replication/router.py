"""The replicated serving tier of the port (``isoforest_tpu/replication/router.py``):
a router that survives replica death.

One stdlib process (``python -m isoforest_tpu_torch route --replicas K
--models-dir DIR``) fronts K serving replicas over the same sealed models
directory and keeps the client contract, no failed request, through replica
crashes, wedges, drains and rolling model pushes. The router holds no model
and scores nothing, so it never brings up CUDA: each replica is its own
process with its own CUDA context and its own copy of each tenant's tables,
and every answer is that replica's ``model.score``.

* **Balancing**: ``POST /score`` and ``POST /score/<model_id>`` go to the
  admitted replica with the fewest outstanding requests (ties break on
  name, so the schedule is deterministic).
* **Health**: a maintenance thread probes every replica each
  ``probe_interval_s``: a process that exited, a ``GET /healthz`` that
  fails or takes longer than ``probe_timeout_s``, or a heartbeat file older
  than ``stale_after_s`` ejects it (``router.replica_down``); a recovered
  probe admits it again (``router.replica_up``). The router's own
  ``/healthz`` reads the replicas' heartbeat directory.
* **Retries**: scoring is idempotent, so a forward that dies on the wire
  (connection severed, timeout) is retried on another replica under a
  :class:`~..resilience.retry.RetryPolicy`. Every forward carries an
  ``X-Isoforest-Idempotency-Key``: a replica that already answered the key
  replays without folding, so a retried flush never counts twice in the
  drift monitor. A replica's own error answer (4xx/5xx) passes through
  untouched: the router retries wire death, not answers.
* **Drain**: SIGTERM flips the router to draining (new requests answer
  503), waits for the forwards in flight, then SIGTERMs each spawned
  replica (``router.replica_drain``), whose coalescers drain in turn.
* **Rolling pushes**: the maintenance thread reads each tenant's
  ``CURRENT.json`` generation pointer (the lifecycle manager's durable swap
  record); when a swap advances it, the router POSTs ``/reload/<model_id>``
  to every admitted replica until all ack the new generation, then records
  one ``router.push`` event. Requests in flight answer with the old or the
  new generation bit for bit, never a mix.

Every request runs in a ``router.request`` span and echoes
``X-Isoforest-Trace``; the ``isoforest_router_*`` series (the JAX package's
names, help strings and buckets) count forwards, retries, admitted replicas
and outstanding depth; ``GET /replicas``, ``/healthz`` and the debug
bundle's ``router`` section show each replica's state.

The router's daemon answers the telemetry built-ins for the whole tier:
``GET /metrics``, ``/snapshot``, ``/trace``, ``/traces/recent`` and
``/debug/bundle`` fan out to every admitted replica and merge
(:mod:`..telemetry.federation`); replicas that cannot answer make the answer
partial, named in ``missing_replicas``, and with ``--journal-dir`` the
bundle reads a dead replica's flight-recorder spool off disk
(:mod:`..telemetry.journal`).
"""

from __future__ import annotations

import http.client
import json
import math
import os
import pathlib
import queue
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..fleet.service import RELOAD_PREFIX, SCORE_PREFIX, discover_models
from ..lifecycle.manager import CURRENT_NAME
from ..resilience import faults
from ..resilience.retry import RetryError, RetryPolicy, retry_call
from ..resilience.watchdog import peer_heartbeat_ages
from ..serving.http import (
    IDEMPOTENCY_HEADER,
    SCORE_PATH,
    TRACE_HEADER,
    inbound_idempotency_key,
    inbound_trace_id,
)
from ..telemetry.events import record_event
from ..telemetry.metrics import counter as _counter
from ..telemetry.metrics import exponential_buckets, gauge as _gauge
from ..telemetry.metrics import histogram as _histogram
from ..telemetry.spans import TraceContext, span, with_context
from ..utils.logging import logger

REPLICAS_PATH = "/replicas"
HEARTBEAT_DIR_NAME = ".router-heartbeats"

# same bucket shape as isoforest_serving_request_seconds so the router's
# added latency reads bucket-for-bucket against the replicas' own series
_ROUTER_REQUEST_SECONDS = _histogram(
    "isoforest_router_request_seconds",
    "End-to-end routed /score request latency (pick + forward + retries)",
    buckets=exponential_buckets(50e-6, 1.3, 36),
)
_ROUTER_REQUESTS = _counter(
    "isoforest_router_requests_total",
    "Routed /score responses by serving replica and HTTP status code",
    labelnames=("replica", "code"),
)
_ROUTER_RETRIES = _counter(
    "isoforest_router_retries_total",
    "Forwards abandoned on a dead/wedged replica and retried elsewhere",
    labelnames=("cause",),
)
_ROUTER_ADMITTED = _gauge(
    "isoforest_router_replicas_admitted",
    "Replicas currently admitted to the balancing pool",
)
_ROUTER_OUTSTANDING = _gauge(
    "isoforest_router_outstanding_requests",
    "Forwards currently in flight across all replicas",
)
_TIER_MISSING = _gauge(
    "isoforest_tier_missing_replicas",
    "1 when the named replica could not contribute to the last federated "
    "telemetry answer (ejected or unreachable), 0 when it answered",
    labelnames=("replica",),
)


class NoReplicaError(RuntimeError):
    """Every replica is ejected — retried under the forward budget (a
    probe may re-admit one between attempts), then a 503."""


class ReplicaRequestError(RuntimeError):
    """A forward died on the wire (the replica crashed/wedged holding the
    request) — retryable on another replica; the idempotency key keeps a
    half-answered flush from double-counting drift."""


@dataclass
class RouterConfig:
    """The router's timing knobs."""

    probe_interval_s: float = 1.0    # maintenance cadence (health + push)
    probe_timeout_s: float = 2.0     # /healthz answer budget per replica
    stale_after_s: float = 15.0      # heartbeat age that ejects a replica
    request_timeout_s: float = 30.0  # one forward's wire budget
    drain_timeout_s: float = 30.0    # SIGTERM -> in-flight completion wait
    retry_attempts: int = 3          # forward attempts across replicas
    retry_base_delay_s: float = 0.05
    retry_max_delay_s: float = 0.5

    def retry_policy(self) -> RetryPolicy:
        return RetryPolicy(
            max_attempts=self.retry_attempts,
            base_delay_s=self.retry_base_delay_s,
            multiplier=2.0,
            max_delay_s=self.retry_max_delay_s,
            jitter=0.0,  # deterministic schedule: replicas, not thundering herds
        )


class Replica:
    """One serving replica as the router sees it: its URL, the process the
    router spawned (None for adopted replicas), and its admission state."""

    def __init__(
        self,
        name: str,
        url: str,
        process: Optional[subprocess.Popen] = None,
    ) -> None:
        self.name = str(name)
        self.url = url.rstrip("/")
        self.process = process
        self.admitted = False
        self.outstanding = 0
        self.requests = 0
        self.down_cause: Optional[str] = None
        self.last_error: Optional[str] = None
        # model_id -> generation this replica acked via POST /reload/<id>
        self.acked_generations: Dict[str, int] = {}
        # seconds from spawn to the ready line (spawned replicas only)
        self.ready_s: Optional[float] = None

    @property
    def pid(self) -> Optional[int]:
        return self.process.pid if self.process is not None else None

    def state(self) -> dict:
        return {
            "name": self.name,
            "url": self.url,
            "pid": self.pid,
            "admitted": self.admitted,
            "outstanding": self.outstanding,
            "requests": self.requests,
            "down_cause": self.down_cause,
            "last_error": self.last_error,
            "acked_generations": dict(self.acked_generations),
        }


class Router:
    """The balancing/health/retry/push brain (module doc). Pure enough to
    drive in-process: injectable ``clock``/``sleep`` (retry backoff) and
    ``wall_clock`` (heartbeat ages), no sockets of its own — probes and
    forwards are plain urllib calls against the replica URLs."""

    def __init__(
        self,
        replicas: List[Replica],
        *,
        models_dir: Optional[str] = None,
        heartbeat_dir: Optional[str] = None,
        work_root: Optional[str] = None,
        journal_dir: Optional[str] = None,
        config: Optional[RouterConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        wall_clock: Callable[[], float] = time.time,
    ) -> None:
        self.replicas = list(replicas)
        self.models_dir = models_dir
        self.heartbeat_dir = heartbeat_dir
        self.work_root = work_root
        self.journal_dir = journal_dir
        self.config = config or RouterConfig()
        self._clock = clock
        self._sleep = sleep
        self._wall_clock = wall_clock
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)
        self._draining = False
        self._inflight = 0
        # model_id -> generation every admitted replica has acked
        self._pushed: Dict[str, int] = {}
        _ROUTER_ADMITTED.set(0)
        _ROUTER_OUTSTANDING.set(0)

    # ------------------------------------------------------------ health #

    def _set_gauges(self) -> None:
        with self._lock:
            admitted = sum(1 for r in self.replicas if r.admitted)
            outstanding = sum(r.outstanding for r in self.replicas)
        _ROUTER_ADMITTED.set(admitted)
        _ROUTER_OUTSTANDING.set(outstanding)

    def _admit(self, replica: Replica) -> None:
        with self._lock:
            changed = not replica.admitted
            replica.admitted = True
            replica.down_cause = None
        if changed:
            record_event(
                "router.replica_up", replica=replica.name, url=replica.url
            )
            logger.info("router: replica %s admitted (%s)", replica.name,
                        replica.url)
        self._set_gauges()

    def _eject(self, replica: Replica, cause: str, error: Optional[str] = None) -> None:
        with self._lock:
            changed = replica.admitted
            replica.admitted = False
            replica.down_cause = cause
            if error:
                replica.last_error = error
        if changed:
            record_event(
                "router.replica_down",
                replica=replica.name,
                cause=cause,
                error=error,
            )
            logger.warning(
                "router: replica %s ejected (%s)", replica.name, cause
            )
        self._set_gauges()

    def probe_once(self) -> None:
        """One health pass over every replica: process exit, ``/healthz``
        reachability within ``probe_timeout_s``, heartbeat staleness. Each
        verdict flips admission (with the ``router.replica_{up,down}``
        event) only on a state change."""
        ages: Dict[str, float] = {}
        if self.heartbeat_dir:
            ages = peer_heartbeat_ages(self.heartbeat_dir, self._wall_clock)
        for replica in self.replicas:
            cause = error = None
            if replica.process is not None and replica.process.poll() is not None:
                cause = "exited"
                error = f"exit code {replica.process.returncode}"
            else:
                try:
                    with urllib.request.urlopen(
                        replica.url + "/healthz",
                        timeout=self.config.probe_timeout_s,
                    ) as resp:
                        resp.read()
                except urllib.error.HTTPError as exc:
                    cause, error = f"http_{exc.code}", repr(exc)
                except (http.client.HTTPException, OSError) as exc:
                    timed_out = "timed out" in str(exc).lower()
                    cause = "probe_timeout" if timed_out else "probe_failed"
                    error = repr(exc)
            if cause is None and replica.name in ages:
                age = ages[replica.name]
                if not (age <= self.config.stale_after_s):  # inf/nan count stale
                    cause = "heartbeat_stale"
                    error = f"heartbeat age {age!r}s > {self.config.stale_after_s}s"
            if cause is None:
                self._admit(replica)
            else:
                self._eject(replica, cause, error)

    # ----------------------------------------------------------- routing #

    def _pick(self, tried: set) -> Optional[Replica]:
        """The admitted replica with the fewest outstanding forwards,
        preferring ones this request has not tried yet (when every
        admitted replica has been tried, a retry may revisit — the
        idempotency key makes that safe)."""
        with self._lock:
            admitted = [r for r in self.replicas if r.admitted]
            pool = [r for r in admitted if r.name not in tried] or admitted
            if not pool:
                return None
            return min(pool, key=lambda r: (r.outstanding, r.name))

    def handle_score(self, body: bytes, headers, query: str = ""):
        """``POST /score`` (single-model replicas)."""
        return self._proxy(SCORE_PATH, body, headers, query)

    def handle_score_model(self, model_id: str, body: bytes, headers, query: str = ""):
        """``POST /score/<model_id>`` (fleet replicas)."""
        return self._proxy(SCORE_PREFIX + model_id, body, headers, query)

    def _proxy(
        self, path: str, body: bytes, headers, query: str
    ) -> Tuple[int, str, str, Dict[str, str]]:
        t0 = time.perf_counter()
        with self._lock:
            if self._draining:
                draining = True
            else:
                draining = False
                self._inflight += 1
        if draining:
            payload = json.dumps(
                {"error": "router is draining", "status": 503}
            ) + "\n"
            _ROUTER_REQUEST_SECONDS.observe(time.perf_counter() - t0)
            _ROUTER_REQUESTS.inc(replica="none", code=503)
            # a draining router never recovers: the backoff just needs to
            # push the client to another tier within a probe interval
            return 503, "application/json", payload, {
                "Retry-After": self._retry_after_value()
            }
        inbound = inbound_trace_id(headers)
        # the request's identity across retries: adopt the client's key or
        # mint one — either way every forward of THIS request carries the
        # same key, so a replica that already answered it replays fold-free
        idem_key = inbound_idempotency_key(headers) or os.urandom(12).hex()
        content_type = (headers.get("Content-Type") or "") if headers else ""
        tried: set = set()
        served: List[Replica] = []
        trace_id = inbound
        retry_after: Optional[str] = None
        ctx = TraceContext(inbound) if inbound else None
        try:
            with with_context(ctx):
                with span("router.request", path=path) as sp:
                    trace_id = sp.trace_id or inbound

                    def _attempt():
                        replica = self._pick(tried)
                        if replica is None:
                            raise NoReplicaError(
                                "no admitted replicas "
                                f"({len(self.replicas)} registered)"
                            )
                        tried.add(replica.name)
                        return self._forward(
                            replica, path, body, content_type, query,
                            trace_id, idem_key,
                        )

                    try:
                        replica, status, ctype, payload, retry_after = (
                            retry_call(
                                _attempt,
                                policy=self.config.retry_policy(),
                                retry_on=(ReplicaRequestError, NoReplicaError),
                                describe=f"router forward {path}",
                                clock=self._clock,
                                sleep=self._sleep,
                            )
                        )
                        served.append(replica)
                    except RetryError as exc:
                        status, ctype = 503, "application/json"
                        payload = json.dumps(
                            {
                                "error": "no replica answered: "
                                         f"{exc.last_exception!r}",
                                "status": 503,
                                "attempts": exc.attempts,
                            }
                        ) + "\n"
                        # every replica is down/wedged: a probe pass may
                        # re-admit one — tell the client to wait that long
                        retry_after = self._retry_after_value()
                    sp.set_attrs(
                        status=status,
                        replica=served[0].name if served else None,
                        attempts=len(tried),
                    )
        finally:
            with self._lock:
                self._inflight -= 1
                if self._inflight == 0:
                    self._drained.notify_all()
        name = served[0].name if served else "none"
        _ROUTER_REQUEST_SECONDS.observe(time.perf_counter() - t0)
        _ROUTER_REQUESTS.inc(replica=name, code=status)
        resp_headers = {TRACE_HEADER: trace_id} if trace_id else {}
        if retry_after is not None:
            # a replica's backpressure answer travels VERBATIM: its
            # Retry-After is the queue-drain estimate of the machine that
            # actually refused, not anything the router should re-derive
            resp_headers["Retry-After"] = retry_after
        return status, ctype, payload, resp_headers

    def _retry_after_value(self) -> str:
        """The router's own ``Retry-After`` for 503s it mints itself
        (draining, retry budget exhausted): one probe interval — the
        soonest admission state can change — floored to 1 s."""
        return str(max(1, math.ceil(self.config.probe_interval_s)))

    def _forward(
        self,
        replica: Replica,
        path: str,
        body: bytes,
        content_type: str,
        query: str,
        trace_id: Optional[str],
        idem_key: str,
    ) -> Tuple[Replica, int, str, str, Optional[str]]:
        """One forward to one replica. An HTTP response (any status) is the
        replica's authoritative answer and passes through — a 429/503
        backpressure refusal is an ANSWER, not wire death: it consumes no
        retry attempt, ticks no retry counter, emits no
        ``router.replica_retry`` event, and its ``Retry-After`` header
        travels back verbatim (re-forwarding refused load elsewhere would
        convert one replica's backpressure into tier-wide congestion).
        Only wire death (connection severed, timeout) ejects the replica
        and raises the retryable error."""
        with self._lock:
            replica.outstanding += 1
        _ROUTER_OUTSTANDING.inc()
        try:
            url = replica.url + path + (f"?{query}" if query else "")
            req = urllib.request.Request(url, data=body, method="POST")
            if content_type:
                req.add_header("Content-Type", content_type)
            if trace_id:
                req.add_header(TRACE_HEADER, trace_id)
            req.add_header(IDEMPOTENCY_HEADER, idem_key)
            try:
                with urllib.request.urlopen(
                    req, timeout=self.config.request_timeout_s
                ) as resp:
                    payload = resp.read().decode("utf-8")
                    status = resp.status
                    ctype = resp.headers.get("Content-Type") or "application/json"
                    retry_after = resp.headers.get("Retry-After")
            except urllib.error.HTTPError as exc:
                # authoritative pass-through (docstring): 4xx/5xx — and in
                # particular 429/503 backpressure — RETURNS here rather
                # than raising a retryable error, so it never mints a
                # retry attempt
                payload = exc.read().decode("utf-8", errors="replace")
                status = exc.code
                ctype = exc.headers.get("Content-Type") or "application/json"
                retry_after = exc.headers.get("Retry-After")
            except (http.client.HTTPException, OSError) as exc:
                # URLError (incl. timeouts/refused) is an OSError; a severed
                # connection is RemoteDisconnected — all wire death
                self._eject(replica, "request_failed", repr(exc))
                _ROUTER_RETRIES.inc(cause="request_failed")
                record_event(
                    "router.replica_retry",
                    replica=replica.name,
                    path=path,
                    error=repr(exc),
                )
                raise ReplicaRequestError(
                    f"forward to {replica.name} died: {exc!r}"
                ) from exc
            with self._lock:
                replica.requests += 1
            return replica, status, ctype, payload, retry_after
        finally:
            with self._lock:
                replica.outstanding -= 1
            _ROUTER_OUTSTANDING.inc(-1)

    # ------------------------------------------------------ model pushes #

    def _current_path(self, model_id: str, model_dir: str) -> str:
        if self.work_root:
            return os.path.join(self.work_root, model_id, CURRENT_NAME)
        return os.path.join(model_dir + ".lifecycle", CURRENT_NAME)

    def push_once(self) -> Dict[str, int]:
        """One rolling-push pass: read each tenant's ``CURRENT.json``
        generation pointer and ``POST /reload/<model_id>`` to every
        admitted replica that has not acked it yet. Records one
        ``router.push`` event per (tenant, generation) once ALL admitted
        replicas converge. Returns ``{model_id: target generation}`` for
        tenants with a readable pointer."""
        if self.models_dir is None:
            return {}
        if faults.push_stalled():
            return {}  # the chaos seam: push plane wedged, no progress
        targets: Dict[str, int] = {}
        for model_id, model_dir in sorted(
            discover_models(self.models_dir).items()
        ):
            try:
                with open(self._current_path(model_id, model_dir)) as fh:
                    doc = json.load(fh)
                target = int(doc["generation"])
            except (OSError, ValueError, KeyError, TypeError):
                continue  # no swap yet (or torn mid-write): nothing to push
            targets[model_id] = target
            converged = True
            for replica in self.replicas:
                if not replica.admitted:
                    continue
                if replica.acked_generations.get(model_id, -1) >= target:
                    continue
                if self._push_replica(replica, model_id, target):
                    replica.acked_generations[model_id] = target
                else:
                    converged = False
            if converged and self._pushed.get(model_id) != target:
                self._pushed[model_id] = target
                record_event(
                    "router.push", model_id=model_id, generation=target
                )
                logger.info(
                    "router: model %s generation %d reached all replicas",
                    model_id, target,
                )
        return targets

    def _push_replica(self, replica: Replica, model_id: str, target: int) -> bool:
        """True when the replica acks generation ``target`` for
        ``model_id`` (a non-resident tenant acks trivially: its next lazy
        load resumes from ``CURRENT.json`` by construction)."""
        req = urllib.request.Request(
            replica.url + RELOAD_PREFIX + model_id, data=b"", method="POST"
        )
        try:
            with urllib.request.urlopen(
                req, timeout=self.config.probe_timeout_s
            ) as resp:
                doc = json.loads(resp.read().decode("utf-8"))
        except Exception as exc:
            replica.last_error = repr(exc)
            return False  # unreachable/refused: the next pass retries
        if doc.get("resident") is False:
            return True
        generation = doc.get("generation")
        return generation is not None and int(generation) >= target

    # ------------------------------------------------------------- drain #

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Stop admitting new requests (they answer 503) and wait — real
        wall time, this is the shutdown path — for in-flight forwards to
        finish. True when the tier drained inside the budget."""
        budget = (
            timeout_s if timeout_s is not None else self.config.drain_timeout_s
        )
        deadline = time.monotonic() + budget
        with self._lock:
            self._draining = True
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._drained.wait(remaining)
            drained = self._inflight == 0
            inflight = self._inflight
        if not drained:
            logger.warning(
                "router: drain timed out with %d request(s) in flight",
                inflight,
            )
        return drained

    def terminate_replicas(self, timeout_s: float = 10.0) -> None:
        """SIGTERM every replica this router spawned (each drains its own
        coalescer on the way down — ``cmd_serve``'s signal handler), then
        reap; a replica that ignores the drain window is killed."""
        spawned = [
            r for r in self.replicas
            if r.process is not None and r.process.poll() is None
        ]
        for replica in spawned:
            record_event(
                "router.replica_drain", replica=replica.name, pid=replica.pid
            )
            replica.process.terminate()
        for replica in spawned:
            try:
                replica.process.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                replica.process.kill()
                replica.process.wait(timeout=5.0)

    # -------------------------------------------- tier-wide observability #

    def federation_sources(
        self, path: str, *, none_on_404: bool = False
    ) -> Tuple[List[Tuple[str, Optional[dict]]], List[str]]:
        """Fan ``GET path`` out to every ADMITTED replica (the probe
        plumbing's timeout budget applies per fetch) and return
        ``(sources, missing)``: ``sources`` pairs each answering replica's
        name with its JSON document; ``missing`` names replicas that could
        not contribute — ejected, unreachable, or answering garbage. With
        ``none_on_404`` a clean 404 still counts as answering (the replica
        is alive, it just has no data for this query — e.g. a trace id it
        never saw) and contributes a ``None`` document. Updates the
        ``isoforest_tier_missing_replicas`` gauge per replica."""
        sources: List[Tuple[str, Optional[dict]]] = []
        missing: List[str] = []
        for replica in self.replicas:
            if not replica.admitted:
                missing.append(replica.name)
                _TIER_MISSING.set(1, replica=replica.name)
                continue
            try:
                with urllib.request.urlopen(
                    replica.url + path, timeout=self.config.probe_timeout_s
                ) as resp:
                    doc = json.loads(resp.read().decode("utf-8"))
            except urllib.error.HTTPError as exc:
                if none_on_404 and exc.code == 404:
                    sources.append((replica.name, None))
                    _TIER_MISSING.set(0, replica=replica.name)
                    continue
                replica.last_error = repr(exc)
                missing.append(replica.name)
                _TIER_MISSING.set(1, replica=replica.name)
                continue
            except (http.client.HTTPException, OSError, ValueError) as exc:
                replica.last_error = repr(exc)
                missing.append(replica.name)
                _TIER_MISSING.set(1, replica=replica.name)
                continue
            sources.append((replica.name, doc))
            _TIER_MISSING.set(0, replica=replica.name)
        return sources, missing

    @staticmethod
    def _json_reply(status: int, doc: dict) -> Tuple[int, str, str]:
        return status, "application/json", json.dumps(doc, sort_keys=True) + "\n"

    @staticmethod
    def _refusal(exc) -> Tuple[int, str, str]:
        from ..telemetry import federation

        payload = dict(federation.error_payload(exc), status=500)
        return Router._json_reply(500, payload)

    def handle_tier_metrics(self, query: str = "") -> Tuple[int, str, str]:
        """Federated ``GET /metrics``: one Prometheus exposition for the
        tier — counters summed, histograms bucket-summed (identical edges
        enforced), gauges labelled ``{replica=}``. Ejected/unreachable
        replicas are reported via ``isoforest_tier_missing_replicas``;
        merge conflicts are a typed 500, never a silently wrong sum."""
        from ..telemetry import federation
        from ..telemetry import metrics as _metrics

        replica_sources, _missing = self.federation_sources("/snapshot")
        # the local snapshot is taken AFTER the fan-out so the freshly
        # updated missing-replica gauge rides this very exposition
        local = ("router", _metrics.registry().snapshot())
        try:
            merged = federation.merge_metrics(
                [
                    local,
                    *[
                        (name, (doc or {}).get("metrics", {}))
                        for name, doc in replica_sources
                    ],
                ]
            )
        except federation.FederationError as exc:
            return self._refusal(exc)
        return (
            200,
            "text/plain; version=0.0.4; charset=utf-8",
            federation.metrics_to_prometheus(merged),
        )

    def handle_tier_snapshot(self, query: str = "") -> Tuple[int, str, str]:
        """Federated ``GET /snapshot``: the merged tier snapshot —
        ``metrics`` keeps the single-process registry shape, ``events``
        interleave with ``source`` labels, and ``missing_replicas`` makes
        a partial answer explicit."""
        from ..telemetry import export, federation

        replica_sources, missing = self.federation_sources("/snapshot")
        local = ("router", export.snapshot())
        try:
            doc = federation.merge_snapshots(
                [local, *[(n, d or {}) for n, d in replica_sources]],
                missing_replicas=missing,
            )
        except federation.FederationError as exc:
            return self._refusal(exc)
        doc["router"] = self.state()
        return self._json_reply(200, doc)

    def handle_tier_trace(self, query: str = "") -> Tuple[int, str, str]:
        """Federated ``GET /trace?trace_id=``: stitch the trace across the
        tier. The router's ``router.request`` span and each replica's
        ``serving.request`` span share the id via ``X-Isoforest-Trace``,
        so ``format=chrome`` (default) renders one Perfetto document with
        a ``pid`` lane per process and flow arrows crossing the boundary;
        ``format=spans`` returns the flat merged span list."""
        from ..telemetry import federation
        from ..telemetry import spans as _spans

        params = urllib.parse.parse_qs(query)
        trace_id = (params.get("trace_id") or [""])[0]
        if not trace_id:
            return self._json_reply(
                400, {"error": "trace_id query parameter required", "status": 400}
            )
        fmt = (params.get("format") or ["chrome"])[0]
        path = (
            f"/trace?trace_id={urllib.parse.quote(trace_id)}&format=spans"
        )
        replica_sources, missing = self.federation_sources(
            path, none_on_404=True
        )
        named: List[Tuple[str, dict]] = []
        local = _spans.get_trace(trace_id)
        if local is not None:
            named.append(("router", local))
        named.extend(
            (name, doc) for name, doc in replica_sources if doc is not None
        )
        if not named:
            return self._json_reply(
                404,
                {
                    "error": f"no captured trace {trace_id} on any tier "
                             "member (never captured, sampled out, or "
                             "evicted)",
                    "status": 404,
                    "missing_replicas": sorted(missing),
                },
            )
        try:
            if fmt == "spans":
                doc = federation.federated_trace_spans(
                    named, trace_id, missing_replicas=missing
                )
            else:
                doc = federation.federated_chrome(
                    [
                        (name, federation.flatten_trace_doc(trace))
                        for name, trace in named
                    ],
                    trace_id,
                    missing_replicas=missing,
                )
        except federation.FederationError as exc:
            return self._refusal(exc)
        return self._json_reply(200, doc)

    def handle_tier_traces_recent(self, query: str = "") -> Tuple[int, str, str]:
        """Federated ``GET /traces/recent``: newest-first trace summaries
        across the tier, each tagged with its ``source``."""
        from ..telemetry import federation
        from ..telemetry import spans as _spans

        params = urllib.parse.parse_qs(query)
        try:
            limit = int((params.get("limit") or ["20"])[0])
        except ValueError:
            limit = 20
        replica_sources, missing = self.federation_sources(
            f"/traces/recent?limit={limit}"
        )
        try:
            doc = federation.merge_recent_traces(
                [
                    ("router", _spans.recent_traces(limit=limit)),
                    *[
                        (name, (d or {}).get("traces", []))
                        for name, d in replica_sources
                    ],
                ],
                limit=limit,
                missing_replicas=missing,
            )
        except federation.FederationError as exc:
            return self._refusal(exc)
        return self._json_reply(200, doc)

    # how many journal records a recovered spool contributes to the tier
    # bundle (newest first; the full spool stays on disk for the CLI)
    BUNDLE_JOURNAL_TAIL = 500

    def handle_tier_bundle(self, query: str = "") -> Tuple[int, str, str]:
        """Federated ``GET /debug/bundle``: the router's own bundle (all
        single-process sections intact) plus every admitted replica's
        bundle under ``replicas`` — and for replicas that can NOT answer,
        their journal spool read off disk (``--journal-dir``), so a
        kill -9 victim still contributes its last events and traces.
        ``missing_replicas`` names every replica whose live bundle is
        absent, journal recovery or not."""
        from ..telemetry import journal as _journal
        from ..telemetry import resources

        try:
            doc = resources.build_bundle()
        except Exception as exc:  # the daemon must never die to this
            return self._json_reply(500, {"error": repr(exc), "status": 500})
        replica_sources, missing = self.federation_sources("/debug/bundle")
        replicas_out: Dict[str, dict] = {
            name: (bundle or {}) for name, bundle in replica_sources
        }
        for name in missing:
            if not self.journal_dir:
                continue
            spool_dir = os.path.join(self.journal_dir, name)
            if not os.path.isdir(spool_dir):
                continue
            try:
                recovered = _journal.read_spool(
                    spool_dir, tail=self.BUNDLE_JOURNAL_TAIL
                )
            except Exception as exc:
                recovered = {"error": repr(exc)}
            replicas_out[name] = {"journal": recovered}
        doc["federated"] = True
        doc["replicas"] = replicas_out
        doc["missing_replicas"] = sorted(missing)
        return self._json_reply(200, doc)

    # ------------------------------------------------------------- state #

    def state(self) -> dict:
        """Operator-facing tier state: the ``/healthz`` ``serving``
        section, ``GET /replicas`` and the debug bundle's ``router``
        section (plain JSON types)."""
        with self._lock:
            return {
                "router": True,
                "draining": self._draining,
                "inflight": self._inflight,
                "models_dir": self.models_dir,
                "heartbeat_dir": self.heartbeat_dir,
                "journal_dir": self.journal_dir,
                "replicas": [r.state() for r in self.replicas],
                "pushed_generations": dict(self._pushed),
            }

    def handle_replicas(self, query: str = "") -> Tuple[int, str, str]:
        """``GET /replicas``: the per-replica admission/outstanding rows."""
        return (
            200,
            "application/json",
            json.dumps(self.state(), sort_keys=True) + "\n",
        )


# ---------------------------------------------------------------- wiring #


def mount_router(server, router: Router) -> None:
    """Register the routed scoring paths + ``GET /replicas`` on a running
    :class:`~..telemetry.http.MetricsServer`, surface the
    tier state in ``/healthz`` and the debug bundle, and shadow the
    single-process telemetry built-ins with their tier-FEDERATED versions
    (registered GET routes dispatch before built-ins, so the router's
    daemon answers ``/metrics``, ``/snapshot``, ``/trace``,
    ``/traces/recent`` and ``/debug/bundle`` for the whole replica
    group)."""
    from ..telemetry import resources

    server.register_post(SCORE_PATH, router.handle_score)
    server.register_post_prefix(SCORE_PREFIX, router.handle_score_model)
    server.register_get(REPLICAS_PATH, router.handle_replicas)
    server.register_get("/metrics", router.handle_tier_metrics)
    server.register_get("/snapshot", router.handle_tier_snapshot)
    server.register_get("/trace", router.handle_tier_trace)
    server.register_get("/traces/recent", router.handle_tier_traces_recent)
    server.register_get("/debug/bundle", router.handle_tier_bundle)
    server.serving_state = router.state
    resources.register_bundle_section("router", router.state)


def unmount_router(server) -> None:
    from ..telemetry import resources

    server.unregister_post(SCORE_PATH)
    server.unregister_post_prefix(SCORE_PREFIX)
    server.unregister_get(REPLICAS_PATH)
    server.unregister_get("/metrics")
    server.unregister_get("/snapshot")
    server.unregister_get("/trace")
    server.unregister_get("/traces/recent")
    server.unregister_get("/debug/bundle")
    server.serving_state = None
    resources.unregister_bundle_section("router")


# the directory that holds the isoforest_tpu_torch package: a spawned replica
# imports the package from it, wherever the router was started
_PACKAGE_PARENT = str(pathlib.Path(__file__).resolve().parents[2])


def _child_env() -> dict:
    """The spawned replica's environment: the package's directory first on
    ``PYTHONPATH`` (nothing installs the package), and none of the
    variables that would make the child serve, beat or journal on its own
    at import."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_PACKAGE_PARENT, env.get("PYTHONPATH")) if p)
    env.pop("ISOFOREST_TPU_METRICS_PORT", None)
    env.pop("ISOFOREST_TPU_HEARTBEAT_DIR", None)
    # the child journals under its replica name via --journal-dir (in
    # extra_args when the tier journals); the environment variable would
    # also open a stray pid-named spool at import
    env.pop("ISOFOREST_TPU_JOURNAL_DIR", None)
    return env


def _pump_lines(stream, lines: "queue.Queue") -> None:
    """Read a child's stdout to its end: lines go to ``lines`` (the ready
    line among them), and the pipe never fills and blocks the child."""
    try:
        for line in stream:
            lines.put(line)
    except (OSError, ValueError):
        pass
    lines.put(None)


def spawn_replica(
    name: str,
    models_dir: str,
    heartbeat_dir: str,
    *,
    host: str = "127.0.0.1",
    extra_args: Tuple[str, ...] = (),
    ready_timeout_s: float = 120.0,
) -> Replica:
    """Spawn one ``python -m isoforest_tpu_torch serve --models-dir``
    replica on an ephemeral port and parse its JSON ready line for the URL.
    The child gets ``--replica-name`` and ``--heartbeat-dir`` (so the
    router's ``/healthz`` sees its heartbeat) but never
    ``ISOFOREST_TPU_HEARTBEAT_DIR``: a replica reading the shared directory
    would answer 503 on its own ``/healthz`` whenever a peer died, and the
    router would eject the whole tier. ``ready_timeout_s`` bounds the wait
    for the ready line (importing torch, bringing up CUDA); past it the
    child is stopped and this raises. The replica's ``ready_s`` holds the
    seconds it took."""
    argv = [
        sys.executable, "-m", "isoforest_tpu_torch", "serve",
        "--models-dir", models_dir,
        "--host", host,
        "--port", "0",
        "--replica-name", name,
        "--heartbeat-dir", heartbeat_dir,
        *extra_args,
    ]
    t0 = time.monotonic()
    proc = subprocess.Popen(
        argv, stdout=subprocess.PIPE, env=_child_env(), text=True, bufsize=1
    )
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(
        target=_pump_lines, args=(proc.stdout, lines), daemon=True,
        name=f"isoforest-replica-stdout-{name}",
    ).start()
    deadline = t0 + ready_timeout_s
    while True:
        try:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
        except queue.Empty:
            proc.terminate()
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
            raise RuntimeError(
                f"replica {name} did not become ready within {ready_timeout_s} s"
            )
        if line is None:  # stdout closed: the child is gone or going
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
            raise RuntimeError(
                f"replica {name} exited with code {proc.returncode} "
                "before printing its ready line"
            )
        try:
            ready = json.loads(line)
        except ValueError:
            continue  # a stray banner line: keep reading
        if isinstance(ready, dict) and ready.get("serving") and ready.get("url"):
            replica = Replica(name, ready["url"], process=proc)
            replica.ready_s = time.monotonic() - t0
            return replica


class RouterHandle:
    """A running replicated tier: HTTP front + router + maintenance
    thread (+ the spawned replica processes). ``close()`` drains, stops
    the replicas, and tears the server down; usable as a context
    manager."""

    def __init__(self, server, router: Router, stop: threading.Event,
                 maintenance: threading.Thread) -> None:
        self.server = server
        self.router = router
        self._stop = stop
        self._maintenance = maintenance
        self._closed = False

    @property
    def url(self) -> str:
        return self.server.url

    def __enter__(self) -> "RouterHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._maintenance.join(timeout=10.0)
        self.router.drain()
        self.router.terminate_replicas()
        unmount_router(self.server)
        self.server.stop()
        record_event("router.stop", replicas=len(self.router.replicas))


def serve_router(
    models_dir: str,
    *,
    replicas: int = 2,
    port: int = 0,
    host: str = "127.0.0.1",
    config: Optional[RouterConfig] = None,
    work_root: Optional[str] = None,
    replica_args: Tuple[str, ...] = (),
    heartbeat_dir: Optional[str] = None,
    journal_dir: Optional[str] = None,
) -> RouterHandle:
    """Assemble the replicated tier (module doc): spawn ``replicas``
    fleet replicas over ``models_dir``, admit the healthy ones, start the
    telemetry HTTP front with the routed scoring paths mounted, and run
    the probe + rolling-push maintenance loop until ``close()``. With
    ``journal_dir`` every replica flight-records into
    ``<journal_dir>/<replica name>/`` (the child gets ``--journal-dir``)
    and the tier ``/debug/bundle`` recovers dead replicas' spools."""
    config = config or RouterConfig()
    hb_dir = heartbeat_dir or os.path.join(models_dir, HEARTBEAT_DIR_NAME)
    os.makedirs(hb_dir, exist_ok=True)
    spawn_args = tuple(replica_args)
    if journal_dir:
        os.makedirs(journal_dir, exist_ok=True)
        spawn_args = (*spawn_args, "--journal-dir", journal_dir)
    pool: List[Replica] = []
    try:
        for i in range(int(replicas)):
            pool.append(
                spawn_replica(
                    f"replica-{i}", models_dir, hb_dir,
                    host=host, extra_args=spawn_args,
                )
            )
    except Exception:
        for replica in pool:
            if replica.process is not None:
                replica.process.terminate()
        raise
    router = Router(
        pool,
        models_dir=models_dir,
        heartbeat_dir=hb_dir,
        work_root=work_root,
        journal_dir=journal_dir,
        config=config,
    )
    router.probe_once()  # admit the freshly spawned replicas
    from ..telemetry.http import MetricsServer

    server = MetricsServer(
        host=host,
        port=port,
        heartbeat_dir=hb_dir,
        stale_after_s=config.stale_after_s,
    ).start()
    mount_router(server, router)
    stop = threading.Event()

    def _maintain() -> None:
        while not stop.wait(config.probe_interval_s):
            try:
                router.probe_once()
            except Exception:
                logger.exception("router: probe pass failed")
            try:
                router.push_once()
            except Exception:
                logger.exception("router: push pass failed")

    maintenance = threading.Thread(
        target=_maintain, daemon=True, name="isoforest-router-maintenance"
    )
    maintenance.start()
    record_event(
        "router.start",
        port=server.port,
        replicas=[r.name for r in pool],
        models_dir=models_dir,
    )
    logger.info(
        "router: fronting %d replica(s) on %s: %s",
        len(pool), server.url, ", ".join(r.url for r in pool),
    )
    return RouterHandle(server, router, stop, maintenance)
