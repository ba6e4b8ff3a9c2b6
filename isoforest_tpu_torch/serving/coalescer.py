"""Dynamic micro-batch coalescing: many requests, one scoring call
(``isoforest_tpu/serving/coalescer.py``, copied: it is host Python and
numpy).

A kernel launch costs nearly the same for 1 row as for a few thousand
once the per-call host cost is paid, so an online endpoint that scores
each request alone throws the batch away. :class:`MicroBatchCoalescer`
recovers it: concurrent requests enqueue their rows into one shared
buffer, and a flusher drains it into a single scoring call when either

* the pending row count reaches ``max_batch_rows`` (serving pre-warms
  this bucket), or
* the oldest queued request has lingered ``max_linger_s`` (the
  tail-latency bound),

whichever comes first, then hands each waiter its slice of the scores by
row offset. A request is never split across flushes: its rows are scored
together, by one model.

Admission control keeps overload failure crisp:

* a request that would push the buffer past ``max_queue_rows`` is refused
  at once with :class:`QueueFullError` (HTTP 429: back off and retry);
* once the oldest queued request is older than ``queue_deadline_s``, new
  work is refused with :class:`QueueStaleError` (HTTP 503);
* a waiter whose result does not arrive within its budget gets
  :class:`RequestTimeoutError` (503), never a hang.

``clock`` is injectable and ``start=False`` runs without the flusher
thread: tests drive flushes with :meth:`pump` on a
:class:`~isoforest_tpu_torch.resilience.faults.FakeClock`, with no real
sleeps. Metrics (the JAX package's names): ``isoforest_serving_queue_depth``,
``isoforest_serving_batch_rows``,
``isoforest_serving_coalesced_requests_total`` and
``isoforest_serving_flushes_total{cause=size|linger|close}``.

Tracing: :meth:`submit` captures the caller's span context, and the
flush's ``serving.flush`` span links every captured context (one flush,
many requests: links, not parentage). Each served request gets its queue
wait and the flush span's context back on its pending handle.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..telemetry.metrics import counter as _counter, gauge as _gauge
from ..telemetry.metrics import histogram as _histogram
from ..telemetry.spans import current_context as _current_context
from ..telemetry.spans import span as _span

_QUEUE_DEPTH = _gauge(
    "isoforest_serving_queue_depth",
    "Rows currently waiting in the micro-batch coalescer buffer",
)
_BATCH_ROWS = _histogram(
    "isoforest_serving_batch_rows",
    "Rows per coalesced scoring flush",
    buckets=tuple(float(1 << i) for i in range(17)),  # 1 .. 65536
)
_COALESCED = _counter(
    "isoforest_serving_coalesced_requests_total",
    "Requests whose rows were scored via a coalesced flush "
    "(incremented by the request count of every flush)",
)
_FLUSHES = _counter(
    "isoforest_serving_flushes_total",
    "Coalesced scoring flushes by trigger "
    "(size = buffer reached max_batch_rows; linger = oldest request hit "
    "the max-linger deadline; close = drain at shutdown)",
    labelnames=("cause",),
)


class ServingError(Exception):
    """Base class for serving-layer refusals; ``status`` is the HTTP code
    the endpoint maps the error to (the backpressure ladder of the module doc).
    ``retry_after_s`` is the server's drain estimate — every 429/503
    response carries it as an integer ``Retry-After`` header so clients
    back off for a grounded interval instead of guessing."""

    status = 500
    retry_after_s: Optional[float] = None


class QueueFullError(ServingError):
    """Admission refused: the request would overflow ``max_queue_rows``
    (HTTP 429 — retriable after backoff)."""

    status = 429


class QueueStaleError(ServingError):
    """Admission refused: the oldest queued request has aged past
    ``queue_deadline_s`` — the service is not draining (HTTP 503)."""

    status = 503


class RequestTimeoutError(ServingError):
    """The caller's wait budget expired before its flush completed
    (HTTP 503)."""

    status = 503


class CoalescerClosedError(ServingError):
    """Submitted after :meth:`MicroBatchCoalescer.close` (HTTP 503)."""

    status = 503


class _Pending:
    """One enqueued request: its rows, arrival time, and the slot its
    flush fills in. ``flush_rows``/``flush_requests`` record the flush it
    rode in (surfaced in the HTTP response so a load generator can verify
    coalescing actually happened); ``generation`` is the model generation
    that scored the flush, when the scorer names one."""

    __slots__ = (
        "rows",
        "enqueued_at",
        "event",
        "scores",
        "error",
        "flush_rows",
        "flush_requests",
        "generation",
        "ctx",
        "queue_wait_s",
        "flush_ctx",
    )

    def __init__(self, rows: np.ndarray, enqueued_at: float, ctx=None) -> None:
        self.rows = rows
        self.enqueued_at = enqueued_at
        self.event = threading.Event()
        self.scores: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.flush_rows = 0
        self.flush_requests = 0
        self.generation = None
        # trace handoff: the submitter's span context (linked by the flush
        # span), the measured enqueue->drain wait, and the flush span's own
        # context (reported back so the request trace names its flush)
        self.ctx = ctx
        self.queue_wait_s = 0.0
        self.flush_ctx = None


class MicroBatchCoalescer:
    """Shared request buffer with size-or-linger flushing (module doc).

    ``score_fn(X) -> (scores, generation)`` is called once per flush with
    the concatenated ``[N, F]`` rows of every drained request; in serving it
    is :meth:`~.service.ScoringService._score_batch`, which returns the
    scores on the host and the lifecycle generation that scored them (None
    without a manager), which every request of the flush records.
    """

    def __init__(
        self,
        score_fn: Callable[[np.ndarray], Tuple[np.ndarray, Optional[int]]],
        *,
        max_batch_rows: int = 1024,
        max_linger_s: float = 0.002,
        max_queue_rows: int = 8192,
        queue_deadline_s: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
        start: bool = True,
    ) -> None:
        if max_batch_rows < 1:
            raise ValueError(f"max_batch_rows must be >= 1, got {max_batch_rows}")
        if max_queue_rows < max_batch_rows:
            raise ValueError(
                f"max_queue_rows ({max_queue_rows}) must be >= max_batch_rows "
                f"({max_batch_rows}) or the size trigger can never fire"
            )
        if max_linger_s < 0 or queue_deadline_s <= 0:
            raise ValueError(
                "max_linger_s must be >= 0 and queue_deadline_s > 0"
            )
        self._score_fn = score_fn
        self.max_batch_rows = int(max_batch_rows)
        self.max_linger_s = float(max_linger_s)
        self.max_queue_rows = int(max_queue_rows)
        self.queue_deadline_s = float(queue_deadline_s)
        self._clock = clock
        self._cond = threading.Condition()
        self._queue: List[_Pending] = []
        self._pending_rows = 0
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="isoforest-coalescer"
            )
            self._thread.start()

    # ------------------------------------------------------------------ #
    # request side
    # ------------------------------------------------------------------ #

    def submit(self, rows: np.ndarray) -> _Pending:
        """Enqueue one request's rows; returns the pending handle to pass
        to :meth:`result`. Raises the admission-control errors documented
        on the module instead of ever blocking the caller on a full or
        stalled buffer."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[0] < 1:
            raise ValueError(
                f"submit expects a non-empty [N, F] row matrix, got shape "
                f"{rows.shape}"
            )
        n = int(rows.shape[0])
        with self._cond:
            if self._closed:
                raise CoalescerClosedError("the coalescer is shut down")
            now = self._clock()
            if self._queue:
                age = now - self._queue[0].enqueued_at
                if age > self.queue_deadline_s:
                    exc: ServingError = QueueStaleError(
                        f"oldest queued request is {age:.3f}s old "
                        f"(> queue_deadline_s={self.queue_deadline_s:g}); "
                        "the scoring backend is not draining the queue"
                    )
                    exc.retry_after_s = self.queue_deadline_s
                    raise exc
            if self._pending_rows + n > self.max_queue_rows:
                exc = QueueFullError(
                    f"{n} rows would overflow the admission queue "
                    f"({self._pending_rows}/{self.max_queue_rows} rows "
                    "pending); back off and retry"
                )
                exc.retry_after_s = self._drain_estimate_s_locked()
                raise exc
            pending = _Pending(rows, now, ctx=_current_context())
            self._queue.append(pending)
            self._pending_rows += n
            _QUEUE_DEPTH.set(self._pending_rows)
            self._cond.notify_all()
        return pending

    def result(
        self, pending: _Pending, timeout_s: Optional[float] = None
    ) -> np.ndarray:
        """Block until ``pending``'s flush completes; returns its scores or
        re-raises the flush's error. A wait past ``timeout_s`` raises
        :class:`RequestTimeoutError` (the flush may still complete later;
        its result is discarded)."""
        if not pending.event.wait(timeout_s):
            raise RequestTimeoutError(
                f"no result within {timeout_s:g}s (queue wait + scoring)"
            )
        if pending.error is not None:
            raise pending.error
        assert pending.scores is not None
        return pending.scores

    def score(self, rows: np.ndarray, timeout_s: Optional[float] = None) -> np.ndarray:
        """Convenience: :meth:`submit` + :meth:`result`."""
        return self.result(self.submit(rows), timeout_s=timeout_s)

    # ------------------------------------------------------------------ #
    # flush side
    # ------------------------------------------------------------------ #

    @property
    def pending_rows(self) -> int:
        with self._cond:
            return self._pending_rows

    def _drain_estimate_s_locked(self) -> float:
        """Rough time to drain the current backlog: flushes needed at the
        configured batch size, each paced by the linger window (floored so
        a zero-linger coalescer still advertises a sane backoff). Caller
        holds the lock; feeds the ``Retry-After`` header on 429s."""
        flushes = max(1, -(-self._pending_rows // self.max_batch_rows))
        return flushes * max(self.max_linger_s, 0.05)

    def reconfigure(
        self,
        *,
        max_batch_rows: Optional[int] = None,
        max_linger_s: Optional[float] = None,
    ) -> dict:
        """Adjust the flush policy on a live coalescer. Takes effect under the condition
        lock so in-flight submits/flushes see one consistent policy: queued
        requests are never lost, split, or double-drained across the
        change — the next ``_due_locked`` simply evaluates the new
        thresholds. Returns the policy that was in force BEFORE the change
        so the caller can revert. Same validation as the constructor."""
        with self._cond:
            previous = {
                "max_batch_rows": self.max_batch_rows,
                "max_linger_s": self.max_linger_s,
            }
            new_batch = (
                self.max_batch_rows
                if max_batch_rows is None
                else int(max_batch_rows)
            )
            new_linger = (
                self.max_linger_s if max_linger_s is None else float(max_linger_s)
            )
            if new_batch < 1:
                raise ValueError(f"max_batch_rows must be >= 1, got {new_batch}")
            if self.max_queue_rows < new_batch:
                raise ValueError(
                    f"max_batch_rows ({new_batch}) must stay <= max_queue_rows "
                    f"({self.max_queue_rows}) or the size trigger can never fire"
                )
            if new_linger < 0:
                raise ValueError(f"max_linger_s must be >= 0, got {new_linger}")
            self.max_batch_rows = new_batch
            self.max_linger_s = new_linger
            # wake the flusher: the new policy may make a waiting batch due
            # (shorter linger) or let it keep filling (wider batch)
            self._cond.notify_all()
        return previous

    def _due_locked(self) -> Tuple[List[_Pending], Optional[str]]:
        """(batch, cause) when a flush is due, else ([], None). Caller
        holds the lock. Never splits a request: drains whole waiters from
        the front until the NEXT one would exceed ``max_batch_rows`` (a
        single oversize request drains alone — ``score_fn`` chunks
        internally)."""
        if not self._queue:
            return [], None
        if self._closed:
            cause = "close"
        elif self._pending_rows >= self.max_batch_rows:
            cause = "size"
        elif self._clock() - self._queue[0].enqueued_at >= self.max_linger_s:
            cause = "linger"
        else:
            return [], None
        batch: List[_Pending] = []
        rows = 0
        while self._queue:
            head = self._queue[0]
            n = int(head.rows.shape[0])
            if batch and rows + n > self.max_batch_rows:
                break
            batch.append(self._queue.pop(0))
            rows += n
        self._pending_rows -= rows
        _QUEUE_DEPTH.set(self._pending_rows)
        return batch, cause

    def _wait_s_locked(self) -> Optional[float]:
        """How long the flusher may sleep before the next linger deadline
        (None = until notified). Caller holds the lock."""
        if not self._queue:
            return None
        due = self._queue[0].enqueued_at + self.max_linger_s - self._clock()
        return max(due, 0.0)

    def _flush(self, batch: List[_Pending], cause: str) -> None:
        offsets = np.cumsum([0] + [int(p.rows.shape[0]) for p in batch])
        total = int(offsets[-1])
        X = batch[0].rows if len(batch) == 1 else np.concatenate(
            [p.rows for p in batch], axis=0
        )
        drained_at = self._clock()
        for p in batch:
            p.queue_wait_s = max(drained_at - p.enqueued_at, 0.0)
        # one flush serves many requests on this (flusher) thread: the span
        # LINKS each request's captured context instead of parenting it
        with _span(
            "serving.flush",
            links=[p.ctx for p in batch],
            cause=cause,
            rows=total,
            requests=len(batch),
        ) as fsp:
            flush_ctx = fsp.context
            for p in batch:
                p.flush_ctx = flush_ctx
            try:
                scores, generation = self._score_fn(X)
                scores = np.asarray(scores)
                if scores.shape[0] != total:
                    raise ValueError(
                        f"score_fn returned {scores.shape[0]} scores for "
                        f"{total} rows"
                    )
            except BaseException as exc:  # every waiter learns the same fate
                fsp.set_attrs(error=type(exc).__name__)
                for p in batch:
                    p.error = exc
                    p.event.set()
                _FLUSHES.inc(cause=cause)
                return
            _BATCH_ROWS.observe(float(total))
            _COALESCED.inc(len(batch))
            _FLUSHES.inc(cause=cause)
            for i, p in enumerate(batch):
                p.scores = scores[offsets[i] : offsets[i + 1]]
                p.flush_rows = total
                p.flush_requests = len(batch)
                p.generation = generation
                p.event.set()

    def pump(self) -> int:
        """Run at most one due flush on the CALLER's thread; returns the
        number of requests flushed (0 = nothing due). The threadless test
        mode: with ``start=False`` and an injected fake clock, the
        size/linger/backpressure policy is exercised deterministically."""
        with self._cond:
            batch, cause = self._due_locked()
        if not batch:
            return 0
        self._flush(batch, cause)
        return len(batch)

    def _run(self) -> None:
        while True:
            with self._cond:
                while True:
                    batch, cause = self._due_locked()
                    if batch:
                        break
                    if self._closed:
                        return
                    self._cond.wait(self._wait_s_locked())
            self._flush(batch, cause)

    def close(self, drain: bool = True) -> None:
        """Stop accepting work. ``drain=True`` flushes whatever is queued
        (cause ``close``) so no waiter is stranded; ``drain=False`` fails
        the stragglers with :class:`CoalescerClosedError`. Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            if not drain:
                for p in self._queue:
                    p.error = CoalescerClosedError("coalescer closed")
                    p.event.set()
                self._queue.clear()
                self._pending_rows = 0
                _QUEUE_DEPTH.set(0)
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        elif drain:
            while self.pump():
                pass
