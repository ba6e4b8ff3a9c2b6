"""StreamEngine: event-time windows, a watermark, and the steady-state
retrain loop (``isoforest_tpu/stream/engine.py``).

Rows arrive stamped with the time they happened (event time), are scored
with bounded lag through the serving micro-batch coalescer, and fold into
the retrain window only when their **pane** seals under the watermark, so
the (decay) reservoir weighs rows by event time even when the transport
delivers them out of order.

* Windows are ``[m * slide_s, m * slide_s + window_s)``; ``slide_s``
  defaults to ``window_s`` (tumbling) and must divide ``window_s``.
* The **watermark** is ``max(event_ts seen) - lateness_s``: a function of
  the data, never of the wall clock.
* A **pane** (one ``slide_s`` stripe) seals when the watermark passes its
  end: its rows fold into the manager's reservoir exactly once, stamped
  with their event times (``stream.fold``). A **window** closes when the
  watermark passes its end (``stream.window_closed``), and every
  ``retrain_every``-th non-empty close drives ``ModelManager.retrain``
  (``stream.retrain`` / ``stream.swap``).
* A row behind the watermark is **late**: scored, counted in
  ``isoforest_stream_late_rows_total`` and a ``stream.late`` event, never
  folded.

Each coalesced flush is one ``manager.score(X, fold_reservoir=False,
return_generation=True)`` on the model's device (the port's kernels), its
scores copied to the host once; every batch of the flush records the
generation pinned with the model that scored it (``on_scored`` sees each
batch, its scores and that generation; ``state()["rows_by_generation"]``
sums them). The submit-to-result wall time lands in
``isoforest_stream_lag_seconds``. ``threaded=False`` runs the coalescer
without its flusher and the engine never blocks: tests drive the whole
loop on a FakeClock with no real sleeps.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..lifecycle.manager import OUTCOME_SWAPPED, ModelManager
from ..lifecycle.window import DecayReservoir
from ..serving.coalescer import MicroBatchCoalescer
from ..serving.service import _host
from ..telemetry.events import record_event
from ..telemetry.metrics import counter as _counter, gauge as _gauge
from ..telemetry.metrics import histogram as _histogram
from ..telemetry.spans import span as _span
from ..utils.logging import logger
from .sources import StreamBatch

_ROWS_TOTAL = _counter(
    "isoforest_stream_rows_total",
    "Rows ingested (scored) by the streaming engine, late rows included",
)
_LATE_ROWS_TOTAL = _counter(
    "isoforest_stream_late_rows_total",
    "Rows that arrived behind the watermark (scored, routed to a "
    "stream.late event, excluded from window folds)",
)
_WINDOWS_CLOSED_TOTAL = _counter(
    "isoforest_stream_windows_closed_total",
    "Event-time windows closed by the watermark (empty windows included)",
)
_WATERMARK_LAG = _gauge(
    "isoforest_stream_watermark_lag_seconds",
    "Wall clock minus the event-time watermark at the last ingest — how far "
    "behind 'now' the stream's complete prefix is (large and shrinking "
    "during a historical replay; growing when the stream stalls)",
)
_FRESHNESS = _gauge(
    "isoforest_window_freshness_seconds",
    "Seconds of wall time since the newest window pane was folded into the "
    "retrain reservoir — the staleness companion to the drift gauges "
    "(isoforest_score_drift_psi drifting while this grows means the model "
    "is judged against a window nobody is refreshing)",
)
_LAG_SECONDS = _histogram(
    "isoforest_stream_lag_seconds",
    "Bounded-lag proof: wall seconds from a stream batch's coalescer "
    "submit to its scores arriving (queue wait + coalesced flush)",
)


def _peak_rss_bytes() -> int:
    """Process peak RSS (ru_maxrss is KB on Linux, bytes on macOS) — the
    flat-memory proof the stream soak pins per window close."""
    try:
        import resource
        import sys

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(peak if sys.platform == "darwin" else peak * 1024)
    except Exception:  # pragma: no cover - exotic platforms
        return 0


@dataclass
class StreamConfig:
    """Engine knobs; every time quantity is in seconds.

    ``window_s``/``slide_s``/``lateness_s`` define the event-time geometry
    (``slide_s=None`` = tumbling). ``retrain_every`` is the window-close
    cadence of the steady-state retrain loop (non-empty closes only).
    ``batch_rows``/``linger_s``/``max_queue_rows``/``queue_deadline_s``
    forward to the micro-batch coalescer; ``max_pending`` bounds how many
    source batches may be in flight before ingest blocks on the oldest
    (the lag bound, in batches). ``threaded=False`` is the deterministic
    test mode: no flusher thread, the engine pumps, nothing sleeps.
    """

    window_s: float = 60.0
    slide_s: Optional[float] = None
    lateness_s: float = 0.0
    retrain_every: int = 1
    batch_rows: int = 1024
    linger_s: float = 0.002
    max_queue_rows: int = 65536
    queue_deadline_s: float = 60.0
    max_pending: int = 8
    result_timeout_s: float = 300.0
    wait_retrain: bool = True
    threaded: bool = True

    def __post_init__(self) -> None:
        if not (self.window_s > 0):
            raise ValueError(f"window_s must be > 0, got {self.window_s}")
        if self.slide_s is None:
            self.slide_s = float(self.window_s)
        if not (0 < self.slide_s <= self.window_s):
            raise ValueError(
                f"slide_s must be in (0, window_s], got {self.slide_s}"
            )
        panes = self.window_s / self.slide_s
        if abs(panes - round(panes)) > 1e-9:
            raise ValueError(
                f"window_s ({self.window_s}) must be a whole multiple of "
                f"slide_s ({self.slide_s}); got {panes:.6f} panes per window"
            )
        if self.lateness_s < 0:
            raise ValueError(f"lateness_s must be >= 0, got {self.lateness_s}")
        if self.retrain_every < 1:
            raise ValueError(f"retrain_every must be >= 1, got {self.retrain_every}")

    @property
    def panes_per_window(self) -> int:
        return int(round(self.window_s / self.slide_s))


class _Pane:
    """Buffered on-time rows of one ``slide_s`` stripe, pre-seal."""

    __slots__ = ("xs", "ys", "tss", "score_sum", "anomalies", "labeled")

    def __init__(self) -> None:
        self.xs: List[np.ndarray] = []
        self.ys: List[np.ndarray] = []
        self.tss: List[np.ndarray] = []
        self.score_sum = 0.0
        self.anomalies = 0
        self.labeled = True


class StreamEngine:
    """Online anomaly detection over an event-time stream (module doc).

    ``manager`` is a :class:`~isoforest_tpu_torch.lifecycle.ModelManager` —
    usually constructed with ``auto_retrain=False`` (the engine's window
    cadence drives retrains, not the drift debounce; both can coexist) and
    ``reservoir="decay"`` so the fold stream's event stamps matter.
    ``clock`` is the wall clock (injectable: FakeClock in tests); event
    time only ever comes from the data. ``on_scored(batch, scores,
    generation)`` is called for every ingested batch, in submission order.
    """

    def __init__(
        self,
        manager: ModelManager,
        config: Optional[StreamConfig] = None,
        *,
        clock: Callable[[], float] = time.time,
        on_scored: Optional[Callable[[StreamBatch, np.ndarray, Optional[int]], None]] = None,
    ) -> None:
        self.manager = manager
        self._on_scored = on_scored
        self.config = config or StreamConfig()
        self._clock = clock
        self._decay = isinstance(manager.reservoir, DecayReservoir)
        self.coalescer = MicroBatchCoalescer(
            self._score_flush,
            max_batch_rows=self.config.batch_rows,
            max_linger_s=self.config.linger_s,
            max_queue_rows=self.config.max_queue_rows,
            queue_deadline_s=self.config.queue_deadline_s,
            clock=clock,
            start=self.config.threaded,
        )
        # event-time state: all -inf until the first row lands
        self._watermark = float("-inf")
        self._max_event_ts = float("-inf")
        self._cursor: Optional[float] = None  # next window end to close
        self._max_pane_end = float("-inf")  # bound for the +inf final sweep
        self._panes: Dict[int, _Pane] = {}
        self._sealed: Dict[int, dict] = {}  # pane stats until last window closes
        self._in_flight: List[Tuple[StreamBatch, object, float]] = []
        self._windows_since_retrain = 0
        self._last_fold_wall: Optional[float] = None
        self._finished = False
        # summary counters
        self.rows = 0
        self.late_rows = 0
        self.windows_closed = 0
        self.empty_windows = 0
        self.folded_rows = 0
        self.swaps = 0
        self.retrain_outcomes: Dict[str, int] = {}
        self.rss_trajectory: List[Tuple[float, int]] = []
        self.rows_by_generation: Dict[int, int] = {}

    # ------------------------------------------------------------------ #
    # scoring path
    # ------------------------------------------------------------------ #

    def _score_flush(self, X: np.ndarray) -> Tuple[np.ndarray, Optional[int]]:
        # the coalescer's score_fn: the drift monitor folds, the reservoir
        # does not (rows enter the window only when their pane seals,
        # stamped with event time); one copy of the scores to the host, and
        # the generation pinned with the model that scored them
        scores, generation = self.manager.score(X, fold_reservoir=False, return_generation=True)
        return _host(scores), generation

    def process(self, batch: StreamBatch) -> None:
        """Submit one source batch for scoring and ingest every completed
        one. Never blocks in threadless mode; in threaded mode blocks only
        when more than ``max_pending`` batches are in flight (the lag
        bound)."""
        if self._finished:
            raise RuntimeError("StreamEngine.finish() already ran")
        if batch.rows == 0:
            return
        if batch.ts.shape[0] != batch.X.shape[0]:
            raise ValueError(
                f"batch has {batch.ts.shape[0]} timestamps for "
                f"{batch.X.shape[0]} rows"
            )
        with _span("stream.ingest", rows=batch.rows):
            pending = self.coalescer.submit(batch.X)
        self._in_flight.append((batch, pending, self._clock()))
        self.drain(block=len(self._in_flight) > self.config.max_pending)

    def drain(self, block: bool = False) -> int:
        """Ingest completed in-flight batches, in submission order (the
        watermark is order-sensitive). Returns how many were ingested."""
        done = 0
        while self._in_flight:
            batch, pending, submitted = self._in_flight[0]
            if not pending.event.is_set():
                if not self.config.threaded:
                    self.coalescer.pump()
                if not pending.event.is_set():
                    if not (block and self.config.threaded):
                        break
            scores = self.coalescer.result(
                pending, timeout_s=self.config.result_timeout_s
            )
            self._in_flight.pop(0)
            self._ingest(batch, scores, pending.generation, self._clock() - submitted)
            done += 1
            block = len(self._in_flight) > self.config.max_pending
        return done

    # ------------------------------------------------------------------ #
    # event-time bookkeeping
    # ------------------------------------------------------------------ #

    def _ingest(self, batch: StreamBatch, scores: np.ndarray, generation: Optional[int], lag_s: float) -> None:
        cfg = self.config
        n = batch.rows
        self.rows += n
        if generation is not None:
            self.rows_by_generation[generation] = self.rows_by_generation.get(generation, 0) + n
        if self._on_scored is not None:
            self._on_scored(batch, scores, generation)
        _ROWS_TOTAL.inc(n)
        _LAG_SECONDS.observe(max(lag_s, 0.0))
        threshold = getattr(self.manager.model, "outlier_score_threshold", None)
        late = batch.ts < self._watermark
        n_late = int(late.sum())
        if n_late:
            self.late_rows += n_late
            _LATE_ROWS_TOTAL.inc(n_late)
            record_event(
                "stream.late",
                rows=n_late,
                watermark=self._watermark,
                min_ts=float(batch.ts[late].min()),
                max_ts=float(batch.ts[late].max()),
            )
        ontime = ~late
        if ontime.any():
            ts = batch.ts[ontime]
            X = batch.X[ontime]
            y = batch.y[ontime] if batch.y is not None else None
            s = np.asarray(scores)[ontime]
            pane_ids = np.floor(ts / cfg.slide_s).astype(np.int64)
            for pid in np.unique(pane_ids):
                rows = pane_ids == pid
                pane = self._panes.get(int(pid))
                if pane is None:
                    pane = self._panes[int(pid)] = _Pane()
                    self._max_pane_end = max(
                        self._max_pane_end,
                        (float(pid) + cfg.panes_per_window) * cfg.slide_s,
                    )
                pane.xs.append(X[rows])
                pane.tss.append(ts[rows])
                if y is None:
                    pane.labeled = False
                elif pane.labeled:
                    pane.ys.append(y[rows])
                pane.score_sum += float(s[rows].sum())
                if threshold is not None:
                    pane.anomalies += int((s[rows] > threshold).sum())
            if self._cursor is None:
                first = float(ts.min())
                self._cursor = (math.floor(first / cfg.slide_s) + 1) * cfg.slide_s
            self._max_event_ts = max(self._max_event_ts, float(ts.max()))
            self._watermark = self._max_event_ts - cfg.lateness_s
        _WATERMARK_LAG.set(self._clock() - self._watermark)
        if self._last_fold_wall is not None:
            _FRESHNESS.set(self._clock() - self._last_fold_wall)
        self._advance()

    def _advance(self) -> None:
        cfg = self.config
        for pid in sorted(self._panes):
            if (pid + 1) * cfg.slide_s <= self._watermark:
                self._seal_pane(pid)
        while (
            self._cursor is not None
            and self._watermark >= self._cursor
            and self._cursor <= self._max_pane_end
        ):
            end = self._cursor
            self._cursor = end + cfg.slide_s
            self._close_window(end)

    def _seal_pane(self, pid: int) -> None:
        cfg = self.config
        pane = self._panes.pop(pid)
        X = np.concatenate(pane.xs)
        ts = np.concatenate(pane.tss)
        y = np.concatenate(pane.ys) if (pane.labeled and pane.ys) else None
        if self._decay:
            self.manager.reservoir.fold(X, y, event_ts=ts)
        else:
            self.manager.reservoir.fold(X, y)
        self.folded_rows += int(X.shape[0])
        self._last_fold_wall = self._clock()
        _FRESHNESS.set(0.0)
        record_event(
            "stream.fold",
            pane_start=pid * cfg.slide_s,
            pane_end=(pid + 1) * cfg.slide_s,
            rows=int(X.shape[0]),
            labeled=y is not None,
            reservoir_rows=self.manager.reservoir.rows,
        )
        self._sealed[pid] = {
            "rows": int(X.shape[0]),
            "anomalies": pane.anomalies,
            "score_sum": pane.score_sum,
        }

    def _close_window(self, end: float) -> None:
        cfg = self.config
        end_pid = int(round(end / cfg.slide_s))
        pids = range(end_pid - cfg.panes_per_window, end_pid)
        stats = [self._sealed[p] for p in pids if p in self._sealed]
        rows = sum(s["rows"] for s in stats)
        anomalies = sum(s["anomalies"] for s in stats)
        score_sum = sum(s["score_sum"] for s in stats)
        self.windows_closed += 1
        _WINDOWS_CLOSED_TOTAL.inc()
        if rows == 0:
            self.empty_windows += 1
        record_event(
            "stream.window_closed",
            start=end - cfg.window_s,
            end=end,
            rows=rows,
            anomalies=anomalies,
            mean_score=(score_sum / rows) if rows else None,
            watermark=self._watermark,
            reservoir_rows=self.manager.reservoir.rows,
        )
        self.rss_trajectory.append((end, _peak_rss_bytes()))
        # a pane is spent once its LAST containing window has closed
        for pid in [p for p in self._sealed if (p + cfg.panes_per_window) * cfg.slide_s <= end]:
            del self._sealed[pid]
        if rows > 0:
            self._windows_since_retrain += 1
            if self._windows_since_retrain >= cfg.retrain_every:
                self._maybe_retrain(end)

    # ------------------------------------------------------------------ #
    # steady-state retrain loop
    # ------------------------------------------------------------------ #

    def _maybe_retrain(self, window_end: float) -> None:
        manager = self.manager
        if manager.retrain_in_progress:
            return  # a background retrain is still running: retry next close
        if manager.reservoir.rows < manager.min_window_rows:
            logger.info(
                "stream: window closed at %.1f but the reservoir holds %d "
                "rows (< min_window_rows=%d); retrain deferred",
                window_end,
                manager.reservoir.rows,
                manager.min_window_rows,
            )
            return
        self._windows_since_retrain = 0
        with _span("stream.retrain", window_end=window_end):
            outcome = manager.retrain(
                reason="window_close", wait=self.config.wait_retrain
            )
        if outcome is None:
            return
        self.retrain_outcomes[outcome] = self.retrain_outcomes.get(outcome, 0) + 1
        record_event(
            "stream.retrain",
            window_end=window_end,
            outcome=outcome,
            generation=manager.generation,
        )
        if outcome == OUTCOME_SWAPPED:
            self.swaps += 1
            record_event(
                "stream.swap",
                window_end=window_end,
                generation=manager.generation,
                path=manager.model_path,
                reservoir_rows=manager.reservoir.rows,
            )

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    def run(self, source: Iterable[StreamBatch], max_rows: Optional[int] = None) -> dict:
        """Consume ``source`` to exhaustion (or ``max_rows``), then
        :meth:`finish`. Returns the summary dict."""
        record_event(
            "stream.start",
            window_s=self.config.window_s,
            slide_s=self.config.slide_s,
            lateness_s=self.config.lateness_s,
            retrain_every=self.config.retrain_every,
            mode=self.manager.mode,
            reservoir=self.manager.reservoir_mode,
        )
        for batch in source:
            self.process(batch)
            if max_rows is not None and self.rows + sum(
                b.rows for b, _, _ in self._in_flight
            ) >= max_rows:
                break
        return self.finish()

    def finish(self) -> dict:
        """Drain in-flight scoring, advance the watermark past every pane
        (end-of-stream closes all windows), emit ``stream.stop`` and return
        the summary. Idempotent."""
        if self._finished:
            return self.state()
        self._finished = True
        self.coalescer.close(drain=True)
        while self._in_flight:
            batch, pending, submitted = self._in_flight.pop(0)
            scores = self.coalescer.result(pending, timeout_s=self.config.result_timeout_s)
            self._ingest(batch, scores, pending.generation, self._clock() - submitted)
        if math.isfinite(self._max_event_ts):
            self._watermark = float("inf")
            self._advance()
            self._watermark = self._max_event_ts - self.config.lateness_s
        summary = self.state()
        record_event(
            "stream.stop",
            rows=self.rows,
            late_rows=self.late_rows,
            windows_closed=self.windows_closed,
            swaps=self.swaps,
            generation=self.manager.generation,
        )
        return summary

    def close(self) -> None:
        """Tear down without the end-of-stream watermark sweep (buffered
        panes stay unfolded): the abandon path. :meth:`finish` is the
        graceful one."""
        self._finished = True
        self.coalescer.close(drain=False)

    def freshness_seconds(self) -> Optional[float]:
        """Wall seconds since the newest pane fold (None = nothing folded)."""
        if self._last_fold_wall is None:
            return None
        return self._clock() - self._last_fold_wall

    @property
    def watermark(self) -> float:
        return self._watermark

    def state(self) -> dict:
        """Operator-facing summary (plain JSON types)."""
        lag = _LAG_SECONDS.summary()
        return {
            "rows": self.rows,
            "late_rows": self.late_rows,
            "folded_rows": self.folded_rows,
            "windows_closed": self.windows_closed,
            "empty_windows": self.empty_windows,
            "swaps": self.swaps,
            "retrain_outcomes": dict(self.retrain_outcomes),
            "generation": self.manager.generation,
            "rows_by_generation": {str(g): r for g, r in sorted(self.rows_by_generation.items())},
            "watermark": None if not math.isfinite(self._watermark) else self._watermark,
            "max_event_ts": (
                None if not math.isfinite(self._max_event_ts) else self._max_event_ts
            ),
            "window_s": self.config.window_s,
            "slide_s": self.config.slide_s,
            "lateness_s": self.config.lateness_s,
            "freshness_seconds": self.freshness_seconds(),
            "lag_p99_s": lag.get("p99"),
            "reservoir_rows": self.manager.reservoir.rows,
            "reservoir": self.manager.reservoir_mode,
            "rss_trajectory": [
                {"window_end": e, "peak_rss_bytes": b} for e, b in self.rss_trajectory
            ],
            "peak_rss_bytes": _peak_rss_bytes(),
        }
