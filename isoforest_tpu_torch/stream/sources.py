"""Append-only stream sources: file tail, TCP line protocol, generators
(``isoforest_tpu/stream/sources.py``, host Python copied).

Every source yields :class:`StreamBatch`: event timestamps (float64 unix
seconds, the windowing coordinate, never truncated to float32), a float32
feature matrix, and optional labels. The row convention everywhere is

    event_ts, f1, ..., fn[, label]

The first column is the event time, and ``labeled=True`` treats the last
column as the label.

``tail_source`` rides the :mod:`..io.source` shard abstraction: a
directory (or glob) of ``.csv``/``.npy`` shards is streamed in sorted-name
order, and in ``follow`` mode the tail then polls for shard files that were
not there before (producers write, then rename). A single CSV file tails
line by line instead, picking up appended rows. The poll ``sleep`` is
injectable so tests drive the tail on a FakeClock with no real sleeps.

``socket_source`` binds a ThreadingTCPServer speaking one CSV row per line;
``generator_source`` adapts any in-process iterable.
"""

from __future__ import annotations

import io as _io
import os
import queue
import socketserver
import threading
import time
from typing import Callable, Iterable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from ..io.source import SHARD_FORMATS, open_source


class StreamBatch(NamedTuple):
    """One decoded slice of the stream: per-row event times (float64 unix
    seconds), features (float32 ``[N, F]``), optional labels."""

    ts: np.ndarray
    X: np.ndarray
    y: Optional[np.ndarray]

    @property
    def rows(self) -> int:
        return int(self.X.shape[0])


def split_timed(data: np.ndarray, labeled: bool) -> StreamBatch:
    """Split a raw ``[N, 1 + F (+1)]`` float64 matrix into
    ``(event_ts, features, label?)`` per the first/last-column convention."""
    data = np.asarray(data, np.float64)
    if data.ndim != 2:
        data = data.reshape(data.shape[0], -1) if data.size else data.reshape(0, 2)
    min_cols = 3 if labeled else 2
    if data.shape[1] < min_cols:
        raise ValueError(
            f"timed rows need >= {min_cols} columns "
            f"(event_ts + features{' + label' if labeled else ''}); "
            f"got {data.shape[1]}"
        )
    ts = np.ascontiguousarray(data[:, 0])
    if labeled:
        X = np.ascontiguousarray(data[:, 1:-1], dtype=np.float32)
        y = np.ascontiguousarray(data[:, -1])
        return StreamBatch(ts, X, y)
    return StreamBatch(ts, np.ascontiguousarray(data[:, 1:], dtype=np.float32), None)


def parse_lines(lines: List[str], labeled: bool) -> StreamBatch:
    """Parse buffered CSV lines (blank/comment lines already skipped) into
    one batch — float64 end-to-end so unix-epoch event times keep
    sub-second resolution."""
    data = np.loadtxt(_io.StringIO("\n".join(lines)), delimiter=",", ndmin=2)
    return split_timed(data, labeled)


def generator_source(
    batches: Iterable, labeled: bool = False
) -> Iterator[StreamBatch]:
    """Adapt an in-process iterable: items may be :class:`StreamBatch`,
    ``(ts, X)`` / ``(ts, X, y)`` tuples, or raw timed matrices (first
    column = event time, ``labeled`` applies the trailing-label split)."""
    for item in batches:
        if isinstance(item, StreamBatch):
            yield item
        elif isinstance(item, tuple) and len(item) in (2, 3):
            ts, X = item[0], item[1]
            y = item[2] if len(item) == 3 else None
            ts = np.asarray(ts, np.float64).reshape(-1)
            X = np.asarray(X, np.float32)
            yield StreamBatch(ts, X, None if y is None else np.asarray(y, np.float64))
        else:
            yield split_timed(np.asarray(item), labeled)


# --------------------------------------------------------------------------- #
# file tail
# --------------------------------------------------------------------------- #


def _iter_timed_shard(path: str, fmt: str, labeled: bool, chunk_rows: int):
    """Chunked float64 pass over one shard. Only the textual and npy formats
    are tailed — they preserve the float64 event-time column; avro/parquet
    shards decode features as float32 and would truncate unix timestamps."""
    if fmt == "csv":
        buf: List[str] = []
        with open(path, "r") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                buf.append(line)
                if len(buf) >= chunk_rows:
                    yield parse_lines(buf, labeled)
                    buf.clear()
            if buf:
                yield parse_lines(buf, labeled)
    elif fmt == "npy":
        mm = np.load(path, mmap_mode="r")
        if mm.ndim != 2:
            raise ValueError(f"npy shard {path!r} must be 2-D, got shape {mm.shape}")
        for start in range(0, mm.shape[0], chunk_rows):
            yield split_timed(np.array(mm[start : start + chunk_rows]), labeled)
    else:
        raise ValueError(
            f"stream tailing supports .csv/.npy shards; {path!r} is {fmt!r} "
            "(float32 record formats would truncate the event-time column)"
        )


def _resolve_shards(spec: str) -> List[Tuple[str, str]]:
    """Sorted ``(path, format)`` pairs currently matching ``spec`` (a
    directory or glob). An empty/absent directory resolves to [] — in
    follow mode the very first shard may not exist yet."""
    try:
        source = open_source(spec)
    except FileNotFoundError:
        return []
    return [(s.path, s.format) for s in source.shards]


def tail_source(
    spec: str,
    labeled: bool = False,
    *,
    follow: bool = False,
    poll_s: float = 0.25,
    chunk_rows: int = 4096,
    sleep: Callable[[float], None] = time.sleep,
    stop: Optional[Callable[[], bool]] = None,
) -> Iterator[StreamBatch]:
    """Tail ``spec`` as an append-only timed stream.

    * directory / glob — stream every current ``.csv``/``.npy`` shard in
      sorted-name order, then (``follow=True``) poll every ``poll_s`` for
      shards that appeared since and stream those; a shard is read exactly
      once, so producers must write-then-rename complete files.
    * single file — parse as CSV and, in follow mode, keep reading rows
      appended past the last EOF (the classic ``tail -f``).

    ``stop()`` (checked between batches and polls) ends a follow tail;
    without ``follow`` the iterator ends at the current end of the data.
    """
    if os.path.isfile(spec) and SHARD_FORMATS.get(
        os.path.splitext(spec)[1].lower(), "csv"
    ) == "csv":
        yield from _tail_csv_file(
            spec, labeled, follow=follow, poll_s=poll_s, chunk_rows=chunk_rows,
            sleep=sleep, stop=stop,
        )
        return
    if not follow:
        # a one-shot replay of a missing/empty source is an operator error,
        # not a zero-row stream; only a follow tail may start before its
        # first shard exists
        open_source(spec)
    seen = set()
    while True:
        new = [(p, f) for p, f in _resolve_shards(spec) if p not in seen]
        for path, fmt in new:
            seen.add(path)
            for batch in _iter_timed_shard(path, fmt, labeled, chunk_rows):
                if batch.rows:
                    yield batch
                if stop is not None and stop():
                    return
        if not follow or (stop is not None and stop()):
            return
        if not new:
            sleep(poll_s)


def _tail_csv_file(
    path: str,
    labeled: bool,
    *,
    follow: bool,
    poll_s: float,
    chunk_rows: int,
    sleep: Callable[[float], None],
    stop: Optional[Callable[[], bool]],
) -> Iterator[StreamBatch]:
    buf: List[str] = []
    partial = ""
    position = 0
    while True:
        with open(path, "r") as fh:
            fh.seek(position)
            text = fh.read()
            position = fh.tell()
        lines = (partial + text).split("\n")
        # the final element is "" after a complete line, else a fragment a
        # producer is mid-append on: hold it until its newline lands
        partial = lines.pop()
        for line in lines:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            buf.append(line)
            if len(buf) >= chunk_rows:
                yield parse_lines(buf, labeled)
                buf.clear()
                if stop is not None and stop():
                    return
        if buf:
            yield parse_lines(buf, labeled)
            buf.clear()
        if not follow or (stop is not None and stop()):
            if not follow and partial.strip() and not partial.startswith("#"):
                yield parse_lines([partial.strip()], labeled)
            return
        sleep(poll_s)


# --------------------------------------------------------------------------- #
# TCP line protocol
# --------------------------------------------------------------------------- #


class _LineHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:  # one connection: CSV rows, one per line
        for raw in self.rfile:
            line = raw.decode("utf-8", "replace").strip()
            if line and not line.startswith("#"):
                self.server.lines.put(line)  # type: ignore[attr-defined]


class SocketFeed:
    """A bound TCP line-protocol listener plus its batch iterator.

    ``batches()`` drains complete rows into :class:`StreamBatch` chunks —
    a batch closes at ``chunk_rows`` rows or after ``idle_s`` with no new
    line (so a trickle still flows with bounded latency). ``stop()`` (or
    an external ``should_stop`` callable turning True) shuts the listener
    and ends the iterator once the queue is drained.
    """

    def __init__(
        self,
        port: int,
        host: str = "127.0.0.1",
        *,
        labeled: bool = False,
        chunk_rows: int = 1024,
        idle_s: float = 0.25,
        should_stop: Optional[Callable[[], bool]] = None,
    ) -> None:
        self.labeled = bool(labeled)
        self.chunk_rows = int(chunk_rows)
        self.idle_s = float(idle_s)
        self._should_stop = should_stop
        self._stopped = threading.Event()
        self.server = socketserver.ThreadingTCPServer(
            (host, int(port)), _LineHandler, bind_and_activate=True
        )
        self.server.daemon_threads = True
        self.server.lines = queue.Queue()  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self.server.serve_forever,
            kwargs={"poll_interval": 0.1},
            daemon=True,
            name="isoforest-stream-listener",
        )
        self._thread.start()
        self.address = self.server.server_address[:2]

    @property
    def port(self) -> int:
        return int(self.address[1])

    def stop(self) -> None:
        if not self._stopped.is_set():
            self._stopped.set()
            self.server.shutdown()
            self.server.server_close()

    def _done(self) -> bool:
        return self._stopped.is_set() or (
            self._should_stop is not None and self._should_stop()
        )

    def batches(self) -> Iterator[StreamBatch]:
        lines: "queue.Queue[str]" = self.server.lines  # type: ignore[attr-defined]
        buf: List[str] = []
        while True:
            try:
                buf.append(lines.get(timeout=self.idle_s))
                if len(buf) < self.chunk_rows:
                    continue
            except queue.Empty:
                if self._done() and lines.empty():
                    break
            if buf:
                yield parse_lines(buf, self.labeled)
                buf = []
        if buf:
            yield parse_lines(buf, self.labeled)
        self.stop()


def socket_source(
    port: int,
    host: str = "127.0.0.1",
    *,
    labeled: bool = False,
    chunk_rows: int = 1024,
    idle_s: float = 0.25,
    should_stop: Optional[Callable[[], bool]] = None,
) -> SocketFeed:
    """Bind the TCP line-protocol listener; iterate ``feed.batches()``."""
    return SocketFeed(
        port,
        host,
        labeled=labeled,
        chunk_rows=chunk_rows,
        idle_s=idle_s,
        should_stop=should_stop,
    )
