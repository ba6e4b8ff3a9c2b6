"""The flight recorder of the port (``isoforest_tpu/telemetry/journal.py``,
copied: it is stdlib only): a per-process append-only NDJSON spool.

Every in-memory telemetry plane (the trace ring, the event timeline, the
metrics registry) dies with its process, and the replicated tier exists
because processes die. With ``--journal-dir`` or
``ISOFOREST_TPU_JOURNAL_DIR`` set, every recorded event (degradation rungs
included: they go through ``record_event``) and every committed trace is
also appended to an on-disk spool, so the tier's ``/debug/bundle`` reads a
SIGKILLed replica's last records off disk.

Spool layout, one directory a process under the journal root::

    <journal_dir>/<name>/segment-00000.ndjson
    <journal_dir>/<name>/segment-00001.ndjson      # rotated by size
    ...

Each line is one JSON record: ``{"type": "open", ...}`` when a segment
starts, ``{"type": "event", "seq", "unix_s", "kind", ...}`` an event,
``{"type": "trace", "trace": {...}}`` a committed trace (the whole ring
entry: root, spans, links). Writes are flushed a record (a kill -9 loses
at most the record being written) and fsynced every ``fsync_every``
records; segments rotate at ``max_segment_bytes`` and the oldest past
``max_segments`` are deleted. The reader counts a torn final line
(``torn_tail``) and never raises on it. The spool is the JAX package's
byte layout, record for record: each package reads the other's.

Activation installs two sinks, the event tap
(:func:`..events.set_event_sink`) and the trace-commit tap
(:func:`..spans.set_trace_commit_sink`, called outside the trace-ring lock);
both are None while no journal is active.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

from . import events as _events
from . import spans as _spans

JOURNAL_DIR_ENV = "ISOFOREST_TPU_JOURNAL_DIR"
JOURNAL_NAME_ENV = "ISOFOREST_TPU_JOURNAL_NAME"
JOURNAL_FSYNC_ENV = "ISOFOREST_TPU_JOURNAL_FSYNC_EVERY"
JOURNAL_SEGMENT_ENV = "ISOFOREST_TPU_JOURNAL_SEGMENT_BYTES"

DEFAULT_SEGMENT_BYTES = 4 << 20  # rotate spool segments at 4 MiB
DEFAULT_FSYNC_EVERY = 64         # fsync cadence in records (0 = never)
DEFAULT_MAX_SEGMENTS = 8         # keep at most this many segments per spool

SEGMENT_PREFIX = "segment-"
SEGMENT_SUFFIX = ".ndjson"


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    return default


class Journal:
    """One process's append-only spool under ``<root>/<name>/``.

    Thread-safe: the event tap fires from any instrumented thread and the
    trace tap from whichever thread completes a root span. A journal that
    hits an OS error (disk full, directory removed) disarms itself after
    logging once — flight recording must never take the plane down."""

    def __init__(
        self,
        root: str,
        name: str,
        *,
        max_segment_bytes: Optional[int] = None,
        fsync_every: Optional[int] = None,
        max_segments: int = DEFAULT_MAX_SEGMENTS,
    ) -> None:
        self.root = str(root)
        self.name = str(name)
        self.spool_dir = os.path.join(self.root, self.name)
        self.max_segment_bytes = int(
            max_segment_bytes
            if max_segment_bytes is not None
            else _env_int(JOURNAL_SEGMENT_ENV, DEFAULT_SEGMENT_BYTES)
        )
        self.fsync_every = int(
            fsync_every
            if fsync_every is not None
            else _env_int(JOURNAL_FSYNC_ENV, DEFAULT_FSYNC_EVERY)
        )
        self.max_segments = max(1, int(max_segments))
        self._lock = threading.Lock()
        self._fh = None
        self._segment_index = 0
        self._segment_bytes = 0
        self._records = 0
        self._fsyncs = 0
        self._since_fsync = 0
        self._broken = False
        os.makedirs(self.spool_dir, exist_ok=True)
        # resume after the highest existing segment: a restarted replica
        # appends a new segment instead of clobbering its own history
        existing = _segment_indices(self.spool_dir)
        self._segment_index = (existing[-1] + 1) if existing else 0
        self._open_segment()

    # ------------------------------------------------------------ writing #

    def _segment_path(self, index: int) -> str:
        return os.path.join(
            self.spool_dir, f"{SEGMENT_PREFIX}{index:05d}{SEGMENT_SUFFIX}"
        )

    def _open_segment(self) -> None:
        self._fh = open(self._segment_path(self._segment_index), "a")
        self._segment_bytes = self._fh.tell()
        header = {
            "type": "open",
            "name": self.name,
            "pid": os.getpid(),
            "unix_s": round(time.time(), 3),
            "segment": self._segment_index,
        }
        self._write_locked(json.dumps(header, sort_keys=True) + "\n")

    def _rotate_locked(self) -> None:
        self._fh.close()
        self._segment_index += 1
        self._open_segment()
        indices = _segment_indices(self.spool_dir)
        for index in indices[: max(0, len(indices) - self.max_segments)]:
            try:
                os.unlink(self._segment_path(index))
            except OSError:
                pass  # already gone / racing reader: retention is best-effort

    def _write_locked(self, line: str) -> None:
        self._fh.write(line)
        # flush per record: a kill -9 victim's spool is complete up to the
        # record in flight (page cache survives process death; only a
        # machine crash needs the fsync cadence below)
        self._fh.flush()
        self._segment_bytes += len(line.encode("utf-8"))
        self._since_fsync += 1
        if self.fsync_every and self._since_fsync >= self.fsync_every:
            os.fsync(self._fh.fileno())
            self._fsyncs += 1
            self._since_fsync = 0

    def append(self, doc: dict) -> None:
        """Append one record; errors disarm the journal (logged once)."""
        if self._broken:
            return
        try:
            line = json.dumps(doc, sort_keys=True, default=repr) + "\n"
        except (TypeError, ValueError):
            return  # an unserialisable record must not kill the recorder
        try:
            with self._lock:
                if self._fh is None:
                    return
                if (
                    self._segment_bytes + len(line) > self.max_segment_bytes
                    and self._segment_bytes > 0
                ):
                    self._rotate_locked()
                self._write_locked(line)
                self._records += 1
        except OSError as exc:
            self._broken = True
            from ..utils.logging import logger

            logger.warning(
                "journal %s disarmed after write failure: %r", self.spool_dir, exc
            )

    def state(self) -> dict:
        """Spool accounting for ``/debug/bundle`` and the bench gate."""
        with self._lock:
            return {
                "name": self.name,
                "spool_dir": self.spool_dir,
                "segment": self._segment_index,
                "segment_bytes": self._segment_bytes,
                "records": self._records,
                "fsyncs": self._fsyncs,
                "fsync_every": self.fsync_every,
                "max_segment_bytes": self.max_segment_bytes,
                "max_segments": self.max_segments,
                "broken": self._broken,
            }

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


# --------------------------------------------------------------------------- #
# reading: torn-tail-tolerant spool recovery
# --------------------------------------------------------------------------- #


def _segment_indices(spool_dir: str) -> List[int]:
    out = []
    try:
        names = os.listdir(spool_dir)
    except OSError:
        return []
    for name in names:
        if name.startswith(SEGMENT_PREFIX) and name.endswith(SEGMENT_SUFFIX):
            try:
                out.append(int(name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)]))
            except ValueError:
                continue
    return sorted(out)


def read_spool(spool_dir: str, tail: Optional[int] = None) -> dict:
    """Recover one spool off disk — the dead replica's flight recorder.

    Returns ``{"name", "records", "segments", "torn_tail", "skipped_lines"}``.
    A final line that fails to parse in the LAST segment is the torn tail a
    kill -9 mid-write leaves; it is counted, never raised. Unparseable
    lines elsewhere count as ``skipped_lines``. ``tail`` keeps only the
    newest N records (the bundle embeds a bounded view)."""
    indices = _segment_indices(spool_dir)
    records: List[dict] = []
    torn_tail = False
    skipped = 0
    for pos, index in enumerate(indices):
        path = os.path.join(
            spool_dir, f"{SEGMENT_PREFIX}{index:05d}{SEGMENT_SUFFIX}"
        )
        try:
            with open(path) as fh:
                lines = fh.read().split("\n")
        except OSError:
            continue
        last_segment = pos == len(indices) - 1
        for line_no, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                if last_segment and line_no >= len(lines) - 2:
                    # the final (possibly newline-less) line of the newest
                    # segment: the kill -9 signature, tolerated by design
                    torn_tail = True
                else:
                    skipped += 1
    if tail is not None and tail >= 0:
        records = records[-tail:] if tail else []
    return {
        "name": os.path.basename(spool_dir.rstrip("/")),
        "records": records,
        "segments": len(indices),
        "torn_tail": torn_tail,
        "skipped_lines": skipped,
    }


def list_spools(journal_dir: str) -> List[str]:
    """Spool names (one per process that journaled) under a journal root."""
    try:
        names = os.listdir(journal_dir)
    except OSError:
        return []
    return sorted(
        n for n in names
        if os.path.isdir(os.path.join(journal_dir, n))
        and _segment_indices(os.path.join(journal_dir, n))
    )


# --------------------------------------------------------------------------- #
# activation: install the event + trace-commit taps
# --------------------------------------------------------------------------- #

_active_lock = threading.Lock()
_ACTIVE: Optional[Journal] = None


def activate_journal(
    journal_dir: str,
    name: Optional[str] = None,
    *,
    max_segment_bytes: Optional[int] = None,
    fsync_every: Optional[int] = None,
) -> Journal:
    """Start flight-recording this process into ``<journal_dir>/<name>/``.

    Installs the event-timeline and trace-commit sinks; replaces any
    previously active journal. ``name`` defaults to
    ``ISOFOREST_TPU_JOURNAL_NAME``, then ``ISOFOREST_TPU_REPLICA_NAME``
    (a spawned replica spools under its tier name), then ``pid-<pid>``."""
    global _ACTIVE
    if name is None:
        name = (
            os.environ.get(JOURNAL_NAME_ENV)
            or os.environ.get("ISOFOREST_TPU_REPLICA_NAME")
            or f"pid-{os.getpid()}"
        )
    journal = Journal(
        journal_dir,
        name,
        max_segment_bytes=max_segment_bytes,
        fsync_every=fsync_every,
    )
    with _active_lock:
        previous, _ACTIVE = _ACTIVE, journal
    if previous is not None:
        previous.close()
    _events.set_event_sink(
        lambda event: journal.append({"type": "event", **event.as_dict()})
    )
    _spans.set_trace_commit_sink(
        lambda entry: journal.append({"type": "trace", "trace": entry})
    )
    _events.record_event(
        "journal.start", name=journal.name, spool_dir=journal.spool_dir,
        fsync_every=journal.fsync_every,
        max_segment_bytes=journal.max_segment_bytes,
    )
    return journal


def deactivate_journal() -> None:
    """Stop flight-recording (idempotent); the spool stays on disk."""
    global _ACTIVE
    with _active_lock:
        journal, _ACTIVE = _ACTIVE, None
    if journal is None:
        return
    # record the stop marker while the sink is still armed so the spool's
    # last record says the process stopped cleanly (a spool WITHOUT it and
    # with a torn tail is the kill -9 signature)
    _events.record_event("journal.stop", name=journal.name,
                         records=journal.state()["records"])
    _events.set_event_sink(None)
    _spans.set_trace_commit_sink(None)
    journal.close()


def active_journal() -> Optional[Journal]:
    """The currently recording journal, if any."""
    return _ACTIVE


def maybe_activate_from_env() -> Optional[Journal]:
    """Auto-activate at package import when ``ISOFOREST_TPU_JOURNAL_DIR``
    is set — the same opt-in pattern as the metrics endpoint. A spool
    failure logs a warning instead of breaking the import."""
    raw = os.environ.get(JOURNAL_DIR_ENV)
    if not raw or _ACTIVE is not None:
        return None
    try:
        return activate_journal(raw)
    except Exception as exc:
        from ..utils.logging import logger

        logger.warning(
            "could not activate the telemetry journal from %s=%r: %s",
            JOURNAL_DIR_ENV, raw, exc,
        )
        return None
