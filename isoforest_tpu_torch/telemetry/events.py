"""One ordered, timestamped event timeline for the process
(``isoforest_tpu/telemetry/events.py``).

Every discrete operational fact of the port is appended here with a
process-wide increasing sequence number: a degradation rung taken (a
dropped-tree load, a drift alert), a checkpoint begun, a block sealed,
resumed or regrown. The timeline is bounded (:data:`MAX_EVENTS`, drop
oldest, with an exact ``dropped`` count) and thread-safe. With telemetry
off, :func:`record_event` drops the event and returns None;
``model.degradations()`` keeps its own counts either way.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from . import _state

MAX_EVENTS = 4096

# the journal's write-through tap (:mod:`.journal`): every recorded event is
# also handed to the sink, outside the timeline lock, so file I/O never
# blocks a producer; None costs one load
_EVENT_SINK: Optional[Callable[["Event"], None]] = None


def set_event_sink(sink: Optional[Callable[["Event"], None]]) -> None:
    """Install (or clear, with None) the process-wide event sink. Its
    exceptions are swallowed: recording must never break the recorded path."""
    global _EVENT_SINK
    _EVENT_SINK = sink


@dataclasses.dataclass(frozen=True)
class Event:
    """One timeline entry: ``seq`` orders events across all threads."""

    seq: int
    unix_s: float
    kind: str
    fields: Dict[str, object]

    def as_dict(self) -> dict:
        return {"seq": self.seq, "unix_s": self.unix_s, "kind": self.kind, **self.fields}


class EventTimeline:
    """Bounded, ordered, thread-safe event store."""

    def __init__(self, maxlen: int = MAX_EVENTS) -> None:
        self._lock = threading.Lock()
        self._maxlen = int(maxlen)
        self._events: List[Event] = []
        self._next_seq = 0
        self._dropped = 0

    def record(self, kind: str, **fields: object) -> Optional[Event]:
        if not _state.enabled():
            return None
        with self._lock:
            event = Event(seq=self._next_seq, unix_s=time.time(), kind=str(kind), fields=fields)
            self._next_seq += 1
            self._events.append(event)
            if len(self._events) > self._maxlen:
                overflow = len(self._events) - self._maxlen
                del self._events[:overflow]
                self._dropped += overflow
        sink = _EVENT_SINK
        if sink is not None:
            try:
                sink(event)
            except Exception:
                pass  # the recorder must never take the recorded path down
        return event

    def events(self, kind: Optional[str] = None, since_seq: Optional[int] = None) -> List[Event]:
        with self._lock:
            out = list(self._events)
        if kind is not None:
            out = [e for e in out if e.kind == kind]
        if since_seq is not None:
            out = [e for e in out if e.seq > since_seq]
        return out

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        """Drop stored events; the sequence counter keeps advancing, so
        ordering stays valid across a clear."""
        with self._lock:
            self._events.clear()
            self._dropped = 0


_TIMELINE = EventTimeline()


def record_event(kind: str, **fields: object) -> Optional[Event]:
    """Append one event and return it (None with telemetry off). Field
    values should be JSON-serialisable."""
    return _TIMELINE.record(kind, **fields)


def timeline() -> EventTimeline:
    """The process-wide timeline (its ``dropped`` count feeds snapshots)."""
    return _TIMELINE


def get_events(kind: Optional[str] = None, since_seq: Optional[int] = None) -> List[Event]:
    """Recorded events in order; optionally of one kind, or after a sequence number."""
    return _TIMELINE.events(kind=kind, since_seq=since_seq)


def reset_events() -> None:
    _TIMELINE.clear()
