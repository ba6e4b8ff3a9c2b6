"""Nestable, thread-safe span tracer with request-scoped trace context
(``isoforest_tpu/telemetry/spans.py``).

A span times one named region of work::

    from isoforest_tpu_torch import telemetry

    with telemetry.span("fit.grow_block", block=3):
        ...

Each completed span records wall time (``perf_counter``) and process CPU
time (``process_time``), its parent span (per-thread nesting stack), depth,
thread name and any keyword attributes. Completions feed three sinks:

* a bounded in-memory ring of recent :class:`SpanRecord` s (:func:`records`);
* the ``isoforest_span_seconds{span=<name>}`` histogram, which supplies
  per-name count/total/p50/p95/p99 for :func:`summary`;
* the bounded **trace ring**: spans sharing a ``trace_id`` assemble into
  one trace, committed when its root span completes and queryable with
  :func:`get_trace` / :func:`recent_traces`.

Every span carries ``trace_id`` / ``span_id`` / ``parent_id``, from a
seeded per-process counter (``ISOFOREST_TPU_TRACE_SEED``; default the pid),
never ``random``; :func:`seed_trace_ids` gives the JAX package's ids for the
same seed. A root span (empty per-thread stack, no ambient context) mints a
fresh trace; children inherit. Causality across threads is explicit: capture
:func:`current_context` on one thread and adopt it with :func:`with_context`
on another, or declare span **links** (``span(..., links=[ctx, ...])``).
The trace ring keeps traces whose root took at least ``slow_threshold_s``
and roots that declare links, and one in ``sample_every`` of the rest
(:func:`set_trace_policy`); bounds drop with exact accounting
(:func:`trace_stats`, ``isoforest_traces_total{outcome=}``).

The changes from the JAX package: a span is also a
``torch.profiler.record_function`` range (the JAX package's
``jax.profiler.TraceAnnotation``), so a torch.profiler trace shows the same
names nested as the spans are. The port annotates every span unless
``annotate=False``, and only while a profiler records. And a span can be cut
into **stages** without adding records: ``sp.mark("pack")`` starts the stage
``pack`` at a ``time.time_ns()`` reading, and it ends at the next mark or at
the span's end, read on the same clock. A span that was marked records
``stages=[[name, start_ns, end_ns], ...]`` (integer Unix nanoseconds, the
clock ``torch.profiler`` maps its events to) among its attributes;
``start_unix_s`` comes from the same start reading, so within a span
start <= first stage start <= ... <= last stage end <= end. The executor marks
``wait``/``pack``/``copy``/``launch`` in each ``pipeline.chunk`` span
(``ops/streaming.py``) and ``score_matrix`` marks
``prepare``/``execute``/``finish``.

When telemetry is disabled (:mod:`._state`) :func:`span` returns a shared
no-op context manager: no clocks, no locks, no ids, no profiler range, no
stages.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from . import _state
from .metrics import DEFAULT_LATENCY_BUCKETS, counter, histogram

# Completed-span ring size: big enough for a 1000-tree checkpointed fit
# (~32 sealed blocks) and its scoring, small enough to stay O(100 KB).
MAX_RECORDS = 512

# Trace-ring bounds: committed traces kept for
# /trace queries, spans buffered per not-yet-complete trace, and distinct
# open traces — all drop-oldest with exact accounting in trace_stats().
MAX_TRACES = 128
MAX_TRACE_SPANS = 256
MAX_OPEN_TRACES = 256

TRACE_SEED_ENV = "ISOFOREST_TPU_TRACE_SEED"
TRACE_SLOW_ENV = "ISOFOREST_TPU_TRACE_SLOW_S"
TRACE_SAMPLE_ENV = "ISOFOREST_TPU_TRACE_SAMPLE"

_SPAN_SECONDS = histogram(
    "isoforest_span_seconds",
    "Wall-clock duration of telemetry spans, by span name",
    labelnames=("span",),
    buckets=DEFAULT_LATENCY_BUCKETS,
)
_TRACES_TOTAL = counter(
    "isoforest_traces_total",
    "Completed traces by capture-policy outcome (kept = committed to the "
    "trace ring; sampled_out = fast trace dropped by the 1-in-N sampler; "
    "ring_dropped = evicted from the bounded ring by a newer trace)",
    labelnames=("outcome",),
)

_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_records_lock = threading.Lock()
_local = threading.local()


# --------------------------------------------------------------------------- #
# trace identity
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """An addressable point in a trace: the handle :func:`current_context`
    captures and :func:`with_context` / span links consume. ``span_id`` is
    None for contexts adopted from a bare trace id (no span identity)."""

    trace_id: str
    span_id: Optional[str] = None


def _seed_default() -> int:
    raw = os.environ.get(TRACE_SEED_ENV)
    if raw:
        try:
            return int(raw)
        except ValueError:
            pass
    return os.getpid()


_ids_lock = threading.Lock()
_id_prefix = f"{_seed_default() & 0xFFFF:04x}"
_id_next = 1


def seed_trace_ids(seed: int) -> None:
    """Re-seed the deterministic id allocator (tests pin this for golden
    traces; production never needs it — the per-process default seed keeps
    ids unique across a fleet of pids)."""
    global _id_prefix, _id_next
    with _ids_lock:
        _id_prefix = f"{int(seed) & 0xFFFF:04x}"
        _id_next = 1


def _next_id() -> str:
    """16-hex-char id from the seeded per-process counter — deterministic,
    no ``random``."""
    global _id_next
    with _ids_lock:
        n = _id_next
        _id_next += 1
    return f"{_id_prefix}{n:012x}"


def _ambient() -> list:
    amb = getattr(_local, "ambient", None)
    if amb is None:
        amb = _local.ambient = []
    return amb


def current_context() -> Optional[TraceContext]:
    """The context a child span (or a cross-thread link) would attach to:
    this thread's innermost OPEN span, else the innermost
    :func:`with_context` adoption, else None."""
    stack = getattr(_local, "stack", None)
    if stack:
        top = stack[-1]
        return TraceContext(top.trace_id, top.span_id)
    amb = getattr(_local, "ambient", None)
    return amb[-1] if amb else None


@contextlib.contextmanager
def with_context(ctx: Optional[TraceContext]):
    """Adopt ``ctx`` as this thread's ambient trace context: spans opened
    under it join ``ctx.trace_id`` (parented to ``ctx.span_id`` when set)
    instead of minting a fresh trace. ``None`` is a no-op adoption, so
    callers can pass an optional handoff straight through."""
    if ctx is None:
        yield None
        return
    amb = _ambient()
    amb.append(ctx)
    try:
        yield ctx
    finally:
        if ctx in amb:  # tolerate exotic exits without corrupting peers
            amb.remove(ctx)


# --------------------------------------------------------------------------- #
# span records
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One completed span."""

    name: str
    parent: Optional[str]
    depth: int
    thread: str
    start_unix_s: float
    wall_s: float
    process_s: float
    attrs: Dict[str, object]
    trace_id: Optional[str] = None
    span_id: Optional[str] = None
    parent_id: Optional[str] = None
    links: Tuple[Tuple[str, Optional[str]], ...] = ()

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "parent": self.parent,
            "depth": self.depth,
            "thread": self.thread,
            "start_unix_s": self.start_unix_s,
            "wall_s": self.wall_s,
            "process_s": self.process_s,
            "attrs": dict(self.attrs),
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "links": [list(link) for link in self.links],
        }


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _NullSpan:
    """Shared do-nothing context manager returned while disabled."""

    __slots__ = ()

    trace_id = None
    span_id = None
    parent_id = None
    stages = ()

    @property
    def context(self) -> None:
        return None

    def set_attrs(self, **attrs: object) -> None:
        pass

    def mark(self, stage: str) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()

def _annotation(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records, else None: a range costs about 10 us a span, which a
    1-row serving call should not pay when nothing traces it."""
    import torch

    if not torch.autograd._profiler_enabled():
        return None
    return torch.profiler.record_function(name)


class _Span:
    __slots__ = (
        "name", "attrs", "parent", "depth", "start_unix_s",
        "trace_id", "span_id", "parent_id", "links", "stages",
        "_t0", "_p0", "_annotation_cm",
    )

    def __init__(
        self,
        name: str,
        annotate: bool,
        attrs: Dict[str, object],
        links: Tuple[Tuple[str, Optional[str]], ...] = (),
    ) -> None:
        self.name = name
        self.attrs = attrs
        self.links = links
        self.stages: List[list] = []  # [name, start_ns, end_ns]; the last one's end is set at exit
        self._annotation_cm = _annotation(name) if annotate else None

    @property
    def context(self) -> TraceContext:
        """This span's addressable context (valid once entered)."""
        return TraceContext(self.trace_id, self.span_id)

    def set_attrs(self, **attrs: object) -> None:
        """Merge attributes into the span after entry — for values only
        known mid-block (resolved strategy, generation, queue wait)."""
        self.attrs.update(attrs)

    def mark(self, stage: str) -> None:
        """Start stage ``stage`` now; it ends at the next mark or at the
        span's end."""
        now = time.time_ns()
        if self.stages:
            self.stages[-1][2] = now
        self.stages.append([stage, now, None])

    def __enter__(self) -> "_Span":
        stack = _stack()
        if stack:
            top = stack[-1]
            self.parent = top.name
            self.trace_id = top.trace_id
            self.parent_id = top.span_id
        else:
            self.parent = None
            amb = getattr(_local, "ambient", None)
            ctx = amb[-1] if amb else None
            if ctx is not None:
                self.trace_id = ctx.trace_id
                self.parent_id = ctx.span_id
            else:
                self.trace_id = _next_id()
                self.parent_id = None
        self.span_id = _next_id()
        self.depth = len(stack)
        stack.append(self)
        if self._annotation_cm is not None:
            self._annotation_cm.__enter__()
        self.start_unix_s = time.time_ns() / 1e9
        self._p0 = time.process_time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.stages:
            self.stages[-1][2] = time.time_ns()
            self.attrs["stages"] = self.stages
        wall = time.perf_counter() - self._t0
        process = time.process_time() - self._p0
        if self._annotation_cm is not None:
            self._annotation_cm.__exit__(exc_type, exc, tb)
        stack = _stack()
        if self in stack:  # tolerate exotic exits without corrupting peers
            stack.remove(self)
        record = SpanRecord(
            name=self.name,
            parent=self.parent,
            depth=self.depth,
            thread=threading.current_thread().name,
            start_unix_s=self.start_unix_s,
            wall_s=wall,
            process_s=process,
            attrs=self.attrs,
            trace_id=self.trace_id,
            span_id=self.span_id,
            parent_id=self.parent_id,
            links=self.links,
        )
        with _records_lock:
            _records.append(record)
        _trace_sink(record)
        _SPAN_SECONDS.observe(wall, span=self.name)
        return False


def span(
    name: str,
    annotate: bool = True,
    links: Iterable[Optional[TraceContext]] = (),
    **attrs: object,
):
    """Context manager timing the enclosed block as span ``name``.

    ``annotate`` (default on) also wraps the block in a
    ``torch.profiler.record_function`` range. ``links`` declares peer references to
    other spans' :class:`TraceContext` s (a shared flush links every
    request it served: causality without parentage). Extra keyword
    arguments are recorded verbatim as span attributes (keep them
    JSON-serialisable). Returns a shared no-op when telemetry is disabled.
    """
    if not _state.enabled():
        return _NULL_SPAN
    link_tuple = tuple(
        (c.trace_id, c.span_id) for c in links if c is not None
    )
    return _Span(name, annotate, attrs, link_tuple)


def current_span_name() -> Optional[str]:
    """Name of this thread's innermost open span (None outside any span)."""
    stack = getattr(_local, "stack", None)
    return stack[-1].name if stack else None


def set_span_attrs(**attrs: object) -> None:
    """Merge attributes into this thread's innermost OPEN span; no-op
    outside any span or while disabled. The handoff for layers that know a
    value mid-flight (``score_matrix`` resolves the strategy inside the
    flush; the service knows the generation after scoring)."""
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].attrs.update(attrs)


def records(name: Optional[str] = None) -> List[SpanRecord]:
    """Recent completed spans, oldest first (bounded at
    :data:`MAX_RECORDS`); optionally filtered by name."""
    with _records_lock:
        out = list(_records)
    if name is not None:
        out = [r for r in out if r.name == name]
    return out


def summary() -> Dict[str, dict]:
    """Per-span-name aggregate: count, total/max wall seconds and
    bucket-estimated p50/p95/p99 from the backing histogram."""
    out: Dict[str, dict] = {}
    for series in _SPAN_SECONDS.snapshot()["series"]:
        name = series["labels"]["span"]
        stats = _SPAN_SECONDS.summary(span=name)
        out[name] = {
            "count": stats["count"],
            "total_wall_s": stats["sum"],
            "max_wall_s": stats["max"],
            "p50_s": stats["p50"],
            "p95_s": stats["p95"],
            "p99_s": stats["p99"],
        }
    return out


def reset_spans() -> None:
    """Drop recorded spans (the backing histogram is cleared by
    ``metrics.reset_metrics`` / ``telemetry.reset``)."""
    with _records_lock:
        _records.clear()


# --------------------------------------------------------------------------- #
# trace ring: assemble spans into traces, commit at root completion
# --------------------------------------------------------------------------- #


def _policy_defaults() -> Dict[str, object]:
    try:
        slow_s = float(os.environ.get(TRACE_SLOW_ENV, 0.25))
    except ValueError:
        slow_s = 0.25
    try:
        sample_every = max(1, int(os.environ.get(TRACE_SAMPLE_ENV, 1)))
    except ValueError:
        sample_every = 1
    return {"slow_threshold_s": slow_s, "sample_every": sample_every}


_traces_lock = threading.Lock()
_open_traces: "collections.OrderedDict[str, List[SpanRecord]]" = (
    collections.OrderedDict()
)
_trace_ring: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
_linked_from: Dict[str, set] = {}
_policy: Dict[str, object] = _policy_defaults()
_sample_seq = 0
_trace_stats: Dict[str, int] = {
    "kept": 0,
    "sampled_out": 0,
    "ring_dropped": 0,
    "open_dropped": 0,
    "span_dropped": 0,
}


def set_trace_policy(
    slow_threshold_s: Optional[float] = None,
    sample_every: Optional[int] = None,
) -> Dict[str, object]:
    """Adjust the slow-request capture policy:
    traces whose root span is slower than ``slow_threshold_s`` (and roots
    declaring links — the shared flush) are ALWAYS kept; the rest are kept
    one-in-``sample_every`` (1 = keep everything, the default). Returns
    the effective policy."""
    with _traces_lock:
        if slow_threshold_s is not None:
            _policy["slow_threshold_s"] = float(slow_threshold_s)
        if sample_every is not None:
            _policy["sample_every"] = max(1, int(sample_every))
        return dict(_policy)


# the journal's write-through tap (:mod:`.journal`): each committed trace-ring
# entry is also handed to the sink, outside ``_traces_lock``, so spool I/O
# never blocks span completion
_TRACE_COMMIT_SINK: Optional[Callable[[dict], None]] = None


def set_trace_commit_sink(sink: Optional[Callable[[dict], None]]) -> None:
    """Install (or clear, with None) the trace-commit sink. It receives the
    committed ring entry (trace_id, root, spans, ...); its exceptions are
    swallowed: recording must never break tracing."""
    global _TRACE_COMMIT_SINK
    _TRACE_COMMIT_SINK = sink


def _trace_sink(record: SpanRecord) -> None:
    if record.trace_id is None:
        return
    committed_entry = None
    with _traces_lock:
        committed = _trace_ring.get(record.trace_id)
        if committed is not None:
            # a cross-thread child completing after its trace committed
            # (with_context adoption): append late instead of losing it
            if len(committed["spans"]) < MAX_TRACE_SPANS:
                committed["spans"].append(record.as_dict())
            else:
                _trace_stats["span_dropped"] += 1
            return
        spans_list = _open_traces.get(record.trace_id)
        if spans_list is None:
            while len(_open_traces) >= MAX_OPEN_TRACES:
                _open_traces.popitem(last=False)
                _trace_stats["open_dropped"] += 1
            spans_list = _open_traces.setdefault(record.trace_id, [])
        if len(spans_list) >= MAX_TRACE_SPANS:
            _trace_stats["span_dropped"] += 1
        else:
            spans_list.append(record)
        if record.parent_id is None:
            entry = _finalize_locked(record)
            if entry is not None:
                # copied under the lock: a late child appends to the ring's
                # list, never to the copy the sink serialises after release
                committed_entry = dict(entry, spans=list(entry["spans"]))
    sink = _TRACE_COMMIT_SINK
    if committed_entry is not None and sink is not None:
        try:
            sink(committed_entry)
        except Exception:
            pass  # the recorder must never take the traced path down


def _finalize_locked(root: SpanRecord) -> Optional[dict]:
    """Root span completed: apply the capture policy and commit (or drop)
    the trace. Caller holds ``_traces_lock``. Returns the committed ring
    entry (for the trace-commit sink, called after the lock is released),
    or None when the trace was sampled out."""
    global _sample_seq
    spans_list = _open_traces.pop(root.trace_id, [])
    slow = root.wall_s >= float(_policy["slow_threshold_s"])
    keep = slow or bool(root.links)
    if not keep:
        _sample_seq += 1
        keep = _sample_seq % int(_policy["sample_every"]) == 0
    if not keep:
        _trace_stats["sampled_out"] += 1
        _TRACES_TOTAL.inc(outcome="sampled_out")
        return None
    entry = {
        "trace_id": root.trace_id,
        "root": root.name,
        "root_span_id": root.span_id,
        "start_unix_s": root.start_unix_s,
        "wall_s": root.wall_s,
        "slow": slow,
        "spans": [r.as_dict() for r in spans_list],
    }
    _trace_ring[root.trace_id] = entry
    for r in spans_list:
        for target_trace, _target_span in r.links:
            if target_trace != root.trace_id:
                _linked_from.setdefault(target_trace, set()).add(root.trace_id)
    while len(_trace_ring) > MAX_TRACES:
        old_id, _ = _trace_ring.popitem(last=False)
        _linked_from.pop(old_id, None)
        _trace_stats["ring_dropped"] += 1
        _TRACES_TOTAL.inc(outcome="ring_dropped")
    _trace_stats["kept"] += 1
    _TRACES_TOTAL.inc(outcome="kept")
    return entry


def get_trace(trace_id: str, include_linked: bool = True) -> Optional[dict]:
    """One trace's spans (plain JSON types), or None when unknown (never
    captured, sampled out, or evicted). ``include_linked`` attaches the
    spans of link-adjacent committed traces — for a request trace that is
    the flush trace that served it (flush span + its strategy / per-chunk
    children), so the full causal path reconstructs from one call."""
    with _traces_lock:
        entry = _trace_ring.get(trace_id)
        if entry is not None:
            doc = dict(entry)
            doc["spans"] = list(entry["spans"])
            doc["complete"] = True
        else:
            open_spans = _open_traces.get(trace_id)
            if open_spans is None:
                return None
            doc = {
                "trace_id": trace_id,
                "root": None,
                "root_span_id": None,
                "start_unix_s": min(r.start_unix_s for r in open_spans),
                "wall_s": None,
                "slow": False,
                "spans": [r.as_dict() for r in open_spans],
                "complete": False,
            }
        if include_linked:
            adjacent = set(_linked_from.get(trace_id, ()))
            for s in doc["spans"]:
                for target_trace, _target_span in s["links"]:
                    adjacent.add(target_trace)
            adjacent.discard(trace_id)
            doc["linked"] = [
                {
                    "trace_id": t,
                    "root": _trace_ring[t]["root"],
                    "spans": list(_trace_ring[t]["spans"]),
                }
                for t in sorted(adjacent)
                if t in _trace_ring
            ]
        return doc


def recent_traces(limit: int = 20) -> List[dict]:
    """Newest-first summaries of committed traces (bounded by the ring)."""
    with _traces_lock:
        entries = list(_trace_ring.values())
    out = []
    for entry in reversed(entries[-max(0, int(limit)):] if limit else entries):
        out.append(
            {
                "trace_id": entry["trace_id"],
                "root": entry["root"],
                "start_unix_s": entry["start_unix_s"],
                "wall_s": entry["wall_s"],
                "slow": entry["slow"],
                "spans": len(entry["spans"]),
                "links": sum(len(s["links"]) for s in entry["spans"]),
            }
        )
    return out


def trace_stats() -> dict:
    """Exact trace-ring accounting: policy outcomes, bound drops, current
    occupancy and the effective capture policy."""
    with _traces_lock:
        doc = dict(_trace_stats)
        doc["ring_size"] = len(_trace_ring)
        doc["open_traces"] = len(_open_traces)
        doc["policy"] = dict(_policy)
    return doc


def reset_traces() -> None:
    """Drop all committed and in-flight traces and zero the accounting
    (the ``isoforest_traces_total`` counter is cleared by
    ``metrics.reset_metrics`` / ``telemetry.reset``)."""
    global _sample_seq
    with _traces_lock:
        _open_traces.clear()
        _trace_ring.clear()
        _linked_from.clear()
        _sample_seq = 0
        for key in _trace_stats:
            _trace_stats[key] = 0
