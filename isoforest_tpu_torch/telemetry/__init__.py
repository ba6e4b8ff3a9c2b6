"""Telemetry of the port (``isoforest_tpu/telemetry``): the process-wide
on/off switch, the event timeline, the metrics registry (counters, gauges,
histograms), spans and traces (:mod:`.spans`, each span also a
``torch.profiler`` range), the drift baseline and monitor (:mod:`.monitor`)
and forest diagnostics (:mod:`.diagnostics`). Export (Chrome and Prometheus),
HTTP, the journal, federation and resource accounting are not ported."""

from ._state import disable, enable, enabled
from .events import Event, get_events, record_event, reset_events
from .metrics import DEFAULT_LATENCY_BUCKETS, Histogram, counter, gauge, histogram, registry, reset_metrics
from .spans import (
    SpanRecord,
    TraceContext,
    current_context,
    current_span_name,
    get_trace,
    recent_traces,
    reset_spans,
    reset_traces,
    seed_trace_ids,
    set_span_attrs,
    set_trace_policy,
    span,
    trace_stats,
    with_context,
)
from .spans import records as span_records
from .spans import summary as span_summary


def reset() -> None:
    """Clear recorded events, every metric series, spans and traces (tests, operators)."""
    reset_events()
    reset_metrics()
    reset_spans()
    reset_traces()


__all__ = [
    "DEFAULT_LATENCY_BUCKETS", "Event", "Histogram", "SpanRecord", "TraceContext", "counter", "current_context",
    "current_span_name", "disable", "enable", "enabled", "gauge", "get_events", "get_trace", "histogram",
    "recent_traces", "record_event", "registry", "reset", "reset_events", "reset_metrics", "reset_spans",
    "reset_traces", "seed_trace_ids", "set_span_attrs", "set_trace_policy", "span", "span_records",
    "span_summary", "trace_stats", "with_context",
]
