"""Telemetry of the port (``isoforest_tpu/telemetry``): the process-wide
on/off switch, the event timeline, the metrics registry (counters, gauges,
histograms), spans and traces (:mod:`.spans`, each span also a
``torch.profiler`` range), the drift baseline and monitor (:mod:`.monitor`),
forest diagnostics (:mod:`.diagnostics`), the exporters (:mod:`.export`:
the JSON snapshot, Prometheus text and Chrome trace JSON, byte for byte the
JAX package's), resource accounting (:mod:`.resources`: kernel and table
builds counted as compiles, staging and plane bytes, the debug bundle) and
the HTTP daemon (:mod:`.http`: ``/metrics``, ``/healthz``, ``/snapshot``,
``/trace``, ``/traces/recent``, ``/debug/bundle`` and the routes serving
mounts), the flight recorder (:mod:`.journal`: every event and committed
trace appended to an NDJSON spool on disk, read back by :func:`read_spool`)
and federation (:mod:`.federation`: the pure merges under the replicated
tier's endpoints).

Setting ``ISOFOREST_TPU_METRICS_PORT`` before import starts the HTTP daemon
on that port, and ``ISOFOREST_TPU_JOURNAL_DIR`` starts the journal there,
as in the JAX package.
"""

from ._state import disable, enable, enabled
from .diagnostics import forest_diagnostics, publish_gauges
from .events import Event, EventTimeline, get_events, record_event, reset_events, set_event_sink, timeline
from .export import (
    parse_prometheus,
    reset,
    snapshot,
    snapshot_json,
    to_chrome_trace,
    to_chrome_trace_json,
    to_prometheus,
)
from .federation import (
    BucketMismatchError,
    DuplicateSourceError,
    FederationError,
    MetricTypeConflictError,
    federated_chrome,
    federated_trace_spans,
    merge_events,
    merge_metrics,
    merge_recent_traces,
    merge_snapshots,
    metrics_to_prometheus,
)
from .http import MetricsServer, active_server, maybe_serve_from_env, serve
from .journal import Journal, activate_journal, active_journal, deactivate_journal, list_spools, read_spool
from .metrics import (
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    exponential_buckets,
    gauge,
    histogram,
    registry,
    reset_metrics,
)
from .monitor import Baseline, ScoreMonitor, StreamBaseline, capture_baseline, ks, psi
from .resources import (
    BUNDLE_SCHEMA,
    BUNDLE_SECTIONS,
    build_bundle,
    compile_counts,
    compile_log,
    compile_scope,
    compile_seconds_total,
    disable_resources,
    enable_resources,
    mark_steady,
    mark_warmup,
    memory_watermarks,
    model_plane_bytes,
    note_host_staging,
    peak_host_staging_bytes,
    reset_resources,
    resident_plane_bytes,
    resources_enabled,
    warmup_scope,
    write_bundle,
)
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
    set_trace_commit_sink,
    set_trace_policy,
    span,
    trace_stats,
    with_context,
)
from .spans import records as span_records
from .spans import summary as span_summary

__all__ = [
    "BUNDLE_SCHEMA", "BUNDLE_SECTIONS", "Baseline", "BucketMismatchError", "Counter", "DEFAULT_LATENCY_BUCKETS",
    "DuplicateSourceError", "Event", "EventTimeline", "FederationError", "Gauge", "Histogram", "Journal",
    "MetricTypeConflictError", "MetricsRegistry", "MetricsServer", "ScoreMonitor", "SpanRecord", "StreamBaseline",
    "TraceContext", "activate_journal", "active_journal", "active_server", "build_bundle", "capture_baseline",
    "compile_counts", "compile_log", "compile_scope", "compile_seconds_total", "counter", "current_context",
    "current_span_name", "deactivate_journal", "disable", "disable_resources", "enable", "enable_resources",
    "enabled", "exponential_buckets", "federated_chrome", "federated_trace_spans", "forest_diagnostics", "gauge",
    "get_events", "get_trace", "histogram", "ks", "list_spools", "mark_steady", "mark_warmup",
    "maybe_serve_from_env", "memory_watermarks", "merge_events", "merge_metrics", "merge_recent_traces",
    "merge_snapshots", "metrics_to_prometheus", "model_plane_bytes", "note_host_staging", "parse_prometheus",
    "peak_host_staging_bytes", "psi", "publish_gauges", "read_spool", "recent_traces", "record_event", "registry",
    "reset", "reset_events", "reset_metrics", "reset_resources", "reset_spans", "reset_traces",
    "resident_plane_bytes", "resources_enabled", "seed_trace_ids", "serve", "set_event_sink", "set_span_attrs",
    "set_trace_commit_sink", "set_trace_policy", "snapshot", "snapshot_json", "span", "span_records",
    "span_summary", "timeline", "to_chrome_trace", "to_chrome_trace_json", "to_prometheus", "trace_stats",
    "warmup_scope", "with_context", "write_bundle",
]

# the live endpoint's opt-in: with ISOFOREST_TPU_METRICS_PORT set, any
# process that imports the package serves its telemetry
maybe_serve_from_env()

# the flight recorder's opt-in: with ISOFOREST_TPU_JOURNAL_DIR set, any
# process that imports the package spools its events and traces there
from .journal import maybe_activate_from_env as _maybe_activate_journal  # noqa: E402

_maybe_activate_journal()
