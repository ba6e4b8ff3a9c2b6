"""Telemetry exporters of the port (``isoforest_tpu/telemetry/export.py``,
copied: it is stdlib only): the JSON snapshot, the Prometheus text
exposition and the Chrome trace-event JSON.

``snapshot()`` holds telemetry's state, per-span aggregates, the recent
spans, every metric series, the ordered event timeline and the trace
ring's counts, all as plain JSON types. ``to_prometheus()`` renders the
metrics registry in the Prometheus text format 0.0.4 (``# HELP``/``# TYPE``
headers, sorted label sets, cumulative ``le`` buckets with ``_sum`` and
``_count``); :func:`parse_prometheus` is the matching minimal parser.
``to_chrome_trace()`` renders one committed trace (and its link-adjacent
traces) as Chrome trace-event JSON: ``ph:"X"`` complete events, one
``tid`` lane a thread named by ``ph:"M"`` metadata, and ``ph:"s"``/``ph:"f"``
flow arrows for every request-to-flush span link; Perfetto and
``chrome://tracing`` load it. For the same registry and the same trace
the output equals the JAX package's byte for byte (the ``producer`` field
included), so one dashboard and one trace viewer read both packages.
"""

from __future__ import annotations

import json
import math
import time
from typing import Dict, Optional, Tuple

from . import _state, events, metrics, spans

# how many trailing SpanRecords snapshot() embeds; the full bounded ring
# stays queryable via spans.records()
SNAPSHOT_RECENT_SPANS = 64


def snapshot() -> dict:
    """Everything telemetry knows, as plain JSON types."""
    timeline = events.timeline()
    return {
        "telemetry_enabled": _state.enabled(),
        "generated_unix_s": round(time.time(), 3),
        "spans": spans.summary(),
        "recent_spans": [
            r.as_dict() for r in spans.records()[-SNAPSHOT_RECENT_SPANS:]
        ],
        "metrics": metrics.registry().snapshot(),
        "events": [e.as_dict() for e in events.get_events()],
        "events_dropped": timeline.dropped,
        "traces": spans.trace_stats(),
    }


def snapshot_json(indent: Optional[int] = None) -> str:
    return json.dumps(snapshot(), indent=indent, sort_keys=True)


# --------------------------------------------------------------------------- #
# Prometheus text exposition
# --------------------------------------------------------------------------- #


def _format_value(value: float) -> str:
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if math.isnan(value):  # pragma: no cover - nothing here produces NaN
        return "NaN"
    if float(value) == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_labels(labels: Dict[str, str], extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = [*sorted(labels.items()), *extra]
    if not items:
        return ""
    body = ",".join(
        f'{name}="{_escape_label_value(str(value))}"' for name, value in items
    )
    return "{" + body + "}"


def to_prometheus(registry: Optional[metrics.MetricsRegistry] = None) -> str:
    """Prometheus text-format exposition of the (default: process-wide)
    metrics registry."""
    registry = registry if registry is not None else metrics.registry()
    lines = []
    for metric in registry.metrics():
        snap = metric.snapshot()
        if metric.help:
            lines.append(f"# HELP {metric.name} {metric.help}")
        lines.append(f"# TYPE {metric.name} {snap['type']}")
        for series in snap["series"]:
            labels = series["labels"]
            if snap["type"] == "histogram":
                cumulative = 0
                for bound, count in series["buckets"]:
                    cumulative += count
                    le = bound if bound == "+Inf" else _format_value(float(bound))
                    lines.append(
                        f"{metric.name}_bucket"
                        f"{_format_labels(labels, (('le', le),))} {cumulative}"
                    )
                lines.append(
                    f"{metric.name}_sum{_format_labels(labels)} "
                    f"{_format_value(series['sum'])}"
                )
                lines.append(
                    f"{metric.name}_count{_format_labels(labels)} {series['count']}"
                )
            else:
                lines.append(
                    f"{metric.name}{_format_labels(labels)} "
                    f"{_format_value(series['value'])}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus(text: str) -> Dict[str, Dict[Tuple[Tuple[str, str], ...], float]]:
    """Minimal exposition parser: ``{metric name: {sorted label tuple:
    value}}``. Histogram series appear under their ``_bucket``/``_sum``/
    ``_count`` sample names, exactly as exposed."""
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            label_body, value_part = rest.rsplit("}", 1)
            labels = []
            for item in _split_labels(label_body):
                key, _, raw = item.partition("=")
                raw = raw.strip()[1:-1]  # strip quotes
                labels.append(
                    (
                        key.strip(),
                        raw.replace('\\"', '"')
                        .replace("\\n", "\n")
                        .replace("\\\\", "\\"),
                    )
                )
            key = tuple(sorted(labels))
            value_text = value_part.strip()
        else:
            parts = line.split()
            name, value_text = parts[0], parts[1]
            key = ()
        value = {"+Inf": math.inf, "-Inf": -math.inf, "NaN": math.nan}.get(
            value_text, None
        )
        out.setdefault(name, {})[key] = (
            float(value_text) if value is None else value
        )
    return out


def _split_labels(body: str):
    """Split ``a="x",b="y,z"`` on commas outside quotes."""
    items, depth, current = [], False, []
    i = 0
    while i < len(body):
        ch = body[i]
        if ch == "\\" and depth:
            current.append(body[i : i + 2])
            i += 2
            continue
        if ch == '"':
            depth = not depth
        if ch == "," and not depth:
            items.append("".join(current))
            current = []
        else:
            current.append(ch)
        i += 1
    if current:
        items.append("".join(current))
    return items


# --------------------------------------------------------------------------- #
# Chrome trace-event JSON (Perfetto / chrome://tracing)
# --------------------------------------------------------------------------- #


def _flatten_trace_spans(trace: dict) -> list:
    """One trace doc (get_trace output) -> every span dict it carries,
    including link-adjacent traces merged in under ``linked``."""
    out = list(trace.get("spans", ()))
    for adj in trace.get("linked", ()):
        out.extend(adj.get("spans", ()))
    return out


def to_chrome_trace(trace: dict, pid: Optional[int] = None) -> dict:
    """Render one trace doc (:func:`spans.get_trace` /
    ``{"spans": [...]}``) as Chrome trace-event JSON.

    Every span becomes a ``ph:"X"`` complete event (microsecond
    ``ts``/``dur``); each recorded thread gets a stable ``tid`` lane with
    ``ph:"M"`` ``thread_name`` metadata; every span *link* becomes a flow
    arrow — ``ph:"s"`` anchored inside the linked (request) slice,
    ``ph:"f"`` with ``bp:"e"`` anchored inside the linking (flush) slice,
    sharing the linked span's id — so Perfetto draws request→flush
    causality across thread lanes. ``pid`` defaults to the live process id
    (tests pin it for golden comparison)."""
    import os as _os

    pid = _os.getpid() if pid is None else int(pid)
    span_docs = _flatten_trace_spans(trace)
    tids: Dict[str, int] = {}
    events_out = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": "isoforest-tpu"},
        }
    ]
    by_span_id: Dict[str, dict] = {}
    for doc in span_docs:
        thread = str(doc.get("thread") or "main")
        if thread not in tids:
            tids[thread] = len(tids) + 1
            events_out.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tids[thread],
                    "args": {"name": thread},
                }
            )
        ts_us = float(doc["start_unix_s"]) * 1e6
        dur_us = max(float(doc["wall_s"]) * 1e6, 1.0)
        args = {
            "trace_id": doc.get("trace_id"),
            "span_id": doc.get("span_id"),
            "parent_id": doc.get("parent_id"),
        }
        args.update(doc.get("attrs") or {})
        event = {
            "name": doc["name"],
            "cat": "span",
            "ph": "X",
            "ts": ts_us,
            "dur": dur_us,
            "pid": pid,
            "tid": tids[thread],
            "args": args,
        }
        events_out.append(event)
        if doc.get("span_id"):
            by_span_id[doc["span_id"]] = event
    # flow arrows: for each span that declares links, draw linked-span ->
    # linking-span (the request slice flows into the flush that served it)
    for doc in span_docs:
        sink = by_span_id.get(doc.get("span_id") or "")
        if sink is None:
            continue
        for target_trace, target_span in doc.get("links") or ():
            source = by_span_id.get(target_span or "")
            if source is None:
                continue  # linked span not captured (sampled out/evicted)
            flow_id = str(target_span)
            events_out.append(
                {
                    "name": "coalesce",
                    "cat": "link",
                    "ph": "s",
                    "id": flow_id,
                    "ts": source["ts"],
                    "pid": pid,
                    "tid": source["tid"],
                    "args": {"trace_id": target_trace},
                }
            )
            events_out.append(
                {
                    "name": "coalesce",
                    "cat": "link",
                    "ph": "f",
                    "bp": "e",
                    "id": flow_id,
                    "ts": sink["ts"],
                    "pid": pid,
                    "tid": sink["tid"],
                    "args": {"trace_id": doc.get("trace_id")},
                }
            )
    return {
        "traceEvents": events_out,
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": trace.get("trace_id"),
            "root": trace.get("root"),
            "producer": "isoforest_tpu.telemetry",
        },
    }


def to_chrome_trace_json(
    trace: dict, pid: Optional[int] = None, indent: Optional[int] = None
) -> str:
    return json.dumps(to_chrome_trace(trace, pid=pid), indent=indent)


def reset() -> None:
    """Clear spans, traces, metric series, and the event timeline
    (registered metric objects stay valid). For tests and
    sample-and-clear operators."""
    spans.reset_spans()
    spans.reset_traces()
    metrics.reset_metrics()
    events.reset_events()
