"""Tier-wide telemetry federation of the port
(``isoforest_tpu/telemetry/federation.py``, copied: it is pure stdlib).

In the replicated tier every serving process (the router and each replica)
keeps its own in-memory telemetry. This module is the pure merge layer
under the router's federated endpoints (``GET /metrics``, ``/snapshot``,
``/trace``, ``/traces/recent``, ``/debug/bundle``, which
``replication.router.mount_router`` mounts): it takes named per-source
documents (the ``/snapshot`` and ``/trace`` payloads each process serves)
and makes one tier document.

* **counters** sum per label set;
* **histograms** sum bucket by bucket per label set; the ``le`` edges must
  be equal across sources, and a mismatch is a typed
  :class:`BucketMismatchError`, never a silent drop;
* **gauges** do not sum (a tier's "outstanding requests" is one number a
  process): every series gains a ``{replica="<source>"}`` label;
* **events** interleave by ``unix_s``, each with a ``source`` label;
* **traces** stitch across processes: the router's ``router.request`` span
  and the replica's ``serving.request`` span share a trace id through
  ``X-Isoforest-Trace``, so :func:`federated_chrome` draws each source as
  its own Perfetto ``pid`` lane with flow arrows across the boundary.

Every refusal is a typed subclass of :class:`FederationError` (duplicate
source names, conflicting metric types or labels, mismatched bucket
edges), which the HTTP layer maps to a structured error body. Partial
answers are the caller's: the router reports what did not answer in
``missing_replicas``; this module never touches the network. On the same
input documents the output equals the JAX package's, the Prometheus text
byte for byte and the Chrome document's ``producer`` field included, so
a tier may mix replicas of both packages.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .export import _escape_label_value, _format_labels, _format_value  # noqa: F401

_LabelKey = Tuple[Tuple[str, str], ...]


class FederationError(ValueError):
    """Base for typed merge refusals; ``code`` keys the HTTP error body."""

    code = "federation_error"


class DuplicateSourceError(FederationError):
    """Two sources claim the same name — a merge would double-count."""

    code = "duplicate_source"


class MetricTypeConflictError(FederationError):
    """One metric name, conflicting types or label schemas across sources."""

    code = "metric_type_conflict"


class BucketMismatchError(FederationError):
    """One histogram, different ``le`` edges across sources — bucket-wise
    sums would be meaningless, so the merge refuses loudly."""

    code = "bucket_mismatch"


def error_payload(exc: FederationError) -> dict:
    """The structured body federated endpoints return on refusal."""
    return {"error": exc.code, "detail": str(exc)}


def _check_source_names(sources: Sequence[Tuple[str, object]]) -> List[str]:
    names = [str(name) for name, _doc in sources]
    seen = set()
    for name in names:
        if name in seen:
            raise DuplicateSourceError(
                f"duplicate source name {name!r}: every replica must federate "
                "under a unique name"
            )
        seen.add(name)
    return names


def _label_key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _bucket_edges(series: dict) -> Tuple[str, ...]:
    return tuple(str(bound) for bound, _count in series.get("buckets", ()))


# --------------------------------------------------------------------------- #
# metrics
# --------------------------------------------------------------------------- #


def merge_metrics(
    sources: Sequence[Tuple[str, Dict[str, dict]]]
) -> Dict[str, dict]:
    """Merge per-source registry snapshots (``{name: snapshot-dict}`` as
    produced by ``metrics.registry().snapshot()``) into one document of the
    same shape. Counters sum, histograms bucket-sum (identical edges
    enforced), gauges gain a ``replica`` label. Raises a typed
    :class:`FederationError` subclass on any conflict."""
    _check_source_names(sources)
    ordered_names: List[str] = []
    seen_names = set()
    for source, metrics_doc in sources:
        for metric_name in metrics_doc or {}:
            if metric_name not in seen_names:
                seen_names.add(metric_name)
                ordered_names.append(metric_name)

    out: Dict[str, dict] = {}
    for metric_name in sorted(ordered_names):
        present = [
            (source, (metrics_doc or {})[metric_name])
            for source, metrics_doc in sources
            if metric_name in (metrics_doc or {})
        ]
        types = {snap.get("type") for _s, snap in present}
        if len(types) > 1:
            raise MetricTypeConflictError(
                f"metric {metric_name!r} has conflicting types across "
                f"sources: {sorted(t for t in types if t)}"
            )
        mtype = next(iter(types))
        label_schemas = {tuple(snap.get("labelnames", ())) for _s, snap in present}
        if len(label_schemas) > 1:
            raise MetricTypeConflictError(
                f"metric {metric_name!r} has conflicting label schemas "
                f"across sources: {sorted(label_schemas)}"
            )
        labelnames = list(next(iter(label_schemas)))
        help_text = next(
            (snap.get("help") for _s, snap in present if snap.get("help")), ""
        )
        if mtype == "counter":
            out[metric_name] = _merge_counter(
                metric_name, mtype, help_text, labelnames, present
            )
        elif mtype == "gauge":
            out[metric_name] = _merge_gauge(
                metric_name, help_text, labelnames, present
            )
        elif mtype == "histogram":
            out[metric_name] = _merge_histogram(
                metric_name, help_text, labelnames, present
            )
        else:
            raise MetricTypeConflictError(
                f"metric {metric_name!r} has unknown type {mtype!r}"
            )
    return out


def _merge_counter(name, mtype, help_text, labelnames, present) -> dict:
    totals: Dict[_LabelKey, float] = {}
    for _source, snap in present:
        for series in snap.get("series", ()):
            key = _label_key(series.get("labels", {}))
            totals[key] = totals.get(key, 0) + series.get("value", 0)
    return {
        "type": mtype,
        "help": help_text,
        "labelnames": labelnames,
        "series": [
            {"labels": dict(key), "value": totals[key]}
            for key in sorted(totals)
        ],
    }


def _merge_gauge(name, help_text, labelnames, present) -> dict:
    series_out = []
    for source, snap in present:
        for series in snap.get("series", ()):
            labels = dict(series.get("labels", {}))
            # a gauge that ALREADY speaks per-replica (the router's own
            # isoforest_tier_missing_replicas) keeps its label — the
            # source tag must never clobber it
            labels.setdefault("replica", source)
            series_out.append(
                {"labels": labels, "value": series.get("value", 0)}
            )
    series_out.sort(key=lambda s: _label_key(s["labels"]))
    if "replica" not in labelnames:
        labelnames = [*labelnames, "replica"]
    return {
        "type": "gauge",
        "help": help_text,
        "labelnames": list(labelnames),
        "series": series_out,
    }


def _merge_histogram(name, help_text, labelnames, present) -> dict:
    edges: Optional[Tuple[str, ...]] = None
    edge_owner = None
    acc: Dict[_LabelKey, dict] = {}
    for source, snap in present:
        for series in snap.get("series", ()):
            series_edges = _bucket_edges(series)
            if edges is None:
                edges, edge_owner = series_edges, source
            elif series_edges != edges:
                raise BucketMismatchError(
                    f"histogram {name!r} bucket edges differ between "
                    f"source {edge_owner!r} ({list(edges)}) and source "
                    f"{source!r} ({list(series_edges)})"
                )
            key = _label_key(series.get("labels", {}))
            slot = acc.get(key)
            if slot is None:
                slot = acc[key] = {
                    "labels": dict(series.get("labels", {})),
                    "count": 0,
                    "sum": 0.0,
                    "min": None,
                    "max": None,
                    "counts": [0] * len(series_edges),
                }
            slot["count"] += series.get("count", 0)
            slot["sum"] += series.get("sum", 0.0)
            for stat, pick in (("min", min), ("max", max)):
                value = series.get(stat)
                if value is not None:
                    slot[stat] = (
                        value if slot[stat] is None else pick(slot[stat], value)
                    )
            for i, (_bound, count) in enumerate(series.get("buckets", ())):
                slot["counts"][i] += count
    series_out = []
    for key in sorted(acc):
        slot = acc[key]
        series_out.append(
            {
                "labels": slot["labels"],
                "count": slot["count"],
                "sum": slot["sum"],
                "min": slot["min"],
                "max": slot["max"],
                "buckets": [
                    [bound, slot["counts"][i]]
                    for i, bound in enumerate(edges or ())
                ],
            }
        )
    return {
        "type": "histogram",
        "help": help_text,
        "labelnames": labelnames,
        "series": series_out,
    }


def metrics_to_prometheus(metrics_doc: Dict[str, dict]) -> str:
    """Render a plain registry-snapshot document (local or merged) in the
    Prometheus text exposition format — the same output shape as
    ``export.to_prometheus``, but working from data instead of live metric
    objects, so a merged tier document renders identically."""
    lines: List[str] = []
    for name in metrics_doc:
        snap = metrics_doc[name]
        if snap.get("help"):
            lines.append(f"# HELP {name} {snap['help']}")
        lines.append(f"# TYPE {name} {snap['type']}")
        for series in snap.get("series", ()):
            labels = series.get("labels", {})
            if snap["type"] == "histogram":
                cumulative = 0
                for bound, count in series.get("buckets", ()):
                    cumulative += count
                    le = bound if bound == "+Inf" else _format_value(float(bound))
                    lines.append(
                        f"{name}_bucket"
                        f"{_format_labels(labels, (('le', le),))} {cumulative}"
                    )
                lines.append(
                    f"{name}_sum{_format_labels(labels)} "
                    f"{_format_value(series.get('sum', 0.0))}"
                )
                lines.append(
                    f"{name}_count{_format_labels(labels)} "
                    f"{series.get('count', 0)}"
                )
            else:
                lines.append(
                    f"{name}{_format_labels(labels)} "
                    f"{_format_value(series.get('value', 0))}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


# --------------------------------------------------------------------------- #
# events + snapshots
# --------------------------------------------------------------------------- #


def merge_events(
    sources: Sequence[Tuple[str, Iterable[dict]]]
) -> List[dict]:
    """Interleave per-source event timelines by timestamp, each event
    tagged with its ``source``. Ties break on (source, seq) so the merged
    order is deterministic across calls."""
    _check_source_names(sources)
    merged: List[dict] = []
    for source, events in sources:
        for event in events or ():
            merged.append({**event, "source": source})
    merged.sort(
        key=lambda e: (e.get("unix_s", 0.0), e.get("source", ""), e.get("seq", 0))
    )
    return merged


def merge_snapshots(
    sources: Sequence[Tuple[str, dict]],
    missing_replicas: Sequence[str] = (),
) -> dict:
    """Merge per-source ``telemetry.snapshot()`` documents into one tier
    snapshot. The ``metrics`` section keeps the exact registry-snapshot
    shape (tools that read a single process's snapshot — e.g.
    ``tools/serving_latency.py`` — work unchanged against the merged one);
    events interleave with ``source`` labels; per-source trace-ring stats
    are kept under ``traces.sources``. ``missing_replicas`` names fanned-
    out sources that could not answer — a partial answer is explicit,
    never silent."""
    names = _check_source_names(sources)
    merged_metrics = merge_metrics(
        [(name, doc.get("metrics", {})) for name, doc in sources]
    )
    events = merge_events(
        [(name, doc.get("events", ())) for name, doc in sources]
    )
    return {
        "federated": True,
        "sources": names,
        "missing_replicas": sorted(missing_replicas),
        "telemetry_enabled": any(
            doc.get("telemetry_enabled", False) for _n, doc in sources
        ),
        "generated_unix_s": max(
            [doc.get("generated_unix_s", 0.0) for _n, doc in sources],
            default=0.0,
        ),
        "metrics": merged_metrics,
        "events": events,
        "events_dropped": sum(
            doc.get("events_dropped", 0) for _n, doc in sources
        ),
        "traces": {
            "sources": {name: doc.get("traces") for name, doc in sources}
        },
    }


def merge_recent_traces(
    sources: Sequence[Tuple[str, Iterable[dict]]],
    limit: int = 20,
    missing_replicas: Sequence[str] = (),
) -> dict:
    """Merge per-source ``recent_traces`` summaries, newest first, each
    tagged with its ``source``."""
    _check_source_names(sources)
    merged: List[dict] = []
    for source, summaries in sources:
        for summary in summaries or ():
            merged.append({**summary, "source": source})
    merged.sort(
        key=lambda t: (-(t.get("start_unix_s") or 0.0), t.get("source", ""))
    )
    if limit:
        merged = merged[: max(0, int(limit))]
    return {
        "federated": True,
        "traces": merged,
        "missing_replicas": sorted(missing_replicas),
    }


# --------------------------------------------------------------------------- #
# traces: cross-process stitching
# --------------------------------------------------------------------------- #


def flatten_trace_doc(trace: dict) -> List[dict]:
    """Every span dict one ``get_trace``-shaped document carries, including
    link-adjacent traces merged in under ``linked``."""
    out = list(trace.get("spans", ()))
    for adj in trace.get("linked", ()):
        out.extend(adj.get("spans", ()))
    return out


def federated_trace_spans(
    sources: Sequence[Tuple[str, dict]],
    trace_id: str,
    missing_replicas: Sequence[str] = (),
) -> dict:
    """Merge per-source trace documents for one trace id into a flat
    ``spans`` view: each span tagged with its ``source``, de-duplicated by
    span id (sources sharing a process — or a proxy echoing a replica's
    spans — must not double-report), ordered by start time."""
    _check_source_names(sources)
    seen = set()
    spans_out: List[dict] = []
    per_source: Dict[str, dict] = {}
    for source, doc in sources:
        per_source[source] = doc
        for span in flatten_trace_doc(doc):
            span_id = span.get("span_id")
            if span_id and span_id in seen:
                continue
            if span_id:
                seen.add(span_id)
            spans_out.append({**span, "source": source})
    spans_out.sort(key=lambda s: (s.get("start_unix_s") or 0.0, s.get("span_id") or ""))
    return {
        "federated": True,
        "trace_id": trace_id,
        "sources": per_source,
        "missing_replicas": sorted(missing_replicas),
        "spans": spans_out,
    }


def federated_chrome(
    sources: Sequence[Tuple[str, List[dict]]],
    trace_id: Optional[str] = None,
    missing_replicas: Sequence[str] = (),
) -> dict:
    """Stitch per-source span lists into ONE Chrome trace-event document:
    each source gets its own ``pid`` lane (named by ``process_name``
    metadata — "router", replica names, journal spool names), spans keep
    their per-thread ``tid`` lanes inside it, in-process span links render
    as flow arrows exactly like ``export.to_chrome_trace``, and one extra
    arrow family crosses the process boundary: every ``router.request``
    span flows into each *other-source* root span sharing its trace id
    (the replica's ``serving.request`` adopted via ``X-Isoforest-Trace``),
    so Perfetto draws the request hop router-lane → replica-lane."""
    _check_source_names(sources)
    events_out: List[dict] = []
    by_span_id: Dict[str, dict] = {}
    all_docs: List[Tuple[str, dict]] = []
    for pid, (source, span_docs) in enumerate(sources, start=1):
        events_out.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": source},
            }
        )
        tids: Dict[str, int] = {}
        for doc in span_docs or ():
            span_id = doc.get("span_id")
            if span_id and span_id in by_span_id:
                continue  # de-dup: a span lives in its first source's lane
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
            args = {
                "trace_id": doc.get("trace_id"),
                "span_id": span_id,
                "parent_id": doc.get("parent_id"),
                "source": source,
            }
            args.update(doc.get("attrs") or {})
            event = {
                "name": doc["name"],
                "cat": "span",
                "ph": "X",
                "ts": float(doc.get("start_unix_s") or 0.0) * 1e6,
                "dur": max(float(doc.get("wall_s") or 0.0) * 1e6, 1.0),
                "pid": pid,
                "tid": tids[thread],
                "args": args,
            }
            events_out.append(event)
            if span_id:
                by_span_id[span_id] = event
            all_docs.append((source, doc))
    # in-process flow arrows: declared span links (request -> flush)
    for source, doc in all_docs:
        sink = by_span_id.get(doc.get("span_id") or "")
        if sink is None:
            continue
        for target_trace, target_span in doc.get("links") or ():
            origin = by_span_id.get(target_span or "")
            if origin is None:
                continue
            flow_id = str(target_span)
            events_out.append(
                {
                    "name": "coalesce", "cat": "link", "ph": "s",
                    "id": flow_id, "ts": origin["ts"],
                    "pid": origin["pid"], "tid": origin["tid"],
                    "args": {"trace_id": target_trace},
                }
            )
            events_out.append(
                {
                    "name": "coalesce", "cat": "link", "ph": "f", "bp": "e",
                    "id": flow_id, "ts": sink["ts"],
                    "pid": sink["pid"], "tid": sink["tid"],
                    "args": {"trace_id": doc.get("trace_id")},
                }
            )
    # cross-process flow arrows: router.request -> other-source roots
    # sharing the trace id (the hop X-Isoforest-Trace carried on the wire)
    for source, doc in all_docs:
        if doc.get("name") != "router.request":
            continue
        origin = by_span_id.get(doc.get("span_id") or "")
        if origin is None:
            continue
        for other_source, other in all_docs:
            if (
                other_source == source
                or other.get("parent_id") is not None
                or other.get("trace_id") != doc.get("trace_id")
                or other.get("span_id") == doc.get("span_id")
            ):
                continue
            sink = by_span_id.get(other.get("span_id") or "")
            if sink is None:
                continue
            flow_id = f"xproc-{other.get('span_id')}"
            events_out.append(
                {
                    "name": "route", "cat": "xproc", "ph": "s",
                    "id": flow_id, "ts": origin["ts"],
                    "pid": origin["pid"], "tid": origin["tid"],
                    "args": {"trace_id": doc.get("trace_id")},
                }
            )
            events_out.append(
                {
                    "name": "route", "cat": "xproc", "ph": "f", "bp": "e",
                    "id": flow_id, "ts": sink["ts"],
                    "pid": sink["pid"], "tid": sink["tid"],
                    "args": {"trace_id": other.get("trace_id")},
                }
            )
    return {
        "traceEvents": events_out,
        "displayTimeUnit": "ms",
        "otherData": {
            "trace_id": trace_id,
            "federated": True,
            "sources": [name for name, _docs in sources],
            "missing_replicas": sorted(missing_replicas),
            "producer": "isoforest_tpu.telemetry",
        },
    }
