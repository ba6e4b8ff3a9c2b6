"""The port's exporters (``isoforest_tpu_torch/telemetry/export.py``) against
the JAX package's goldens and the JAX package's own exporters, on the CPU.

The module is stdlib code copied from the JAX package, so every output must
equal the JAX package's byte for byte: the Prometheus text of the same
registry operations, the Chrome trace JSON of the same trace document, and
the parse of the same exposition.
"""

from __future__ import annotations

import json
import math
import pathlib

import pytest

from isoforest_tpu.telemetry import export as jax_export
from isoforest_tpu.telemetry import metrics as jax_metrics
from isoforest_tpu_torch import telemetry
from isoforest_tpu_torch.telemetry import export, metrics

RESOURCES = pathlib.Path(__file__).parent / "resources"


@pytest.fixture(autouse=True)
def _clean_telemetry():
    policy = telemetry.set_trace_policy()
    telemetry.enable()
    telemetry.reset()
    yield
    telemetry.set_trace_policy(**policy)
    telemetry.enable()
    telemetry.reset()


def _golden_registry(module):
    """The registry of the JAX package's Prometheus golden
    (``tests/test_telemetry.py``), built through ``module``."""
    reg = module.MetricsRegistry()
    c = reg.counter("demo_requests_total", "Requests served", labelnames=("route",))
    c.inc(3, route="fit")
    c.inc(route="score")
    reg.gauge("demo_queue_depth", "Current queue depth").set(2.5)
    h = reg.histogram("demo_latency_seconds", "Request latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return reg


def _fixture_trace():
    """The JAX package's handcrafted trace document (``tests/test_trace.py``):
    one flush trace (a root and a chunk child) linking one request span of
    another trace, with fixed timings."""
    request_span = {
        "name": "serving.request", "parent": None, "depth": 0, "thread": "http-1",
        "start_unix_s": 1000.0, "wall_s": 0.004, "process_s": 0.001,
        "attrs": {"path": "/score", "rows": 3, "status": 200},
        "trace_id": "aaaa000000000001", "span_id": "aaaa000000000002", "parent_id": None, "links": [],
    }
    chunk_span = {
        "name": "pipeline.chunk", "parent": "serving.flush", "depth": 1, "thread": "isoforest-coalescer",
        "start_unix_s": 1000.0021, "wall_s": 0.001, "process_s": 0.001,
        "attrs": {"site": "score_matrix", "index": 0, "rows": 3},
        "trace_id": "bbbb000000000001", "span_id": "bbbb000000000003", "parent_id": "bbbb000000000002",
        "links": [],
    }
    flush_span = {
        "name": "serving.flush", "parent": None, "depth": 0, "thread": "isoforest-coalescer",
        "start_unix_s": 1000.002, "wall_s": 0.0015, "process_s": 0.001,
        "attrs": {"cause": "size", "rows": 3, "requests": 1},
        "trace_id": "bbbb000000000001", "span_id": "bbbb000000000002", "parent_id": None,
        "links": [["aaaa000000000001", "aaaa000000000002"]],
    }
    return {
        "trace_id": "bbbb000000000001", "root": "serving.flush", "root_span_id": "bbbb000000000002",
        "start_unix_s": 1000.002, "wall_s": 0.0015, "slow": False, "spans": [chunk_span, flush_span],
        "complete": True,
        "linked": [{"trace_id": "aaaa000000000001", "root": "serving.request", "spans": [request_span]}],
    }


def test_prometheus_equals_the_golden_file_byte_for_byte():
    text = export.to_prometheus(_golden_registry(metrics))
    assert text == (RESOURCES / "telemetry_golden.prom").read_text()


def test_chrome_trace_equals_the_golden_file_byte_for_byte():
    golden = (RESOURCES / "chrome_trace_golden.json").read_text()
    assert export.to_chrome_trace(_fixture_trace(), pid=1) == json.loads(golden)
    assert export.to_chrome_trace_json(_fixture_trace(), pid=1, indent=1) + "\n" == golden


@pytest.mark.parametrize("indent", [None, 2])
def test_chrome_trace_json_equals_the_jax_packages(indent):
    assert (export.to_chrome_trace_json(_fixture_trace(), pid=7, indent=indent)
            == jax_export.to_chrome_trace_json(_fixture_trace(), pid=7, indent=indent))


def _ops_counters(m):
    reg = m.MetricsRegistry()
    c = reg.counter("isoforest_demo_total", "Demo counter", labelnames=("code", "path"))
    c.inc(code=200, path="/score")
    c.inc(2.5, code=429, path="/score")
    c.inc(1e16, code=500, path='a"b\\c\nd')
    reg.counter("isoforest_bare_total").inc(7)
    return reg


def _ops_gauges(m):
    reg = m.MetricsRegistry()
    g = reg.gauge("isoforest_demo_gauge", "Demo gauge", labelnames=("site",))
    g.set(float("inf"), site="a")
    g.set(float("-inf"), site="b")
    g.set(0.1 + 0.2, site="c")
    g.set(-3, site="d")
    return reg


def _ops_histograms(m):
    reg = m.MetricsRegistry()
    h = reg.histogram("isoforest_demo_seconds", "Latency", labelnames=("strategy",))
    for i, v in enumerate((1e-5, 0.0003, 0.004, 0.7, 12.0, 99.0)):
        h.observe(v, strategy="walk" if i % 2 else "dense")
    e = reg.histogram("isoforest_demo_rows", "Rows", buckets=m.exponential_buckets(50e-6, 1.3, 36))
    for v in (60e-6, 1e-3, 0.2, 5.0):
        e.observe(v)
    reg.histogram("isoforest_demo_unobserved", "Never observed")
    return reg


@pytest.mark.parametrize("ops", [_ops_counters, _ops_gauges, _ops_histograms, _golden_registry],
                         ids=["counters", "gauges", "histograms", "golden"])
def test_the_same_operations_give_the_jax_packages_text(ops):
    ours = export.to_prometheus(ops(metrics))
    theirs = jax_export.to_prometheus(ops(jax_metrics))
    assert ours == theirs
    parsed = export.parse_prometheus(ours)
    want = jax_export.parse_prometheus(theirs)
    assert parsed.keys() == want.keys()
    for name in want:
        for key, value in want[name].items():
            assert parsed[name][key] == value or (math.isnan(value) and math.isnan(parsed[name][key]))


def test_parse_round_trips_escaped_labels():
    reg = metrics.MetricsRegistry()
    reg.counter("esc_total", labelnames=("k",)).inc(k='a"b\\c\nd')
    assert export.parse_prometheus(export.to_prometheus(reg)) == {"esc_total": {(("k", 'a"b\\c\nd'),): 1.0}}


def test_empty_registry_exposes_nothing():
    assert export.to_prometheus(metrics.MetricsRegistry()) == ""


def test_a_live_trace_renders_as_the_jax_package_renders_it():
    """A trace the port's spans captured: a request root with a child, and a
    flush linking it from another thread's trace."""
    telemetry.set_trace_policy(slow_threshold_s=0.0, sample_every=1)
    telemetry.seed_trace_ids(9)
    with telemetry.span("serving.request", rows=3) as request:
        with telemetry.span("score_matrix"):
            pass
        ctx = request.context
    with telemetry.span("serving.flush", links=[ctx], rows=3):
        pass
    trace = telemetry.get_trace(ctx.trace_id)
    assert trace is not None
    ours = export.to_chrome_trace(trace, pid=3)
    assert ours == jax_export.to_chrome_trace(trace, pid=3)
    names = {e["name"] for e in ours["traceEvents"] if e["ph"] == "X"}
    assert names == {"serving.request", "score_matrix", "serving.flush"}


def test_snapshot_has_the_jax_packages_sections_and_round_trips():
    telemetry.counter("isoforest_snapshot_demo_total", "demo").inc()
    telemetry.record_event("demo.event", n=1)
    with telemetry.span("demo.span"):
        pass
    doc = export.snapshot()
    assert sorted(doc) == sorted(jax_export.snapshot())
    assert json.loads(json.dumps(doc)) == doc  # plain JSON types only
    assert sorted(json.loads(export.snapshot_json())) == sorted(doc)
    assert doc["metrics"]["isoforest_snapshot_demo_total"]["series"][0]["value"] == 1.0
    assert [e["kind"] for e in doc["events"]] == ["demo.event"]
    assert doc["events_dropped"] == 0
    assert "demo.span" in doc["spans"]


def test_reset_clears_series_events_and_spans():
    c = telemetry.counter("isoforest_reset_demo_total", "demo")
    c.inc()
    telemetry.record_event("demo.event")
    with telemetry.span("demo.span"):
        pass
    export.reset()
    assert c.value() == 0.0
    assert telemetry.get_events() == []
    assert telemetry.span_records() == []
    c.inc()  # the registered metric object stays valid
    assert c.value() == 1.0
