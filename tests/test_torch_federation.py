"""The port's journal and federation (``isoforest_tpu_torch/telemetry``) on
the CPU: ``tests/test_federation.py`` against the port, then both packages
on the same inputs.

* **Federation**: the port router's daemon answers ``/metrics``,
  ``/snapshot``, ``/trace``, ``/traces/recent`` and ``/debug/bundle`` for
  the whole tier (counters sum, histograms sum bucket by bucket with equal
  edges enforced, gauges gain ``{replica=}``, events interleave, a trace
  stitches across process lanes); replicas that cannot answer are named in
  ``missing_replicas``.
* **Journal**: every recorded event and committed trace appends to an
  NDJSON spool with rotation, an fsync cadence and a reader that tolerates
  a torn tail.
* **Parity**: seeded documents merged by both packages give equal output,
  the Prometheus text and the Chrome document byte for byte, and the typed
  refusals carry the same codes and messages; a spool written by either
  package is read by the other record for record, torn tail included, and
  the same records are written as the same bytes.

The tier here runs in one process: stub ``MetricsServer`` replicas answer
canned payloads, and every router schedule runs on a ``FakeClock``. No real
sleeps; every socket has its own timeout.
"""

import json
import os
import random
import socket

import numpy as np
import pytest

from isoforest_tpu_torch import telemetry
from isoforest_tpu_torch.replication import (
    Replica,
    Router,
    RouterConfig,
    mount_router,
    unmount_router,
)
from isoforest_tpu_torch.resilience import faults
from isoforest_tpu_torch.resilience.degradation import degrade, reset_degradations
from isoforest_tpu_torch.telemetry import TraceContext, federation
from isoforest_tpu_torch.telemetry.http import MetricsServer
from isoforest_tpu_torch.telemetry.journal import (
    Journal,
    activate_journal,
    active_journal,
    deactivate_journal,
    list_spools,
    read_spool,
)


@pytest.fixture(autouse=True)
def _clean():
    telemetry.reset()
    reset_degradations()
    deactivate_journal()
    telemetry.set_trace_policy(slow_threshold_s=0.0, sample_every=1)
    yield
    deactivate_journal()
    telemetry.reset()
    reset_degradations()
    telemetry.set_trace_policy(slow_threshold_s=0.25, sample_every=1)


def _counter_doc(value, labels=None, labelnames=()):
    return {
        "type": "counter",
        "help": "stub",
        "labelnames": list(labelnames),
        "series": [{"labels": dict(labels or {}), "value": value}],
    }


def _hist_doc(edges, counts, count, total, labelnames=()):
    return {
        "type": "histogram",
        "help": "stub",
        "labelnames": list(labelnames),
        "series": [
            {
                "labels": {},
                "count": count,
                "sum": total,
                "min": 0.01,
                "max": 0.5,
                "buckets": [[b, c] for b, c in zip(edges, counts)],
            }
        ],
    }


# --------------------------------------------------------------------------- #
# journal: the crash-durable flight recorder
# --------------------------------------------------------------------------- #


class TestJournal:
    def test_rotation_retention_and_resume(self, tmp_path):
        j = Journal(
            str(tmp_path), "r0",
            max_segment_bytes=256, fsync_every=0, max_segments=2,
        )
        for i in range(40):
            j.append({"type": "event", "seq": i, "kind": "fleet.load"})
        state = j.state()
        j.close()
        assert state["segment"] >= 2, "256-byte segments must have rotated"
        names = sorted(os.listdir(tmp_path / "r0"))
        assert len(names) == 2, "retention keeps max_segments newest"
        spool = read_spool(str(tmp_path / "r0"))
        assert spool["segments"] == 2
        assert not spool["torn_tail"] and spool["skipped_lines"] == 0
        # each kept segment leads with its own open header
        opens = [r for r in spool["records"] if r["type"] == "open"]
        assert len(opens) == 2 and opens[0]["name"] == "r0"
        seqs = [r["seq"] for r in spool["records"] if r["type"] == "event"]
        assert seqs == sorted(seqs) and seqs[-1] == 39

        # a restarted process appends a NEW segment, never clobbers history
        j2 = Journal(str(tmp_path), "r0", max_segment_bytes=256, fsync_every=0)
        try:
            assert j2.state()["segment"] == state["segment"] + 1
        finally:
            j2.close()

    def test_fsync_cadence_is_a_knob(self, tmp_path):
        j = Journal(str(tmp_path), "r0", fsync_every=3)
        for i in range(7):
            j.append({"seq": i})
        # 8 writes total (open header + 7 records) at cadence 3 -> 2 fsyncs
        assert j.state()["fsyncs"] == 2
        j.close()
        j0 = Journal(str(tmp_path), "never", fsync_every=0)
        for i in range(5):
            j0.append({"seq": i})
        assert j0.state()["fsyncs"] == 0
        j0.close()

    def test_torn_tail_tolerated_mid_garbage_skipped(self, tmp_path):
        spool_dir = tmp_path / "victim"
        spool_dir.mkdir()
        with open(spool_dir / "segment-00000.ndjson", "w") as fh:
            fh.write('{"type": "open", "name": "victim", "segment": 0}\n')
            fh.write("%% corrupted line in the middle %%\n")
            fh.write('{"type": "event", "kind": "fleet.load", "seq": 1}\n')
        with open(spool_dir / "segment-00001.ndjson", "w") as fh:
            fh.write('{"type": "event", "kind": "serving.flush", "seq": 2}\n')
            fh.write('{"type": "trace", "trace": {"trace_id"')  # kill -9 here
        spool = read_spool(str(spool_dir))
        assert spool["torn_tail"] is True
        assert spool["skipped_lines"] == 1
        kinds = [r.get("kind") for r in spool["records"] if r.get("kind")]
        assert kinds == ["fleet.load", "serving.flush"]
        # tail bounds the recovered view, newest last
        tailed = read_spool(str(spool_dir), tail=1)
        assert [r["seq"] for r in tailed["records"]] == [2]
        assert list_spools(str(tmp_path)) == ["victim"]

    def test_sinks_write_through_events_traces_degradations(self, tmp_path):
        activate_journal(str(tmp_path), "proc-a")
        assert active_journal() is not None
        telemetry.record_event("fleet.load", model_id="alpha", generation=1)
        degrade("pipeline_fallback", "pipeline", "single_shot", "journal write-through")
        with telemetry.with_context(TraceContext("fed-trace-1")):
            with telemetry.span("serving.request"):
                pass
        deactivate_journal()
        assert active_journal() is None

        spool = read_spool(str(tmp_path / "proc-a"))
        events = [r for r in spool["records"] if r["type"] == "event"]
        kinds = [e["kind"] for e in events]
        # the start/stop markers bracket the recording; a spool missing the
        # stop marker (plus a torn tail) is the kill -9 signature
        assert kinds[0] == "journal.start" and kinds[-1] == "journal.stop"
        assert "fleet.load" in kinds and "degradation" in kinds
        traces = [r for r in spool["records"] if r["type"] == "trace"]
        assert len(traces) == 1
        entry = traces[0]["trace"]
        assert entry["trace_id"] == "fed-trace-1"
        assert [s["name"] for s in entry["spans"]] == ["serving.request"]

    def test_write_failure_disarms_never_raises(self, tmp_path):
        class _Boom:
            def write(self, _s):
                raise OSError("disk full")

            def flush(self):
                pass

            def close(self):
                pass

        j = Journal(str(tmp_path), "r0", fsync_every=0)
        j._fh = _Boom()
        j.append({"seq": 0})  # must not raise
        assert j.state()["broken"] is True
        j.append({"seq": 1})  # disarmed: a no-op, still no raise
        j.close()

    def test_awkward_records_never_break_the_recorder(self, tmp_path):
        j = Journal(str(tmp_path), "r0", fsync_every=0)
        # non-JSON values fall back to their repr (default=repr): the
        # recorder keeps recording rather than raising on exotic payloads
        j.append({"seq": 0, "worse": {1, 2}})
        j.append({"seq": 1})
        j.close()
        spool = read_spool(str(tmp_path / "r0"))
        assert [r.get("seq") for r in spool["records"]] == [None, 0, 1]
        assert spool["records"][1]["worse"] == "{1, 2}"
        assert j.state()["broken"] is False


# --------------------------------------------------------------------------- #
# merge correctness (satellite: property tests + typed refusals)
# --------------------------------------------------------------------------- #


class TestMergeMetrics:
    def test_counter_sum_roundtrips_with_hostile_label_values(self):
        """Escaping property: any label value — backslashes, quotes,
        newlines, unicode, separators — must survive merge -> Prometheus
        text -> parse_prometheus with the summed value intact."""
        rng = random.Random(20)
        alphabet = list('a\\"\n,={}é ')
        values = {
            "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 12)))
            for _ in range(30)
        }
        values |= {'back\\slash', 'say "hi"', "line\nbreak", "plain"}
        docs = []
        expected = {}
        for shard in range(2):
            series = []
            for i, value in enumerate(sorted(values)):
                amount = float(shard + i + 1)
                series.append({"labels": {"tenant": value}, "value": amount})
                expected[value] = expected.get(value, 0.0) + amount
            docs.append(
                {
                    "stub_requests_total": {
                        "type": "counter",
                        "help": "stub",
                        "labelnames": ["tenant"],
                        "series": series,
                    }
                }
            )
        merged = federation.merge_metrics([("r0", docs[0]), ("r1", docs[1])])
        parsed = telemetry.parse_prometheus(
            federation.metrics_to_prometheus(merged)
        )
        assert len(parsed["stub_requests_total"]) == len(values)
        for value, total in expected.items():
            assert parsed["stub_requests_total"][(("tenant", value),)] == total

    def test_gauges_gain_replica_label_never_sum(self):
        merged = federation.merge_metrics(
            [
                ("r0", {"stub_depth": {
                    "type": "gauge", "help": "", "labelnames": [],
                    "series": [{"labels": {}, "value": 3}]}}),
                ("r1", {"stub_depth": {
                    "type": "gauge", "help": "", "labelnames": [],
                    "series": [{"labels": {}, "value": 5}]}}),
            ]
        )
        snap = merged["stub_depth"]
        assert snap["labelnames"] == ["replica"]
        assert [(s["labels"]["replica"], s["value"]) for s in snap["series"]] \
            == [("r0", 3), ("r1", 5)]
        parsed = telemetry.parse_prometheus(
            federation.metrics_to_prometheus(merged)
        )
        assert parsed["stub_depth"][(("replica", "r0"),)] == 3
        assert parsed["stub_depth"][(("replica", "r1"),)] == 5

    def test_histogram_bucket_sums_roundtrip_cumulative(self):
        edges = [0.1, 0.5, "+Inf"]
        merged = federation.merge_metrics(
            [
                ("r0", {"stub_seconds": _hist_doc(edges, [2, 1, 0], 3, 0.4)}),
                ("r1", {"stub_seconds": _hist_doc(edges, [1, 0, 2], 3, 1.2)}),
            ]
        )
        series = merged["stub_seconds"]["series"][0]
        assert series["count"] == 6
        assert series["sum"] == pytest.approx(1.6)
        assert [c for _b, c in series["buckets"]] == [3, 1, 2]
        assert series["min"] == 0.01 and series["max"] == 0.5
        parsed = telemetry.parse_prometheus(
            federation.metrics_to_prometheus(merged)
        )
        # text exposition is CUMULATIVE per le edge
        assert parsed["stub_seconds_bucket"][(("le", "0.1"),)] == 3
        assert parsed["stub_seconds_bucket"][(("le", "0.5"),)] == 4
        assert parsed["stub_seconds_bucket"][(("le", "+Inf"),)] == 6
        assert parsed["stub_seconds_count"][()] == 6

    def test_bucket_edge_mismatch_is_a_typed_refusal(self):
        with pytest.raises(federation.BucketMismatchError) as err:
            federation.merge_metrics(
                [
                    ("r0", {"stub_seconds": _hist_doc([0.1, "+Inf"], [1, 0], 1, 0.05)}),
                    ("r1", {"stub_seconds": _hist_doc([0.2, "+Inf"], [1, 0], 1, 0.05)}),
                ]
            )
        assert isinstance(err.value, federation.FederationError)
        payload = federation.error_payload(err.value)
        assert payload["error"] == "bucket_mismatch"
        assert "r0" in payload["detail"] and "r1" in payload["detail"]

    def test_duplicate_source_names_refused(self):
        with pytest.raises(federation.DuplicateSourceError) as err:
            federation.merge_metrics([("r0", {}), ("r0", {})])
        assert federation.error_payload(err.value)["error"] == "duplicate_source"
        with pytest.raises(federation.DuplicateSourceError):
            federation.merge_events([("r0", []), ("r0", [])])
        with pytest.raises(federation.DuplicateSourceError):
            federation.merge_snapshots([("r0", {}), ("r0", {})])

    def test_type_and_label_schema_conflicts_refused(self):
        with pytest.raises(federation.MetricTypeConflictError):
            federation.merge_metrics(
                [
                    ("r0", {"stub_m": _counter_doc(1)}),
                    ("r1", {"stub_m": {
                        "type": "gauge", "help": "", "labelnames": [],
                        "series": [{"labels": {}, "value": 1}]}}),
                ]
            )
        with pytest.raises(federation.MetricTypeConflictError):
            federation.merge_metrics(
                [
                    ("r0", {"stub_m": _counter_doc(1, labelnames=["a"])}),
                    ("r1", {"stub_m": _counter_doc(1, labelnames=["b"])}),
                ]
            )

    def test_events_interleave_by_time_with_source(self):
        merged = federation.merge_events(
            [
                ("r1", [{"seq": 0, "unix_s": 20.0, "kind": "b"}]),
                ("r0", [
                    {"seq": 0, "unix_s": 10.0, "kind": "a"},
                    {"seq": 1, "unix_s": 30.0, "kind": "c"},
                ]),
            ]
        )
        assert [(e["kind"], e["source"]) for e in merged] == [
            ("a", "r0"), ("b", "r1"), ("c", "r0"),
        ]


# --------------------------------------------------------------------------- #
# the federated tier over stub replicas (FakeClock, zero real sleeps)
# --------------------------------------------------------------------------- #


def _stub_server(routes):
    """A stub replica: registered GET routes serve canned JSON — they
    shadow the built-ins exactly like the router's federated mounts do."""
    server = MetricsServer(port=0).start()
    for path, doc in routes.items():
        def handler(query, _doc=doc):
            return 200, "application/json", json.dumps(_doc) + "\n"
        server.register_get(path, handler)
    return server


def _dead_url():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    url = "http://127.0.0.1:%d" % probe.getsockname()[1]
    probe.close()
    return url


class _StubTier:
    """Router + HTTP front over stub replica servers; FakeClock on every
    router schedule."""

    def __init__(self, named_servers, dead=(), journal_dir=None):
        self.servers = [s for _n, s in named_servers]
        replicas = [Replica(n, s.url) for n, s in named_servers]
        replicas += [Replica(n, _dead_url()) for n in dead]
        self.fc = faults.FakeClock()
        self.router = Router(
            replicas,
            config=RouterConfig(probe_timeout_s=5.0),
            clock=self.fc.now,
            sleep=self.fc.sleep,
            journal_dir=journal_dir,
        )
        self.router.probe_once()
        self.front = MetricsServer(port=0).start()
        mount_router(self.front, self.router)

    def close(self):
        unmount_router(self.front)
        self.front.stop()
        for server in self.servers:
            server.stop()
        assert self.fc.sleeps == [], "the tier must never sleep for real"


def _get(url, path):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url + path, timeout=30) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


SNAP_R0 = {
    "telemetry_enabled": True,
    "generated_unix_s": 100.0,
    "events": [{"seq": 0, "unix_s": 10.0, "kind": "fleet.load"}],
    "events_dropped": 0,
    "metrics": {
        "stub_requests_total": _counter_doc(2.0),
        "stub_depth": {
            "type": "gauge", "help": "", "labelnames": [],
            "series": [{"labels": {}, "value": 4}],
        },
    },
    "traces": {"captured": 1},
}
SNAP_R1 = {
    "telemetry_enabled": True,
    "generated_unix_s": 101.0,
    "events": [{"seq": 0, "unix_s": 5.0, "kind": "serving.flush"}],
    "events_dropped": 2,
    "metrics": {
        "stub_requests_total": _counter_doc(3.0),
        "stub_depth": {
            "type": "gauge", "help": "", "labelnames": [],
            "series": [{"labels": {}, "value": 7}],
        },
    },
    "traces": {"captured": 0},
}


class TestFederatedTier:
    def test_tier_metrics_sums_counters_and_labels_gauges(self):
        tier = _StubTier(
            [("r0", _stub_server({"/snapshot": SNAP_R0})),
             ("r1", _stub_server({"/snapshot": SNAP_R1}))]
        )
        try:
            status, body = _get(tier.front.url, "/metrics")
            assert status == 200
            parsed = telemetry.parse_prometheus(body)
            # the stub series exist ONLY in the replicas' canned snapshots:
            # seeing them proves the front served the FEDERATED view, not
            # the single-process built-in
            assert parsed["stub_requests_total"][()] == 5.0
            assert parsed["stub_depth"][(("replica", "r0"),)] == 4
            assert parsed["stub_depth"][(("replica", "r1"),)] == 7
            # the freshly-updated fan-out gauge rides the same exposition
            missing = parsed["isoforest_tier_missing_replicas"]
            assert missing[(("replica", "r0"),)] == 0
            assert missing[(("replica", "r1"),)] == 0
        finally:
            tier.close()

    def test_tier_snapshot_interleaves_events_and_keeps_metric_shape(self):
        tier = _StubTier(
            [("r0", _stub_server({"/snapshot": SNAP_R0})),
             ("r1", _stub_server({"/snapshot": SNAP_R1}))]
        )
        try:
            status, body = _get(tier.front.url, "/snapshot")
            assert status == 200
            doc = json.loads(body)
            assert doc["federated"] is True
            assert doc["sources"] == ["router", "r0", "r1"]
            assert doc["missing_replicas"] == []
            assert doc["events_dropped"] == 2
            stub_events = [
                (e["kind"], e["source"]) for e in doc["events"]
                if e["source"] != "router"
            ]
            assert stub_events == [("serving.flush", "r1"), ("fleet.load", "r0")]
            # the metrics section keeps the registry-snapshot shape, so
            # single-process tooling reads the merged document unchanged
            metric = doc["metrics"]["stub_requests_total"]
            assert metric["series"][0]["value"] == 5.0
            assert doc["traces"]["sources"]["r0"] == {"captured": 1}
            assert doc["router"]["router"] is True
        finally:
            tier.close()

    def test_federated_trace_stitches_lanes_with_cross_process_arrow(self):
        replica_trace = {
            "trace_id": "fed-42",
            "root": "serving.request",
            "spans": [
                {
                    "name": "serving.request", "trace_id": "fed-42",
                    "span_id": "aaaa", "parent_id": None, "thread": "srv-0",
                    "start_unix_s": 10.001, "wall_s": 0.5, "attrs": {},
                    "links": [],
                }
            ],
            "linked": [],
        }
        tier = _StubTier(
            [("r0", _stub_server({"/trace": replica_trace}))]
        )
        try:
            # the router's own half of the trace: its request span adopted
            # the client trace id exactly as X-Isoforest-Trace carries it
            with telemetry.with_context(TraceContext("fed-42")):
                with telemetry.span("router.request"):
                    pass

            status, body = _get(tier.front.url, "/trace?trace_id=fed-42")
            assert status == 200
            doc = json.loads(body)
            assert doc["otherData"]["federated"] is True
            assert doc["otherData"]["missing_replicas"] == []
            lanes = {
                e["args"]["name"]: e["pid"]
                for e in doc["traceEvents"]
                if e["ph"] == "M" and e["name"] == "process_name"
            }
            assert set(lanes) == {"router", "r0"}
            spans = {
                e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"
            }
            assert spans["router.request"]["pid"] == lanes["router"]
            assert spans["serving.request"]["pid"] == lanes["r0"]
            # THE flow arrow: router lane -> replica lane, one hop
            starts = [
                e for e in doc["traceEvents"]
                if e["name"] == "route" and e["ph"] == "s"
            ]
            finishes = [
                e for e in doc["traceEvents"]
                if e["name"] == "route" and e["ph"] == "f"
            ]
            assert len(starts) == 1 and len(finishes) == 1
            assert starts[0]["pid"] == lanes["router"]
            assert finishes[0]["pid"] == lanes["r0"]
            assert starts[0]["id"] == finishes[0]["id"] == "xproc-aaaa"

            # format=spans: the flat merged view, every span source-tagged
            status, body = _get(
                tier.front.url, "/trace?trace_id=fed-42&format=spans"
            )
            doc = json.loads(body)
            named = {(s["name"], s["source"]) for s in doc["spans"]}
            assert ("router.request", "router") in named
            assert ("serving.request", "r0") in named
        finally:
            tier.close()

    def test_unknown_trace_is_404_with_missing_replicas(self):
        tier = _StubTier(
            [("r0", _stub_server({}))], dead=("r1",)
        )
        try:
            status, body = _get(
                tier.front.url, "/trace?trace_id=never-seen"
            )
            assert status == 404
            doc = json.loads(body)
            assert doc["missing_replicas"] == ["r1"]
            status, _body = _get(tier.front.url, "/trace")
            assert status == 400
        finally:
            tier.close()

    def test_partial_answers_name_missing_replicas_explicitly(self):
        tier = _StubTier(
            [("r0", _stub_server({"/snapshot": SNAP_R0}))], dead=("r1",)
        )
        try:
            status, body = _get(tier.front.url, "/snapshot")
            assert status == 200
            doc = json.loads(body)
            assert doc["missing_replicas"] == ["r1"]
            assert doc["sources"] == ["router", "r0"]
            status, body = _get(tier.front.url, "/metrics")
            parsed = telemetry.parse_prometheus(body)
            missing = parsed["isoforest_tier_missing_replicas"]
            assert missing[(("replica", "r0"),)] == 0
            assert missing[(("replica", "r1"),)] == 1
        finally:
            tier.close()

    def test_merge_conflicts_are_typed_500s_over_http(self):
        snap_r0 = {"metrics": {
            "stub_seconds": _hist_doc([0.1, "+Inf"], [1, 0], 1, 0.05)}}
        snap_r1 = {"metrics": {
            "stub_seconds": _hist_doc([0.2, "+Inf"], [1, 0], 1, 0.05)}}
        tier = _StubTier(
            [("r0", _stub_server({"/snapshot": snap_r0})),
             ("r1", _stub_server({"/snapshot": snap_r1}))]
        )
        try:
            status, body = _get(tier.front.url, "/metrics")
            assert status == 500
            assert json.loads(body)["error"] == "bucket_mismatch"
            status, body = _get(tier.front.url, "/snapshot")
            assert status == 500
            assert json.loads(body)["error"] == "bucket_mismatch"
        finally:
            tier.close()

    def test_tier_traces_recent_merges_newest_first(self):
        tier = _StubTier(
            [("r0", _stub_server({"/traces/recent": {
                "traces": [{"trace_id": "t-old", "start_unix_s": 5.0}]}})),
             ("r1", _stub_server({"/traces/recent": {
                "traces": [{"trace_id": "t-new", "start_unix_s": 9.0}]}}))]
        )
        try:
            status, body = _get(tier.front.url, "/traces/recent?limit=5")
            assert status == 200
            doc = json.loads(body)
            assert doc["federated"] is True
            heads = [(t["trace_id"], t["source"]) for t in doc["traces"]]
            assert heads[0] == ("t-new", "r1")
            assert ("t-old", "r0") in heads
        finally:
            tier.close()

    def test_tier_bundle_recovers_victim_journal_with_torn_tail(self, tmp_path):
        """The flight-recorder proof: a dead replica contributes its spool
        off disk — last events, last committed trace, torn final line —
        and the bundle still names it missing (journal recovery is not
        liveness)."""
        journal_dir = tmp_path / "journal"
        victim_spool = journal_dir / "r1"
        victim_spool.mkdir(parents=True)
        committed = {
            "trace_id": "vic-7",
            "root": "serving.request",
            "spans": [
                {"name": "serving.request", "span_id": "s1", "parent_id": None},
                {"name": "serving.flush", "span_id": "s2", "parent_id": None},
            ],
        }
        with open(victim_spool / "segment-00000.ndjson", "w") as fh:
            fh.write(json.dumps({"type": "open", "name": "r1", "segment": 0}) + "\n")
            fh.write(json.dumps({
                "type": "event", "seq": 0, "unix_s": 1.0,
                "kind": "journal.start", "name": "r1"}) + "\n")
            fh.write(json.dumps({
                "type": "event", "seq": 1, "unix_s": 2.0,
                "kind": "fleet.load", "model_id": "alpha"}) + "\n")
            fh.write(json.dumps({"type": "trace", "trace": committed}) + "\n")
            fh.write('{"type": "event", "seq": 2, "kin')  # SIGKILL mid-write

        live_bundle = {"schema": "stub-bundle", "events": []}
        tier = _StubTier(
            [("r0", _stub_server({"/debug/bundle": live_bundle}))],
            dead=("r1",),
            journal_dir=str(journal_dir),
        )
        try:
            status, body = _get(tier.front.url, "/debug/bundle")
            assert status == 200
            doc = json.loads(body)
            # the router's own single-process bundle sections stay at the
            # top level; federation is strictly additive
            assert "events" in doc and doc["router"]["router"] is True
            assert doc["federated"] is True
            assert doc["missing_replicas"] == ["r1"]
            assert doc["replicas"]["r0"] == live_bundle
            recovered = doc["replicas"]["r1"]["journal"]
            assert recovered["torn_tail"] is True
            kinds = [
                r.get("kind") for r in recovered["records"]
                if r.get("type") == "event"
            ]
            assert kinds == ["journal.start", "fleet.load"]
            trace_records = [
                r for r in recovered["records"] if r.get("type") == "trace"
            ]
            assert trace_records[0]["trace"]["trace_id"] == "vic-7"
            names = [s["name"] for s in trace_records[0]["trace"]["spans"]]
            assert "serving.flush" in names
        finally:
            tier.close()

    def test_unmount_restores_single_process_views(self):
        tier = _StubTier([("r0", _stub_server({"/snapshot": SNAP_R0}))])
        try:
            status, body = _get(tier.front.url, "/snapshot")
            assert json.loads(body)["federated"] is True
        finally:
            tier.close()
        # after unmount (inside close) a fresh server serves the built-in
        server = MetricsServer(port=0).start()
        try:
            status, body = _get(server.url, "/snapshot")
            assert status == 200
            assert "federated" not in json.loads(body)
        finally:
            server.stop()


# --------------------------------------------------------------------------- #
# parity: both packages on the same documents and the same spools
# --------------------------------------------------------------------------- #

SOURCES = ("router", "r0", "r1")
EDGES = [0.001, 0.01, 0.1, 1.0, "+Inf"]


def _seeded_sources(seed):
    """Per-source registry snapshots, events, trace summaries and span
    lists made from ``seed`` with numpy: counters and histograms with
    shared label sets (so merges sum), gauges, hostile label values, and a
    request trace that crosses from the router to each replica."""
    rng = np.random.default_rng(seed)
    tenants = ["alpha", 'say "hi"', "back\\slash", "line\nbreak", "é"]
    metrics, events, recent, spans = {}, {}, {}, {}
    for i, source in enumerate(SOURCES):
        doc = {
            "isoforest_stub_requests_total": {
                "type": "counter", "help": "requests", "labelnames": ["tenant", "code"],
                "series": [{"labels": {"tenant": t, "code": str(c)}, "value": float(rng.integers(0, 50))}
                           for t in tenants[: 2 + i] for c in (200, 503)],
            },
            "isoforest_stub_depth": {
                "type": "gauge", "help": "depth", "labelnames": [],
                "series": [{"labels": {}, "value": float(rng.normal())}],
            },
        }
        series = []
        for t in tenants[:3]:
            counts = [int(c) for c in rng.integers(0, 9, len(EDGES))]
            lo, hi = sorted(float(v) for v in rng.uniform(1e-4, 2.0, 2))
            series.append({"labels": {"tenant": t}, "count": sum(counts), "sum": float(rng.uniform(0, 5)),
                           "min": lo, "max": hi, "buckets": [[b, c] for b, c in zip(EDGES, counts)]})
        doc["isoforest_stub_seconds"] = {"type": "histogram", "help": "latency", "labelnames": ["tenant"],
                                         "series": series}
        if i == 2:  # a metric only one source has
            doc["isoforest_stub_only_r1"] = {"type": "counter", "help": "", "labelnames": [],
                                             "series": [{"labels": {}, "value": 3}]}
        metrics[source] = doc
        events[source] = [{"seq": k, "unix_s": float(rng.uniform(0, 100)), "kind": f"stub.{k % 3}"}
                          for k in range(int(rng.integers(1, 6)))]
        recent[source] = [{"trace_id": f"t{source}{k}", "start_unix_s": float(rng.uniform(0, 100))}
                          for k in range(3)]
        if source == "router":
            spans[source] = [{"name": "router.request", "trace_id": "x-1", "span_id": "rr", "parent_id": None,
                              "thread": "front", "start_unix_s": 10.0, "wall_s": 0.01, "attrs": {"path": "/score"},
                              "links": []}]
        else:
            spans[source] = [
                {"name": "serving.request", "trace_id": "x-1", "span_id": f"q{i}", "parent_id": None,
                 "thread": f"srv-{i}", "start_unix_s": 10.001 + i * 1e-3, "wall_s": 0.005, "attrs": {},
                 "links": []},
                {"name": "serving.flush", "trace_id": f"f-{i}", "span_id": f"f{i}", "parent_id": None,
                 "thread": "flush", "start_unix_s": 10.002, "wall_s": 0.002, "attrs": {"rows": 1},
                 "links": [["x-1", f"q{i}"]]},
            ]
    return metrics, events, recent, spans


def _jax_federation():
    from isoforest_tpu.telemetry import federation as jax_federation

    return jax_federation


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merges_equal_the_jax_packages(seed):
    jf = _jax_federation()
    metrics, events, recent, spans = _seeded_sources(seed)
    named = [(s, metrics[s]) for s in SOURCES]
    merged = federation.merge_metrics(named)
    assert merged == jf.merge_metrics(named)
    text = federation.metrics_to_prometheus(merged)
    assert text == jf.metrics_to_prometheus(merged)
    assert text.encode() == jf.metrics_to_prometheus(jf.merge_metrics(named)).encode()
    assert telemetry.parse_prometheus(text)["isoforest_stub_only_r1"][()] == 3
    named_events = [(s, events[s]) for s in SOURCES]
    assert federation.merge_events(named_events) == jf.merge_events(named_events)
    snaps = [(s, {"metrics": metrics[s], "events": events[s], "generated_unix_s": float(i),
                  "events_dropped": i, "traces": {"kept": i}, "telemetry_enabled": i == 1})
             for i, s in enumerate(SOURCES)]
    assert federation.merge_snapshots(snaps, missing_replicas=["r9"]) == jf.merge_snapshots(
        snaps, missing_replicas=["r9"])
    named_recent = [(s, recent[s]) for s in SOURCES]
    for limit in (0, 2, 20):
        assert federation.merge_recent_traces(named_recent, limit=limit) == jf.merge_recent_traces(
            named_recent, limit=limit)
    docs = [(s, {"spans": spans[s], "linked": []}) for s in SOURCES]
    assert federation.federated_trace_spans(docs, "x-1") == jf.federated_trace_spans(docs, "x-1")
    named_spans = [(s, spans[s]) for s in SOURCES]
    chrome = federation.federated_chrome(named_spans, "x-1", missing_replicas=["r9"])
    want = jf.federated_chrome(named_spans, "x-1", missing_replicas=["r9"])
    assert json.dumps(chrome, sort_keys=True) == json.dumps(want, sort_keys=True)
    # the cross-process arrows: router lane into each replica's request root
    assert sum(1 for e in chrome["traceEvents"] if e["name"] == "route" and e["ph"] == "s") == 2


def test_refusals_equal_the_jax_packages():
    jf = _jax_federation()
    cases = [
        [("r0", {"m": _hist_doc([0.1, "+Inf"], [1, 0], 1, 0.05)}),
         ("r1", {"m": _hist_doc([0.2, "+Inf"], [1, 0], 1, 0.05)})],
        [("r0", {"m": _counter_doc(1)}), ("r1", {"m": {"type": "gauge", "help": "", "labelnames": [],
                                                       "series": []}})],
        [("r0", {"m": _counter_doc(1, labelnames=["a"])}), ("r1", {"m": _counter_doc(1, labelnames=["b"])})],
        [("r0", {}), ("r0", {})],
        [("r0", {"m": {"type": "summary", "series": []}})],
    ]
    for sources in cases:
        with pytest.raises(federation.FederationError) as ours:
            federation.merge_metrics(sources)
        with pytest.raises(jf.FederationError) as theirs:
            jf.merge_metrics(sources)
        assert type(ours.value).__name__ == type(theirs.value).__name__
        assert federation.error_payload(ours.value) == jf.error_payload(theirs.value)


def _write_records(journal):
    journal.append({"type": "event", "seq": 0, "unix_s": 1.5, "kind": "fleet.load", "model_id": "alpha"})
    journal.append({"type": "trace", "trace": {"trace_id": "t-1", "root": "serving.request",
                                               "spans": [{"name": "serving.request", "span_id": "s1"}]}})
    journal.append({"type": "event", "seq": 1, "unix_s": 2.5, "kind": "odd", "value": {1, 2}})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_spool(tmp_path, writer):
    from isoforest_tpu.telemetry import journal as jax_journal
    from isoforest_tpu_torch.telemetry import journal as port_journal

    write_mod, read_mod = (port_journal, jax_journal) if writer == "port" else (jax_journal, port_journal)
    j = write_mod.Journal(str(tmp_path), "victim", max_segment_bytes=300, fsync_every=2)
    for _ in range(4):
        _write_records(j)
    j.close()
    spool_dir = str(tmp_path / "victim")
    assert read_mod.list_spools(str(tmp_path)) == write_mod.list_spools(str(tmp_path)) == ["victim"]
    theirs, ours = read_mod.read_spool(spool_dir), write_mod.read_spool(spool_dir)
    assert theirs == ours and theirs["segments"] > 1 and not theirs["torn_tail"]
    assert sum(1 for r in theirs["records"] if r.get("kind") == "fleet.load") >= 1
    # a kill -9 mid-write: the newest segment ends in half a record
    last = sorted(os.listdir(spool_dir))[-1]
    with open(os.path.join(spool_dir, last), "a") as fh:
        fh.write('{"type": "event", "seq": 9, "ki')
    theirs, ours = read_mod.read_spool(spool_dir, tail=3), write_mod.read_spool(spool_dir, tail=3)
    assert theirs == ours and theirs["torn_tail"] is True and len(theirs["records"]) == 3


def test_the_same_records_are_the_same_bytes(tmp_path):
    """After each segment's ``open`` header (pid and time differ), both
    packages write the same records as the same bytes."""
    from isoforest_tpu.telemetry import journal as jax_journal

    for name, mod in (("port", None), ("jax", jax_journal)):
        j = (mod.Journal if mod else Journal)(str(tmp_path), name, fsync_every=0)
        _write_records(j)
        j.close()
    texts = {}
    for name in ("port", "jax"):
        with open(tmp_path / name / "segment-00000.ndjson", "rb") as fh:
            texts[name] = fh.read().split(b"\n", 1)
    assert texts["port"][1] == texts["jax"][1]
    assert json.loads(texts["port"][0]).keys() == json.loads(texts["jax"][0]).keys()


def test_the_port_journal_records_the_jax_journals_shapes(tmp_path):
    """Activated in each package, the same events and the same trace make
    records of the same shape: the event and trace records carry the same
    keys, the traces the same spans."""
    from isoforest_tpu import telemetry as jax_telemetry

    spools = {}
    for name, tel in (("port", telemetry), ("jax", jax_telemetry)):
        tel.reset()
        tel.set_trace_policy(slow_threshold_s=0.0, sample_every=1)
        tel.activate_journal(str(tmp_path), name)
        tel.record_event("fleet.load", model_id="alpha", generation=1)
        with tel.with_context(tel.TraceContext("shape-1")):
            with tel.span("serving.request", rows=3):
                pass
        tel.deactivate_journal()
        spools[name] = tel.read_spool(str(tmp_path / name))
    jax_telemetry.set_trace_policy(slow_threshold_s=0.25, sample_every=1)
    jax_telemetry.reset()

    def shape(spool):
        out = []
        for r in spool["records"]:
            if r["type"] == "trace":
                out.append(("trace", sorted(r["trace"]), [(s["name"], sorted(s)) for s in r["trace"]["spans"]]))
            elif r["type"] == "event":
                out.append(("event", r["kind"], sorted(k for k in r if k not in ("name", "spool_dir", "records"))))
            else:
                out.append(("open", sorted(r)))
        return out

    assert shape(spools["port"]) == shape(spools["jax"])
