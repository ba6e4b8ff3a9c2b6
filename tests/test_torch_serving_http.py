"""``POST /score`` and the telemetry daemon of the port
(``isoforest_tpu_torch/serving/http.py``, ``telemetry/http.py``) on the CPU.

Wire parity: each package's ``handle_score`` over its own ``ScoringService``
with the same stand-in scorer gives the same status, content type, body and
headers for the same request bodies (trace ids seeded alike in both). Then
the port's server over a real socket: ``serve_model(device="cpu",
lifecycle=False)`` over both committed fixtures answers within 2e-6 of the
committed JAX scores, and as ``model.score`` of the same rows does; the
telemetry endpoints answer; the fault seams and ``/healthz``'s heartbeats
work on the wire. The managed path (``lifecycle=True``) answers ``POST
/score`` and ``POST /reload`` as the JAX package's managed server does,
before and after a generation is pushed into the work directory. Every
socket wait has a timeout.
"""

from __future__ import annotations

import http.client
import json
import os
import pathlib
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from isoforest_tpu import serving as jax_serving
from isoforest_tpu.telemetry import http as jax_http
from isoforest_tpu.telemetry import spans as jax_spans
from isoforest_tpu_torch import load_model, serving, telemetry
from isoforest_tpu_torch.resilience import faults, watchdog
from isoforest_tpu_torch.telemetry import http as torch_http
from isoforest_tpu_torch.telemetry import spans as torch_spans

RESOURCES = pathlib.Path(__file__).parent / "resources"
FIXTURES = {"standard": RESOURCES / "torch_port" / "mammography_std",
            "extended": RESOURCES / "torch_port" / "mammography_eif"}
# the committed JAX scores of each fixture's served strategy (``walk``: on the
# CPU ``auto`` resolves to it); the EIF walk keeps the reference's own tie
# split from its gather walk, so it is held to the JAX walk's scores
JAX_SCORES = {"standard": "jax_scores.npy", "extended": "jax_walk_scores.npy"}
TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.enable()
    telemetry.reset()
    telemetry.reset_resources()
    yield
    telemetry.enable()
    telemetry.reset()
    telemetry.reset_resources()


@pytest.fixture(scope="module")
def mammography():
    d = np.loadtxt(RESOURCES / "mammography.csv", delimiter=",", comments="#").astype(np.float32)
    return np.ascontiguousarray(d[:, :-1])


def _echo_score(X):
    """The JAX package's stand-in scorer (``tests/test_serving.py``)."""
    return np.asarray(X, np.float64).sum(axis=1)


class _JaxStub:
    total_num_features = 2

    def score(self, X, timeout_s=None, **kw):
        return _echo_score(X)

    def predict(self, scores):
        return (np.asarray(scores) >= 1.0).astype(np.float64)


class _TorchStub(_JaxStub):
    def predict(self, scores):
        return (scores >= 1.0).to(torch.float64)


CONFIG = dict(batch_rows=64, linger_ms=0.0, max_queue_rows=64, request_timeout_s=30.0)


@pytest.fixture(scope="module")
def services():
    """One service of each package over the stand-in scorer, each with its
    flusher thread (a request waits on its own flush's event)."""
    ours = serving.ScoringService(model=_TorchStub(), config=serving.ServingConfig(**CONFIG))
    theirs = jax_serving.ScoringService(model=_JaxStub(), config=jax_serving.ServingConfig(**CONFIG))
    yield ours, theirs
    ours.close()
    theirs.close()


ROWS = [[1.5, -0.25], [0.0, 3.0], [2.0, 2.0]]
WIRE_CASES = {
    "json_single_row": (json.dumps({"row": ROWS[0]}).encode(), {}, ""),
    "json_batch": (json.dumps({"rows": ROWS}).encode(), {"Content-Type": "application/json"}, ""),
    "csv": (b"1.5,-0.25\n0.0,3.0\n# a comment\n2,2\n", {"Content-Type": "text/csv"}, ""),
    "csv_by_query": (b"1.5,-0.25\n", {}, "format=csv"),
    "inbound_trace_id": (json.dumps({"rows": ROWS}).encode(), {"X-Isoforest-Trace": "client.trace-1"}, ""),
    "junk_trace_id_ignored": (json.dumps({"rows": ROWS}).encode(), {"X-Isoforest-Trace": "bad id!"}, ""),
    "oversize_429": (json.dumps({"rows": [[1.0, 2.0]] * 65}).encode(), {}, ""),
}
MALFORMED_JSON = [b"{nope", b'{"rows": "not-a-matrix"}', b'{"row": [1], "rows": [[1]]}', b'{"neither": 1}',
                  b'{"rows": []}', b'{"rows": [[1, "x"]]}', b"\xff\xfe", b"[1,2]", b'{"rows": [[[1]]]}']
MALFORMED_CSV = [b"1,2,banana\n", b"", b"\xff\xfe", b"  \n"]
for i, body in enumerate(MALFORMED_JSON):
    WIRE_CASES[f"malformed_json_{i}"] = (body, {}, "")
for i, body in enumerate(MALFORMED_CSV):
    WIRE_CASES[f"malformed_csv_{i}"] = (body, {"Content-Type": "text/csv"}, "")


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_handle_score_answers_as_the_jax_package_does(services, case):
    body, headers, query = WIRE_CASES[case]
    ours, theirs = services
    torch_spans.seed_trace_ids(77)
    got = serving.handle_score(ours, body, headers, query)
    jax_spans.seed_trace_ids(77)
    want = jax_serving.handle_score(theirs, body, headers, query)
    assert got == want
    if case.startswith("malformed"):
        assert got[0] == 400
    if case == "oversize_429":
        assert got[0] == 429 and got[3]["Retry-After"] == "1"


class _RaisingService:
    """A service whose queue raises: the handler's status ladder alone."""

    def __init__(self, exc, config):
        self.manager = None
        self.config = config

        class _Coalescer:
            def submit(_self, rows):
                raise exc

        self.coalescer = _Coalescer()

    def check_admission(self):
        return None


LADDER = [("QueueFullError", 429), ("QueueStaleError", 503), ("RequestTimeoutError", 503),
          ("CoalescerClosedError", 503), ("RuntimeError", 500)]


@pytest.mark.parametrize("name,status", LADDER)
def test_the_status_ladder_is_the_jax_packages(name, status):
    def make(module):
        exc = RuntimeError("scoring exploded") if name == "RuntimeError" else getattr(module, name)("refused")
        if name == "QueueStaleError":
            exc.retry_after_s = 2.2
        return _RaisingService(exc, module.ServingConfig())

    body = json.dumps({"rows": [[1.0, 2.0]]}).encode()
    torch_spans.seed_trace_ids(5)
    got = serving.handle_score(make(serving), body, {})
    jax_spans.seed_trace_ids(5)
    want = jax_serving.handle_score(make(jax_serving), body, {})
    assert got == want
    assert got[0] == status and json.loads(got[2])["status"] == status
    assert ("Retry-After" in got[3]) == (status in (429, 503))


def test_reload_without_a_manager_answers_as_the_jax_package_does(services):
    ours, theirs = services
    assert serving.http.handle_reload(ours, b"", {}) == jax_serving.http.handle_reload(theirs, b"", {})


@pytest.mark.parametrize("status,after", [(429, None), (503, 0.2), (503, 3.5), (200, 1.0), (500, None)])
def test_retry_after_headers_are_the_jax_packages(status, after):
    assert serving.http.retry_after_headers(status, after) == jax_serving.http.retry_after_headers(status, after)


def _request(url, path, body=None, content_type="application/json", headers=None):
    """``(status, headers, text)`` of one request, with a timeout."""
    req = urllib.request.Request(url + path, data=body, headers={"Content-Type": content_type, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read().decode()


def test_an_unknown_post_path_is_the_jax_packages_404(services):
    ours, theirs = services
    servers = []
    try:
        for module, svc, mount in ((torch_http, ours, serving.mount), (jax_http, theirs, jax_serving.mount)):
            server = module.MetricsServer(port=0).start()
            servers.append(server)
            mount(server, svc)
        got, want = (_request(s.url, "/nope", b"{}") for s in servers)
        assert got[0] == want[0] == 404
        assert got[2] == want[2] and got[1]["Content-Type"] == want[1]["Content-Type"]
        assert json.loads(got[2])["routes"] == ["/reload", "/score"]
    finally:
        for server in servers:
            server.stop()


# --------------------------------------------------------------------------- #
# the port's server over a real socket
# --------------------------------------------------------------------------- #


# rows of the JSON and the CSV request: the standard fixture's CSV passes the
# largest warmed bucket (1,024) and streams in 1,024-row chunks; the EIF's
# plain walk costs about 1 ms a row on the CPU, so it takes fewer
SOCKET_ROWS = {"standard": (64, 1500), "extended": (16, 200)}


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_serve_model_answers_within_2e6_of_the_jax_scores(kind, mammography):
    """JSON and CSV requests through ``serve_model(device="cpu",
    lifecycle=False)``: each answer equals ``model.score`` of the same rows
    in the same chunks exactly (a request flushes alone here), one call over
    them within 1 ulp, and the committed JAX scores within 2e-6."""
    jax_scores = np.load(FIXTURES[kind] / JAX_SCORES[kind])
    n_json, n_csv = SOCKET_ROWS[kind]
    config = serving.ServingConfig(linger_ms=0.0, max_queue_rows=1 << 14, request_timeout_s=TIMEOUT_S)
    with serving.serve_model(str(FIXTURES[kind] / "model"), device="cpu", lifecycle=False, config=config,
                             warm_batch_sizes=(1, 64)) as handle:
        model = handle.service.model
        assert model.device.type == "cpu" and handle.manager is None
        rows = mammography[:n_json]
        status, headers, body = _request(handle.url, "/score", json.dumps({"rows": rows.tolist()}).encode())
        assert status == 200, body
        doc = json.loads(body)
        assert doc["rows"] == n_json and doc["generation"] is None and doc["flush_requests"] == 1
        got = np.asarray(doc["scores"], np.float32)
        np.testing.assert_array_equal(got, model.score(rows).numpy())
        assert np.abs(got - jax_scores[:n_json]).max() <= 2e-6
        np.testing.assert_array_equal(doc["predictions"], model.predict(torch.from_numpy(got)).numpy())
        rows = mammography[n_json:n_json + n_csv]
        csv = "\n".join(",".join(repr(float(v)) for v in row) for row in rows).encode()
        status, headers, body = _request(handle.url, "/score", csv, content_type="text/csv")
        assert status == 200 and headers["Content-Type"].startswith("text/csv")
        lines = body.strip().splitlines()
        assert lines[0] == "outlierScore"
        got = np.asarray([float(s) for s in lines[1:]], np.float32)
        np.testing.assert_array_equal(got, model.score(rows, chunk_size=1024).numpy())
        if n_csv > 1024:
            np.testing.assert_array_max_ulp(got, model.score(rows).numpy(), maxulp=1)
        assert np.abs(got - jax_scores[n_json:n_json + n_csv]).max() <= 2e-6
        assert telemetry.compile_counts()["by_phase"]["steady"] == 0


def test_the_managed_path_answers_score_and_reload_as_the_jax_package_does(mammography, tmp_path):
    """Both packages' ``serve_model(lifecycle=True)`` over the standard
    fixture, each with its own work directory: ``/score`` answers with the
    same keys and generation (scores within 2e-6), ``/reload`` with the same
    body before a push and after one (a sealed generation directory and
    ``CURRENT.json`` written into each work directory), and the next answer
    names generation 2 in both."""
    import shutil

    fixture = FIXTURES["standard"] / "model"
    rows = mammography[:16]
    body = json.dumps({"rows": rows.tolist()}).encode()
    ours = serving.serve_model(str(fixture), device="cpu", work_dir=str(tmp_path / "ours"),
                               config=serving.ServingConfig(linger_ms=0.0, request_timeout_s=TIMEOUT_S))
    theirs = jax_serving.serve_model(str(fixture), work_dir=str(tmp_path / "theirs"),
                                     config=jax_serving.ServingConfig(linger_ms=0.0, request_timeout_s=TIMEOUT_S))
    try:
        assert ours.manager is not None and theirs.manager is not None

        def both(path, payload=b"{}"):
            got, want = _request(ours.url, path, payload), _request(theirs.url, path, payload)
            assert got[0] == want[0] == 200 and got[1]["Content-Type"] == want[1]["Content-Type"]
            return json.loads(got[2]), json.loads(want[2])

        def same_answer(generation):
            got, want = both("/score", body)
            assert sorted(got) == sorted(want) and got["generation"] == want["generation"] == generation
            assert np.abs(np.asarray(got["scores"]) - np.asarray(want["scores"])).max() <= 2e-6

        same_answer(1)
        got, want = both("/reload")
        assert got == want == {"reloaded": False, "lifecycle": True, "generation": 1}
        for handle in (ours, theirs):
            work = handle.manager.work_dir
            shutil.copytree(str(fixture), os.path.join(work, "gen-00002"))
            with open(os.path.join(work, "CURRENT.json"), "w") as fh:
                json.dump({"generation": 2, "path": os.path.join(work, "gen-00002"), "swapped_unix_s": 5.0}, fh)
        got, want = both("/reload")
        assert got == want == {"reloaded": True, "lifecycle": True, "generation": 2}
        assert ours.manager.model.device.type == "cpu"
        same_answer(2)
        got, want = both("/reload")
        assert got == want == {"reloaded": False, "lifecycle": True, "generation": 2}
        health, jax_health = (json.loads(_request(h.url, "/healthz")[2]) for h in (ours, theirs))
        for key in ("model_path",):
            health["lifecycle"].pop(key), jax_health["lifecycle"].pop(key)
        assert health["lifecycle"] == jax_health["lifecycle"]
    finally:
        theirs.close()
        ours.close()


def test_the_telemetry_endpoints_answer(mammography):
    config = serving.ServingConfig(linger_ms=0.0, request_timeout_s=TIMEOUT_S)
    with serving.serve_model(str(FIXTURES["standard"] / "model"), device="cpu", lifecycle=False,
                             config=config) as handle:
        url = handle.url
        sent = {200: 0, 400: 0}
        trace_id = None
        for i in range(3):
            status, headers, _ = _request(url, "/score", json.dumps({"row": mammography[i].tolist()}).encode())
            sent[status] += 1
            trace_id = headers["X-Isoforest-Trace"]
        sent[_request(url, "/score", b"{nope")[0]] += 1
        status, _, text = _request(url, "/metrics")
        assert status == 200
        parsed = telemetry.parse_prometheus(text)
        responses = {dict(k)["code"]: v for k, v in parsed["isoforest_serving_responses_total"].items()}
        assert responses == {"200": 3.0, "400": 1.0} and sent == {200: 3, 400: 1}
        status, _, text = _request(url, "/healthz")
        doc = json.loads(text)
        assert status == 200 and doc["status"] == "ok" and "lifecycle" not in doc
        assert doc["serving"]["batch_rows"] == 1024 and doc["serving"]["lifecycle"] is False
        status, _, text = _request(url, "/snapshot")
        assert status == 200 and "isoforest_serving_request_seconds" in json.loads(text)["metrics"]
        status, _, text = _request(url, "/trace?trace_id=" + trace_id)
        chrome = json.loads(text)
        assert status == 200 and chrome["otherData"]["trace_id"] == trace_id
        assert {"serving.request", "serving.flush"} <= {e["name"] for e in chrome["traceEvents"] if e["ph"] == "X"}
        status, _, text = _request(url, "/trace?trace_id=" + trace_id + "&format=spans")
        assert status == 200 and json.loads(text)["trace_id"] == trace_id
        assert _request(url, "/trace")[0] == 400
        assert _request(url, "/trace?trace_id=ffff000000000000")[0] == 404
        status, _, text = _request(url, "/traces/recent?limit=2")
        assert status == 200 and len(json.loads(text)["traces"]) <= 2
        status, _, text = _request(url, "/debug/bundle")
        bundle = json.loads(text)
        assert status == 200 and sorted(bundle) == sorted(telemetry.BUNDLE_SECTIONS)
        assert bundle["compiles"]["by_phase"]["steady"] == 0 and bundle["compiles"]["by_phase"]["warmup"] >= 1
        assert _request(url, "/")[0] == 200 and _request(url, "/nowhere")[0] == 404


def test_concurrent_requests_coalesce_and_each_gets_its_own_rows(mammography):
    """Eight threads post one row each through a barrier; each answer is its
    own row's score within 1 ulp (the CPU's ``exp2`` by vector position),
    and every request was served by a flush."""
    model = load_model(str(FIXTURES["standard"] / "model"), device="cpu")
    want = model.score(mammography[:8]).numpy()
    config = serving.ServingConfig(linger_ms=20.0, request_timeout_s=TIMEOUT_S)
    results, errors = [None] * 8, []
    go = threading.Barrier(8)
    with serving.serve_model(str(FIXTURES["standard"] / "model"), device="cpu", lifecycle=False,
                             config=config) as handle:
        def worker(i):
            try:
                go.wait(timeout=TIMEOUT_S)
                status, _, body = _request(handle.url, "/score", json.dumps({"row": mammography[i].tolist()})
                                           .encode())
                assert status == 200, body
                results[i] = json.loads(body)["scores"][0]
            except Exception as exc:  # surfaced below
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
        assert not any(t.is_alive() for t in threads) and not errors, errors
    np.testing.assert_array_max_ulp(np.asarray(results, np.float32), want, maxulp=1)
    snap = telemetry.registry().snapshot()
    assert snap["isoforest_serving_coalesced_requests_total"]["series"][0]["value"] == 8
    flushes = sum(s["value"] for s in snap["isoforest_serving_flushes_total"]["series"])
    assert 1 <= flushes <= 8


def test_healthz_reads_the_heartbeats(tmp_path):
    server = torch_http.MetricsServer(port=0, heartbeat_dir=str(tmp_path), stale_after_s=5.0).start()
    try:
        watchdog.HeartbeatWriter(str(tmp_path), "w0").beat()
        status, _, text = _request(server.url, "/healthz")
        doc = json.loads(text)
        assert status == 200 and doc["status"] == "ok" and list(doc["peers"]) == ["w0"]
        (tmp_path / "heartbeat-w1.json").write_text("{torn")
        status, _, text = _request(server.url, "/health")
        doc = json.loads(text)
        assert status == 503 and doc["stale_peers"] == ["w1"] and doc["peers"]["w1"] is None
    finally:
        server.stop()


def test_a_replica_kill_severs_one_request_and_the_next_is_served(mammography):
    config = serving.ServingConfig(linger_ms=0.0, request_timeout_s=TIMEOUT_S)
    body = json.dumps({"row": mammography[0].tolist()}).encode()
    with serving.serve_model(str(FIXTURES["standard"] / "model"), device="cpu", lifecycle=False,
                             config=config) as handle:
        with faults.inject(kill_replica_during_score=True):
            with pytest.raises((http.client.RemoteDisconnected, urllib.error.URLError, ConnectionError)):
                _request(handle.url, "/score", body)
            assert _request(handle.url, "/score", body)[0] == 200


def test_a_body_past_the_limit_is_refused_unread():
    server = torch_http.MetricsServer(port=0).start()
    server.register_post("/echo", lambda body, headers, query="": (200, "text/plain", "read"))
    try:
        conn = http.client.HTTPConnection(server.host, server.port, timeout=TIMEOUT_S)
        conn.putrequest("POST", "/echo")
        conn.putheader("Content-Length", str(torch_http.MAX_POST_BYTES + 1))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413 and json.loads(resp.read())["status"] == 413
        conn.close()
    finally:
        server.stop()
    assert torch_http.MAX_POST_BYTES == jax_http.MAX_POST_BYTES


def test_the_metrics_port_variable_starts_and_stop_clears_the_server(monkeypatch):
    assert telemetry.active_server() is None
    monkeypatch.setenv(torch_http.METRICS_PORT_ENV, "0")
    server = telemetry.maybe_serve_from_env()
    try:
        assert server is not None and telemetry.active_server() is server
        assert telemetry.maybe_serve_from_env() is None, "one server a process"
        assert _request(server.url, "/metrics")[0] == 200
    finally:
        server.stop()
    assert telemetry.active_server() is None
    assert [e.kind for e in telemetry.get_events() if e.kind.startswith("metrics_server.")] == [
        "metrics_server.start", "metrics_server.stop"]
    monkeypatch.setenv(torch_http.METRICS_PORT_ENV, "not-a-port")
    assert telemetry.maybe_serve_from_env() is None, "a bad value warns and does not raise"


def test_serve_needs_a_port_and_stop_is_idempotent(monkeypatch):
    monkeypatch.delenv(torch_http.METRICS_PORT_ENV, raising=False)
    with pytest.raises(ValueError, match="ISOFOREST_TPU_METRICS_PORT"):
        torch_http.serve()
    server = torch_http.serve(port=0)
    server.stop()
    server.stop()
    assert len(telemetry.get_events(kind="metrics_server.stop")) == 1
