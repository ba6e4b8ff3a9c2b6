"""The port's online scoring service (``isoforest_tpu_torch/serving``) on the
CPU: the coalescer's policy, parity with ``model.score``, prewarm and the
steady phase, the quality rung's table cache, the watchdog's typed 500,
``serve_model``'s managed path (a baselined model served through a
lifecycle manager, answering as the JAX package's managed server does), the
fault seams and the peer heartbeats.

No real sleeps: the size and linger policy runs threadless on a FakeClock
(``pump()``). On the CPU torch's ``exp2`` rounds by vector position, so a
coalesced flush's scores equal ``model.score`` of exactly the flushed rows,
and ``model.score`` of one request alone within 1 ulp; each test says which.
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import pytest
import torch

from isoforest_tpu_torch import load_model, telemetry
from isoforest_tpu_torch.ops.streaming import pipeline_stats
from isoforest_tpu_torch.ops.traversal import score_matrix
from isoforest_tpu_torch.resilience import faults, watchdog
from isoforest_tpu_torch.serving import (
    CoalescerClosedError,
    MicroBatchCoalescer,
    QueueFullError,
    QueueStaleError,
    RequestTimeoutError,
    ScoringService,
    ServingConfig,
    handle_score,
    serve_model,
)

RESOURCES = pathlib.Path(__file__).parent / "resources"
STD = RESOURCES / "torch_port" / "mammography_std" / "model"
EIF = RESOURCES / "torch_port" / "mammography_eif" / "model"


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
def data():
    d = np.loadtxt(RESOURCES / "mammography.csv", delimiter=",", comments="#").astype(np.float32)
    return np.ascontiguousarray(d[:4096, :-1])


@pytest.fixture(scope="module")
def model():
    return load_model(str(STD), device="cpu")


def _echo_score(X):
    """The JAX package's stand-in scorer: each row's score is a function of
    the row alone, so the hand-back is provable."""
    return np.asarray(X, np.float64).sum(axis=1)


def _echo_flush(X):
    """``_echo_score`` as a flush scorer: ``(scores, generation)``, no generation."""
    return _echo_score(X), None


def _coalescer(fc, **kw):
    kw.setdefault("max_batch_rows", 8)
    kw.setdefault("max_linger_s", 0.010)
    kw.setdefault("max_queue_rows", 32)
    kw.setdefault("queue_deadline_s", 1.0)
    return MicroBatchCoalescer(_echo_flush, clock=fc.now, start=False, **kw)


# --------------------------------------------------------------------------- #
# the coalescer's policy (threadless, FakeClock)
# --------------------------------------------------------------------------- #


# (requests as row ranges, max_batch_rows, clock advance before the pump,
#  requests the pump flushes, the flush's cause)
FLUSH_CASES = {
    "below_size_and_linger": ([(0, 3), (3, 6)], 8, 0.0, 0, None),
    "size_drains_whole_requests_up_to_the_batch": ([(0, 3), (3, 6), (6, 9)], 8, 0.0, 2, "size"),
    "before_the_linger_deadline": ([(0, 2)], 8, 0.008, 0, None),
    "past_the_linger_deadline": ([(0, 2)], 8, 0.012, 1, "linger"),
    "oversize_request_drains_alone": ([(0, 20), (20, 21)], 8, 0.0, 1, "size"),
    "never_splits_a_request": ([(0, 3), (3, 6)], 4, 0.0, 1, "size"),
}


@pytest.mark.parametrize("case", sorted(FLUSH_CASES))
def test_flush_policy(case, data):
    ranges, batch, advance, flushed, cause = FLUSH_CASES[case]
    fc = faults.FakeClock()
    c = _coalescer(fc, max_batch_rows=batch)
    pendings = [c.submit(data[lo:hi]) for lo, hi in ranges]
    fc.advance(advance)
    assert c.pump() == flushed
    rows = sum(hi - lo for lo, hi in ranges[:flushed])
    for p, (lo, hi) in zip(pendings[:flushed], ranges):
        np.testing.assert_array_equal(c.result(p, timeout_s=0), _echo_score(data[lo:hi]))
        assert p.flush_rows == rows and p.flush_requests == flushed
    assert not any(p.event.is_set() for p in pendings[flushed:])
    if cause is not None:
        series = telemetry.registry().snapshot()["isoforest_serving_flushes_total"]["series"]
        assert {s["labels"]["cause"]: s["value"] for s in series} == {cause: 1.0}
    fc.advance(1.0)  # whatever stayed queued rides the linger deadline out
    while c.pump():
        pass
    assert all(p.event.is_set() for p in pendings)


def test_admission_ladder_and_wait_budget(data):
    fc = faults.FakeClock()
    c = _coalescer(fc, max_queue_rows=8, max_batch_rows=8)
    p = c.submit(data[:6])
    with pytest.raises(QueueFullError) as full:
        c.submit(data[6:12])
    assert full.value.status == 429 and full.value.retry_after_s == pytest.approx(0.05)
    assert c.pending_rows == 6, "the refused request left no residue"
    with pytest.raises(RequestTimeoutError) as late:
        c.result(p, timeout_s=0)  # nothing pumps: the budget expires at once
    assert late.value.status == 503
    fc.advance(1.5)  # nothing drained the queue: the service is stuck
    with pytest.raises(QueueStaleError) as stale:
        c.submit(data[:1])
    assert stale.value.status == 503 and stale.value.retry_after_s == 1.0


def test_a_score_error_reaches_every_waiter(data):
    fc = faults.FakeClock()

    def boom(X):
        raise RuntimeError("kernel exploded")

    c = MicroBatchCoalescer(boom, max_batch_rows=4, clock=fc.now, start=False)
    p1, p2 = c.submit(data[:2]), c.submit(data[2:4])
    assert c.pump() == 2
    for p in (p1, p2):
        with pytest.raises(RuntimeError, match="kernel exploded"):
            c.result(p, timeout_s=0)


@pytest.mark.parametrize("drain", [True, False])
def test_close_drains_or_fails_the_stragglers_then_refuses(data, drain):
    fc = faults.FakeClock()
    c = _coalescer(fc)
    p = c.submit(data[:2])
    c.close(drain=drain)
    if drain:
        np.testing.assert_array_equal(c.result(p, timeout_s=0), _echo_score(data[:2]))
    else:
        with pytest.raises(CoalescerClosedError):
            c.result(p, timeout_s=0)
    with pytest.raises(CoalescerClosedError):
        c.submit(data[:1])


def test_queue_depth_gauge_tracks_rows(data):
    fc = faults.FakeClock()
    c = _coalescer(fc, max_batch_rows=16)
    c.submit(data[:3])
    c.submit(data[3:5])
    depth = lambda: telemetry.registry().snapshot()["isoforest_serving_queue_depth"]["series"][0]["value"]  # noqa: E731
    assert depth() == 5
    fc.advance(1.0)
    c.pump()
    assert depth() == 0


def test_reconfigure_takes_effect_and_returns_the_old_policy(data):
    fc = faults.FakeClock()
    c = _coalescer(fc)
    c.submit(data[:3])
    assert c.reconfigure(max_batch_rows=2) == {"max_batch_rows": 8, "max_linger_s": 0.010}
    assert c.pump() == 1, "3 rows now pass the size trigger"
    with pytest.raises(ValueError, match="max_queue_rows"):
        c.reconfigure(max_batch_rows=64)


def test_bad_knobs_are_refused():
    with pytest.raises(ValueError, match="max_batch_rows"):
        MicroBatchCoalescer(_echo_flush, max_batch_rows=0, start=False)
    with pytest.raises(ValueError, match="max_queue_rows"):
        MicroBatchCoalescer(_echo_flush, max_batch_rows=64, max_queue_rows=32, start=False)
    with pytest.raises(ValueError, match="queue_deadline_s"):
        MicroBatchCoalescer(_echo_flush, queue_deadline_s=0, start=False)
    with pytest.raises(ValueError, match="exactly one"):
        ScoringService()
    c = MicroBatchCoalescer(_echo_flush, start=False)
    for shape in ((0, 4), (4,)):
        with pytest.raises(ValueError, match="non-empty"):
            c.submit(np.zeros(shape, np.float32))


# --------------------------------------------------------------------------- #
# parity with model.score
# --------------------------------------------------------------------------- #


def test_coalesced_scores_equal_model_score_of_the_flushed_rows(model, data):
    """Mixed-size requests in one flush: each waiter's slice equals
    ``model.score`` of all the flushed rows exactly, and ``model.score`` of
    its own rows within 1 ulp (the CPU's ``exp2``)."""
    fc = faults.FakeClock()
    service = ScoringService(model=model, config=ServingConfig(batch_rows=256, max_queue_rows=1024),
                             clock=fc.now, start=False)
    slices = [(0, 1), (1, 8), (8, 108), (108, 109), (109, 256)]
    pendings = [service.coalescer.submit(data[lo:hi]) for lo, hi in slices]
    assert service.coalescer.pump() == len(slices)
    flushed = model.score(data[:256]).numpy()
    for p, (lo, hi) in zip(pendings, slices):
        got = service.coalescer.result(p, timeout_s=0)
        assert got.dtype == np.float32 and isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, flushed[lo:hi])
        np.testing.assert_array_max_ulp(got, model.score(data[lo:hi]).numpy(), maxulp=1)
        assert p.flush_rows == 256 and p.flush_requests == len(slices)


def test_an_oversized_request_streams_in_warm_bucket_chunks(model, data):
    """Past the largest warmed bucket (``batch_bucket(64) == 1024``) a flush
    streams through the executor in 1,024-row chunks, with the scores of
    ``model.score`` of the same chunks exactly."""
    service = ScoringService(model=model, config=ServingConfig(batch_rows=64), start=False)
    assert service._max_warm_bucket == 1024
    big = np.resize(data, (2500, data.shape[1]))
    before = pipeline_stats("score_matrix")["chunks"]
    pending = service.coalescer.submit(big)
    assert service.coalescer.pump() == 1, "an oversize request drains alone"
    got = service.coalescer.result(pending, timeout_s=0)
    assert pipeline_stats("score_matrix")["chunks"] - before == 3, "2,500 rows in 1,024-row chunks"
    np.testing.assert_array_equal(got, model.score(big, chunk_size=1024).numpy())
    np.testing.assert_array_max_ulp(got, model.score(big).numpy(), maxulp=1)
    service.close()


def test_predictions_are_the_models_labels(model, data):
    service = ScoringService(model=model, start=False)
    scores = model.score(data[:300]).numpy()
    labels = service.predict(scores)
    assert labels.dtype == np.float64
    np.testing.assert_array_equal(labels, model.predict(torch.from_numpy(scores)).numpy())
    assert labels.sum() > 0, "the fixture's threshold marks some of these rows"


# --------------------------------------------------------------------------- #
# prewarm, steady phase, state
# --------------------------------------------------------------------------- #


def test_prewarm_builds_under_warmup_and_steady_flushes_build_nothing(data):
    model = load_model(str(STD), device="cpu")  # fresh table cache
    fc = faults.FakeClock()
    service = ScoringService(model=model, config=ServingConfig(batch_rows=1024), clock=fc.now, start=False)
    decisions = service.prewarm([1, 2000])
    assert [d["bucket"] for d in decisions] == [1024, 2048]
    assert {d["strategy"] for d in decisions} == {"walk"} and service._max_warm_bucket == 2048
    (event,) = telemetry.get_events(kind="serving.warmup")
    assert event.fields == {"buckets": "1024,2048", "strategies": json.dumps({"1024": "walk", "2048": "walk"})}
    decision_sites = {e.fields["site"] for e in telemetry.get_events(kind="autotune.decision")}
    assert "serving.prewarm" in decision_sites
    counts = telemetry.compile_counts()
    assert counts == {"total": 1, "by_site": {"serving.prewarm": 1}, "by_phase": {"steady": 0, "warmup": 1}}
    telemetry.mark_steady()
    p = service.coalescer.submit(data[:5])
    fc.advance(1.0)
    assert service.coalescer.pump() == 1
    np.testing.assert_array_equal(service.coalescer.result(p, timeout_s=0), model.score(data[:5]).numpy())
    assert telemetry.compile_counts()["by_phase"]["steady"] == 0
    assert telemetry.get_events(kind="compile.steady_recompile") == []
    service.close()


def test_state_is_json_types(model):
    service = ScoringService(model=model, start=False)
    doc = service.state()
    assert json.loads(json.dumps(doc)) == doc
    assert doc["lifecycle"] is False and doc["generation"] is None and doc["batch_rows"] == 1024
    service.close()


# --------------------------------------------------------------------------- #
# the brownout rungs
# --------------------------------------------------------------------------- #


def test_quality_rung_scores_the_tree_prefix_on_a_cached_table(model, data):
    """Half the trees: the flush equals ``score_matrix`` of the 50-tree
    prefix, and a second flush reuses the subforest and its tables."""
    fc = faults.FakeClock()
    service = ScoringService(model=model, config=ServingConfig(batch_rows=64), clock=fc.now, start=False)
    service.set_quality(subsample_trees=0.5)
    sub = type(model.forest)(*(leaf[:50] for leaf in model.forest))
    want = score_matrix(sub, data[:20], model.num_samples, device="cpu").numpy()
    for _ in range(2):
        p = service.coalescer.submit(data[:20])
        fc.advance(1.0)
        service.coalescer.pump()
        np.testing.assert_array_equal(service.coalescer.result(p, timeout_s=0), want)
    cache = service._subforest_cache
    assert cache[1] == 50 and ("walk", torch.device("cpu")) in cache[3]
    table = cache[3][("walk", torch.device("cpu"))]
    p = service.coalescer.submit(data[:3])
    fc.advance(1.0)
    service.coalescer.pump()
    assert service._subforest_cache[3][("walk", torch.device("cpu"))] is table
    status, _, body, _ = _handle(service, fc, {"rows": data[:2].tolist()})
    assert status == 200 and json.loads(body)["degraded"] == {"subsample_trees": 0.5, "q16": False}
    service.set_quality()
    assert service.quality is None and service._subforest_cache is None
    with pytest.raises(ValueError, match="subsample_trees"):
        service.set_quality(subsample_trees=1.5)


def _handle(service, fc, doc):
    """``handle_score`` of a JSON body on a threadless service: the request
    is answered once a pump flushes it (the flush runs inside ``submit``'s
    caller through a linger of 0)."""
    service.coalescer.reconfigure(max_linger_s=0.0)
    real_submit = service.coalescer.submit

    def submit_and_flush(rows):
        pending = real_submit(rows)
        service.coalescer.pump()
        return pending

    service.coalescer.submit = submit_and_flush
    try:
        return handle_score(service, json.dumps(doc).encode(), {})
    finally:
        service.coalescer.submit = real_submit


def test_shed_rung_refuses_with_a_typed_429(model, data):
    fc = faults.FakeClock()
    service = ScoringService(model=model, clock=fc.now, start=False)
    service.set_shed(True, retry_after_s=2.5)
    status, _, body, headers = _handle(service, fc, {"row": data[0].tolist()})
    assert status == 429 and json.loads(body)["status"] == 429 and headers["Retry-After"] == "3"
    service.set_shed(False)
    status, _, _, _ = _handle(service, fc, {"row": data[0].tolist()})
    assert status == 200


# --------------------------------------------------------------------------- #
# the watchdog: a stalled flush is a typed 500, never a hang
# --------------------------------------------------------------------------- #


def test_a_stalled_flush_answers_its_waiters_with_a_typed_500(model, data):
    """``score_timeout_s`` arms the scoring watchdog: the port raises
    ``WatchdogTimeout`` (it retries on no other kernel, where the JAX
    package takes its ``scoring_timeout`` rung), and the request gets a 500
    naming it, within the deadline."""
    fc = faults.FakeClock()
    service = ScoringService(model=model, config=ServingConfig(score_timeout_s=0.5), clock=fc.now, start=False)
    try:
        with faults.inject(slow_collective=True):
            status, ctype, body, headers = _handle(service, fc, {"rows": data[:3].tolist()})
    finally:
        assert watchdog.join_abandoned(timeout_s=5.0) == 0
    doc = json.loads(body)
    assert (status, ctype, doc["status"]) == (500, "application/json", 500)
    assert "WatchdogTimeout" in doc["error"] and "Retry-After" not in headers
    assert telemetry.get_events(kind="watchdog.timeout")
    service.config.score_timeout_s = 30.0  # a deadline no CPU flush of 3 rows comes near
    status, _, _, _ = _handle(service, fc, {"rows": data[:3].tolist()})
    assert status == 200, "the next flush scores again"


# --------------------------------------------------------------------------- #
# serve_model: the managed path
# --------------------------------------------------------------------------- #


def _post(url: str, path: str, body: bytes):
    import urllib.request

    req = urllib.request.Request(url + path, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read().decode())


def _get(url: str, path: str):
    import urllib.request

    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return resp.status, json.loads(resp.read().decode())


@pytest.mark.parametrize("fixture", [STD, EIF], ids=["standard", "extended"])
def test_lifecycle_true_on_a_baselined_model_serves_managed(fixture, tmp_path, data):
    """``lifecycle=True`` (the default) wraps a baselined model in a
    ``ModelManager`` on the given device; the answers, the ``/healthz``
    lifecycle section and the ``serving.start`` event are the JAX package's
    managed server's (scores within 2e-6 of the committed JAX walk scores,
    and of the JAX server's within its own gap to them)."""
    from isoforest_tpu import serving as jax_serving
    from isoforest_tpu_torch.lifecycle import ModelManager

    assert (fixture / "_BASELINE.json").exists()
    rows = data[:8]
    body = json.dumps({"rows": rows.tolist()}).encode()
    # 64-row buckets: the CPU's plain EIF walk costs about 1 ms a row
    ours = serve_model(str(fixture), device="cpu", work_dir=str(tmp_path / "ours"),
                       config=ServingConfig(linger_ms=0.0, batch_rows=64))
    try:
        assert isinstance(ours.manager, ModelManager) and ours.service.manager is ours.manager
        assert ours.manager.model.device.type == "cpu" and ours.manager.generation == 1
        start = telemetry.get_events(kind="serving.start")[-1].fields
        assert start["lifecycle"] is True and start["generation"] == 1
        theirs = jax_serving.serve_model(str(fixture), work_dir=str(tmp_path / "theirs"),
                                         config=jax_serving.ServingConfig(linger_ms=0.0, batch_rows=64))
        try:
            (status, got), (jstatus, want) = _post(ours.url, "/score", body), _post(theirs.url, "/score", body)
            assert status == jstatus == 200 and sorted(got) == sorted(want)
            assert got["generation"] == want["generation"] == 1 and got["rows"] == want["rows"] == 8
            jax_walk = np.load(fixture.parent / ("jax_scores.npy" if fixture == STD else "jax_walk_scores.npy"))[:8]
            got_s, want_s = np.asarray(got["scores"]), np.asarray(want["scores"])
            assert np.abs(got_s - jax_walk).max() <= 2e-6
            assert np.abs(got_s - want_s).max() <= np.abs(want_s - jax_walk).max() + 2e-6
            (status, health), (_, jax_health) = _get(ours.url, "/healthz"), _get(theirs.url, "/healthz")
            assert status == 200 and health["lifecycle"] == jax_health["lifecycle"]
            assert health["lifecycle"]["window_rows"] == 8 and health["serving"]["lifecycle"] is True
            assert health["serving"]["generation"] == jax_health["serving"]["generation"] == 1
        finally:
            theirs.close()
    finally:
        ours.close()
    assert ours.manager.closed and telemetry.active_server() is None


def test_a_model_without_a_baseline_warns_and_serves_bare(tmp_path, caplog, data):
    model = load_model(str(STD), device="cpu")
    model.baseline = None
    model.save(str(tmp_path / "m"))
    assert not (tmp_path / "m" / "_BASELINE.json").exists()
    with caplog.at_level("WARNING", logger="isoforest_tpu_torch"):
        handle = serve_model(str(tmp_path / "m"), device="cpu", config=ServingConfig(linger_ms=0.0))
    try:
        assert handle.manager is None and handle.service.manager is None
        assert any("WITHOUT the lifecycle manager" in r.getMessage() for r in caplog.records)
        np.testing.assert_array_equal(handle.service.score(data[:4]), model.score(data[:4]).numpy())
        (start,) = telemetry.get_events(kind="serving.start")
        assert start.fields["lifecycle"] is False and start.fields["generation"] == 0
    finally:
        handle.close()


# --------------------------------------------------------------------------- #
# fault seams and heartbeats
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("value,want", [(True, ["sever", None]), (3, [None, None, "sever", None]),
                                        ("exit", ["exit", None])])
def test_replica_kill_is_one_shot(value, want):
    with faults.inject(kill_replica_during_score=value):
        assert [faults.take_replica_kill() for _ in want] == want
    assert faults.take_replica_kill() is None


def test_wedged_healthz_stalls_on_the_injected_clock():
    fc = faults.FakeClock()
    faults.maybe_wedge_healthz(clock=fc.now, sleep=fc.sleep)
    assert fc.sleeps == []
    with faults.inject(wedge_replica_healthz=0.05):
        faults.maybe_wedge_healthz(clock=fc.now, sleep=fc.sleep)
    assert len(fc.sleeps) == 5 and fc.now() == pytest.approx(0.05)


def test_heartbeat_ages_and_a_torn_file(tmp_path):
    clock = faults.FakeClock(start=1000.0)
    writer = watchdog.HeartbeatWriter(str(tmp_path), "w0", clock=clock.now)
    writer.beat()
    watchdog.HeartbeatWriter(str(tmp_path), "w1", clock=lambda: 990.0).beat()
    (tmp_path / "heartbeat-w2.json").write_text('{"name": "w2", "ti')  # died mid-write
    (tmp_path / "other.json").write_text("{}")
    clock.advance(2.0)
    ages = watchdog.peer_heartbeat_ages(str(tmp_path), clock=clock.now)
    assert ages == {"w0": 2.0, "w1": 12.0, "w2": float("inf")}
    gauge = telemetry.registry().snapshot()["isoforest_peer_heartbeat_age_seconds"]["series"]
    assert {s["labels"]["peer"]: s["value"] for s in gauge} == ages
    line = watchdog.format_heartbeat_ages(ages, stale_after_s=5.0)
    assert line == ("peer w0: last heartbeat 2.0s ago, peer w1: last heartbeat 12.0s ago (LIKELY DEAD), "
                    "peer w2: last heartbeat infs ago (LIKELY DEAD)")
    assert watchdog.format_heartbeat_ages({}, 5.0) == "no peer heartbeats found"
    assert watchdog.peer_heartbeat_ages(str(tmp_path / "missing")) == {}
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f], "writes are atomic"


def test_heartbeat_writer_thread_starts_and_stops(tmp_path):
    writer = watchdog.HeartbeatWriter(str(tmp_path / "hb"), "w0", interval_s=60.0).start()
    try:
        assert (tmp_path / "hb" / "heartbeat-w0.json").exists(), "the first beat is synchronous"
    finally:
        writer.stop()
    assert not writer._thread.is_alive()
    kinds = [e.kind for e in telemetry.get_events() if e.kind.startswith("heartbeat.")]
    assert kinds == ["heartbeat.start", "heartbeat.stop"]
