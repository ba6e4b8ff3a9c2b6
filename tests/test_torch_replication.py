"""The port's replicated serving tier (``isoforest_tpu_torch/replication``)
on the CPU: ``tests/test_replication.py`` against the port, then a tier
that mixes the packages.

A port ``Router`` over two port ``serve_fleet`` replicas (one process, real
HTTP on loopback, ``device="cpu"``), every retry and staleness schedule on a
``FakeClock``, no real sleeps:

* ``kill_replica_during_score`` severs a replica mid-request: the client
  still gets a 200 with scores bit for bit the tenant's ``model.score``,
  the drift monitor folds the rows once, and a probe admits the replica
  again;
* ``wedge_replica_healthz`` ejects the wedged replica on its probe timeout
  while traffic flows on the survivor;
* ``stall_current_json_push`` freezes a rolling push (answers stay the old
  generation's bit for bit) until the stall clears and one ``router.push``
  marks the convergence;
* a drain finishes the forwards in flight and answers new requests 503;
* a stale heartbeat ejects a replica that still listens.

The mixed tier: the port's router over one JAX ``serve_fleet`` replica and
one port replica. Its ``GET /metrics`` merges with no ``FederationError``,
and the two replicas' answers for a tenant agree within 2e-6 (the packages'
float32 ``c(n)`` differs by a few ulps, so scores of the same forest may
differ in the last bits).
"""

import json
import os
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from isoforest_tpu_torch import IsolationForest, telemetry
from isoforest_tpu_torch.fleet import serve_fleet
from isoforest_tpu_torch.replication import (
    REPLICAS_PATH,
    Replica,
    Router,
    RouterConfig,
    mount_router,
    unmount_router,
)
from isoforest_tpu_torch.resilience import faults
from isoforest_tpu_torch.resilience.degradation import reset_degradations
from isoforest_tpu_torch.resilience.watchdog import HeartbeatWriter
from isoforest_tpu_torch.serving import ServingConfig
from isoforest_tpu_torch.serving.http import (
    IDEMPOTENCY_HEADER,
    SCORE_PATH,
    TRACE_HEADER,
)
from isoforest_tpu_torch.telemetry.http import MetricsServer

N_TREES = 10
TENANTS = ("alpha", "beta")


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    reset_degradations()
    yield
    telemetry.reset()
    reset_degradations()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    X = rng.normal(size=(2048, 4)).astype(np.float32)
    X[:40] += 4.0
    return X


@pytest.fixture(scope="module")
def tier_models(data, tmp_path_factory):
    """A models root with two sealed tenants plus the in-memory models
    for bitwise cross-checks (save/load round-trips are bitwise)."""
    root = tmp_path_factory.mktemp("tier-models")
    models = {}
    for i, model_id in enumerate(TENANTS):
        model = IsolationForest(
            num_estimators=N_TREES, max_samples=64.0, random_seed=i + 1, device="cpu"
        ).fit(data)
        model.save(str(root / model_id))
        models[model_id] = model
    return str(root), models


def _scores(model, rows):
    return model.score(rows).numpy()


def _fast_config(**kw):
    kw.setdefault("linger_ms", 0.0)
    kw.setdefault("request_timeout_s", 120.0)
    return ServingConfig(**kw)


def _counter_value(name, **labels):
    metric = telemetry.snapshot()["metrics"].get(name)
    if not metric or not metric["series"]:
        return 0.0
    for series in metric["series"]:
        if all(series.get("labels", {}).get(k) == v for k, v in labels.items()):
            return series["value"]
    return 0.0


def _post(url, path, payload, headers=None, timeout=60):
    body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(url + path, data=body, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(), dict(exc.headers)


def _get(url, path, timeout=30):
    try:
        with urllib.request.urlopen(url + path, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


class _Tier:
    """Two in-process fleet replicas + a router over them, FakeClock on
    every router schedule (retry backoff, heartbeat ages)."""

    def __init__(self, models_root, work_root, config=None):
        self.handles = []
        replicas = []
        for i in range(2):
            handle = serve_fleet(
                models_root, config=_fast_config(), work_root=work_root, device="cpu"
            )
            self.handles.append(handle)
            replicas.append(Replica(f"r{i}", handle.server.url))
        self.fc = faults.FakeClock()
        self.router = Router(
            replicas,
            models_dir=models_root,
            work_root=work_root,
            config=config or RouterConfig(),
            clock=self.fc.now,
            sleep=self.fc.sleep,
        )
        self.router.probe_once()

    @property
    def replicas(self):
        return self.router.replicas

    def close(self):
        for handle in self.handles:
            handle.close()


@pytest.fixture()
def tier(tier_models, tmp_path):
    models_root, _ = tier_models
    t = _Tier(models_root, str(tmp_path / "work"))
    try:
        yield t
    finally:
        t.close()


# --------------------------------------------------------------------------- #
# routed scoring through the HTTP front
# --------------------------------------------------------------------------- #


class TestRoutedScoring:
    def test_front_routes_bitwise_with_trace_and_state(
        self, tier, tier_models, data
    ):
        _, models = tier_models
        server = MetricsServer(port=0).start()
        mount_router(server, tier.router)
        try:
            rows = data[:16]
            status, body, headers = _post(
                server.url,
                "/score/alpha",
                {"rows": rows.tolist()},
                headers={TRACE_HEADER: "t-route-1"},
            )
            assert status == 200
            doc = json.loads(body)
            assert doc["scores"] == [float(s) for s in _scores(models["alpha"], rows)]
            assert headers.get(TRACE_HEADER) == "t-route-1"

            # second request balances onto the other (now least-loaded or
            # tied) replica deterministically; both count requests
            status, body, _ = _post(
                server.url, "/score/beta", {"rows": rows.tolist()}
            )
            assert status == 200
            assert json.loads(body)["scores"] == [
                float(s) for s in _scores(models["beta"], rows)
            ]

            status, body = _get(server.url, REPLICAS_PATH)
            assert status == 200
            state = json.loads(body)
            assert [r["name"] for r in state["replicas"]] == ["r0", "r1"]
            assert all(r["admitted"] for r in state["replicas"])
            assert sum(r["requests"] for r in state["replicas"]) == 2
            assert state["draining"] is False

            # the same document rides /healthz (serving section) and the
            # flight-recorder debug bundle's dynamic router section
            status, body = _get(server.url, "/healthz")
            assert status == 200
            assert json.loads(body)["serving"]["router"] is True
            from isoforest_tpu_torch.telemetry import resources

            bundle = resources.build_bundle()
            assert bundle["router"]["replicas"][0]["name"] == "r0"
        finally:
            unmount_router(server)
            server.stop()
        from isoforest_tpu_torch.telemetry import resources

        assert "router" not in resources.build_bundle()

    def test_authoritative_replica_errors_pass_through_untouched(self, tier):
        # an unknown tenant is the replica's 404, not a wire death: no
        # retry, no ejection
        status, _, payload, _ = tier.router.handle_score_model(
            "no-such-tenant", b'{"rows": [[0, 0, 0, 0]]}', {}
        )
        assert status == 404
        assert "no-such-tenant" in payload
        assert all(r.admitted for r in tier.replicas)
        assert not telemetry.get_events(kind="router.replica_retry")
        # malformed payload: the replica's authoritative 400
        status, _, _, _ = tier.router.handle_score_model("alpha", b"{nope", {})
        assert status == 400


# --------------------------------------------------------------------------- #
# backpressure pass-through: a 429 is an ANSWER, never a retry
# --------------------------------------------------------------------------- #


class TestBackpressurePassThrough:
    def test_replica_429_passes_through_with_zero_retry_attempts(
        self, tier, data
    ):
        """A replica's backpressure refusal is its authoritative answer:
        the router must spend ZERO retry attempts on it (re-forwarding
        refused load converts one replica's brownout into tier-wide
        congestion), eject nothing, and forward the refusing machine's
        ``Retry-After`` VERBATIM — the drain estimate belongs to the
        machine that refused, not the router."""
        # the autopilot's rung-2 actuator, applied on both replicas
        for handle in tier.handles:
            handle.registry.ensure_resident("alpha").service.set_shed(
                True, retry_after_s=7.0
            )
        body = json.dumps({"rows": data[:2].tolist()}).encode()
        requests_before = sum(r.requests for r in tier.replicas)
        status, _, payload, headers = tier.router.handle_score_model(
            "alpha", body, {}
        )
        assert status == 429
        assert headers["Retry-After"] == "7", "the replica's estimate, verbatim"
        assert "shed" in payload
        # exactly ONE forward happened: no retry budget was minted for an
        # answered request, nobody was ejected, no retry telemetry fired
        assert sum(r.requests for r in tier.replicas) == requests_before + 1
        assert all(r.admitted for r in tier.replicas)
        assert not telemetry.get_events(kind="router.replica_retry")
        assert _counter_value("isoforest_router_retries_total") == 0.0
        assert _counter_value(
            "isoforest_router_requests_total", code="429"
        ) == 1.0

        # the brownout lifts: the same tenant admits again through the
        # same router with no residual admission state
        for handle in tier.handles:
            handle.registry.ensure_resident("alpha").service.set_shed(False)
        status, _, _, _ = tier.router.handle_score_model("alpha", body, {})
        assert status == 200


# --------------------------------------------------------------------------- #
# chaos: kill_replica_during_score
# --------------------------------------------------------------------------- #


class TestReplicaDeathMidScore:
    def test_severed_replica_retries_bitwise_and_folds_once(
        self, tier, tier_models, data
    ):
        _, models = tier_models
        rows = data[:24]
        body = json.dumps({"rows": rows.tolist()}).encode()
        folded_before = _counter_value("isoforest_monitored_rows_total")
        with faults.inject(kill_replica_during_score=True):
            # r0 is picked first (0 outstanding, name tiebreak), reads the
            # body, and severs the connection without a response — the
            # wire signature of a SIGKILL mid-request
            status, _, payload, headers = tier.router.handle_score_model(
                "alpha", body, {"Content-Type": "application/json"}
            )
        assert status == 200
        doc = json.loads(payload)
        assert doc["scores"] == [float(s) for s in _scores(models["alpha"], rows)]
        assert headers.get(TRACE_HEADER)

        # the dead replica was ejected without waiting for a probe pass
        r0, r1 = tier.replicas
        assert not r0.admitted and r0.down_cause == "request_failed"
        assert r1.admitted and r1.requests == 1
        retries = telemetry.get_events(kind="router.replica_retry")
        assert len(retries) == 1
        assert retries[0].fields["replica"] == "r0"
        downs = telemetry.get_events(kind="router.replica_down")
        assert downs[-1].fields["cause"] == "request_failed"
        assert (
            _counter_value(
                "isoforest_router_retries_total", cause="request_failed"
            )
            == 1
        )
        # the severed attempt never reached scoring: the whole retry chain
        # folded the drift monitor exactly once
        assert (
            _counter_value("isoforest_monitored_rows_total") - folded_before
            == len(rows)
        )
        # the retry backoff ran on the fake clock: zero real sleeps
        assert tier.fc.sleeps == [tier.router.config.retry_base_delay_s]

        # recovery: the replica's server is fine (the fault was one-shot),
        # so the next probe pass re-admits it
        ups_before = len(telemetry.get_events(kind="router.replica_up"))
        tier.router.probe_once()
        assert r0.admitted and r0.down_cause is None
        assert len(telemetry.get_events(kind="router.replica_up")) == ups_before + 1

    def test_kill_seam_value_forms(self):
        # countdown: "the 2nd scoring request from now" — one-shot
        with faults.inject(kill_replica_during_score=2):
            assert faults.take_replica_kill() is None
            assert faults.take_replica_kill() == "sever"
            assert faults.take_replica_kill() is None
        # "exit" names the hard process exit (the subprocess/CI drill)
        with faults.inject(kill_replica_during_score="exit"):
            assert faults.take_replica_kill() == "exit"
            assert faults.take_replica_kill() is None
        with faults.inject(kill_replica_during_score=True):
            assert faults.take_replica_kill() == "sever"
            assert faults.take_replica_kill() is None
        assert faults.take_replica_kill() is None


# --------------------------------------------------------------------------- #
# chaos: wedge_replica_healthz
# --------------------------------------------------------------------------- #


class TestWedgedHealthz:
    def test_wedged_replica_ejected_then_readmitted(self, tier, data):
        tier.router.config.probe_timeout_s = 0.3
        # arm the seam on r0 only: in a real tier the fault lives in one
        # replica's environment; in-process the per-server is_replica flag
        # is the same gate
        tier.handles[1].server.is_replica = False
        body = json.dumps({"rows": data[:8].tolist()}).encode()
        with faults.inject(wedge_replica_healthz=True):
            tier.router.probe_once()
            r0, r1 = tier.replicas
            assert not r0.admitted and r0.down_cause == "probe_timeout"
            assert r1.admitted
            # traffic keeps flowing on the survivor
            status, _, _, _ = tier.router.handle_score_model("alpha", body, {})
            assert status == 200
            assert r1.requests == 1 and r0.requests == 0
        downs = telemetry.get_events(kind="router.replica_down")
        assert downs[-1].fields["cause"] == "probe_timeout"
        # disarming releases the wedged handler; the next pass re-admits
        tier.router.probe_once()
        assert tier.replicas[0].admitted
        ups = telemetry.get_events(kind="router.replica_up")
        assert ups[-1].fields["replica"] == "r0"


# --------------------------------------------------------------------------- #
# heartbeat staleness (FakeClock, zero real sleeps)
# --------------------------------------------------------------------------- #


class TestHeartbeatStaleness:
    def test_dead_replica_heartbeat_goes_stale_and_recovers(self, tmp_path):
        """A replica that died keeps its socket answering (another process
        on the port, a wedged accept loop) but stops beating: the age
        check must eject it. Virtual time only — the clock is fake."""
        hb_dir = str(tmp_path / "hb")
        os.makedirs(hb_dir)
        fc = faults.FakeClock(start=1000.0)
        writer = HeartbeatWriter(hb_dir, "r0", clock=fc.now)
        writer.beat()  # one synchronous beat; no background thread
        server = MetricsServer(port=0).start()
        try:
            router = Router(
                [Replica("r0", server.url)],
                heartbeat_dir=hb_dir,
                config=RouterConfig(stale_after_s=5.0),
                clock=fc.now,
                sleep=fc.sleep,
                wall_clock=fc.now,
            )
            router.probe_once()
            assert router.replicas[0].admitted

            # the replica "dies": no more beats while virtual time passes
            fc.advance(5.5)
            router.probe_once()
            assert not router.replicas[0].admitted
            assert router.replicas[0].down_cause == "heartbeat_stale"
            downs = telemetry.get_events(kind="router.replica_down")
            assert downs[-1].fields["cause"] == "heartbeat_stale"

            # a restarted replica beats again -> re-admitted, no operator
            writer.beat()
            router.probe_once()
            assert router.replicas[0].admitted
            assert fc.sleeps == []  # no retry path ran: zero sleeps at all
        finally:
            server.stop()

    def test_torn_heartbeat_counts_stale(self, tmp_path):
        hb_dir = str(tmp_path / "hb")
        os.makedirs(hb_dir)
        with open(os.path.join(hb_dir, "heartbeat-r0.json"), "w") as fh:
            fh.write('{"name": "r0", "time":')  # died mid-write
        server = MetricsServer(port=0).start()
        try:
            router = Router(
                [Replica("r0", server.url)],
                heartbeat_dir=hb_dir,
                config=RouterConfig(stale_after_s=5.0),
            )
            router.probe_once()
            assert router.replicas[0].down_cause == "heartbeat_stale"
        finally:
            server.stop()

    def test_router_front_healthz_flags_stale_peer(self, tmp_path):
        """The router's own /healthz reads the shared heartbeat dir: one
        curl shows the whole tier, and a dead replica turns it 503."""
        import time as _time

        hb_dir = str(tmp_path / "hb")
        os.makedirs(hb_dir)
        with open(os.path.join(hb_dir, "heartbeat-r0.json"), "w") as fh:
            json.dump({"name": "r0", "pid": 1, "time": _time.time() - 100.0}, fh)
        server = MetricsServer(
            port=0, heartbeat_dir=hb_dir, stale_after_s=5.0
        ).start()
        try:
            status, body = _get(server.url, "/healthz")
            assert status == 503
            doc = json.loads(body)
            assert doc["status"] == "stale"
            assert doc["stale_peers"] == ["r0"]
        finally:
            server.stop()


# --------------------------------------------------------------------------- #
# drain
# --------------------------------------------------------------------------- #


class TestDrain:
    def test_inflight_completes_new_requests_503(self):
        """SIGTERM semantics: the in-flight forward finishes (200), a new
        request answers 503 draining, and the tier reports drained only
        once in-flight hits zero — condition variable, no polling."""
        entered = threading.Event()
        release = threading.Event()

        def slow_score(body, headers, query=""):
            entered.set()
            assert release.wait(30.0)
            return 200, "application/json", json.dumps({"ok": True}) + "\n"

        server = MetricsServer(port=0).start()
        server.register_post(SCORE_PATH, slow_score)
        try:
            router = Router([Replica("r0", server.url)], config=RouterConfig())
            router.probe_once()
            assert router.replicas[0].admitted

            results = []
            worker = threading.Thread(
                target=lambda: results.append(
                    router.handle_score(b"{}", {"Content-Type": "application/json"})
                )
            )
            worker.start()
            assert entered.wait(30.0)
            assert router.state()["inflight"] == 1

            # a zero-budget drain flips draining but cannot finish yet
            assert router.drain(timeout_s=0.0) is False
            assert router.state()["draining"] is True
            status, _, payload, _ = router.handle_score(b"{}", {})
            assert status == 503
            assert json.loads(payload)["error"] == "router is draining"

            # the in-flight request was never abandoned
            release.set()
            worker.join(30.0)
            assert results and results[0][0] == 200
            assert router.drain(timeout_s=5.0) is True
            assert router.state()["inflight"] == 0
        finally:
            release.set()
            server.stop()


# --------------------------------------------------------------------------- #
# rolling pushes (+ chaos: stall_current_json_push)
# --------------------------------------------------------------------------- #


class TestRollingPush:
    def test_push_converges_after_stall_bitwise_old_then_new(
        self, tier, tier_models, data, tmp_path
    ):
        _, models = tier_models
        rows = data[:16]
        payload = {"rows": rows.tolist()}
        old_scores = [float(s) for s in _scores(models["alpha"], rows)]

        # make alpha resident on BOTH replicas at generation 1
        for handle in tier.handles:
            status, body, _ = _post(handle.server.url, "/score/alpha", payload)
            assert status == 200
            doc = json.loads(body)
            assert doc["generation"] == 1 and doc["scores"] == old_scores

        # an offline swap (a manage-driven retrain in another process)
        # seals generation 2 and advances the shared CURRENT.json pointer
        new_model = IsolationForest(
            num_estimators=N_TREES, max_samples=64.0, random_seed=77, device="cpu"
        ).fit(data)
        gen_dir = str(tmp_path / "work" / "alpha" / "gen-00002")
        new_model.save(gen_dir)
        current = os.path.join(str(tmp_path / "work" / "alpha"), "CURRENT.json")
        with open(current, "w") as fh:
            json.dump(
                {"generation": 2, "path": gen_dir, "swapped_unix_s": 123.0}, fh
            )
        new_scores = [float(s) for s in _scores(new_model, rows)]
        assert new_scores != old_scores

        with faults.inject(stall_current_json_push=True):
            # the push plane is wedged: no propagation progress at all,
            # and requests keep answering bitwise OLD-generation scores
            assert tier.router.push_once() == {}
            assert not telemetry.get_events(kind="router.push")
            status, body, _ = _post(
                tier.handles[0].server.url, "/score/alpha", payload
            )
            doc = json.loads(body)
            assert doc["generation"] == 1 and doc["scores"] == old_scores

        # stall cleared: one pass converges every admitted replica
        assert tier.router.push_once() == {"alpha": 2}
        refreshes = telemetry.get_events(kind="lifecycle.refresh")
        assert len(refreshes) == 2  # one in-place adoption per replica
        pushes = telemetry.get_events(kind="router.push")
        assert len(pushes) == 1
        assert pushes[0].fields["model_id"] == "alpha"
        assert pushes[0].fields["generation"] == 2
        for replica in tier.replicas:
            assert replica.acked_generations["alpha"] == 2
        assert tier.router.state()["pushed_generations"] == {"alpha": 2}

        # zero restarts: the same processes now answer bitwise NEW scores
        for handle in tier.handles:
            status, body, _ = _post(handle.server.url, "/score/alpha", payload)
            assert status == 200
            doc = json.loads(body)
            assert doc["generation"] == 2 and doc["scores"] == new_scores

        # converged state is sticky: no duplicate router.push
        assert tier.router.push_once() == {"alpha": 2}
        assert len(telemetry.get_events(kind="router.push")) == 1


# --------------------------------------------------------------------------- #
# idempotent replay (the retry/fold-once contract at the replica)
# --------------------------------------------------------------------------- #


class TestIdempotentReplay:
    def test_replay_is_bitwise_and_folds_monitor_once(
        self, tier_models, data, tmp_path
    ):
        models_root, _ = tier_models
        handle = serve_fleet(
            models_root,
            config=_fast_config(),
            work_root=str(tmp_path / "work"),
            device="cpu",
        )
        try:
            rows = data[:24]
            payload = {"rows": rows.tolist()}
            key = {IDEMPOTENCY_HEADER: "req-0042"}
            base = _counter_value("isoforest_monitored_rows_total")

            status, body, _ = _post(
                handle.server.url, "/score/alpha", payload, headers=key
            )
            assert status == 200
            first = json.loads(body)
            assert "replayed" not in first
            assert (
                _counter_value("isoforest_monitored_rows_total") - base
                == len(rows)
            )

            # the router retrying the same request replays fold-free:
            # bitwise-identical scores, the monitor does NOT count again
            status, body, _ = _post(
                handle.server.url, "/score/alpha", payload, headers=key
            )
            assert status == 200
            replay = json.loads(body)
            assert replay["replayed"] is True
            assert replay["scores"] == first["scores"]
            assert replay["generation"] == first["generation"]
            assert replay["flush_rows"] == len(rows)
            assert (
                _counter_value("isoforest_monitored_rows_total") - base
                == len(rows)
            )

            # a different key is a different request: folds normally
            status, _, _ = _post(
                handle.server.url,
                "/score/alpha",
                payload,
                headers={IDEMPOTENCY_HEADER: "req-0043"},
            )
            assert status == 200
            assert (
                _counter_value("isoforest_monitored_rows_total") - base
                == 2 * len(rows)
            )
        finally:
            handle.close()


# --------------------------------------------------------------------------- #
# exhausted tier
# --------------------------------------------------------------------------- #


class TestNoReplica:
    def test_all_replicas_down_is_typed_503_with_fake_backoff(self):
        # a port nothing listens on: connect refused instantly
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        dead_url = "http://127.0.0.1:%d" % probe.getsockname()[1]
        probe.close()

        fc = faults.FakeClock()
        router = Router(
            [Replica("r0", dead_url)],
            config=RouterConfig(retry_attempts=3),
            clock=fc.now,
            sleep=fc.sleep,
        )
        router.probe_once()
        assert router.replicas[0].down_cause == "probe_failed"

        status, ctype, payload, _ = router.handle_score(b"{}", {})
        assert status == 503 and ctype == "application/json"
        doc = json.loads(payload)
        assert doc["attempts"] == 3
        assert "no replica" in doc["error"]
        # the full retry budget ran on the fake clock: 50 ms then 100 ms,
        # zero real sleeps
        assert fc.sleeps == [0.05, 0.1]
        assert (
            _counter_value(
                "isoforest_router_requests_total", replica="none", code="503"
            )
            == 1
        )


# --------------------------------------------------------------------------- #
# a tier that mixes the packages: one JAX replica, one port replica
# --------------------------------------------------------------------------- #

# series whose help text differs between the packages (the JAX package's
# names its docs/ page); the merged HELP line is the first source's. No
# type, label schema or bucket edge differs (a pinned difference in
# ROADMAP C, not a fault)
HELP_DIFFERS = frozenset({
    "isoforest_autotune_decisions_total", "isoforest_degradations_total", "isoforest_fleet_drift_psi",
    "isoforest_pipeline_overlap_efficiency",
})


class TestMixedTier:
    def test_port_router_over_a_jax_and_a_port_replica(self, tier_models, data, tmp_path):
        from isoforest_tpu import telemetry as jax_telemetry
        from isoforest_tpu.fleet import serve_fleet as jax_serve_fleet
        from isoforest_tpu.resilience import faults as jax_faults
        from isoforest_tpu.serving import ServingConfig as JaxServingConfig
        from isoforest_tpu_torch.telemetry import federation

        models_root, models = tier_models
        jax_telemetry.reset()
        jax_handle = jax_serve_fleet(models_root, config=JaxServingConfig(linger_ms=0.0, request_timeout_s=120.0),
                                     work_root=str(tmp_path / "work-jax"))
        port_handle = serve_fleet(models_root, config=_fast_config(), work_root=str(tmp_path / "work-port"),
                                  device="cpu")
        fc = faults.FakeClock()
        router = Router([Replica("jax", jax_handle.server.url), Replica("port", port_handle.server.url)],
                        models_dir=models_root, clock=fc.now, sleep=fc.sleep)
        front = MetricsServer(port=0).start()
        mount_router(front, router)
        try:
            router.probe_once()
            rows = data[:32]
            payload = {"rows": rows.tolist()}
            # the first request: the JAX replica (no outstanding, name order)
            status, body, _ = _post(front.url, "/score/alpha", payload)
            assert status == 200
            jax_answer = json.loads(body)["scores"]
            # the JAX replica severs the next one: the router retries it on
            # the port replica
            with jax_faults.inject(kill_replica_during_score=True):
                status, body, _ = _post(front.url, "/score/alpha", payload)
            assert status == 200
            port_answer = json.loads(body)["scores"]
            assert port_answer == [float(s) for s in _scores(models["alpha"], rows)]
            np.testing.assert_allclose(port_answer, jax_answer, rtol=0, atol=2e-6)
            jax_replica, port_replica = router.replicas
            assert not jax_replica.admitted and port_replica.requests == 1
            router.probe_once()
            assert jax_replica.admitted

            status, text = _get(front.url, "/metrics")
            assert status == 200, text
            parsed = telemetry.parse_prometheus(text)
            missing = parsed["isoforest_tier_missing_replicas"]
            assert missing[(("replica", "jax"),)] == 0 and missing[(("replica", "port"),)] == 0

            # the series both packages expose: one type, label schema and
            # bucket edges each; only the pinned help strings differ
            sources, missing = router.federation_sources("/snapshot")
            assert missing == []
            docs = dict((name, doc["metrics"]) for name, doc in sources)
            common = set(docs["jax"]) & set(docs["port"])
            assert {"isoforest_fleet_responses_total", "isoforest_serving_responses_total"} <= common
            helps = set()
            for name in common:
                a, b = docs["jax"][name], docs["port"][name]
                assert (a["type"], a["labelnames"]) == (b["type"], b["labelnames"]), name
                if a["type"] == "histogram" and a["series"] and b["series"]:
                    assert ([e for e, _ in a["series"][0]["buckets"]]
                            == [e for e, _ in b["series"][0]["buckets"]]), name
                if a.get("help") != b.get("help"):
                    helps.add(name)
            assert helps <= HELP_DIFFERS
            # each counter of the exposition is the sum of the sources' own
            # (in one process the router and the port replica share the
            # port's registry, so it counts twice here)
            local = telemetry.registry().snapshot()
            merged = federation.merge_metrics([("router", local), ("jax", docs["jax"]), ("port", docs["port"])])
            for name in ("isoforest_router_requests_total", "isoforest_fleet_responses_total"):
                assert merged[name]["series"], name
                for series in merged[name]["series"]:
                    key = tuple(sorted(series["labels"].items()))
                    own = sum(s["value"] for doc in (local, docs["jax"], docs["port"]) if name in doc
                              for s in doc[name]["series"] if tuple(sorted(s["labels"].items())) == key)
                    assert parsed[name][key] == own == series["value"], (name, key)
            assert parsed["isoforest_router_requests_total"][(("code", "200"), ("replica", "port"))] >= 1
        finally:
            unmount_router(front)
            front.stop()
            port_handle.close()
            jax_handle.close()
            jax_telemetry.reset()


def test_spawned_replicas_import_the_package_from_its_directory(monkeypatch):
    """A router started outside the repository spawns replicas that find
    the package: its directory leads the child's ``PYTHONPATH``, and the
    variables that would make the child serve, beat or journal at import
    are gone."""
    import pathlib

    from isoforest_tpu_torch.replication import router as router_mod

    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    for name in ("ISOFOREST_TPU_METRICS_PORT", "ISOFOREST_TPU_HEARTBEAT_DIR", "ISOFOREST_TPU_JOURNAL_DIR"):
        monkeypatch.setenv(name, "1")
    env = router_mod._child_env()
    parent = pathlib.Path(router_mod.__file__).resolve().parents[2]
    assert env["PYTHONPATH"].split(os.pathsep) == [str(parent), "/elsewhere"]
    assert (parent / "isoforest_tpu_torch" / "__main__.py").is_file()
    assert not {"ISOFOREST_TPU_METRICS_PORT", "ISOFOREST_TPU_HEARTBEAT_DIR", "ISOFOREST_TPU_JOURNAL_DIR"} & set(env)
