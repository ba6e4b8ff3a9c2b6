"""The port's overload autopilot (``isoforest_tpu_torch/autopilot``) on the
CPU: ``tests/test_autopilot.py`` against the port, threadless on a
FakeClock (no real sleeps), then the same pressure trace through both
packages.

* Sustained queue pressure walks the three rungs one at a time, each logged
  once, in event order and on the gauge; a drained queue recovers rung by
  rung with hysteresis, and the dead band holds the rung.
* A shed tenant gets typed 429s while its higher-weight neighbour answers
  200 through ``handle_score``; ``strict=True`` refuses every rung visibly;
  the coalescer's ``reconfigure`` loses, splits and double-drains nothing.
* Rung 3 scores a prefix of the trees, and on the CPU the q16 plane, bit
  for bit ``score_matrix`` of that prefix; a service on the card gets the
  prefix alone (a pinned difference: the port's q16 walk is torch ops on
  the card, slower than the kernels).
* Parity: the same pressure trace over the same model file gives the JAX
  package's rung sequence, events, coalescer policies and brownout states,
  and scores within 2e-6 of its scores (the packages' float32 ``c(n)``
  differs by a few ulps, ROADMAP "How parity is checked").

On the CPU torch's ``exp2`` rounds by vector position, so a flush's scores
equal ``model.score`` of exactly the flushed rows; each test compares with
those rows.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from isoforest_tpu_torch import IsolationForest, load_model, telemetry
from isoforest_tpu_torch.autopilot import RUNG_REASONS, Autopilot, AutopilotConfig, current_rung
from isoforest_tpu_torch.autopilot import controller as _controller
from isoforest_tpu_torch.ops.traversal import score_matrix
from isoforest_tpu_torch.resilience import faults
from isoforest_tpu_torch.resilience.degradation import degradations, reset_degradations
from isoforest_tpu_torch.serving import MicroBatchCoalescer, ScoringService, ServingConfig, ShedError, handle_score


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    reset_degradations()
    yield
    telemetry.reset()
    reset_degradations()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(512, 5)).astype(np.float32)
    X[:40] += 4.0
    return X


@pytest.fixture(scope="module")
def model(data):
    return IsolationForest(num_estimators=12, max_samples=64.0, random_seed=1, device="cpu").fit(data)


def _score(model, rows) -> np.ndarray:
    return model.score(rows).numpy()


def _service(model, fc, *, weight=1.0, model_id=None, **cfg):
    """A threadless tenant on the FakeClock: pressure is whatever rows sit
    unpumped in its queue."""
    cfg.setdefault("batch_rows", 8)
    cfg.setdefault("linger_ms", 10.0)
    cfg.setdefault("max_queue_rows", 32)
    return ScoringService(model=model, config=ServingConfig(weight=weight, **cfg), clock=fc.now, start=False,
                          model_id=model_id)


def _pressurize(service, rows_pool, n_rows=24):
    """Queue ``n_rows`` without pumping: pressure n_rows / max_queue_rows."""
    return [service.coalescer.submit(rows_pool[i : i + 8]) for i in range(0, n_rows, 8)]


def _drain(service, fc):
    """Pump until the queue is empty (past the linger for a short tail)."""
    for _ in range(64):
        if service.coalescer.pending_rows == 0:
            return
        if service.coalescer.pump() == 0:
            fc.advance(service.coalescer.max_linger_s + 1e-3)
    assert service.coalescer.pending_rows == 0, "queue failed to drain"


def _event_kinds(prefix="autopilot."):
    return [e.kind for e in telemetry.get_events() if e.kind.startswith(prefix)]


def _autopilot_degradations():
    return {ev.reason: ev.count for ev in degradations() if ev.reason.startswith("autopilot_")}


def _rows_body(rows) -> bytes:
    return json.dumps({"rows": [[float(v) for v in r] for r in rows]}).encode()


class TestLadderDescent:
    def test_sustained_pressure_walks_all_three_rungs(self, model, data):
        fc = faults.FakeClock()
        service = _service(model, fc)
        ap = Autopilot(services=[service], config=AutopilotConfig(engage_ticks=2, recover_ticks=3), clock=fc.now)
        try:
            _pressurize(service, data)  # 24/32 rows = 0.75 >= high_water
            assert ap.pressure() == pytest.approx(0.75)
            assert ap.tick() == 0, "one high tick is below the debounce"
            assert ap.tick() == 1, "engage_ticks=2 -> rung 1 on tick 2"
            assert service.coalescer.max_batch_rows == 16
            assert service.coalescer.max_linger_s == pytest.approx(0.040)
            assert _controller._RUNG_GAUGE.value() == 1
            assert current_rung() == 1
            ap.tick()
            assert ap.tick() == 2, "pressure persists -> rung 2"
            assert not service.shed, "the only attached service is the top weight class"
            ap.tick()
            assert ap.tick() == 3, "pressure persists -> rung 3"
            assert service.quality == {"subsample_trees": 0.5, "q16": True}
            assert _controller._RUNG_GAUGE.value() == 3
            for _ in range(4):
                assert ap.tick() == 3, "no rung 4 exists; the ladder holds"
            assert _autopilot_degradations() == {
                "autopilot_widen_batch": 1, "autopilot_shed_low_weight": 1, "autopilot_quality_degrade": 1,
            }
            engages = [e for e in telemetry.get_events() if e.kind == "autopilot.engage"]
            assert [e.fields["rung"] for e in engages] == [1, 2, 3]
            assert [e.fields["reason"] for e in engages] == list(RUNG_REASONS)
            assert ap.state()["rung_reason"] == "autopilot_quality_degrade"
        finally:
            ap.close()
            service.close()
        assert current_rung() is None, "close() detaches the process slot"

    def test_dead_band_holds_rung_without_oscillation(self, model, data):
        fc = faults.FakeClock()
        service = _service(model, fc)
        ap = Autopilot(services=[service], config=AutopilotConfig(engage_ticks=1, recover_ticks=1), clock=fc.now)
        try:
            _pressurize(service, data)
            assert ap.tick() == 1
            # one widened flush takes two 8-row waiters: 24 -> 8 rows = 0.25
            assert service.coalescer.pump() == 2
            assert ap.pressure() == pytest.approx(0.25)
            events_before = len(_event_kinds())
            for _ in range(10):
                assert ap.tick() == 1, "the dead band holds the rung"
            state = ap.state()
            assert state["high_ticks"] == 0 and state["low_ticks"] == 0
            assert len(_event_kinds()) == events_before
        finally:
            ap.close()
            service.close()


class TestRecovery:
    def test_pressure_drop_recovers_rung_by_rung_with_hysteresis(self, model, data):
        fc = faults.FakeClock()
        service = _service(model, fc)
        ap = Autopilot(services=[service], config=AutopilotConfig(engage_ticks=1, recover_ticks=3), clock=fc.now)
        try:
            _pressurize(service, data)
            for want in (1, 2, 3):
                assert ap.tick() == want
            _drain(service, fc)
            assert ap.pressure() == 0.0
            assert ap.tick() == 3 and ap.tick() == 3
            assert service.quality is not None, "hysteresis still holding"
            assert ap.tick() == 2
            assert service.quality is None, "recovery lifted quality first"
            assert service.coalescer.max_batch_rows == 16, "the widen rung is still held"
            assert ap.tick() == 2 and ap.tick() == 2
            assert ap.tick() == 1
            assert ap.tick() == 1 and ap.tick() == 1
            assert ap.tick() == 0
            assert service.coalescer.max_batch_rows == 8
            assert service.coalescer.max_linger_s == pytest.approx(0.010)
            assert _controller._RUNG_GAUGE.value() == 0
            recoveries = [e for e in telemetry.get_events() if e.kind == "autopilot.recover"]
            assert [(e.fields["rung"], e.fields["to_rung"]) for e in recoveries] == [(3, 2), (2, 1), (1, 0)]
            p = service.coalescer.submit(data[:8])
            assert service.coalescer.pump() == 1
            np.testing.assert_array_equal(service.coalescer.result(p, timeout_s=0), _score(model, data[:8]))
        finally:
            ap.close()
            service.close()


class TestShedNeighbors:
    def test_shed_tenant_429_neighbor_bitwise_all_200(self, model, data):
        fc = faults.FakeClock()
        gold = ScoringService(model=model, config=ServingConfig(batch_rows=64, linger_ms=0.0, request_timeout_s=60.0,
                                                                weight=1.0), model_id="gold")
        bronze = _service(model, fc, weight=0.25, model_id="bronze")
        config = AutopilotConfig(engage_ticks=1, recover_ticks=1, tick_interval_s=0.5)
        ap = Autopilot(services=[gold, bronze], config=config, clock=fc.now)
        try:
            queued = _pressurize(bronze, data)
            assert ap.tick() == 1
            assert ap.tick() == 2
            assert bronze.shed and not gold.shed, "only the sub-top weight class is shed"
            with pytest.raises(ShedError) as exc:
                bronze.check_admission()
            assert exc.value.status == 429
            assert exc.value.retry_after_s == pytest.approx(max(config.recover_ticks * config.tick_interval_s, 1.0))
            status, _, payload, resp_headers = handle_score(bronze, _rows_body(data[:2]), {})
            assert status == 429
            assert resp_headers["Retry-After"] == "1"
            assert "shed" in json.loads(payload)["error"]
            direct = [float(s) for s in _score(model, data[:16])]
            for _ in range(3):
                status, _, payload, _ = handle_score(gold, _rows_body(data[:16]), {})
                assert status == 200
                assert json.loads(payload)["scores"] == direct
            # work queued before the shed still completes: the widened flush
            # takes the first two 8-row requests, 16 rows in one call
            _drain(bronze, fc)
            assert queued[0].flush_rows == 16
            np.testing.assert_array_equal(bronze.coalescer.result(queued[0], timeout_s=0),
                                          _score(model, data[:16])[:8])
            assert ap.tick() == 1
            assert not bronze.shed
            bronze.check_admission()
            assert ap.tick() == 0
            assert gold.coalescer.max_batch_rows == 64
        finally:
            ap.close()
            gold.close()
            bronze.close()


class TestStrictOptOut:
    def test_strict_refuses_every_rung_visibly(self, model, data):
        fc = faults.FakeClock()
        service = _service(model, fc)
        ap = Autopilot(services=[service], config=AutopilotConfig(engage_ticks=1, strict=True), clock=fc.now)
        try:
            _pressurize(service, data)
            for _ in range(3):
                assert ap.tick() == 0, "strict holds rung 0"
            assert service.coalescer.max_batch_rows == 8, "no knob moved"
            assert not service.shed and service.quality is None
            refused = [e for e in telemetry.get_events() if e.kind == "autopilot.refused"]
            assert len(refused) == 3
            assert {e.fields["reason"] for e in refused} == {"autopilot_widen_batch"}
            assert _autopilot_degradations() == {}, "strict raises before the report records"
        finally:
            ap.close()
            service.close()


class TestRuntimeReconfigure:
    """The coalescer's ``reconfigure`` mid-traffic, as rung 1 uses it."""

    @staticmethod
    def _echo(X):
        return np.asarray(X, np.float64).sum(axis=1), None

    def _coalescer(self, fc, **kw):
        kw.setdefault("max_batch_rows", 8)
        kw.setdefault("max_linger_s", 0.010)
        kw.setdefault("max_queue_rows", 32)
        kw.setdefault("queue_deadline_s", 10.0)
        return MicroBatchCoalescer(self._echo, clock=fc.now, start=False, **kw)

    def _want(self, rows):
        return self._echo(rows)[0]

    def test_narrowing_batch_makes_waiting_work_due(self, data):
        fc = faults.FakeClock()
        c = self._coalescer(fc)
        a = c.submit(data[:3])
        b = c.submit(data[3:6])
        assert c.pump() == 0
        assert c.reconfigure(max_batch_rows=4) == {"max_batch_rows": 8, "max_linger_s": 0.010}
        assert c.pump() == 1, "the whole-waiter rule flushes A alone"
        np.testing.assert_array_equal(c.result(a, timeout_s=0), self._want(data[:3]))
        fc.advance(0.010)
        assert c.pump() == 1
        np.testing.assert_array_equal(c.result(b, timeout_s=0), self._want(data[3:6]))
        assert b.flush_requests == 1 and c.pending_rows == 0
        assert c.pump() == 0
        c.close()

    def test_shortened_linger_applies_to_queued_request(self, data):
        fc = faults.FakeClock()
        c = self._coalescer(fc)
        p = c.submit(data[:3])
        fc.advance(0.005)
        assert c.pump() == 0
        c.reconfigure(max_linger_s=0.004)
        assert c.pump() == 1
        np.testing.assert_array_equal(c.result(p, timeout_s=0), self._want(data[:3]))
        c.close()

    def test_widening_mid_traffic_holds_and_coalesces(self, data):
        fc = faults.FakeClock()
        c = self._coalescer(fc)
        a = c.submit(data[:5])
        c.reconfigure(max_batch_rows=16, max_linger_s=0.040)
        fc.advance(0.012)
        assert c.pump() == 0, "past the old 10 ms linger, held by the new"
        b = c.submit(data[5:8])
        fc.advance(0.030)
        assert c.pump() == 2, "one flush serves both waiters"
        np.testing.assert_array_equal(c.result(a, timeout_s=0), self._want(data[:5]))
        np.testing.assert_array_equal(c.result(b, timeout_s=0), self._want(data[5:8]))
        assert a.flush_requests == 2 and a.flush_rows == 8 == b.flush_rows
        assert c.pump() == 0 and c.pending_rows == 0
        c.close()

    def test_reconfigure_validation_leaves_policy_intact(self, data):
        fc = faults.FakeClock()
        c = self._coalescer(fc)
        for kw in ({"max_batch_rows": 0}, {"max_batch_rows": 64}, {"max_linger_s": -0.001}):
            with pytest.raises(ValueError):
                c.reconfigure(**kw)
        assert c.max_batch_rows == 8
        assert c.max_linger_s == pytest.approx(0.010)
        c.close()


class TestConfigValidation:
    @pytest.mark.parametrize("kw", [dict(high_water=0.2, low_water=0.5), dict(engage_ticks=0),
                                    dict(recover_ticks=0), dict(subsample_trees=0.0), dict(widen_batch_factor=0.5),
                                    dict(widen_linger_factor=0.5), dict(tick_interval_s=0.0)])
    def test_bad_knobs_are_refused(self, kw):
        with pytest.raises(ValueError):
            AutopilotConfig(**kw)

    def test_exactly_one_sensor_set(self):
        with pytest.raises(ValueError):
            Autopilot()
        with pytest.raises(ValueError):
            Autopilot(services=[], registry=object())


class TestQualityRung:
    def test_degraded_scores_reported_never_silent(self, model, data):
        """Rung 3 through ``handle_score``: the answer says ``degraded``
        and equals ``score_matrix`` of the 6-tree prefix on the q16 plane
        bit for bit; lifted, full fidelity returns."""
        service = ScoringService(model=model, config=ServingConfig(batch_rows=16, linger_ms=0.0,
                                                                   request_timeout_s=60.0))
        try:
            service.set_quality(subsample_trees=0.5, force_q16=True)
            status, _, payload, _ = handle_score(service, _rows_body(data[:16]), {})
            assert status == 200
            doc = json.loads(payload)
            assert doc["degraded"] == {"subsample_trees": 0.5, "q16": True}
            forest = model.forest
            prefix = type(forest)(*(leaf[:6] for leaf in forest))
            direct = score_matrix(prefix, data[:16], model.num_samples, strategy="q16", device="cpu")
            assert doc["scores"] == [float(s) for s in direct]
            service.set_quality()
            assert service.quality is None
            status, _, payload, _ = handle_score(service, _rows_body(data[:16]), {})
            doc = json.loads(payload)
            assert status == 200 and "degraded" not in doc
            assert doc["scores"] == [float(s) for s in _score(model, data[:16])]
        finally:
            service.close()

    def test_a_service_on_the_card_gets_the_prefix_without_q16(self, model, data, monkeypatch):
        """The pinned difference: rung 3 on a service whose model lies on
        the card keeps the f32 kernels and applies ``subsample_trees``
        alone, and its ``degrade`` detail says q16 was left out. The card
        is stood in for by the controller's device test."""
        monkeypatch.setattr(_controller, "_on_card", lambda service: True)
        fc = faults.FakeClock()
        service = _service(model, fc)
        ap = Autopilot(services=[service], config=AutopilotConfig(engage_ticks=1, recover_ticks=1), clock=fc.now)
        try:
            _pressurize(service, data)
            assert [ap.tick() for _ in range(3)] == [1, 2, 3]
            assert service.quality == {"subsample_trees": 0.5, "q16": False}
            (rung3,) = [ev for ev in degradations() if ev.reason == "autopilot_quality_degrade"]
            assert rung3.to == "subsample_trees=0.5"
            assert "q16 left out on the card" in rung3.detail
            _drain(service, fc)
            p = service.coalescer.submit(data[:16])
            fc.advance(1.0)
            assert service.coalescer.pump() == 1
            prefix = type(model.forest)(*(leaf[:6] for leaf in model.forest))
            np.testing.assert_array_equal(service.coalescer.result(p, timeout_s=0),
                                          score_matrix(prefix, data[:16], model.num_samples, device="cpu").numpy())
        finally:
            ap.close()
            service.close()

    def test_the_cpu_keeps_q16(self, model):
        service = ScoringService(model=model, start=False)
        ap = Autopilot(services=[service])
        try:
            assert not _controller._on_card(service)
            assert ap._q16_for(service)
        finally:
            ap.close()
            service.close()


class TestControlThread:
    def test_start_is_idempotent_and_close_joins(self, model):
        """``start()`` runs the tick on a daemon thread (once however often
        it is called) and ``close()`` joins it and frees the process slot;
        the long interval keeps the thread from ticking in the test."""
        service = ScoringService(model=model, start=False)
        ap = Autopilot(services=[service], config=AutopilotConfig(tick_interval_s=3600.0))
        try:
            ap.start()
            thread = ap._thread
            ap.start()
            assert ap._thread is thread and thread.is_alive()
            assert current_rung() == 0
        finally:
            ap.close()
            service.close()
        thread.join(timeout=30)
        assert not thread.is_alive()
        assert current_rung() is None
        assert [e.kind for e in telemetry.get_events() if e.kind.startswith("autopilot.")] == [
            "autopilot.start", "autopilot.stop"]


class TestMount:
    def test_healthz_section_and_bundle(self, model):
        from isoforest_tpu_torch.autopilot import mount_autopilot
        from isoforest_tpu_torch.telemetry import resources
        from isoforest_tpu_torch.telemetry.http import MetricsServer

        server = MetricsServer(port=0)
        service = ScoringService(model=model, start=False, model_id="m")
        ap = Autopilot(services=[service])
        try:
            server.serving_state = service.state
            mount_autopilot(server, ap)
            doc = server.serving_state()
            assert doc["autopilot"]["rung"] == 0 and doc["model_id"] == "m"
            assert resources.build_bundle()["autopilot"]["rung"] == 0
        finally:
            resources.unregister_bundle_section("autopilot")
            ap.close()
            service.close()


# -- parity with the JAX package ----------------------------------------------


def _drive_trace(service_cls, config_cls, autopilot_cls, config_ap_cls, fault_mod, tel, model, data, score):
    """One pressure trace through one package: a threadless top-weight
    tenant and a low-weight one on a FakeClock, descent, a scored flush at
    each rung, recovery. Returns what a parity test compares."""
    fc = fault_mod.FakeClock()
    gold = service_cls(model=model, config=config_cls(batch_rows=8, linger_ms=10.0, max_queue_rows=32, weight=1.0),
                       clock=fc.now, start=False, model_id="gold")
    bronze = service_cls(model=model, config=config_cls(batch_rows=8, linger_ms=10.0, max_queue_rows=32,
                                                        weight=0.5), clock=fc.now, start=False, model_id="bronze")
    ap = autopilot_cls(services=[gold, bronze], config=config_ap_cls(engage_ticks=2, recover_ticks=2), clock=fc.now)
    rungs, states, flushed = [], [], []
    try:
        for i in range(0, 24, 8):
            gold.coalescer.submit(data[i : i + 8])
        for _ in range(7):
            rungs.append(ap.tick())
            states.append((gold.coalescer.max_batch_rows, gold.coalescer.max_linger_s, gold.shed, bronze.shed,
                           gold.quality))
        # one flush under rung 3 (q16 on the CPU, a 6-tree prefix)
        fc.advance(1.0)
        while gold.coalescer.pending_rows:
            gold.coalescer.pump()
        p = gold.coalescer.submit(data[:16])
        fc.advance(1.0)
        gold.coalescer.pump()
        flushed.append(np.asarray(gold.coalescer.result(p, timeout_s=0), np.float64))
        for _ in range(7):
            rungs.append(ap.tick())
            states.append((gold.coalescer.max_batch_rows, gold.coalescer.max_linger_s, gold.shed, bronze.shed,
                           gold.quality))
        p = gold.coalescer.submit(data[:16])
        fc.advance(1.0)
        gold.coalescer.pump()
        flushed.append(np.asarray(gold.coalescer.result(p, timeout_s=0), np.float64))
        events = [(e.kind, dict(e.fields)) for e in tel.get_events() if e.kind.startswith("autopilot.")]
        final = ap.state()
    finally:
        ap.close()
        gold.close()
        bronze.close()
    return rungs, states, flushed, events, final


def test_the_same_pressure_trace_walks_the_jax_packages_ladder(data, tmp_path):
    """Both packages over the same saved model and the same trace: the same
    rung per tick, the same ``autopilot.*`` events and fields, the same
    knobs, the same final state; scores within 2e-6."""
    from isoforest_tpu import IsolationForest as JaxForest
    from isoforest_tpu import telemetry as jax_telemetry
    from isoforest_tpu.autopilot import Autopilot as JaxAutopilot
    from isoforest_tpu.autopilot import AutopilotConfig as JaxAutopilotConfig
    from isoforest_tpu.resilience import faults as jax_faults
    from isoforest_tpu.resilience.degradation import reset_degradations as jax_reset_degradations
    from isoforest_tpu.serving import ScoringService as JaxService
    from isoforest_tpu.serving import ServingConfig as JaxConfig

    path = str(tmp_path / "model")
    jax_model = JaxForest(num_estimators=12, max_samples=64.0, random_seed=1).fit(data)
    jax_model.save(path)
    port_model = load_model(path, device="cpu")
    jax_telemetry.reset()
    jax_reset_degradations()
    try:
        want = _drive_trace(JaxService, JaxConfig, JaxAutopilot, JaxAutopilotConfig, jax_faults, jax_telemetry,
                            jax_model, data, None)
    finally:
        jax_telemetry.reset()
        jax_reset_degradations()
    got = _drive_trace(ScoringService, ServingConfig, Autopilot, AutopilotConfig, faults, telemetry, port_model,
                       data, None)
    rungs, states, flushed, events, final = got
    assert rungs == want[0] == [0, 1, 1, 2, 2, 3, 3, 3, 2, 2, 1, 1, 0, 0]
    assert states == want[1]
    assert events == want[3]
    assert final == want[4]
    for mine, theirs in zip(flushed, want[2]):
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=2e-6)
