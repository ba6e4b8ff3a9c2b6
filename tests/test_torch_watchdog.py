"""The port's scoring watchdog (``isoforest_tpu_torch/resilience/watchdog.py``)
on the CPU, mirroring ``tests/test_resilience.py::TestWatchdogPrimitives``
and ``TestScoringWatchdog`` where the port has the feature.

The JAX package retries a stalled strategy on its gather kernel; the port
raises ``WatchdogTimeout`` and retries nothing, so the scoring tests here
check that no rung is taken and that the next call is exact.
"""

from __future__ import annotations

import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from isoforest_tpu_torch import load_model, telemetry
from isoforest_tpu_torch.resilience import WatchdogTimeout, faults, watchdog
from isoforest_tpu_torch.resilience.degradation import degradations, reset_degradations

FIXTURE = pathlib.Path(__file__).parent / "resources" / "torch_port" / "mammography_std" / "model"
# how late a timeout may surface past its deadline on a loaded CI host
SLACK_S = 2.0


class _FakeClock:
    """Virtual time for the stall: ``sleep`` advances ``now``."""

    def __init__(self) -> None:
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(autouse=True)
def _drain_abandoned():
    yield
    assert watchdog.join_abandoned(10.0) == 0


class TestWatchdogPrimitives:
    def test_returns_value_and_reraises(self):
        assert watchdog.run_with_deadline(lambda: 41 + 1, 5.0) == 42
        with pytest.raises(KeyError, match="boom"):
            watchdog.run_with_deadline(lambda: (_ for _ in ()).throw(KeyError("boom")), 5.0)
        with pytest.raises(ValueError, match="timeout_s"):
            watchdog.run_with_deadline(lambda: None, 0.0)

    def test_timeout_carries_on_timeout_diagnostics(self):
        telemetry.enable()
        before = watchdog._WATCHDOG_TIMEOUTS_TOTAL.value()
        with faults.inject(slow_collective=True):
            with pytest.raises(WatchdogTimeout, match="peer worker-3") as err:
                watchdog.run_with_deadline(faults.maybe_slow_collective, 0.2, describe="test op",
                                           on_timeout=lambda: "peer worker-3: last heartbeat 9.0s ago")
        assert err.value.deadline_s == 0.2
        assert watchdog._WATCHDOG_TIMEOUTS_TOTAL.value() == before + 1
        event = telemetry.get_events("watchdog.timeout")[-1]
        assert event.fields["describe"] == "test op" and event.fields["deadline_s"] == 0.2

    def test_abandoned_threads_are_accounted_and_drained(self):
        release = threading.Event()
        with pytest.raises(WatchdogTimeout):
            watchdog.run_with_deadline(lambda: release.wait(10.0), 0.05, describe="held")
        assert watchdog.join_abandoned(0.0) == 1  # still held
        release.set()
        assert watchdog.join_abandoned(10.0) == 0

    def test_stall_forms(self):
        clk = _FakeClock()
        with faults.inject(slow_collective=2.0):
            faults.maybe_slow_collective("dense", clock=clk.now, sleep=clk.sleep)
        assert clk.now() >= 2.0  # a number stalls any caller that long
        clk = _FakeClock()
        with faults.inject(slow_collective="dense"):
            faults.maybe_slow_collective("walk", clock=clk.now, sleep=clk.sleep)
            assert clk.now() == 0.0  # a stall named for another strategy
            faults.maybe_slow_collective("dense", clock=clk.now, sleep=clk.sleep)
        assert clk.now() >= 30.0  # the named one, to the 30 s cap
        faults.maybe_slow_collective("dense", clock=clk.now, sleep=lambda dt: pytest.fail("not armed"))

    def test_known_faults(self):
        assert {"slow_collective", "raise_strategy", "break_pipeline_stage"} <= faults.KNOWN_FAULTS
        with pytest.raises(ValueError, match="unknown fault"):
            with faults.inject(hide_native=True):
                pass


class TestScoringWatchdog:
    @pytest.fixture(scope="class")
    def model_and_rows(self, mammography):
        model = load_model(str(FIXTURE), device="cpu")
        X = np.ascontiguousarray(mammography[0][:3000])
        return model, X, model.score(X)

    @pytest.mark.parametrize("chunk", [None, 700])
    def test_stalled_scoring_raises_and_the_next_call_is_exact(self, model_and_rows, chunk):
        model, X, want = model_and_rows
        reset_degradations()
        with faults.inject(slow_collective=True):
            t0 = time.monotonic()
            with pytest.raises(WatchdogTimeout, match="scoring strategy 'walk'") as err:
                model.score(X, chunk_size=chunk, timeout_s=0.5)
            waited = time.monotonic() - t0
        assert err.value.deadline_s == 0.5 and 0.5 <= waited <= 0.5 + SLACK_S
        assert degradations() == []  # nothing retried on another strategy
        # the abandoned run wakes now, beside the next call: never on its buffers
        assert torch.equal(model.score(X, chunk_size=chunk, timeout_s=30.0), want)
        assert watchdog.join_abandoned(10.0) == 0

    def test_a_stall_named_for_another_strategy_does_not_fire(self, model_and_rows):
        model, X, want = model_and_rows
        with faults.inject(slow_collective="dense"):
            assert torch.equal(model.score(X, strategy="walk", timeout_s=5.0), want)

    def test_errors_inside_the_watchdog_reraise(self, model_and_rows):
        model, X, _ = model_and_rows
        with faults.inject(raise_strategy="walk"):
            with pytest.raises(faults.FaultInjectedError, match="walk"):
                model.score(X, strategy="walk", timeout_s=5.0)
        bad = X.copy()
        bad[7, 2] = np.nan
        with pytest.raises(ValueError, match="nonfinite='raise'"):
            model.score(bad, nonfinite="raise", chunk_size=700, timeout_s=5.0)

    def test_no_timeout_means_no_watchdog(self, model_and_rows, monkeypatch):
        model, X, want = model_and_rows
        monkeypatch.setattr(watchdog, "run_with_deadline", lambda *a, **k: pytest.fail("watchdog armed"))
        assert torch.equal(model.score(X), want)
