"""The port's retry layer (``isoforest_tpu_torch/resilience/retry.py``)
against the JAX package's on the CPU.

Tolerances: none. Both draw their jitter from ``random.Random(seed)``, so
the schedules, the sleeps on a FakeClock, the events and the counter are
equal for every policy and seed. No real sleep anywhere.
"""

from __future__ import annotations

import pytest

from isoforest_tpu import telemetry as jax_telemetry
from isoforest_tpu.resilience import faults as jax_faults
from isoforest_tpu.resilience import retry as jax_retry
from isoforest_tpu_torch import resilience, telemetry
from isoforest_tpu_torch.resilience import faults, retry

POLICIES = {
    "default": {},
    "capped": dict(max_attempts=6, base_delay_s=0.5, multiplier=2.0, max_delay_s=3.0, jitter=0.0),
    "jittered": dict(max_attempts=5, base_delay_s=0.25, multiplier=3.0, max_delay_s=10.0, jitter=0.5),
    "one_attempt": dict(max_attempts=1),
    "flat": dict(max_attempts=4, base_delay_s=1.0, multiplier=1.0, jitter=0.2),
}


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    jax_telemetry.reset()
    yield
    telemetry.reset()
    jax_telemetry.reset()


def test_the_package_exports_the_retry_layer():
    assert resilience.retry is retry
    for name in ("RetryError", "RetryPolicy", "DistributedTimeoutError", "backoff_schedule", "retry_call"):
        assert getattr(resilience, name) is getattr(retry, name)
        assert name in resilience.__all__


@pytest.mark.parametrize("seed", [0, 5, 12345])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_backoff_schedule_is_the_jax_packages(policy, seed):
    ours = retry.RetryPolicy(**POLICIES[policy])
    theirs = jax_retry.RetryPolicy(**POLICIES[policy])
    assert retry.backoff_schedule(ours, seed=seed) == jax_retry.backoff_schedule(theirs, seed=seed)
    assert retry.backoff_schedule(ours, attempts=7, seed=seed) == jax_retry.backoff_schedule(theirs, attempts=7,
                                                                                              seed=seed)
    for attempt in range(6):
        assert ours.delay(attempt) == theirs.delay(attempt)


def _drive(module, fault_module, policy_kwargs, fail_times, seed, **kw):
    """``retry_call`` of a function that fails ``fail_times`` times on a
    FakeClock: ``(result or exception, the sleeps, the clock)``."""
    clock = fault_module.FakeClock()
    calls = []

    def flaky():
        calls.append(clock.now())
        clock.advance(0.5)  # each attempt takes half a second
        if len(calls) <= fail_times:
            raise OSError(f"transient {len(calls)}")
        return "done"

    try:
        out = module.retry_call(flaky, policy=module.RetryPolicy(**policy_kwargs), clock=clock.now,
                                sleep=clock.sleep, seed=seed, describe="probe", **kw)
    except module.RetryError as exc:
        out = exc
    return out, clock.sleeps, calls


def _events(tel):
    return [(e.kind, {k: v for k, v in e.fields.items()}) for e in tel.get_events() if e.kind.startswith("retry.")]


@pytest.mark.parametrize("fail_times", [0, 1, 3, 10])
@pytest.mark.parametrize("policy", ["default", "jittered", "flat"])
def test_retry_call_sleeps_and_records_what_the_jax_package_does(policy, fail_times):
    ours = _drive(retry, faults, POLICIES[policy], fail_times, seed=7)
    theirs = _drive(jax_retry, jax_faults, POLICIES[policy], fail_times, seed=7)
    assert ours[1] == theirs[1] and ours[2] == theirs[2]
    if isinstance(theirs[0], Exception):
        assert isinstance(ours[0], retry.RetryError)
        assert str(ours[0]) == str(theirs[0])
        assert (ours[0].attempts, ours[0].elapsed_s) == (theirs[0].attempts, theirs[0].elapsed_s)
        assert repr(ours[0].last_exception) == repr(theirs[0].last_exception)
    else:
        assert ours[0] == theirs[0] == "done"
    assert _events(telemetry) == _events(jax_telemetry)
    for outcome in ("retried", "exhausted"):
        ours_n = telemetry.counter("isoforest_retry_attempts_total", labelnames=("outcome",)).value(outcome=outcome)
        theirs_n = jax_telemetry.counter("isoforest_retry_attempts_total",
                                         labelnames=("outcome",)).value(outcome=outcome)
        assert ours_n == theirs_n


def test_the_deadline_abandons_a_retry_it_cannot_afford():
    policy = dict(max_attempts=10, base_delay_s=4.0, multiplier=2.0, jitter=0.0, deadline_s=10.0)
    out, sleeps, calls = _drive(retry, faults, policy, fail_times=100, seed=0)
    assert isinstance(out, retry.RetryError) and "deadline" in str(out)
    # attempt 1 ends at 0.5 s, sleeps 4 s; attempt 2 ends at 5 s, and its
    # 8 s backoff would end past 10 s: abandoned after 2 attempts
    assert sleeps == [4.0] and len(calls) == 2 and out.attempts == 2
    exhausted = [f for kind, f in _events(telemetry) if kind == "retry.exhausted"]
    assert exhausted == [{"describe": "probe", "attempts": 2, "elapsed_s": 5.0, "deadline_s": 10.0,
                          "error": "OSError('transient 2')"}]
    theirs = _drive(jax_retry, jax_faults, policy, fail_times=100, seed=0)
    assert str(out) == str(theirs[0]) and theirs[1] == sleeps


def test_exhaustion_raises_a_typed_error_and_records_it():
    out, sleeps, calls = _drive(retry, faults, dict(max_attempts=3, base_delay_s=0.25), fail_times=100, seed=3)
    assert isinstance(out, retry.RetryError) and out.attempts == 3 and len(calls) == 3
    assert isinstance(out.last_exception, OSError) and isinstance(out.__cause__, OSError)
    assert sleeps == retry.backoff_schedule(retry.RetryPolicy(max_attempts=3, base_delay_s=0.25), seed=3)
    kinds = [kind for kind, _ in _events(telemetry)]
    assert kinds == ["retry.attempt", "retry.attempt", "retry.exhausted"]


def test_only_the_named_errors_are_retried():
    clock = faults.FakeClock()

    def boom():
        raise KeyError("not transient")

    with pytest.raises(KeyError):
        retry.retry_call(boom, policy=retry.RetryPolicy(), retry_on=(OSError,), clock=clock.now,
                         sleep=clock.sleep)
    assert clock.sleeps == [] and _events(telemetry) == []


@pytest.mark.parametrize("kwargs, match", [
    (dict(max_attempts=0), "max_attempts"),
    (dict(base_delay_s=-1.0), "non-negative"),
    (dict(max_delay_s=-1.0), "non-negative"),
    (dict(jitter=1.0), "jitter"),
    (dict(jitter=-0.1), "jitter"),
])
def test_policy_checks(kwargs, match):
    with pytest.raises(ValueError, match=match):
        retry.RetryPolicy(**kwargs)
    with pytest.raises(ValueError, match=match):
        jax_retry.RetryPolicy(**kwargs)


def test_distributed_timeout_error_carries_its_diagnostics():
    ours = retry.DistributedTimeoutError("peer lost", elapsed_s=3.0, deadline_s=2.0, diagnostics=("w1: 9.0s",))
    theirs = jax_retry.DistributedTimeoutError("peer lost", elapsed_s=3.0, deadline_s=2.0, diagnostics=("w1: 9.0s",))
    assert str(ours) == str(theirs) == "peer lost [w1: 9.0s]"
    assert (ours.elapsed_s, ours.deadline_s, ours.diagnostics) == (3.0, 2.0, ("w1: 9.0s",))
