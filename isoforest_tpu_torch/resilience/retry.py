"""Retry with exponential backoff, bounded jitter and a hard deadline
(``isoforest_tpu/resilience/retry.py``, copied: it is stdlib only).

The lifecycle manager runs its checkpointed refit under :func:`retry_call`:
a killed attempt resumes from its sealed blocks on the next one. Built to be
provable:

* **deterministic jitter**: delays come from a seeded ``random.Random``,
  the JAX package's stream for the same seed, so a test (or a postmortem)
  reproduces the exact schedule;
* **injectable clock and sleep**: the whole schedule (growth, jitter
  bounds, deadline) is provable on
  :class:`~isoforest_tpu_torch.resilience.faults.FakeClock` with no real
  sleep;
* **typed exhaustion**: callers get :class:`RetryError` (attempts, elapsed,
  last exception), not the bare last error. :class:`DistributedTimeoutError`
  is the typed error of the multi-device layer, kept here for it.

Attempt ``a`` sleeps ``min(max_delay_s, base_delay_s * multiplier**a) *
(1 + jitter*(2u-1))`` with ``u ~ U[0,1)``. ``deadline_s`` bounds the whole
operation: a retry whose sleep would end past the deadline is not made.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, List, Optional, Tuple

from ..telemetry.events import record_event
from ..telemetry.metrics import counter as _counter
from ..utils.logging import logger

_RETRY_ATTEMPTS_TOTAL = _counter(
    "isoforest_retry_attempts_total",
    "Failed attempts seen by retry_call, by outcome (retried vs exhausted)",
    labelnames=("outcome",),
)


class RetryError(RuntimeError):
    """An operation failed through every allowed attempt (or its deadline):
    ``attempts`` made, ``elapsed_s`` since the first began, ``last_exception``."""

    def __init__(
        self,
        message: str,
        *,
        attempts: int = 0,
        elapsed_s: float = 0.0,
        last_exception: Optional[BaseException] = None,
    ) -> None:
        super().__init__(message)
        self.attempts = attempts
        self.elapsed_s = elapsed_s
        self.last_exception = last_exception


class DistributedTimeoutError(RuntimeError):
    """A distributed peer or collective missed its deadline; ``diagnostics``
    (per-peer heartbeat ages, attempt counts, the coordinator address) join
    the message, so the operator learns which peer died."""

    def __init__(
        self,
        message: str,
        *,
        elapsed_s: Optional[float] = None,
        deadline_s: Optional[float] = None,
        diagnostics: Tuple[str, ...] = (),
    ) -> None:
        if diagnostics:
            message = message + " [" + "; ".join(diagnostics) + "]"
        super().__init__(message)
        self.elapsed_s = elapsed_s
        self.deadline_s = deadline_s
        self.diagnostics = tuple(diagnostics)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff. ``jitter`` is a fraction: each delay is
    scaled by ``1 + jitter*(2u-1)``; ``deadline_s`` bounds the whole
    operation (None: attempts only)."""

    max_attempts: int = 5
    base_delay_s: float = 0.5
    multiplier: float = 2.0
    max_delay_s: float = 30.0
    jitter: float = 0.1
    deadline_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be non-negative")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    def delay(self, attempt: int, u: float = 0.5) -> float:
        """Jittered sleep after failed attempt ``attempt`` (0-based),
        ``u in [0, 1)``; the default midpoint gives the curve itself."""
        base = min(self.max_delay_s, self.base_delay_s * self.multiplier**attempt)
        return base * (1.0 + self.jitter * (2.0 * u - 1.0))


def backoff_schedule(policy: RetryPolicy, attempts: Optional[int] = None, seed: int = 0) -> List[float]:
    """The delays :func:`retry_call` would sleep for this policy and seed."""
    rng = random.Random(seed)
    n = (policy.max_attempts - 1) if attempts is None else attempts
    return [policy.delay(a, rng.random()) for a in range(n)]


def _exhausted(describe: str, attempt: int, elapsed: float, exc: BaseException, message: str,
               **fields) -> RetryError:
    _RETRY_ATTEMPTS_TOTAL.inc(outcome="exhausted")
    record_event("retry.exhausted", describe=describe, attempts=attempt + 1, elapsed_s=round(elapsed, 4),
                 **fields, error=repr(exc))
    return RetryError(message, attempts=attempt + 1, elapsed_s=elapsed, last_exception=exc)


def retry_call(
    fn: Callable[[], object],
    *,
    policy: Optional[RetryPolicy] = None,
    retry_on: tuple = (Exception,),
    describe: str = "operation",
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    seed: int = 0,
):
    """Call ``fn`` under ``policy``; its result, or :class:`RetryError`.

    Only ``retry_on`` exceptions are retried; anything else (and
    ``KeyboardInterrupt``/``SystemExit``) propagates at once. ``seed`` fixes
    the jitter stream (:func:`backoff_schedule` previews it)."""
    policy = policy or RetryPolicy()
    rng = random.Random(seed)
    start = clock()
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except retry_on as exc:
            elapsed = clock() - start
            if attempt == policy.max_attempts - 1:
                raise _exhausted(
                    describe, attempt, elapsed, exc,
                    f"{describe} failed after {attempt + 1} attempt(s) over {elapsed:.2f}s; last error: {exc!r}",
                ) from exc
            delay = policy.delay(attempt, rng.random())
            if policy.deadline_s is not None and elapsed + delay > policy.deadline_s:
                raise _exhausted(
                    describe, attempt, elapsed, exc,
                    f"{describe} abandoned after {attempt + 1} attempt(s): the next retry (+{delay:.2f}s backoff) "
                    f"would exceed the {policy.deadline_s:.2f}s deadline ({elapsed:.2f}s elapsed); "
                    f"last error: {exc!r}",
                    deadline_s=policy.deadline_s,
                ) from exc
            _RETRY_ATTEMPTS_TOTAL.inc(outcome="retried")
            record_event("retry.attempt", describe=describe, attempt=attempt + 1, max_attempts=policy.max_attempts,
                         delay_s=round(delay, 4), error=repr(exc))
            logger.warning("%s attempt %d/%d failed (%r); retrying in %.2fs", describe, attempt + 1,
                           policy.max_attempts, exc, delay)
            sleep(delay)
    raise AssertionError("unreachable: the loop returns or raises")
