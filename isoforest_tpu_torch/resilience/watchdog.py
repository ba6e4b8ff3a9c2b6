"""Deadline watchdog for scoring (``isoforest_tpu/resilience/watchdog.py``).

Python cannot cancel work that never returns (a wedged kernel, a stalled
call), so :func:`run_with_deadline` runs it in a daemon worker thread and
*abandons* it at the deadline: the stalled thread keeps whatever it was
doing, and the caller gets a typed :class:`WatchdogTimeout` promptly.

``score_matrix(timeout_s=...)`` and ``model.score(timeout_s=...)`` arm it
around the streaming executor. The JAX package then retries the batch on
another kernel (its ``scoring_timeout`` rung); the port does not: a
timeout raises, and nothing runs on another strategy. A run that was
abandoned may wake later and finish on its own; the executor never lets it
share staging buffers with a later call (:mod:`..ops.streaming`).

torch's current stream and device are thread-local: the executor captures
the caller's and enters them in the worker, so the kernels launch where the
caller would have launched them. The JAX package's peer heartbeats belong to
replication and are not ported.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..telemetry.events import record_event
from ..telemetry.metrics import counter as _counter

_WATCHDOG_TIMEOUTS_TOTAL = _counter(
    "isoforest_watchdog_timeouts_total",
    "Watchdog deadlines that fired (the watched work was abandoned)",
)


class WatchdogTimeout(RuntimeError):
    """The watched operation did not finish inside its deadline."""

    def __init__(self, message: str, *, deadline_s: Optional[float] = None) -> None:
        super().__init__(message)
        self.deadline_s = deadline_s


# threads whose deadline fired and were left behind; tests drain them with
# join_abandoned() after releasing whatever stalled them
_abandoned: list = []
_abandoned_lock = threading.Lock()


def join_abandoned(timeout_s: float = 5.0) -> int:
    """Join previously abandoned watchdog threads; returns how many are
    still alive after ``timeout_s``. Release the stall first (e.g. leave the
    ``slow_collective`` inject scope) or they cannot finish."""
    deadline = time.monotonic() + timeout_s
    with _abandoned_lock:
        threads = list(_abandoned)
    for worker in threads:
        worker.join(timeout=max(0.0, deadline - time.monotonic()))
    alive = [w for w in threads if w.is_alive()]
    with _abandoned_lock:
        _abandoned[:] = alive
    return len(alive)


def run_with_deadline(fn: Callable[[], object], timeout_s: float, *, describe: str = "operation",
                      on_timeout: Optional[Callable[[], str]] = None):
    """Run ``fn()`` with a hard wall-clock deadline; returns its result,
    re-raises its exception, or raises :class:`WatchdogTimeout`.

    The work runs in a daemon thread, which is abandoned on timeout (Python
    has no thread cancellation). ``on_timeout`` supplies extra diagnostics
    for the error message at the moment the deadline fires.
    """
    if timeout_s <= 0:
        raise ValueError(f"timeout_s must be positive, got {timeout_s}")
    outcome: dict = {}
    done = threading.Event()

    def target() -> None:
        try:
            outcome["value"] = fn()
        except BaseException as exc:  # re-raised in the caller below
            outcome["error"] = exc
        finally:
            done.set()

    worker = threading.Thread(target=target, daemon=True, name=f"isoforest-watchdog[{describe}]")
    worker.start()
    if not done.wait(timeout_s):
        with _abandoned_lock:
            _abandoned.append(worker)
        detail = ""
        if on_timeout is not None:
            try:
                detail = on_timeout()
            except Exception as exc:
                detail = f"(diagnostics unavailable: {exc!r})"
        _WATCHDOG_TIMEOUTS_TOTAL.inc()
        record_event("watchdog.timeout", describe=describe, deadline_s=timeout_s, detail=detail)
        raise WatchdogTimeout(
            f"{describe} exceeded its {timeout_s:g}s deadline; the stalled worker thread was abandoned"
            + (f" [{detail}]" if detail else ""),
            deadline_s=timeout_s,
        )
    if "error" in outcome:
        raise outcome["error"]
    return outcome["value"]
