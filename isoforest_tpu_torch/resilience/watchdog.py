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
caller would have launched them.

Heartbeats are the companion primitive: a :class:`HeartbeatWriter` rewrites
a small JSON file every ``interval_s`` from a background thread, and
:func:`peer_heartbeat_ages` reads a directory of them back, so a survivor
(or the telemetry daemon's ``GET /healthz``) can tell a dead peer from a
slow one. The files are the JAX package's: each package reads the other's.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, Optional

from ..telemetry.events import record_event
from ..telemetry.metrics import counter as _counter
from ..telemetry.metrics import gauge as _gauge

_WATCHDOG_TIMEOUTS_TOTAL = _counter(
    "isoforest_watchdog_timeouts_total",
    "Watchdog deadlines that fired (the watched work was abandoned)",
)
_PEER_HEARTBEAT_AGE = _gauge(
    "isoforest_peer_heartbeat_age_seconds",
    "Seconds since each multihost peer's last heartbeat, at last read "
    "(inf = unreadable/torn heartbeat file)",
    labelnames=("peer",),
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


_HEARTBEAT_PREFIX = "heartbeat-"


class HeartbeatWriter:
    """Background thread rewriting ``<dir>/heartbeat-<name>.json`` every
    ``interval_s`` with a wall-clock time. Writes go to a temporary file and
    ``os.replace``, so a reader never sees a torn file."""

    def __init__(self, directory: str, name: str, interval_s: float = 1.0,
                 clock: Callable[[], float] = time.time) -> None:
        self.path = os.path.join(directory, f"{_HEARTBEAT_PREFIX}{name}.json")
        self.name = str(name)
        self.interval_s = float(interval_s)
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        """Write one heartbeat now (the background loop calls it too)."""
        payload = {"name": self.name, "pid": os.getpid(), "time": self._clock()}
        tmp = f"{self.path}.tmp-{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, self.path)

    def start(self) -> "HeartbeatWriter":
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.beat()  # the first beat at once: peers see this one immediately
        self._thread = threading.Thread(target=self._loop, daemon=True, name=f"isoforest-heartbeat[{self.name}]")
        self._thread.start()
        record_event("heartbeat.start", peer=self.name, interval_s=self.interval_s)
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.beat()
            except OSError:  # a full or vanished disk must not end the writer
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s)
            record_event("heartbeat.stop", peer=self.name)


def peer_heartbeat_ages(directory: str, clock: Callable[[], float] = time.time) -> Dict[str, float]:
    """``{peer: seconds since its last heartbeat}`` for every heartbeat file
    in ``directory``; an unreadable or torn file reports ``inf`` (a peer that
    died mid-write is still a dead peer). Each age is set on the
    ``isoforest_peer_heartbeat_age_seconds{peer}`` gauge."""
    ages: Dict[str, float] = {}
    if not os.path.isdir(directory):
        return ages
    for fname in sorted(os.listdir(directory)):
        if not fname.startswith(_HEARTBEAT_PREFIX) or not fname.endswith(".json"):
            continue
        name = fname[len(_HEARTBEAT_PREFIX):-len(".json")]
        try:
            with open(os.path.join(directory, fname)) as fh:
                payload = json.load(fh)
            ages[name] = max(0.0, clock() - float(payload["time"]))
        except (OSError, ValueError, KeyError, TypeError):
            ages[name] = float("inf")
    for name, age in ages.items():
        _PEER_HEARTBEAT_AGE.set(age, peer=name)
    return ages


def format_heartbeat_ages(ages: Dict[str, float], stale_after_s: float) -> str:
    """One line for a timeout's diagnostics; peers whose last beat is older
    than ``stale_after_s`` are flagged as likely dead."""
    if not ages:
        return "no peer heartbeats found"
    parts = []
    for name in sorted(ages):
        age = ages[name]
        flag = " (LIKELY DEAD)" if age > stale_after_s else ""
        parts.append(f"peer {name}: last heartbeat {age:.1f}s ago{flag}")
    return ", ".join(parts)
