"""Fault injection at the seams of the port (``isoforest_tpu/resilience/faults.py``).

Production code consults this module at these seams, each a no-op when
nothing is armed:

* :func:`filter_read_bytes`, in ``io.avro``'s container read:
  ``corrupt_avro`` flips one byte of a data part file as it is read
  (``=<offset>``, default three quarters in) and ``truncate_data`` reads a
  prefix (``=<bytes>``, default half), the torn-download case;
* :func:`check_fit_block`, in a checkpointed fit: ``kill_fit_after_block=<k>``
  raises right after block ``k`` is sealed, the preemption a resume exists for;
* :func:`check_score_shard`, in ``io.outofcore.score_source``:
  ``kill_score_after_shard=<k>`` raises right after shard ``k``'s scores
  are sealed, the preemption a resumed scoring run exists for;
* :func:`take_retrain_kill`, in the lifecycle manager's refit:
  ``kill_retrain_after_block=<k>`` raises once right after refit block ``k``
  is sealed (one-shot: the retry resumes from the seals);
* :func:`candidate_corrupted`, in the lifecycle manager before validation:
  ``corrupt_candidate`` poisons the candidate's first float plane;
* :func:`check_validation`, in ``lifecycle.validate_candidate``:
  ``fail_validation`` adds a failing gate;
* :func:`check_swap`, in the lifecycle manager's swap, after the
  candidate's durable save and before the flip: ``fail_swap`` raises;
* :func:`check_strategy`, in ``score_matrix`` before a strategy runs:
  ``raise_strategy=<name>`` makes that strategy raise;
* :func:`maybe_slow_collective`, the streaming executor's prelude inside the
  scoring watchdog: ``slow_collective`` stalls the call, the hung kernel
  the watchdog exists to bound;
* ``break_pipeline_stage``, read by ``ops.streaming.stage_available``:
  staging reports unavailable and a streamed call takes the
  ``pipeline_fallback`` rung;
* :func:`take_replica_kill`, in the telemetry daemon's ``POST /score``
  dispatch of a server with a scoring service mounted:
  ``kill_replica_during_score[=<n>|exit]`` severs the connection of the
  next (or the n-th) scoring request without a response, or exits the
  process;
* :func:`maybe_wedge_healthz`, in the same server's ``GET /healthz``:
  ``wedge_replica_healthz[=<seconds>]`` stalls the answer, the replica
  that is alive but does not answer;
* :func:`take_distributed_init_failure`, before each attempt of
  ``parallel.initialize_distributed``: ``fail_distributed_init[=<n>]``
  fails the first n bring-up attempts (default 1), consumed across calls.
* :func:`check_fleet_load`, in the fleet registry's lazy load:
  ``fail_fleet_load[=<model_id>]`` fails every tenant's load (or that
  tenant's), which the registry answers with a typed 503;
* :func:`evict_during_score`, in the fleet registry right after a request
  is queued: ``evict_during_score`` evicts the tenant under the request,
  whose scores still come from the drained flush;
* :func:`push_stalled`, in the router's rolling-push pass:
  ``stall_current_json_push`` freezes it (no replica learns of a new
  ``CURRENT.json`` generation while armed; disarming resumes the push).

:class:`FakeClock` is the injectable clock of the serving tests: its
sleeps only advance virtual time. :func:`corrupt_file_on_disk` and
:func:`truncate_file_on_disk` damage a file in place, for the tests and
the corrupt-model corpus.

Faults arm with the :func:`inject` context manager or the
``ISOFOREST_TPU_FAULTS`` environment variable (comma-separated ``name`` or
``name=value`` items), which the JAX package reads too, so one setting
arms the same seams in both packages; names of seams the port does not
have are ignored there.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional, Union

FAULTS_ENV = "ISOFOREST_TPU_FAULTS"

KNOWN_FAULTS = frozenset({
    "corrupt_avro", "truncate_data", "kill_fit_after_block", "kill_score_after_shard", "raise_strategy",
    "slow_collective", "break_pipeline_stage", "kill_replica_during_score", "wedge_replica_healthz",
    "kill_retrain_after_block", "corrupt_candidate", "fail_validation", "fail_swap", "fail_distributed_init",
    "fail_fleet_load", "evict_during_score", "stall_current_json_push",
})

FaultValue = Union[bool, int, str]


class FaultInjectedError(RuntimeError):
    """Raised by an armed fault at its seam."""


_STACK: List[Dict[str, FaultValue]] = []


def _parse_env() -> Dict[str, FaultValue]:
    out: Dict[str, FaultValue] = {}
    for item in os.environ.get(FAULTS_ENV, "").split(","):
        item = item.strip()
        if item:
            name, _, value = item.partition("=")
            out[name.strip()] = value.strip() if value else True
    return out


@contextlib.contextmanager
def inject(**faults: FaultValue):
    """Arm the given faults for the extent of the block::

        with faults.inject(corrupt_avro=True):
            model = load_model(path, on_corrupt="drop")
    """
    unknown = set(faults) - KNOWN_FAULTS
    if unknown:
        raise ValueError(f"unknown fault(s) {sorted(unknown)}; known: {sorted(KNOWN_FAULTS)}")
    _STACK.append(dict(faults))
    try:
        yield
    finally:
        _STACK.pop()


def get(name: str) -> Optional[FaultValue]:
    """The fault's value: the innermost :func:`inject` frame, then the
    environment; None when it is not armed."""
    for frame in reversed(_STACK):
        if name in frame:
            return frame[name]
    return _parse_env().get(name)


def active(name: str) -> bool:
    value = get(name)
    return value is not None and value is not False


def _flip_at(data: bytes, offset: int) -> bytes:
    offset = max(0, min(offset, len(data) - 1))
    out = bytearray(data)
    out[offset] ^= 0x5A  # nonzero, so the byte always changes
    return bytes(out)


def filter_read_bytes(path: str, data: bytes) -> bytes:
    """Apply the armed read faults to a data part file's bytes as read;
    other files pass untouched."""
    if not _STACK and FAULTS_ENV not in os.environ:
        return data
    if not os.path.basename(path).endswith(".avro") or not data:
        return data
    corrupt = get("corrupt_avro")
    if corrupt is not None and corrupt is not False:
        offset = int(corrupt) if str(corrupt).isdigit() else (len(data) * 3) // 4
        data = _flip_at(data, offset)
    truncate = get("truncate_data")
    if truncate is not None and truncate is not False:
        keep = int(truncate) if str(truncate).isdigit() else len(data) // 2
        data = data[: max(1, min(keep, len(data)))]
    return data


def check_fit_block(block_index: int) -> None:
    """Raise :class:`FaultInjectedError` when ``kill_fit_after_block`` names
    the block that was just sealed: its checkpoint is durable, as after a
    real preemption between blocks."""
    value = get("kill_fit_after_block")
    if value is None or value is False:
        return
    if int(value) == int(block_index):
        raise FaultInjectedError(
            f"injected fault: fit killed after sealing block {block_index} "
            f"(kill_fit_after_block={value!r}) — resume with fit(..., resume=True)"
        )


def check_score_shard(shard_index: int) -> None:
    """Raise :class:`FaultInjectedError` when ``kill_score_after_shard``
    names the source shard whose scores were just sealed: the sink holds
    what a real kill between shards leaves, and ``score_source(...,
    resume=True)`` skips every sealed shard."""
    value = get("kill_score_after_shard")
    if value is None or value is False:
        return
    if int(value) == int(shard_index):
        raise FaultInjectedError(
            f"injected fault: scoring killed after sealing shard {shard_index} "
            f"(kill_score_after_shard={value!r}) — resume with score_source(..., resume=True)"
        )


def take_retrain_kill(block_index: int) -> None:
    """Consume a ``kill_retrain_after_block`` token when it names the refit
    block just sealed. One-shot, unlike :func:`check_fit_block`: a real
    preemption does not recur on every retry, and the manager's retry and
    resume are what the seam exists to prove. A frame's value disarms in
    place (a consumed frame falls through to an outer armed one, so stacked
    frames model back-to-back kills); the environment's fires once a
    process."""
    global _ENV_RETRAIN_KILL_CONSUMED
    for frame in reversed(_STACK):
        if "kill_retrain_after_block" in frame:
            value = frame["kill_retrain_after_block"]
            if value is None or value is False:
                continue
            if int(value) == int(block_index):
                frame["kill_retrain_after_block"] = False
                raise FaultInjectedError(
                    f"injected fault: background refit killed after sealing block {block_index} "
                    f"(kill_retrain_after_block={value!r}) — the sealed blocks resume on the next attempt"
                )
            return
    value = _parse_env().get("kill_retrain_after_block")
    if value is None or value is False or _ENV_RETRAIN_KILL_CONSUMED:
        return
    if int(value) == int(block_index):
        _ENV_RETRAIN_KILL_CONSUMED = True
        raise FaultInjectedError(
            f"injected fault: background refit killed after sealing block {block_index} "
            f"(kill_retrain_after_block={value!r})"
        )


_ENV_RETRAIN_KILL_CONSUMED = False


def candidate_corrupted() -> bool:
    """True while ``corrupt_candidate`` is armed: the lifecycle manager then
    poisons the refit candidate before validation, so the gates, not luck,
    keep it off the scoring path."""
    return active("corrupt_candidate")


def check_validation() -> None:
    """Raise :class:`FaultInjectedError` while ``fail_validation`` is armed:
    the candidate's validation fails (the rollback drill)."""
    if active("fail_validation"):
        raise FaultInjectedError(
            "injected fault: candidate validation forced to fail "
            "(fail_validation) — the manager must roll back to the incumbent"
        )


def check_swap() -> None:
    """Raise :class:`FaultInjectedError` while ``fail_swap`` is armed: a
    fault after the candidate's durable save and before the in-memory flip;
    the incumbent keeps serving."""
    if active("fail_swap"):
        raise FaultInjectedError(
            "injected fault: model hot-swap forced to fail mid-swap "
            "(fail_swap) — rolling back to the incumbent"
        )


def check_strategy(strategy: str) -> None:
    """Raise :class:`FaultInjectedError` when ``raise_strategy`` names the
    strategy about to run."""
    target = get("raise_strategy")
    if target is not None and str(target) == strategy:
        raise FaultInjectedError(
            f"injected fault: scoring strategy {strategy!r} forced to raise (raise_strategy={target!r})"
        )


def maybe_slow_collective(strategy: Optional[str] = None, clock: Callable[[], float] = time.monotonic,
                          sleep: Callable[[float], None] = time.sleep) -> None:
    """Stall while ``slow_collective`` is armed: the hung kernel the scoring
    watchdog bounds.

    Value forms: ``True`` (stall any caller, 30 s cap), a number (stall any
    caller, that many seconds), or a strategy name (stall only when
    ``strategy`` matches, 30 s cap). The stall re-checks its arming every
    10 ms, so leaving :func:`inject` releases an abandoned watchdog thread
    promptly."""
    value = get("slow_collective")
    if value is None or value is False:
        return
    limit = 30.0
    if not isinstance(value, bool):
        try:
            limit = float(value)
        except (TypeError, ValueError):
            if strategy is None or str(value) != strategy:
                return  # a stall named for another strategy
    start = clock()
    while active("slow_collective") and clock() - start < limit:
        sleep(0.01)


def take_replica_kill() -> Optional[str]:
    """Consume a ``kill_replica_during_score`` token at the scoring
    dispatch; returns ``"sever"`` (close the connection without a
    response: the client sees a torn wire), ``"exit"`` (end the process) or
    None. Values: ``True``/``1`` sever the next scoring request, ``<n>``
    the n-th from now (counted down in place), ``"exit"`` exits on the
    next one. One-shot: the fault fires once, and a retried request goes
    through."""
    for frame in reversed(_STACK):
        if "kill_replica_during_score" in frame:
            value = frame["kill_replica_during_score"]
            if value is None or value is False:
                continue  # consumed frame: fall through to any outer one
            if isinstance(value, str) and not value.isdigit():
                frame["kill_replica_during_score"] = False
                return "exit" if value == "exit" else "sever"
            remaining = int(value)
            if remaining <= 1:
                frame["kill_replica_during_score"] = False
                return "sever"
            frame["kill_replica_during_score"] = remaining - 1
            return None
    global _ENV_REPLICA_KILL_STATE
    if _ENV_REPLICA_KILL_STATE == "consumed":
        return None
    value = _parse_env().get("kill_replica_during_score")
    if value is None or value is False:
        return None
    if isinstance(value, str) and not value.isdigit():
        _ENV_REPLICA_KILL_STATE = "consumed"
        return "exit" if value == "exit" else "sever"
    remaining = int(value) if _ENV_REPLICA_KILL_STATE is None else int(_ENV_REPLICA_KILL_STATE)
    if remaining <= 1:
        _ENV_REPLICA_KILL_STATE = "consumed"
        return "sever"
    _ENV_REPLICA_KILL_STATE = remaining - 1
    return None


# the environment-armed countdown: None (untouched), the requests left, or
# "consumed" (the one-shot fired)
_ENV_REPLICA_KILL_STATE: Optional[FaultValue] = None


def maybe_wedge_healthz(clock: Callable[[], float] = time.monotonic,
                        sleep: Callable[[float], None] = time.sleep) -> None:
    """Stall while ``wedge_replica_healthz`` is armed: ``True`` (30 s cap)
    or a number (that many seconds). The stall re-checks its arming every
    10 ms, so leaving :func:`inject` releases the handler thread promptly."""
    value = get("wedge_replica_healthz")
    if value is None or value is False:
        return
    limit = 30.0
    if not isinstance(value, bool):
        try:
            limit = float(value)
        except (TypeError, ValueError):
            pass
    start = clock()
    while active("wedge_replica_healthz") and clock() - start < limit:
        sleep(0.01)


def check_fleet_load(model_id: str) -> None:
    """Raise :class:`FaultInjectedError` while ``fail_fleet_load`` is armed
    (``fail_fleet_load=<model_id>`` fails only that tenant's load): the
    fleet registry refuses the tenant's request with a typed 503 (the
    ``fleet_load_failed`` rung) while every other tenant serves, and
    retries the load on the tenant's next request."""
    value = get("fail_fleet_load")
    if value is None or value is False:
        return
    if value is True or str(value) == str(model_id):
        raise FaultInjectedError(
            f"injected fault: fleet lazy load of model {model_id!r} forced to fail (fail_fleet_load={value!r})"
        )


def evict_during_score() -> bool:
    """True while ``evict_during_score`` is armed: the fleet registry then
    evicts the tenant right after a request is queued, and the waiter's
    scores come from the drained flush on its point-in-time model, bit for
    bit (the ``fleet_evict_under_load`` rung); the next request reloads."""
    return active("evict_during_score")


def push_stalled() -> bool:
    """True while ``stall_current_json_push`` is armed: the router's
    rolling-push pass then makes no progress, so replicas keep answering
    with the old generation bit for bit until the stall clears and the push
    converges."""
    return active("stall_current_json_push")


# the environment-armed fail_distributed_init tokens consumed in this process
# (a spawned worker reads the environment afresh, as a flaky bring-up would)
_ENV_DIST_INIT_CONSUMED = 0


def take_distributed_init_failure() -> None:
    """Consume one ``fail_distributed_init`` token: raise
    :class:`FaultInjectedError` while tokens remain (the first n bring-up
    attempts fail), then do nothing. A frame's count decrements in place,
    so nested :func:`inject` scopes stay independent; the environment's
    counts down once a process."""
    for frame in reversed(_STACK):
        if "fail_distributed_init" in frame:
            value = frame["fail_distributed_init"]
            if value is False:
                return
            remaining = int(value)
            if remaining > 0:
                frame["fail_distributed_init"] = remaining - 1
                raise FaultInjectedError(
                    "injected fault: distributed bring-up attempt failed "
                    f"({remaining - 1} injected failure(s) remaining)"
                )
            return
    value = _parse_env().get("fail_distributed_init")
    if value is None or value is False:
        return
    total = int(value) if str(value).isdigit() else 1
    global _ENV_DIST_INIT_CONSUMED
    if _ENV_DIST_INIT_CONSUMED < total:
        _ENV_DIST_INIT_CONSUMED += 1
        raise FaultInjectedError(
            "injected fault: distributed bring-up attempt failed "
            f"({total - _ENV_DIST_INIT_CONSUMED} injected failure(s) remaining)"
        )


class FakeClock:
    """Deterministic injectable clock: ``now``/``sleep`` advance virtual
    time only, and every requested sleep is recorded."""

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)
        self.sleeps: List[float] = []

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(float(seconds))
        self._now += float(seconds)

    def advance(self, seconds: float) -> None:
        self._now += float(seconds)


# -- on-disk mutators (tests and the corrupt-model corpus) --------------------


def corrupt_file_on_disk(path: str, offset: Optional[int] = None) -> int:
    """Flip one byte of ``path`` in place (default: three quarters in);
    returns the offset flipped. Unlike the read fault this outlives the
    process: it is what a manifest's CRC exists to catch."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data:
        raise ValueError(f"cannot corrupt empty file {path}")
    if offset is None:
        offset = (len(data) * 3) // 4
    with open(path, "wb") as fh:
        fh.write(_flip_at(data, offset))
    return max(0, min(offset, len(data) - 1))


def truncate_file_on_disk(path: str, keep: Optional[int] = None) -> int:
    """Truncate ``path`` in place (default: to half); returns the kept size."""
    size = os.path.getsize(path)
    if keep is None:
        keep = size // 2
    keep = max(1, min(keep, size))
    with open(path, "rb+") as fh:
        fh.truncate(keep)
    return keep
