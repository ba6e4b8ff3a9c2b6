"""The degradation ladder of the port (``isoforest_tpu/resilience/degradation.py``).

Every rung the port may take goes through :func:`degrade`: the event is
recorded in a process-wide :class:`DegradationReport` (queryable with
:func:`degradations` and ``model.degradations()``) with a count per
reason, logged once per reason until :func:`reset_degradations`, counted on
``isoforest_degradations_total{reason}`` and appended to the event timeline.

:data:`LADDER` holds only the rungs that hide no device and no kernel:

* ``dropped_trees``: a load the caller asked to salvage
  (``on_corrupt="drop"``) drops the corrupt trees and scores the rest;
* ``drift_alert``: the drift monitor flags serving traffic that left the
  training baseline; scores stay exact;
* ``pipeline_fallback``: the streaming executor cannot stage (no pinned
  memory or copy stream, or the ``break_pipeline_stage`` fault) and copies
  each chunk synchronously; scores are bitwise equal, only the overlap is
  lost;
* ``env_strategy_unknown``: an ``ISOFOREST_TPU_STRATEGY`` pin the port does
  not know (``gather``, ``native``, ``pallas``, ...) resolves to the static
  default, the walk;
* ``q16_unsupported``: ``strategy="q16"`` on a forest outside the quantized
  plane's fences runs the walk kernel; the JAX package runs its gather
  walk, which the port has only as a test reference;
* ``shard_pin_ineligible``: an ``ISOFOREST_TPU_STRATEGY`` pin outside the
  sharded pool (``walk``, ``dense``) is ignored by sharded scoring
  (:mod:`..parallel.sharded`), which resolves its own default.

Under ``strict=True`` :func:`degrade` raises :class:`DegradationError`
instead of taking the rung; ``pipeline_fallback`` is strict-exempt (its
scores are bitwise equal), so ``env_strategy_unknown`` and
``q16_unsupported`` pass it.

The JAX package's scoring-strategy rungs (``native_unavailable``,
``walk_off_tpu``, ``walk_unsupported``, ``scoring_timeout``,
``autotune_probe_failed``, ...) fall back to another kernel. The port has
no such fallback: a kernel that cannot run, or a card that is missing,
raises; a scoring timeout raises
:class:`~isoforest_tpu_torch.resilience.watchdog.WatchdogTimeout`, and an
autotune probe that raises propagates.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..telemetry.events import record_event
from ..telemetry.metrics import counter as _counter
from ..utils.validation import logger

_DEGRADATIONS_TOTAL = _counter(
    "isoforest_degradations_total",
    "Degradation-ladder rungs taken, by reason",
    labelnames=("reason",),
)

# reason -> the rung's parity guarantee; degrade() refuses any other reason
LADDER: Dict[str, str] = {
    "drift_alert": (
        "serving traffic drifted past the configured PSI threshold vs the "
        "training baseline: scores are still computed exactly (no kernel "
        "change) — the rung flags model-quality risk, not a compute "
        "fallback"
    ),
    "dropped_trees": (
        "corrupt trees dropped at load -> valid smaller forest: path-length "
        "normalisation rescales to the surviving tree count automatically "
        "(score = 2^(-mean_h/c(n)) over kept trees); ensemble quality "
        "degrades gracefully with lost trees (FastForest, arxiv 2004.02423)"
    ),
    "env_strategy_unknown": (
        "unrecognised ISOFOREST_TPU_STRATEGY pin -> the static default (walk): "
        "scores are the walk kernel's, within cross-strategy f32 tolerance of "
        "any valid pin"
    ),
    "q16_unsupported": (
        "q16 -> walk for forests outside the quantized fences "
        "(scoring_layout.quantized_unsupported_reason): the walk kernel's "
        "scores, within cross-strategy f32 tolerance of the gather walk an "
        "eligible q16 run equals bitwise, so this rung changes the kernel, "
        "never the decisions"
    ),
    "shard_pin_ineligible": (
        "ineligible ISOFOREST_TPU_STRATEGY pin inside sharded scoring -> "
        "the sharded pool's default (walk/dense): scores within "
        "cross-strategy f32 tolerance"
    ),
    "pipeline_fallback": (
        "staging unavailable for the streaming executor -> synchronous "
        "per-chunk copy: scores are BITWISE equal (every kernel is "
        "row-independent; only the copy/compute overlap is lost), so this "
        "rung is strict-exempt"
    ),
}


class DegradationError(RuntimeError):
    """A fallback was required but ``strict=True`` forbids it."""


@dataclasses.dataclass
class DegradationEvent:
    """One recorded rung: which, what it replaced, how often."""

    reason: str
    from_: str
    to: str
    detail: str
    count: int = 1
    first_unix_s: float = 0.0
    last_unix_s: float = 0.0

    def as_dict(self) -> dict:
        return {"reason": self.reason, "from": self.from_, "to": self.to, "detail": self.detail,
                "count": self.count}


@dataclasses.dataclass(frozen=True)
class LoadReport:
    """Outcome of an ``on_corrupt="drop"`` load: which trees were lost and
    why. Set on the loaded model as ``model.load_report`` (None for an
    ``on_corrupt="raise"`` load)."""

    path: str
    expected_trees: Optional[int]
    kept_trees: int
    dropped_tree_ids: Tuple[int, ...]
    issues: Tuple[str, ...]

    def as_dict(self) -> dict:
        return {
            "path": self.path,
            "expected_trees": self.expected_trees,
            "kept_trees": self.kept_trees,
            "dropped_tree_ids": list(self.dropped_tree_ids),
            "issues": list(self.issues),
        }


class DegradationReport:
    """Registry of degradation events; one process-wide instance backs
    :func:`degrade`. Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: Dict[str, DegradationEvent] = {}

    def record(self, reason: str, from_: str, to: str, detail: str) -> bool:
        """Record one occurrence; True when it is the first since the last
        reset (the warning should log)."""
        now = time.time()
        with self._lock:
            ev = self._events.get(reason)
            if ev is None:
                self._events[reason] = DegradationEvent(reason, from_, to, detail, 1, now, now)
                return True
            ev.count += 1
            ev.last_unix_s = now
            ev.detail = detail
            return False

    def events(self) -> List[DegradationEvent]:
        with self._lock:
            return [dataclasses.replace(ev) for ev in self._events.values()]

    def count(self, reason: str) -> int:
        with self._lock:
            ev = self._events.get(reason)
            return ev.count if ev else 0

    def reset(self, reason: Optional[str] = None) -> None:
        with self._lock:
            if reason is None:
                self._events.clear()
            else:
                self._events.pop(reason, None)


_REPORT = DegradationReport()


def degradation_report() -> DegradationReport:
    """The process-wide registry."""
    return _REPORT


def degradations() -> List[DegradationEvent]:
    """Every degradation recorded since the process started or the last reset."""
    return _REPORT.events()


def reset_degradations(reason: Optional[str] = None) -> None:
    """Clear recorded events (all, or one reason); re-arms their log-once warning."""
    _REPORT.reset(reason)


def degrade(reason: str, from_: str, to: str, detail: str = "", strict: bool = False) -> str:
    """Take one rung; returns ``to``. Logs ``detail`` once per reason (until
    reset) and records an event every time; under ``strict`` raises
    :class:`DegradationError` instead, and the caller must not fall back."""
    if reason not in LADDER:
        raise ValueError(f"unknown degradation reason {reason!r}; known rungs: {', '.join(sorted(LADDER))}")
    if strict:
        raise DegradationError(
            f"strict mode forbids the {reason!r} fallback ({from_} -> {to}): {detail or LADDER[reason]}"
        )
    first = _REPORT.record(reason, from_, to, detail)
    _DEGRADATIONS_TOTAL.inc(reason=reason)
    record_event("degradation", reason=reason, **{"from": from_, "to": to}, detail=detail or LADDER[reason])
    if first:
        logger.warning("degraded [%s] %s -> %s: %s", reason, from_, to, detail or LADDER[reason])
    return to
